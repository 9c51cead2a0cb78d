import os

# The suite runs on the CPU backend with 8 virtual devices, so that
# multi-device sharding paths run without accelerators. The XLA flag
# must be set before backend init. chip_smoke.py runs the card-only
# tests (tests/test_gpu.py) on the GPU and sets GALAH_TPU_TESTS_ON_GPU=1
# to keep its backend.
if os.environ.get("GALAH_TPU_TESTS_ON_GPU") != "1":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

REFERENCE_DATA = "/root/reference/tests/data"


def data(path: str) -> str:
    return os.path.join(REFERENCE_DATA, path)
