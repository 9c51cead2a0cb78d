"""Platform helpers: the persistent compile cache, per-backend defaults
and the device memory limit that capacity rules take shares of."""

from __future__ import annotations

import os

# Root of the checkout (the directory holding the galah_tpu package).
CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

# The CPU backend reports no memory limit; host-only runs (tests, CPU
# clustering) size their device-side caches against this figure.
HOST_BACKEND_MEMORY = 8 << 30


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache.
    The path is part of the cache key, so it never moves."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir().
    Every entry point (CLI, bench.py, prewarm, chip_smoke.py) calls this
    before its first trace. Returns the directory."""
    import jax

    path = compile_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def backend_default(**by_platform):
    """The default measured for the running backend, given one keyword
    per platform (e.g. ``backend_default(cpu="word", gpu="auto")``).
    A backend with no measured default is an error, not a fallback."""
    import jax

    backend = jax.default_backend()
    if backend not in by_platform:
        raise RuntimeError(
            f"no default measured for the {backend!r} backend "
            f"(known: {', '.join(sorted(by_platform))})"
        )
    return by_platform[backend]


def device_memory_limit(device=None) -> int:
    """Bytes the allocator may hand out on `device` (default: the first
    local device). The CPU backend reports none and gets
    HOST_BACKEND_MEMORY; an accelerator that reports none is an error."""
    import jax

    dev = device if device is not None else jax.local_devices()[0]
    stats = dev.memory_stats() if hasattr(dev, "memory_stats") else None
    if stats and stats.get("bytes_limit"):
        return int(stats["bytes_limit"])
    if dev.platform == "cpu":
        return HOST_BACKEND_MEMORY
    raise RuntimeError(
        f"device {dev} ({dev.platform}) reports no memory limit"
    )


def require_gpu():
    """The first device, if JAX runs on a GPU; SystemExit(2) otherwise.
    Measurement entry points call this so that a missing card is a
    failure, never a silent CPU run."""
    import sys

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(
            f"error: no GPU found (JAX platform {dev.platform!r}); "
            "this command measures the GPU and does not run elsewhere",
            file=sys.stderr,
        )
        raise SystemExit(2)
    return dev
