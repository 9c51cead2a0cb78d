"""Per-backend defaults, device tables, capacity shares, the compile
cache location and the GPU entry points' refusal to run elsewhere.

The GPU branches are exercised here on the CPU by monkeypatching
jax.default_backend to "gpu": each must pick the default measured on
the H100 (PERF.md, "Bring-up on the H100")."""

import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

from galah_tpu.utils import platform as plat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    for var in (
        "GALAH_TPU_SCREEN_DTYPE", "GALAH_TPU_SCREEN_TILE_GROUP",
        "GALAH_TPU_SKETCH_KERNEL", "GALAH_TPU_SKETCH_TRANSPORT",
        "GALAH_TPU_SKETCH_HOST_COPIES", "GALAH_TPU_VERIFY_GATHER",
        "GALAH_TPU_BITMAP_UPLOAD", "GALAH_TPU_VERIFY_GROUP",
        "GALAH_TPU_DEVICE_SKETCH", "GALAH_TPU_SCREEN",
        "GALAH_TPU_SCREEN_BLOCK", "GALAH_TPU_ARENA_HASHES",
        "GALAH_TPU_ARENA_FRAGS",
    ):
        monkeypatch.delenv(var, raising=False)


def _gpu_default(name):
    from galah_tpu.engines import native
    from galah_tpu.ops import device_sketch, fragment_ani, pair_table, prefilter

    return {
        "screen_dtype": prefilter._screen_dtype_name,
        "screen_tile_group": prefilter._screen_tile_group,
        "sketch_routed": device_sketch._default_routed,
        "sketch_transport": device_sketch._transport_mode,
        "sketch_host_copies": device_sketch._host_copies_mode,
        "verify_gather": fragment_ani._verify_gather_mode,
        "bitmap_upload": fragment_ani._bitmap_upload_mode,
        "verify_group": pair_table._verify_group,
        "device_sketch": native._use_device_sketch,
        "screen_backend": native._screen_backend,
    }[name]()


# The defaults measured on the H100 (PERF.md, "Bring-up on the H100").
GPU_DEFAULTS = {
    "screen_dtype": "int8",
    "screen_tile_group": 16,
    "sketch_routed": False,
    "sketch_transport": "lists",
    "sketch_host_copies": "lazy",
    "verify_gather": "bt",
    "bitmap_upload": "auto",
    "verify_group": 8,
    "device_sketch": True,
    "screen_backend": "packed",
}


@pytest.mark.parametrize("name", sorted(GPU_DEFAULTS))
def test_gpu_branch_picks_measured_default(on_gpu, name):
    assert _gpu_default(name) == GPU_DEFAULTS[name]


def test_gpu_extraction_is_routed(on_gpu, monkeypatch):
    """The GPU's sparse extraction takes the routed compaction; both
    paths return the same hits."""
    import jax.numpy as jnp

    from galah_tpu.ops import prefilter

    calls = []
    orig = prefilter._compact_hits

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(prefilter, "_compact_hits", spy)
    rng = np.random.default_rng(3)
    cont = jnp.asarray(rng.random((256, 256)).astype(np.float32))
    mask = cont > 0.999
    got = prefilter._extract_above_cutoff(cont, mask, 1024)
    assert calls
    want = prefilter._extract_above_cutoff(cont, mask, 1024, routed=False)
    n = int(got[0])
    assert n == int(want[0]) > 0
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(np.asarray(g)[:n], np.asarray(w)[:n])


def test_unknown_backend_has_no_default(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="no default measured"):
        plat.backend_default(cpu=1, gpu=2)


def _fake_device(kind, platform="gpu", stats=None):
    return types.SimpleNamespace(
        device_kind=kind, platform=platform, id=0,
        memory_stats=lambda: stats,
    )


@pytest.mark.parametrize("kind", [H100, "Some Future Accelerator"])
def test_screen_tile_rates_keyed_by_device_kind(monkeypatch, kind):
    from galah_tpu.ops import prefilter

    monkeypatch.setattr(prefilter.jax, "devices", lambda: [_fake_device(kind)])
    if kind == H100:
        rates = prefilter._tile_rates()
        assert sorted(rates) == [1024, 2048, 4096, 8192]
        assert all(r > 0 for r in rates.values())
    else:
        with pytest.raises(RuntimeError, match="no screen tile rates"):
            prefilter._tile_rates()


@pytest.mark.parametrize("kind", [H100, "Some Future Accelerator"])
def test_expected_rates_keyed_by_device_kind(kind):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(REPO, "bench.py")
    )
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    if kind == H100:
        table = bench.expected_rates(kind)
        assert float(table["screen_production"]["expect"]) > 0
    else:
        with pytest.raises(KeyError, match="no expected rates"):
            bench.expected_rates(kind)


def test_screen_block_uses_device_rates(on_gpu, monkeypatch):
    from galah_tpu.ops import prefilter

    monkeypatch.setattr(prefilter.jax, "devices", lambda: [_fake_device(H100)])
    blocks = [prefilter._screen_block_for(n) for n in (100, 20_000, 300_000)]
    assert all(b in (1024, 2048, 4096, 8192) for b in blocks)
    assert blocks == sorted(blocks)


@pytest.mark.parametrize("case", ["cpu", "gpu_limit", "gpu_no_limit"])
def test_device_memory_limit(case):
    if case == "cpu":
        dev = _fake_device("cpu", platform="cpu", stats=None)
        assert plat.device_memory_limit(dev) == plat.HOST_BACKEND_MEMORY
    elif case == "gpu_limit":
        dev = _fake_device(H100, stats={"bytes_limit": 60 << 30})
        assert plat.device_memory_limit(dev) == 60 << 30
    else:
        dev = _fake_device(H100, stats={})
        with pytest.raises(RuntimeError, match="reports no memory limit"):
            plat.device_memory_limit(dev)


def test_capacities_are_shares_of_the_device_limit(on_gpu, monkeypatch):
    from galah_tpu.ops import fragment_ani, prefilter

    limit = 60 << 30
    monkeypatch.setattr(plat, "device_memory_limit", lambda device=None: limit)
    assert prefilter._device_resident_budget() == int(
        limit * prefilter.RESIDENT_SHARE
    )
    hashes, frags = fragment_ani._arena_capacities()
    assert hashes & (hashes - 1) == 0 and frags == hashes >> 4
    assert limit * fragment_ani.ARENA_SHARE / 2 < hashes * 4
    assert hashes * 4 <= limit * fragment_ani.ARENA_SHARE


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert plat.compile_cache_dir() == str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert plat.compile_cache_dir() == os.path.join(REPO, ".jax_cache")


def test_forward_kernel_matches_reference():
    """The grouped verify kernel (word gather) and its bit-transposed
    form against the numpy reference: hit counts and AF exact, ANI
    within 1e-4 percentage points."""
    import jax.numpy as jnp

    from galah_tpu.ops.fragment_ani import (
        _bit_transpose_table, _forward_hits, _forward_kernel,
        _forward_kernel_bt, forward_reference,
    )

    rng = np.random.default_rng(5)
    r, bits, npad, nfrag = 32, 1 << 14, 1 << 12, 64
    n = npad - 200
    bitmaps = rng.integers(0, 2**32, (r, bits // 32), dtype=np.uint32)
    # Half the stream draws set bits of ref 0 (high identity to it).
    set0 = np.nonzero(np.unpackbits(bitmaps[0].view(np.uint8),
                                    bitorder="little"))[0]
    buckets = rng.integers(0, bits, npad).astype(np.int32)
    buckets[: n // 2] = rng.choice(set0, n // 2)
    offsets = np.minimum(np.arange(nfrag + 1) * (n // nfrag + 1), n)
    offsets = offsets.astype(np.int32)
    popc = np.array([np.unpackbits(b.view(np.uint8)).sum() for b in bitmaps],
                    np.float32)
    kw = dict(bits=bits, k=15, min_hashes=4, min_ident=0.8)
    args = (jnp.asarray(popc), jnp.asarray(buckets), jnp.asarray(offsets),
            jnp.int32(n))
    ani_w, af_w = (np.asarray(v) for v in _forward_kernel(
        jnp.asarray(bitmaps), *args, **kw))
    ani_b, af_b = (np.asarray(v) for v in _forward_kernel_bt(
        _bit_transpose_table(jnp.asarray(bitmaps)), *args, **kw))
    hits = np.asarray(_forward_hits(
        jnp.asarray(bitmaps), jnp.asarray(buckets), jnp.asarray(offsets),
        jnp.int32(n)))
    for i in range(r):
        m, ani, af, _, _ = forward_reference(
            bitmaps[i], popc[i], buckets[:n], offsets, bits, 15, 4, 0.8
        )
        np.testing.assert_array_equal(hits[i], m)
        assert af_w[i] == np.float32(af) == af_b[i]
        assert abs(ani_w[i] - ani) <= 1e-4 and abs(ani_b[i] - ani) <= 1e-4
    assert ani_w[0] > 90.0  # the related ref is aligned


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RECOVERY_CASES = {
    "exact": ("a\ta\na\tb\nc\tc\nc\td\n", []),
    "split": ("a\ta\nb\tb\nc\tc\nc\td\n", ["families split"]),
    "merged": ("a\ta\na\tb\na\tc\na\td\n", ["merge families"]),
    "missing": ("a\ta\na\tb\nc\tc\n", ["members missing"]),
}


@pytest.mark.parametrize("case", sorted(RECOVERY_CASES))
def test_chip_smoke_family_recovery_checker(case):
    tsv, want = RECOVERY_CASES[case]
    family_of = {"a": 0, "b": 0, "c": 1, "d": 1}
    errors = _chip_smoke().family_recovery_errors(tsv, family_of)
    assert len(errors) == len(want)
    for w, e in zip(want, errors):
        assert w in e


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        with open(script) as f:
            src = f.read()
        script = str(tmp_path / "chip_smoke.py")
        with open(script, "w") as f:
            f.write(src)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, script], capture_output=True, text=True,
        env=env, cwd=os.path.dirname(script), timeout=300,
    )
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_bench_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no GPU" in proc.stderr
