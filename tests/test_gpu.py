"""Card-only tests: the compiled GPU kernels against their plain
references at small shapes. Each skips (from a fixture, never at
import) when JAX finds no GPU; `python chip_smoke.py` runs them on the
card, in its own process, after its other phases."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (run by chip_smoke.py on the card)")
    return dev


def test_screen_counts_match_popcount_oracle(gpu):
    import jax.numpy as jnp

    from galah_tpu.ops.prefilter import _screen_counts_packed

    rng = np.random.default_rng(1)
    a = rng.integers(0, 2**32, (256, 1024), dtype=np.uint32)
    b = rng.integers(0, 2**32, (512, 1024), dtype=np.uint32)
    want = np.stack([np.bitwise_count(r[None, :] & b).sum(axis=1) for r in a])
    for dtname in ("int8", "bf16", "f32"):
        got = np.asarray(_screen_counts_packed(
            jnp.asarray(a), jnp.asarray(b), dtname))
        np.testing.assert_array_equal(got.astype(np.int64), want)


def test_device_sketch_matches_host(gpu):
    from galah_tpu.ops.device_sketch import device_sketch_batch
    from galah_tpu.sketch.fracminhash import (
        NativeSketchParams, sketch_sequences_native,
    )

    rng = np.random.default_rng(2)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    seqs = [[acgt[rng.integers(0, 4, 200_000)].tobytes()] for _ in range(3)]
    params = NativeSketchParams()
    names = [f"g{i}" for i in range(3)]
    for d, n, s in zip(device_sketch_batch(names, seqs, params), names, seqs):
        h = sketch_sequences_native(n, s, params)
        np.testing.assert_array_equal(d.prefilter_buckets, h.prefilter_buckets)
        np.testing.assert_array_equal(d.member_buckets, h.member_buckets)
        np.testing.assert_array_equal(d.frag_offsets, h.frag_offsets)
        np.testing.assert_array_equal(d.frag_buckets, h.frag_buckets)


def test_forward_hits_match_reference(gpu):
    import jax.numpy as jnp

    from galah_tpu.ops.fragment_ani import _forward_hits, forward_reference

    rng = np.random.default_rng(3)
    bits, n, nfrag = 1 << 16, 8192, 32
    bitmaps = rng.integers(0, 2**32, (8, bits // 32), dtype=np.uint32)
    buckets = rng.integers(0, bits, n).astype(np.int32)
    offsets = (np.arange(nfrag + 1) * (n // nfrag)).astype(np.int32)
    hits = np.asarray(_forward_hits(
        jnp.asarray(bitmaps), jnp.asarray(buckets), jnp.asarray(offsets),
        jnp.int32(n)))
    for i in range(8):
        m = forward_reference(bitmaps[i], 0.0, buckets, offsets, bits,
                              15, 4, 0.8)[0]
        np.testing.assert_array_equal(hits[i], m)
