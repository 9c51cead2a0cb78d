"""Screen intersection counts (ops/prefilter.py:_screen_counts_packed,
unpack + dot_general) against a numpy popcount-intersection oracle, in
every screen dtype, and the resident sweep's grouped tile dispatch."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from galah_tpu.ops.prefilter import _screen_counts_packed, pack_indicator


def _pack(bits: np.ndarray) -> np.ndarray:
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32)


def _dense_and_empty():
    rng = np.random.default_rng(7)
    a = rng.random((128, 4096)) < 0.9
    a[3] = False  # empty row
    a[4] = True   # full row
    b = rng.random((128, 4096)) < 0.9
    return a, b


def _sparse(m, n, bits):
    rng = np.random.default_rng(m + n + bits)
    return rng.random((m, bits)) < 0.15, rng.random((n, bits)) < 0.15


CASES = {
    "128x128x4096": lambda: _sparse(128, 128, 4096),
    "256x128x8192": lambda: _sparse(256, 128, 8192),
    "128x256x4096": lambda: _sparse(128, 256, 4096),
    "dense_and_empty_rows": _dense_and_empty,
}


@pytest.mark.parametrize("dtname", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_screen_counts_packed_exact(case, dtname):
    a, b = CASES[case]()
    want = a.astype(np.int64) @ b.astype(np.int64).T
    fn = jax.jit(lambda x, y: _screen_counts_packed(x, y, dtname))
    got = np.asarray(fn(jnp.asarray(_pack(a)), jnp.asarray(_pack(b))))
    assert got.dtype == np.float32
    assert (got == want).all()


def test_pack_indicator():
    bits = 1 << 10
    buckets = np.array([0, 1, 31, 32, 1023], dtype=np.int32)
    words = pack_indicator(buckets, bits)
    assert words[0] == (1 | 2 | (1 << 31))
    assert words[1] == 1
    assert words[31] == (1 << 31)
    assert int(np.unpackbits(words.view(np.uint8)).sum()) == 5


def test_grouped_tile_dispatch_matches_single(monkeypatch):
    """GALAH_TPU_SCREEN_TILE_GROUP>1 batches resident-sweep tiles into
    lax.map dispatches; results must be identical to per-tile
    dispatches (same kernel body)."""
    from galah_tpu.ops.prefilter import screen_triangle_packed

    rng = np.random.default_rng(17)
    n, bits = 700, 4096
    ind = (rng.random((n, bits)) < 0.06).astype(np.uint8)
    # plant duplicates so hits exist, including on a diagonal tile
    ind[1] = ind[0]
    ind[650] = ind[649]
    sizes = ind.sum(axis=1)
    packed = [
        np.packbits(row.astype(bool), bitorder="little").view(np.uint32)
        for row in ind
    ]

    def run(group):
        monkeypatch.setenv("GALAH_TPU_SCREEN_TILE_GROUP", str(group))
        monkeypatch.setenv("GALAH_TPU_SCREEN_BLOCK", "128")
        res = screen_triangle_packed(
            packed, sizes, k=15, min_containment=0.3, bits=bits
        )
        monkeypatch.delenv("GALAH_TPU_SCREEN_BLOCK")
        order = np.lexsort((res.pairs[:, 1], res.pairs[:, 0]))
        return res.pairs[order], res.ani_est[order]

    p1, a1 = run(1)
    p3, a3 = run(3)
    p8, a8 = run(8)
    np.testing.assert_array_equal(p1, p3)
    np.testing.assert_array_equal(p1, p8)
    np.testing.assert_array_equal(a1, a3)
    np.testing.assert_array_equal(a1, a8)
    assert len(p1) >= 2


def test_grouped_rectangle_dispatch_matches_single(monkeypatch):
    """The rectangle (reference-mode) resident sweep groups tiles the
    same way; results must be identical to per-tile dispatches."""
    from galah_tpu.ops.prefilter import screen_rectangle_packed

    rng = np.random.default_rng(23)
    nq, nr, bits = 500, 300, 4096
    qi = (rng.random((nq, bits)) < 0.06).astype(np.uint8)
    ri = (rng.random((nr, bits)) < 0.06).astype(np.uint8)
    ri[5] = qi[3]  # plant a hit
    ri[250] = qi[480]
    qs = qi.sum(axis=1)
    rs = ri.sum(axis=1)
    qp = [np.packbits(r.astype(bool), bitorder="little").view(np.uint32) for r in qi]
    rp = [np.packbits(r.astype(bool), bitorder="little").view(np.uint32) for r in ri]

    def run(group):
        monkeypatch.setenv("GALAH_TPU_SCREEN_TILE_GROUP", str(group))
        monkeypatch.setenv("GALAH_TPU_SCREEN_BLOCK", "128")
        res = screen_rectangle_packed(qp, qs, rp, rs, k=15,
                                      min_containment=0.3, bits=bits)
        monkeypatch.delenv("GALAH_TPU_SCREEN_BLOCK")
        order = np.lexsort((res.pairs[:, 1], res.pairs[:, 0]))
        return res.pairs[order], res.ani_est[order]

    p1, a1 = run(1)
    p3, a3 = run(3)
    np.testing.assert_array_equal(p1, p3)
    np.testing.assert_array_equal(a1, a3)
    assert len(p1) >= 2


def test_grouped_dispatch_group_cap_overflow_fallback(monkeypatch):
    """When a group's total survivors exceed the shared cap region the
    drain re-dispatches tiles singly; a fully-dense corpus (every pair
    passes) exercises that path and must match per-tile results."""
    from galah_tpu.ops.prefilter import screen_triangle_packed

    rng = np.random.default_rng(31)
    n, bits = 600, 4096
    base = (rng.random(bits) < 0.06).astype(np.uint8)
    ind = np.tile(base, (n, 1))  # identical rows: all pairs hit
    sizes = ind.sum(axis=1)
    packed = [
        np.packbits(row.astype(bool), bitorder="little").view(np.uint32)
        for row in ind
    ]

    def run(group):
        monkeypatch.setenv("GALAH_TPU_SCREEN_TILE_GROUP", str(group))
        monkeypatch.setenv("GALAH_TPU_SCREEN_BLOCK", "128")
        res = screen_triangle_packed(
            packed, sizes, k=15, min_containment=0.0, bits=bits
        )
        monkeypatch.delenv("GALAH_TPU_SCREEN_BLOCK")
        order = np.lexsort((res.pairs[:, 1], res.pairs[:, 0]))
        return res.pairs[order], res.ani_est[order]

    p1, a1 = run(1)
    p4, a4 = run(4)
    np.testing.assert_array_equal(p1, p4)
    np.testing.assert_array_equal(a1, a4)
    assert len(p1) == n * (n - 1) // 2


def test_padded_remainder_group_does_not_spuriously_overflow(monkeypatch):
    """A force-flushed remainder group pads with repeats of its first
    tile; the padding must not count toward the shared compaction cap.

    3 diagonal tiles at block=128 with group=8 form a real padded
    remainder group (nreal=3, 5 padding repeats of tile (0,0)). Tile
    (0,0) carries ~C(78,2)=3003 survivors, so padding-blind accounting
    would read 6*3003 > cap=16384 and spuriously fall back to single
    re-dispatches, while the true survivor total is well under cap.
    The spy asserts that exact scenario formed (blind > cap >= real)
    AND that no fallback happened — so the nreal-exclusion fix
    (prefilter.py _decode_group_result / kernel `real` mask) is
    load-bearing, not vacuously green."""
    from galah_tpu.ops import prefilter as pf

    rng = np.random.default_rng(41)
    n, bits = 384, 4096  # 3 diag tiles at block=128
    ind = (rng.random((n, bits)) < 0.06).astype(np.uint8)
    ind[:78] = ind[0]  # C(78,2)=3003 survivors, all inside tile (0,0)
    sizes = ind.sum(axis=1)
    packed = [
        np.packbits(r.astype(bool), bitorder="little").view(np.uint32)
        for r in ind
    ]

    calls = []
    orig = pf._decode_group_result

    def spy(buf, k_tiles, cap, block, nreal):
        cnts, per = orig(buf, k_tiles, cap, block, nreal)
        c = np.asarray(cnts)
        clipped = np.where((c >= 0) & (c <= cap), c, 0)
        calls.append({
            "fallback": per is None,
            "padded": nreal < k_tiles,
            "blind_total": int(clipped.sum()),
            "real_total": int(clipped[:nreal].sum()),
            "cap": cap,
        })
        return cnts, per

    monkeypatch.setattr(pf, "_decode_group_result", spy)
    monkeypatch.setenv("GALAH_TPU_SCREEN_TILE_GROUP", "8")
    monkeypatch.setenv("GALAH_TPU_SCREEN_BLOCK", "128")
    res = pf.screen_triangle_packed(
        packed, sizes, k=15, min_containment=0.3, bits=bits
    )
    monkeypatch.delenv("GALAH_TPU_SCREEN_BLOCK")
    monkeypatch.delenv("GALAH_TPU_SCREEN_TILE_GROUP")
    # The grouped decode ran on at least one padded remainder group…
    padded_calls = [c for c in calls if c["padded"]]
    assert padded_calls
    # …where padding-blind accounting WOULD have overflowed the cap
    # while the true (nreal-masked) total does not — the scenario the
    # fix exists for actually formed…
    assert any(
        c["blind_total"] > c["cap"] >= c["real_total"]
        for c in padded_calls
    )
    # …and no group fell back to single re-dispatches.
    assert not any(c["fallback"] for c in calls)
    assert len(res.pairs) >= 78 * 77 // 2
