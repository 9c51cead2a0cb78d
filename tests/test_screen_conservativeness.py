"""The screen must never drop a pair the verify stage would accept —
its cutoff is derived from the worst admissible case (minimum aligned
fraction at exactly the ANI threshold, with a safety margin;
engines/native._screen_min_containment)."""

import numpy as np
import pytest

from galah_tpu.engines.native import (
    NativeContext,
    NativePreclusterer,
    _screen_min_containment,
)
from galah_tpu.utils.synth import mutate, random_genome, write_fasta


def test_cutoff_formula_below_worst_case():
    # worst containment for a passing pair ~ af * (ani/100)^k; the
    # cutoff must sit below it with margin
    k = 15
    for ani in (90.0, 95.0, 99.0):
        for af in (0.15, 0.3, 0.7):
            worst = af * (ani / 100.0) ** k
            cutoff = _screen_min_containment(ani, af, k)
            assert cutoff < worst * 0.75


def test_borderline_pair_survives_screen(tmp_path):
    """AF barely above the minimum, ANI barely above threshold: the
    pair must be in the verified cache."""
    rng = np.random.default_rng(17)
    L = 400_000
    shared_len = int(L * 0.22)  # just above the 0.15 default min AF
    shared = random_genome(rng, shared_len)
    a = np.concatenate([shared, random_genome(rng, L - shared_len)])
    b = np.concatenate(
        [mutate(rng, shared, 0.965), random_genome(rng, L - shared_len)]
    )
    p1, p2 = str(tmp_path / "a.fna"), str(tmp_path / "b.fna")
    write_fasta(p1, a, "a")
    write_fasta(p2, b, "b")

    ctx = NativeContext(threads=2)
    pre = NativePreclusterer(threshold=95.0, min_aligned_threshold=0.15, ctx=ctx)
    cache = pre.distances([p1, p2])
    got = cache.get((0, 1))
    assert got is not None, "borderline pair was screened out"
    assert got[0] > 95.0


def test_low_af_widens_prefilter_and_keeps_pair(tmp_path):
    """--min-aligned-fraction below 5%: the screen cutoff is computed
    exactly from the requested AF (reference passes --min-af through,
    src/skani.rs:144-159) and the prefilter bitmap widens so the cutoff
    clears collision noise. A ~3%-AF 97%-ANI pair must survive."""
    from galah_tpu import defaults

    rng = np.random.default_rng(5)
    L = 400_000
    shared_len = 12_000  # 3% of L
    shared = random_genome(rng, shared_len)
    a = np.concatenate([shared, random_genome(rng, L - shared_len)])
    b = np.concatenate(
        [mutate(rng, shared, 0.97), random_genome(rng, L - shared_len)]
    )
    p1, p2 = str(tmp_path / "a.fna"), str(tmp_path / "b.fna")
    write_fasta(p1, a, "a")
    write_fasta(p2, b, "b")

    ctx = NativeContext(threads=2)
    pre = NativePreclusterer(threshold=95.0, min_aligned_threshold=0.02, ctx=ctx)
    assert ctx.params.prefilter_bits > defaults.NATIVE_PREFILTER_BITS
    cache = pre.distances([p1, p2])
    got = cache.get((0, 1))
    assert got is not None, "low-AF pair was screened out"
    assert got[0] > 95.0


def test_low_af_above_floor_unchanged():
    from galah_tpu import defaults

    from galah_tpu.engines.native import NativePreclusterer

    ctx = NativeContext(threads=1)
    NativePreclusterer(threshold=95.0, min_aligned_threshold=0.15, ctx=ctx)
    assert ctx.params.prefilter_bits == defaults.NATIVE_PREFILTER_BITS


def test_impossibly_low_af_refused():
    import pytest

    from galah_tpu.engines.native import NativePreclusterer

    with pytest.raises(ValueError, match="min-aligned-fraction"):
        NativePreclusterer(
            threshold=85.0, min_aligned_threshold=0.0005,
            ctx=NativeContext(threads=1),
        )


def test_zero_af_disables_screen_pruning():
    from galah_tpu.engines.native import _screen_min_containment

    assert _screen_min_containment(95.0, 0.0, 15) == 0.0


def test_four_sigma_invariant_at_low_precluster_ani():
    """The 4-sigma cutoff-vs-noise invariant holds for EVERY requested
    AF, not only sub-5% ones: at --precluster-ani 85 the default 2^17
    bitmap leaves an AF-0.05 cutoff at ~1.1 sigma, so the context must
    widen it (regression for the old early-return at the 5% floor)."""
    from galah_tpu.engines.native import _screen_min_containment

    from galah_tpu.engines.native import NativePreclusterer

    ctx = NativeContext(threads=1)
    NativePreclusterer(threshold=85.0, min_aligned_threshold=0.05, ctx=ctx)
    cutoff = _screen_min_containment(85.0, 0.05, ctx.params.k)
    sigma = 1.0 / ctx.params.prefilter_bits ** 0.5
    assert cutoff >= 4.0 * sigma, (cutoff, sigma, ctx.params.prefilter_bits)


def test_zero_cutoff_screen_emits_strict_upper_triangle():
    """With --min-aligned-fraction 0 (cutoff 0.0, 'verify every pair')
    the screen must still emit each pair once as (i, j) with i < j and
    never self-pairs — the diagonal used to be masked with 0.0, which a
    >= 0.0 cutoff let straight through."""
    from galah_tpu.ops.prefilter import pack_indicator
    from galah_tpu.ops.prefilter import (
        screen_triangle,
        screen_triangle_packed,
    )

    rng = np.random.default_rng(11)
    n, bits = 12, 1024
    x = (rng.random((n, bits)) < 0.3).astype(np.uint8)
    sizes = x.sum(axis=1)
    packed = [pack_indicator(np.nonzero(r)[0].astype(np.int64), bits) for r in x]
    want = [(i, j) for i in range(n) for j in range(i + 1, n)]
    for res in (
        screen_triangle(list(x), sizes, 15, 0.0),
        screen_triangle_packed(packed, sizes, 15, 0.0, bits),
    ):
        got = sorted(map(tuple, res.pairs.tolist()))
        assert got == want


def test_widen_after_sketch_refused(tmp_path):
    """Bitmap widths are frozen once any sketch exists: widening later
    would screen old-width sketches with a new-width cutoff and
    silently drop pairs, so it must be an internal error instead."""
    import pytest

    from galah_tpu.engines.native import NativePreclusterer

    p = tmp_path / "g.fna"
    p.write_text(">g\n" + "ACGT" * 2000 + "\n")
    ctx = NativeContext(threads=1)
    ctx.sketch(str(p))
    with pytest.raises(RuntimeError, match="widening"):
        NativePreclusterer(threshold=85.0, min_aligned_threshold=0.05, ctx=ctx)


def test_screen_dtype_paths_identical(monkeypatch):
    """The three screen matmul dtypes (f32, bf16, int8) must
    produce bit-identical screen output: 0/1 indicator intersection
    counts are exact integers under f32 accumulation (< 2^24) and int32
    accumulation alike, so the dtype is purely a throughput knob
    (GALAH_TPU_SCREEN_DTYPE)."""
    from galah_tpu.ops.prefilter import screen_triangle_packed

    rng = np.random.default_rng(11)
    n, bits = 257, 2048  # odd n exercises block padding
    w = bits // 32
    base = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    for t in range(10):  # plant near-duplicate pairs
        base[2 * t + 1] = base[2 * t]
        base[2 * t + 1, 0] ^= np.uint32(0xFF)
    packed = list(base)
    sizes = np.array(
        [np.unpackbits(p.view(np.uint8)).sum() for p in packed], np.float32
    )
    outs = {}
    for dtn in ("f32", "bf16", "int8"):
        monkeypatch.setenv("GALAH_TPU_SCREEN_DTYPE", dtn)
        res = screen_triangle_packed(
            packed, sizes, k=15, min_containment=0.5, bits=bits
        )
        order = np.lexsort((res.pairs[:, 1], res.pairs[:, 0]))
        outs[dtn] = (res.pairs[order], res.ani_est[order])
    assert len(outs["f32"][0]) >= 10
    for dtn in ("bf16", "int8"):
        np.testing.assert_array_equal(outs[dtn][0], outs["f32"][0])
        np.testing.assert_array_equal(outs[dtn][1], outs["f32"][1])


def test_sharded_screen_dtype_paths_identical(monkeypatch):
    """Same dtype invariance for the mesh-sharded tile sweep and the
    row-sharded resident sweep."""
    from galah_tpu.parallel.distance import (
        sharded_screen_triangle_packed,
        sharded_screen_triangle_rowsharded,
    )
    from galah_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(7)
    n, bits = 130, 1024
    w = bits // 32
    base = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    for t in range(6):
        base[2 * t + 1] = base[2 * t]
        base[2 * t + 1, 0] ^= np.uint32(0xF)
    packed = list(base)
    sizes = np.array(
        [np.unpackbits(p.view(np.uint8)).sum() for p in packed], np.float32
    )
    mesh = make_mesh()
    for fn in (
        sharded_screen_triangle_packed,
        sharded_screen_triangle_rowsharded,
    ):
        outs = {}
        for dtn in ("f32", "int8"):
            monkeypatch.setenv("GALAH_TPU_SCREEN_DTYPE", dtn)
            res = fn(packed, sizes, 15, 0.5, bits, mesh=mesh)
            order = np.lexsort((res.pairs[:, 1], res.pairs[:, 0]))
            outs[dtn] = (res.pairs[order], res.ani_est[order])
        assert len(outs["f32"][0]) >= 6
        np.testing.assert_array_equal(outs["int8"][0], outs["f32"][0])
        np.testing.assert_array_equal(outs["int8"][1], outs["f32"][1])


@pytest.mark.parametrize("routed", [False, True])
def test_extract_above_cutoff_matches_argwhere(routed):
    """The two-level extraction must emit exactly np.argwhere's
    row-major hits for sparse masks; masks whose hits span more than
    ROW_SEL rows must signal via the negative-count sentinel, and
    direct=True must always be exact — sparse, dense, empty, and
    cap-overflow cases. Pinned for BOTH extraction backends: nonzero
    (CPU default) and the routed monotone compaction (accelerator
    default)."""
    import jax.numpy as jnp

    from galah_tpu.ops.prefilter import ROW_SEL, _extract_above_cutoff

    rng = np.random.default_rng(21)
    rows, cols, cap = 256, 256, 512
    cont = rng.random((rows, cols)).astype(np.float32)
    cases = {
        "sparse": rng.random((rows, cols)) < 0.002,
        "dense_rows": rng.random((rows, cols)) < 0.006,  # hits most rows
        "empty": np.zeros((rows, cols), bool),
        "one_row": np.zeros((rows, cols), bool),
        "cap_overflow": rng.random((rows, cols)) < 0.03,
    }
    cases["one_row"][7, ::3] = True
    assert (cases["dense_rows"].any(axis=1).sum()) > ROW_SEL
    assert cases["cap_overflow"].sum() > cap
    for name, mask in cases.items():
        want = np.argwhere(mask)
        n_hit_rows = mask.any(axis=1).sum()
        cnt, ii, jj, vals = _extract_above_cutoff(
            jnp.asarray(cont), jnp.asarray(mask), cap, routed=routed
        )
        cnt = int(cnt)
        if n_hit_rows > ROW_SEL:
            # row-overflow sentinel: caller re-extracts directly
            assert cnt == -(len(want) + 1), name
            cnt, ii, jj, vals = _extract_above_cutoff(
                jnp.asarray(cont), jnp.asarray(mask), cap, direct=True,
                routed=routed,
            )
            cnt = int(cnt)
        assert cnt == len(want), name
        take = min(cnt, cap)
        got = np.stack([np.asarray(ii)[:take], np.asarray(jj)[:take]], 1)
        np.testing.assert_array_equal(got, want[:take], err_msg=name)
        np.testing.assert_array_equal(
            np.asarray(vals)[:take], cont[want[:take, 0], want[:take, 1]],
            err_msg=name,
        )


def test_screen_row_overflow_tiles_exact(monkeypatch):
    """A corpus where EVERY tile row has hits (cutoff 0) exercises the
    row-overflow re-extraction in all drain paths: results must equal
    the dense oracle exactly."""
    from galah_tpu.ops.prefilter import pack_indicator
    from galah_tpu.ops.prefilter import ROW_SEL, screen_triangle_packed
    from galah_tpu.parallel.distance import sharded_screen_triangle_packed
    from galah_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(31)
    n, bits = ROW_SEL + 40, 1024  # > ROW_SEL genomes, all pairwise hits
    x = (rng.random((n, bits)) < 0.5).astype(np.uint8)
    sizes = x.sum(axis=1)
    packed = [
        pack_indicator(np.nonzero(r)[0].astype(np.int64), bits) for r in x
    ]
    want = [(i, j) for i in range(n) for j in range(i + 1, n)]
    res = screen_triangle_packed(packed, sizes, 15, 0.0, bits)
    assert sorted(map(tuple, res.pairs.tolist())) == want
    # streaming (low-memory) drain falls back to the dense pull
    res = screen_triangle_packed(
        packed, sizes, 15, 0.0, bits, cache_blocks=False
    )
    assert sorted(map(tuple, res.pairs.tolist())) == want
    res = sharded_screen_triangle_packed(
        packed, sizes, 15, 0.0, bits, mesh=make_mesh()
    )
    assert sorted(map(tuple, res.pairs.tolist())) == want


def test_rectangle_streaming_matches_resident():
    """The streaming rectangle screen (budget-exceeded / --low-memory
    fallback) must produce exactly the resident path's output."""
    from galah_tpu.ops.prefilter import screen_rectangle_packed

    rng = np.random.default_rng(51)
    nq, nr, bits = 150, 90, 1024
    w = bits // 32
    queries = [rng.integers(0, 2**32, w, dtype=np.uint32) for _ in range(nq)]
    refs = [rng.integers(0, 2**32, w, dtype=np.uint32) for _ in range(nr)]
    for t in range(6):  # plant cross-group near-duplicates
        refs[t] = queries[t].copy()
        refs[t][0] ^= np.uint32(0xF)
    qs = np.array(
        [np.unpackbits(p.view(np.uint8)).sum() for p in queries], np.float32
    )
    rs = np.array(
        [np.unpackbits(p.view(np.uint8)).sum() for p in refs], np.float32
    )
    outs = {}
    for cache in (True, False):
        res = screen_rectangle_packed(
            queries, qs, refs, rs, 15, 0.5, bits,
            block=64, cache_blocks=cache,
        )
        order = np.lexsort((res.pairs[:, 1], res.pairs[:, 0]))
        outs[cache] = (res.pairs[order], res.ani_est[order])
    assert len(outs[True][0]) >= 6
    np.testing.assert_array_equal(outs[False][0], outs[True][0])
    np.testing.assert_array_equal(outs[False][1], outs[True][1])
