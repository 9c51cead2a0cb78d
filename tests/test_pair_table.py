"""Pair-table verify kernel parity vs the grouped forward path."""

import os

import numpy as np
import pytest
from conftest import data

from galah_tpu.ops.fragment_ani import FragmentAniConfig, FragmentAniEngine
from galah_tpu.sketch.fracminhash import (
    NativeSketchParams,
    sketch_file_native,
    small_genome_params,
)


def _engine(params):
    return FragmentAniEngine(
        FragmentAniConfig(
            k=params.k,
            member_bits=params.member_bits,
            min_fragment_hashes=params.min_fragment_hashes,
        )
    )


@pytest.mark.parametrize("mode_pair", [("pairtable", "grouped")])
def test_pair_table_matches_grouped(monkeypatch, mode_pair):
    params = NativeSketchParams()
    paths = [
        data("abisko4/73.20120800_S1X.13.fna"),
        data("abisko4/73.20120600_S2D.19.fna"),
        data("abisko4/73.20120700_S3X.12.fna"),
        data("abisko4/73.20110800_S2D.13.fna"),
        data("set1/500kb.fna"),
        data("set1/1mbp.fna"),
    ]
    sketches = {p: sketch_file_native(p, params) for p in paths}
    pairs = [
        (paths[0], paths[1]),
        (paths[0], paths[2]),
        (paths[1], paths[3]),
        (paths[4], paths[5]),
        (paths[0], paths[4]),
    ]
    results = {}
    for mode in mode_pair:
        monkeypatch.setenv("GALAH_TPU_VERIFY", mode)
        eng = _engine(params)
        results[mode] = eng.bidirectional(pairs, sketches)
    for pr in pairs:
        a = results[mode_pair[0]][pr]
        b = results[mode_pair[1]][pr]
        assert a[0] == pytest.approx(b[0], abs=0.02), (pr, a, b)   # ANI pct
        assert a[1] == pytest.approx(b[1], abs=0.005), (pr, a, b)  # AF fwd
        assert a[2] == pytest.approx(b[2], abs=0.005), (pr, a, b)  # AF rev


def test_pair_table_contig_mode(monkeypatch):
    """Small-contig corpus through the pair-table path clusters exactly
    by family (the use case the kernel exists for)."""
    import tempfile

    from galah_tpu.cli.main import main
    from galah_tpu.utils.synth import make_contig_corpus

    monkeypatch.setenv("GALAH_TPU_VERIFY", "pairtable")
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "contigs.fna")
        names, fams = make_contig_corpus(
            path, n_families=20, members_per_family=4,
            contig_length=4000, within_ani=0.98, seed=9,
        )
        out = os.path.join(td, "clusters.tsv")
        rc = main([
            "cluster", "--cluster-contigs", "--small-contigs",
            "--genome-fasta-files", path,
            "--output-cluster-definition", out, "-q",
        ])
        assert rc == 0
        rep_of = {}
        with open(out) as f:
            for line in f:
                rep, member = line.rstrip("\n").split("\t")
                rep_of[member] = rep
        by_family = {}
        for n, fam in zip(names, fams):
            by_family.setdefault(fam, set()).add(rep_of[n])
        assert all(len(r) == 1 for r in by_family.values())
        assert len({next(iter(r)) for r in by_family.values()}) == 20


def test_pair_table_splits_batches(monkeypatch):
    """Tiny caps force multiple dispatches; results must still be
    complete and correct."""
    from galah_tpu.ops.pair_table import PairTableConfig, PairTableVerifier

    params = small_genome_params()
    import tempfile

    from galah_tpu.utils.synth import make_contig_corpus
    from galah_tpu.sketch.fracminhash import sketch_contigs_native

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "c.fna")
        names, fams = make_contig_corpus(
            path, n_families=6, members_per_family=3,
            contig_length=3000, within_ani=0.97, seed=2,
        )
        sketches = {
            s.name: s for s in sketch_contigs_native(path, params)
        }
        eng = _engine(params)
        verifier_small = PairTableVerifier(
            PairTableConfig(
                member_bits=params.member_bits,
                k=params.k,
                min_fragment_hashes=params.min_fragment_hashes,
                min_fragment_identity=0.8,
                max_flat_hashes=1 << 13,
                max_flat_frags=1 << 7,
                max_pairs=4,
                max_unique_hashes=1 << 13,
                max_unique_frags=1 << 7,
                max_bitmaps=4,
            ),
            eng.bitmap_stack,
        )
        # within-family directed pairs
        directed = []
        for fam in range(6):
            a, b, c = [n for n, f in zip(names, fams) if f == fam]
            directed += [(a, b), (b, a), (a, c), (c, a)]
        res = verifier_small.run(directed, sketches)
        assert len(res) == len(directed)
        for (s, t), (ani, af) in res.items():
            assert ani > 93.0, (s, t, ani)
            assert af > 0.5, (s, t, af)


def test_mixed_size_pair_routes_one_kernel(monkeypatch):
    """A (small, large) pair must compute BOTH directions with the
    same kernel (grouped), never pair-table one way and grouped the
    other: max(fwd, rev) would mix the pair-table's 2^-14 fixed-point
    identity sums with the grouped kernel's f32 sums for one pair.
    Pinned by exact equality of the default routing with the forced-
    grouped result for every pair touching the large genome."""
    params = NativeSketchParams()
    small_a = data("abisko4/73.20120800_S1X.13.fna")
    small_b = data("abisko4/73.20120600_S2D.19.fna")
    large = data("set1/1mbp.fna")
    sketches = {p: sketch_file_native(p, params) for p in (small_a, small_b, large)}
    pairs = [(small_a, large), (small_a, small_b), (small_b, large)]

    monkeypatch.setenv("GALAH_TPU_VERIFY", "grouped")
    eng = _engine(params)
    forced = eng.bidirectional(pairs, sketches)

    monkeypatch.delenv("GALAH_TPU_VERIFY")
    eng2 = _engine(params)
    # shrink the pair-table budget so the large genome exceeds it while
    # the small MAGs fit
    pt = eng2._pair_table()
    cut = (len(sketches[large].frag_buckets) - 1) * 8

    class _CfgProxy:
        def __init__(self, cfg, max_flat_hashes):
            self._cfg = cfg
            self.max_flat_hashes = max_flat_hashes
        def __getattr__(self, name):
            return getattr(self._cfg, name)
    pt.cfg = _CfgProxy(pt.cfg, cut)
    default = eng2.bidirectional(pairs, sketches)

    for pr in (pairs[0], pairs[2]):  # pairs touching the large genome
        assert default[pr] == forced[pr], (pr, default[pr], forced[pr])


def test_bt_gather_matches_word_gather(monkeypatch):
    """The bit-transposed grouped kernel must be BIT-identical to the
    word-gather kernel: identical membership bits feed identical f32
    math (the table is a pure re-layout of the same bitmaps)."""
    params = NativeSketchParams()
    paths = [
        data("abisko4/73.20120800_S1X.13.fna"),
        data("abisko4/73.20120600_S2D.19.fna"),
        data("abisko4/73.20120700_S3X.12.fna"),
        data("set1/500kb.fna"),
        data("set1/1mbp.fna"),
    ]
    sketches = {p: sketch_file_native(p, params) for p in paths}
    pairs = [
        (paths[0], paths[1]),
        (paths[0], paths[2]),
        (paths[3], paths[4]),
        (paths[0], paths[3]),
    ]
    monkeypatch.setenv("GALAH_TPU_VERIFY", "grouped")
    results = {}
    for gather in ("word", "bt"):
        monkeypatch.setenv("GALAH_TPU_VERIFY_GATHER", gather)
        eng = _engine(params)
        results[gather] = eng.bidirectional(pairs, sketches)
    assert results["bt"] == results["word"]


def test_bt_kernel_parity_direct():
    """Kernel-level parity incl. ref padding and the invalid stream
    tail: _forward_kernel_bt(table(bitmaps)) == _forward_kernel(bitmaps)
    bit for bit at every ref slot."""
    import jax.numpy as jnp

    from galah_tpu.ops.fragment_ani import (
        _bit_transpose_table,
        _forward_kernel,
        _forward_kernel_bt,
    )

    rng = np.random.default_rng(3)
    R, BITS = 32, 1 << 14
    W = BITS // 32
    NPAD, F = 1 << 12, 64
    n = NPAD - 137  # exercise the invalid tail
    bitmaps = jnp.asarray(
        rng.integers(0, 2**32, (R, W), dtype=np.uint32)
    )
    popcounts = jnp.asarray(
        rng.uniform(0.1, 0.4, R).astype(np.float32) * BITS
    )
    buckets = jnp.asarray(rng.integers(0, BITS, NPAD, dtype=np.int32))
    offsets = np.minimum(
        np.arange(F + 1, dtype=np.int32) * (n // F + 1), n
    )
    offsets = jnp.asarray(offsets)
    kw = dict(bits=BITS, k=15, min_hashes=4, min_ident=0.8)
    ani_w, af_w = _forward_kernel(
        bitmaps, popcounts, buckets, offsets, jnp.int32(n), **kw
    )
    table = _bit_transpose_table(bitmaps)
    ani_b, af_b = _forward_kernel_bt(
        table, popcounts, buckets, offsets, jnp.int32(n), **kw
    )
    np.testing.assert_array_equal(np.asarray(ani_w), np.asarray(ani_b))
    np.testing.assert_array_equal(np.asarray(af_w), np.asarray(af_b))


def test_per_fragment_hits_matches_numpy_cumsum():
    """The block-segmented prefix tail must equal the straightforward
    cumsum + boundary-difference oracle for arbitrary offsets,
    including offsets at 0, mid-block, block edges, and npad."""
    import jax.numpy as jnp

    from galah_tpu.ops.fragment_ani import _per_fragment_hits

    rng = np.random.default_rng(9)
    R, NPAD = 5, 4096
    bits_hit = rng.integers(0, 2, (R, NPAD), dtype=np.int32)
    offsets = np.unique(
        np.concatenate(
            [
                [0, NPAD, 512, 1024, 511, 513],
                rng.integers(0, NPAD + 1, 40),
            ]
        )
    ).astype(np.int32)
    h = np.concatenate(
        [np.zeros((R, 1), np.int64), np.cumsum(bits_hit, axis=1)], axis=1
    )
    want = (h[:, offsets[1:]] - h[:, offsets[:-1]]).astype(np.int32)
    got = np.asarray(
        _per_fragment_hits(jnp.asarray(bits_hit), jnp.asarray(offsets))
    )
    np.testing.assert_array_equal(got, want)


def test_bt_kernel_parity_multigroup():
    """Multi-group table coverage (R=96 -> 3 output words per row): the
    transpose group ordering and the g32*32 expansion must agree at
    every ref slot."""
    import jax.numpy as jnp

    from galah_tpu.ops.fragment_ani import (
        _bit_transpose_table,
        _forward_kernel,
        _forward_kernel_bt,
    )

    rng = np.random.default_rng(13)
    R, BITS = 96, 1 << 13
    W = BITS // 32
    NPAD, F = 1 << 11, 32
    n = NPAD - 73
    bitmaps = jnp.asarray(rng.integers(0, 2**32, (R, W), dtype=np.uint32))
    popcounts = jnp.asarray(
        rng.uniform(0.1, 0.4, R).astype(np.float32) * BITS
    )
    buckets = jnp.asarray(rng.integers(0, BITS, NPAD, dtype=np.int32))
    offsets = jnp.asarray(
        np.minimum(np.arange(F + 1, dtype=np.int32) * (n // F + 1), n)
    )
    kw = dict(bits=BITS, k=15, min_hashes=4, min_ident=0.8)
    ani_w, af_w = _forward_kernel(
        bitmaps, popcounts, buckets, offsets, jnp.int32(n), **kw
    )
    ani_b, af_b = _forward_kernel_bt(
        _bit_transpose_table(bitmaps), popcounts, buckets, offsets,
        jnp.int32(n), **kw
    )
    np.testing.assert_array_equal(np.asarray(ani_w), np.asarray(ani_b))
    np.testing.assert_array_equal(np.asarray(af_w), np.asarray(af_b))


def test_shape_bucket():
    from galah_tpu.ops.pair_table import _shape_bucket

    assert _shape_bucket(0, 1 << 15, 1 << 21) == 1 << 15
    assert _shape_bucket(1 << 15, 1 << 15, 1 << 21) == 1 << 15
    assert _shape_bucket((1 << 15) + 1, 1 << 15, 1 << 21) == 1 << 17
    assert _shape_bucket(1 << 20, 1 << 15, 1 << 21) == 1 << 21
    assert _shape_bucket(1 << 21, 1 << 15, 1 << 21) == 1 << 21
    # caps below the floor still return the cap (tiny-cap test configs)
    assert _shape_bucket(100, 1 << 15, 1 << 13) == 1 << 13


def test_domain_shapes_share_one_level():
    """The hash and fragment domains bucket on ONE shared pow4 level
    (independent bucketing multiplied the compiled-shape space). The shape
    pair is always >= the fill and the number of distinct pairs over
    any fill mix is bounded by the level count (5), not the product."""
    from galah_tpu.ops.pair_table import (
        PairTableConfig,
        flat_domain_shapes,
        unique_domain_shapes,
    )

    cfg = PairTableConfig(
        member_bits=1 << 16, k=15, min_fragment_hashes=8,
        min_fragment_identity=0.8,
    )
    seen = set()
    fills = [0, 1, 100, 1 << 10, 1 << 13, 1 << 15, 1 << 17,
             (1 << 19) + 3, 1 << 21, 1 << 23]
    ffills = [0, 7, 1 << 10, 1 << 12, (1 << 14) + 1, 1 << 16]
    for fh in fills:
        for ff in ffills:
            flatn, flatf = flat_domain_shapes(fh, ff, cfg)
            assert flatn >= min(fh, cfg.max_flat_hashes)
            assert flatf >= min(ff, cfg.max_flat_frags)
            assert flatn <= cfg.max_flat_hashes
            assert flatf <= cfg.max_flat_frags
            seen.add((flatn, flatf))
    assert len(seen) <= 5, seen  # one shared level -> <=5 shape pairs

    # same for the unique buffers, and the formulas agree at the floor
    un = set()
    for uh in fills:
        for uf in ffills:
            if uh > cfg.max_unique_hashes or uf > cfg.max_unique_frags:
                continue
            un.add(unique_domain_shapes(uh, uf, cfg))
    assert len(un) <= 5, un


def test_ustream_bucket_boundary(monkeypatch):
    """Fills just above a pow4 shape bucket edge must produce the same
    results as one far below it (the kernel masks everything past the
    true fill, so the buffer length is semantically invisible)."""
    from galah_tpu.ops.pair_table import (
        PairTableConfig,
        PairTableVerifier,
        _shape_bucket,
    )

    params = small_genome_params()
    import tempfile

    from galah_tpu.sketch.fracminhash import sketch_contigs_native
    from galah_tpu.utils.synth import make_contig_corpus

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "c.fna")
        names, fams = make_contig_corpus(
            path, n_families=4, members_per_family=2,
            contig_length=3000, within_ani=0.97, seed=5,
        )
        sketches = {s.name: s for s in sketch_contigs_native(path, params)}
        directed = []
        for fam in range(4):
            a, b = [n for n, f in zip(names, fams) if f == fam]
            directed += [(a, b), (b, a)]
        eng = _engine(params)

        def run_with(floor_shift):
            # Shrink the bucket floors so the same fill crosses an edge.
            import galah_tpu.ops.pair_table as pt

            def shapes_with_floor(fh, ff, cfg, caph, capf):
                lvl = max(
                    pt._bucket_level(fh, 1 << floor_shift),
                    pt._bucket_level(ff, 1 << max(floor_shift - 5, 1)),
                )
                return (
                    min((1 << floor_shift) << (2 * lvl), caph),
                    min((1 << max(floor_shift - 5, 1)) << (2 * lvl), capf),
                )

            orig_flat = pt.flat_domain_shapes
            orig_uniq = pt.unique_domain_shapes
            monkeypatch.setattr(
                pt, "flat_domain_shapes",
                lambda fh, ff, cfg: shapes_with_floor(
                    fh, ff, cfg, cfg.max_flat_hashes, cfg.max_flat_frags
                ),
            )
            monkeypatch.setattr(
                pt, "unique_domain_shapes",
                lambda uh, uf, cfg: shapes_with_floor(
                    uh, uf, cfg, cfg.max_unique_hashes, cfg.max_unique_frags
                ),
            )
            verifier = PairTableVerifier(
                PairTableConfig(
                    member_bits=params.member_bits,
                    k=params.k,
                    min_fragment_hashes=params.min_fragment_hashes,
                    min_fragment_identity=0.8,
                ),
                eng.bitmap_stack,
            )
            out = verifier.run(directed, sketches)
            monkeypatch.setattr(pt, "flat_domain_shapes", orig_flat)
            monkeypatch.setattr(pt, "unique_domain_shapes", orig_uniq)
            return out

        tight = run_with(6)    # buffers hug the fill
        loose = run_with(15)   # production floor
        for pr in directed:
            assert tight[pr] == loose[pr], (pr, tight[pr], loose[pr])


def test_bitmap_bucket_upload_parity(monkeypatch):
    """Bucket-list + device scatter upload is bit-identical to the
    host-packed dense bitmap, at the kernel and engine level."""
    import jax.numpy as jnp

    from galah_tpu.ops.fragment_ani import _bitmap_from_buckets

    params = NativeSketchParams()
    p1, p2 = data("set1/1mbp.fna"), data("set1/500kb.fna")
    sk1 = sketch_file_native(p1, params)
    sk2 = sketch_file_native(p2, params)

    # kernel-level: scatter == numpy packing, padding dropped
    words = params.member_bits // 32
    mb = sk1.member_buckets
    mpad = 1 << (max(len(mb), 1) - 1).bit_length()
    padded = np.full(max(mpad, len(mb)), params.member_bits, dtype=np.int32)
    padded[: len(mb)] = mb
    got = np.asarray(_bitmap_from_buckets(jnp.asarray(padded), words))
    assert np.array_equal(got, sk1.member_bitmap_words())

    # engine-level: forced bucket uploads give identical results
    sketches = {p1: sk1, p2: sk2}
    pairs = [(p1, p2)]
    res = {}
    for mode in ("dense", "buckets"):
        monkeypatch.setenv("GALAH_TPU_BITMAP_UPLOAD", mode)
        for verify in ("grouped", "pairtable"):
            monkeypatch.setenv("GALAH_TPU_VERIFY", verify)
            res[(mode, verify)] = _engine(params).bidirectional(
                pairs, sketches
            )
    for verify in ("grouped", "pairtable"):
        assert res[("dense", verify)] == res[("buckets", verify)]


def test_stream_pack24_roundtrip():
    """_pack24/_unpack24 are exact inverses over the full 24-bit range."""
    import jax.numpy as jnp

    from galah_tpu.ops.pair_table import _pack24, _unpack24

    rng = np.random.default_rng(3)
    vals = rng.integers(0, 1 << 24, size=4096, dtype=np.int64).astype(np.int32)
    vals[:4] = [0, 1, (1 << 24) - 1, (1 << 22)]
    got = np.asarray(_unpack24(jnp.asarray(_pack24(vals))))
    assert np.array_equal(got, vals)
    # 2D shape (pool bucket fills)
    vals2 = vals.reshape(64, 64)
    got2 = np.asarray(_unpack24(jnp.asarray(_pack24(vals2))))
    assert np.array_equal(got2, vals2)


def test_stream_pack24_engine_parity(monkeypatch):
    """Packed 24-bit transport is bit-identical to the int32 path for
    both verify kernels (the default 2^22 member space routes through
    it; GALAH_TPU_STREAM_PACK=0 restores int32 uploads)."""
    params = NativeSketchParams()
    assert (1 << 16) < params.member_bits < (1 << 24)
    paths = [
        data("abisko4/73.20120800_S1X.13.fna"),
        data("abisko4/73.20120600_S2D.19.fna"),
        data("set1/500kb.fna"),
    ]
    sketches = {p: sketch_file_native(p, params) for p in paths}
    pairs = [(paths[0], paths[1]), (paths[0], paths[2])]
    res = {}
    for pack in ("0", "1"):
        monkeypatch.setenv("GALAH_TPU_STREAM_PACK", pack)
        for verify in ("grouped", "pairtable"):
            monkeypatch.setenv("GALAH_TPU_VERIFY", verify)
            res[(pack, verify)] = _engine(params).bidirectional(
                pairs, sketches
            )
    for verify in ("grouped", "pairtable"):
        assert res[("0", verify)] == res[("1", verify)]


def _contig_fixture(tmp_path_factory=None):
    import tempfile

    from galah_tpu.sketch.fracminhash import sketch_contigs_native
    from galah_tpu.utils.synth import make_contig_corpus

    params = small_genome_params()
    td = tempfile.mkdtemp(prefix="galah-arena-test-")
    path = os.path.join(td, "c.fna")
    names, fams = make_contig_corpus(
        path, n_families=6, members_per_family=3,
        contig_length=3000, within_ani=0.97, seed=9,
    )
    sketches = {s.name: s for s in sketch_contigs_native(path, params)}
    directed = []
    for fam in range(6):
        mem = [n for n, f in zip(names, fams) if f == fam]
        for a in mem:
            for b in mem:
                if a != b:
                    directed.append((a, b))
    return params, sketches, directed


def test_arena_matches_upload_path(monkeypatch):
    """Pair-table results through the persistent stream arena must be
    bit-identical to the per-dispatch upload path (the kernel is
    unchanged; only the ustream residency differs)."""
    params, sketches, directed = _contig_fixture()

    def run(arena: str):
        monkeypatch.setenv("GALAH_TPU_ARENA", arena)
        eng = _engine(params)
        return eng._pair_table().run(directed, sketches)

    with_arena = run("1")
    without = run("0")
    assert with_arena == without
    assert len(with_arena) == len(directed)


def test_arena_reset_on_overflow(monkeypatch):
    """A tiny arena forces whole-arena resets mid-run; results must
    stay identical (each dispatch re-ensures its own sources after a
    reset, and in-flight dispatches hold the pre-reset buffers)."""
    monkeypatch.setenv("GALAH_TPU_ARENA", "1")
    params, sketches, directed = _contig_fixture()
    # Size the arena to hold only ~2 streams: every dispatch resets.
    max_nh = max(len(s.frag_buckets) for s in sketches.values())
    max_nf = max(s.n_fragments for s in sketches.values())
    monkeypatch.setenv("GALAH_TPU_ARENA_HASHES", str(2 * max_nh + 8))
    monkeypatch.setenv("GALAH_TPU_ARENA_FRAGS", str(2 * (max_nf + 1) + 8))
    tiny = _engine(params)._pair_table().run(directed, sketches)
    monkeypatch.delenv("GALAH_TPU_ARENA_HASHES")
    monkeypatch.delenv("GALAH_TPU_ARENA_FRAGS")
    full = _engine(params)._pair_table().run(directed, sketches)
    assert tiny == full


def test_arena_uploads_each_stream_once(monkeypatch):
    """Across repeated verifier runs (the greedy clusterer's access
    pattern), a resident stream must not re-upload: the second run
    performs no arena fills at all."""
    monkeypatch.setenv("GALAH_TPU_ARENA", "1")
    params, sketches, directed = _contig_fixture()
    eng = _engine(params)
    verifier = eng._pair_table()
    first = verifier.run(directed, sketches)

    import galah_tpu.ops.fragment_ani as fa

    calls = []
    orig = fa._arena_fill

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(fa, "_arena_fill", counting)
    second = verifier.run(directed, sketches)
    assert not calls, "resident streams re-uploaded"
    assert first == second


def test_pool_direct_matches_stack_path(monkeypatch):
    """Pool-direct bitmap addressing (per-pair pool rows, no stack
    gather) must be bit-identical to the per-dispatch stack path —
    the kernel reads the same bitmap words either way."""
    params, sketches, directed = _contig_fixture()

    def run(flag: str):
        monkeypatch.setenv("GALAH_TPU_POOL_DIRECT", flag)
        eng = _engine(params)
        return eng._pair_table().run(directed, sketches)

    direct = run("1")
    stacked = run("0")
    assert direct == stacked
    assert len(direct) == len(directed)


def test_grouped_verify_dispatch_matches_single(monkeypatch):
    """GALAH_TPU_VERIFY_GROUP>1 maps K prepared dispatches into one
    program; results must be bit-identical to single dispatches (the
    mapped body IS the single-dispatch kernel)."""
    params, sketches, directed = _contig_fixture()

    def run(group: str):
        monkeypatch.setenv("GALAH_TPU_VERIFY_GROUP", group)
        eng = _engine(params)
        # Tiny caps force many small batches so grouping engages.
        pt = eng._pair_table()
        import dataclasses
        pt.cfg = dataclasses.replace(pt.cfg, max_pairs=8)
        return pt.run(directed, sketches)

    single = run("1")
    grouped = run("3")
    assert single == grouped
    assert len(single) == len(directed)


def test_grouped_verify_survives_arena_resets(monkeypatch):
    """A tiny arena forces resets between prepared dispatches; the
    would_reset flush must keep every prepared span valid (results
    identical to the ungrouped run)."""
    monkeypatch.setenv("GALAH_TPU_VERIFY_GROUP", "4")
    params, sketches, directed = _contig_fixture()
    max_nh = max(len(s.frag_buckets) for s in sketches.values())
    max_nf = max(s.n_fragments for s in sketches.values())
    monkeypatch.setenv("GALAH_TPU_ARENA_HASHES", str(2 * max_nh + 8))
    monkeypatch.setenv("GALAH_TPU_ARENA_FRAGS", str(2 * (max_nf + 1) + 8))
    import dataclasses
    eng = _engine(params)
    pt = eng._pair_table()
    pt.cfg = dataclasses.replace(pt.cfg, max_pairs=4)
    tiny = pt.run(directed, sketches)
    monkeypatch.delenv("GALAH_TPU_ARENA_HASHES")
    monkeypatch.delenv("GALAH_TPU_ARENA_FRAGS")
    monkeypatch.setenv("GALAH_TPU_VERIFY_GROUP", "1")
    full = _engine(params)._pair_table().run(directed, sketches)
    assert tiny == full
