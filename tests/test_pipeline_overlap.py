"""Sketch->screen pipeline overlap (IncrementalPackedScreen).

The reference's sketch->search handoff happens inside one process
(reference src/skani.rs:270-304); overlap moves the e2e wall from
sum(phases) toward max(phase). These tests pin (a) bit-identical
results regardless of feed order/batching vs the sequential sweep,
and (b) that screening genuinely starts before the last rows arrive.
"""

import numpy as np
import pytest


def _corpus(n=300, bits=4096, seed=7, dup_frac=0.25):
    rng = np.random.default_rng(seed)
    ind = (rng.random((n, bits)) < 0.06).astype(np.uint8)
    ndup = int(n * dup_frac)
    ind[:ndup] = ind[0]  # a clique so some pairs survive
    sizes = ind.sum(axis=1)
    packed = [
        np.packbits(r.astype(bool), bitorder="little").view(np.uint32)
        for r in ind
    ]
    return packed, sizes


def _sorted(res):
    order = np.lexsort((res.pairs[:, 1], res.pairs[:, 0]))
    return res.pairs[order], res.ani_est[order]


def test_incremental_feed_matches_sequential(monkeypatch):
    from galah_tpu.ops.prefilter import (
        IncrementalPackedScreen,
        screen_triangle_packed,
    )

    packed, sizes = _corpus()
    n, bits, k = len(packed), 4096, 15
    monkeypatch.setenv("GALAH_TPU_SCREEN_BLOCK", "128")
    monkeypatch.setenv("GALAH_TPU_SCREEN_TILE_GROUP", "3")
    seq = screen_triangle_packed(
        packed, sizes, k=k, min_containment=0.3, bits=bits
    )

    # Feed in uneven batches, out of order (buckets complete out of
    # genome order in the real device sketcher).
    scr = IncrementalPackedScreen(n, k, 0.3, bits, block=128)
    order = list(range(n))
    rng = np.random.default_rng(3)
    rng.shuffle(order)
    cuts = [0, 37, 61, 140, 141, 220, n]
    for lo, hi in zip(cuts, cuts[1:]):
        idxs = order[lo:hi]
        scr.add_host_rows(
            idxs, [packed[i] for i in idxs],
            [float(sizes[i]) for i in idxs],
        )
    inc = scr.finish()
    monkeypatch.delenv("GALAH_TPU_SCREEN_BLOCK")
    monkeypatch.delenv("GALAH_TPU_SCREEN_TILE_GROUP")

    sp, sa = _sorted(seq)
    ip, ia = _sorted(inc)
    np.testing.assert_array_equal(sp, ip)
    np.testing.assert_array_equal(sa, ia)
    assert len(sp) >= 75 * 74 // 2


def test_screen_dispatches_before_feed_completes(monkeypatch):
    """With 3+ row blocks complete early, tiles must dispatch while
    later rows are still being fed (rows_at_first_dispatch < n)."""
    from galah_tpu.ops.prefilter import IncrementalPackedScreen

    packed, sizes = _corpus(n=512)
    n, bits, k = len(packed), 4096, 15
    # group=1: the first ready tile dispatches immediately.
    monkeypatch.setenv("GALAH_TPU_SCREEN_TILE_GROUP", "1")
    scr = IncrementalPackedScreen(n, k, 0.3, bits, block=128)
    monkeypatch.delenv("GALAH_TPU_SCREEN_TILE_GROUP")
    # Feed front-to-back in block-sized batches (the device sketcher's
    # chunk shape): after the first block, tile (0,0) is ready.
    for lo in range(0, n, 128):
        idxs = list(range(lo, min(lo + 128, n)))
        scr.add_host_rows(
            idxs, [packed[i] for i in idxs],
            [float(sizes[i]) for i in idxs],
        )
    res = scr.finish()
    assert scr.rows_at_first_dispatch is not None
    assert scr.rows_at_first_dispatch < n
    assert scr.rows_at_first_dispatch <= 128
    assert len(res.pairs) >= 2


def test_device_rows_and_host_rows_mix(monkeypatch):
    """Device-adopted rows (via a (G, W) device source array) and
    host-uploaded rows must assemble the same matrix."""
    import jax.numpy as jnp

    from galah_tpu.ops.prefilter import (
        IncrementalPackedScreen,
        screen_triangle_packed,
    )

    packed, sizes = _corpus(n=200, seed=11)
    n, bits, k = len(packed), 4096, 15
    monkeypatch.setenv("GALAH_TPU_SCREEN_BLOCK", "64")
    seq = screen_triangle_packed(
        packed, sizes, k=k, min_containment=0.3, bits=bits
    )
    scr = IncrementalPackedScreen(n, k, 0.3, bits, block=64)
    monkeypatch.delenv("GALAH_TPU_SCREEN_BLOCK")
    # First 120 rows arrive as two device batches (rows scattered
    # inside each batch array), the rest as host rows.
    b1 = jnp.asarray(np.stack([packed[i] for i in range(0, 70)]))
    scr.add_device_rows(
        list(range(0, 70)), b1, list(range(70)),
        [float(sizes[i]) for i in range(0, 70)],
    )
    b2_idx = list(range(70, 120))
    b2 = jnp.asarray(np.stack([packed[i] for i in reversed(b2_idx)]))
    scr.add_device_rows(
        b2_idx, b2, list(range(len(b2_idx) - 1, -1, -1)),
        [float(sizes[i]) for i in b2_idx],
    )
    rest = list(range(120, n))
    scr.add_host_rows(
        rest, [packed[i] for i in rest], [float(sizes[i]) for i in rest]
    )
    inc = scr.finish()
    sp, sa = _sorted(seq)
    ip, ia = _sorted(inc)
    np.testing.assert_array_equal(sp, ip)
    np.testing.assert_array_equal(sa, ia)


def test_engine_pipelined_distances_matches_sequential(monkeypatch, tmp_path):
    """Full NativePreclusterer.distances() with the overlap pipeline
    forced (GALAH_TPU_PIPELINE=1) must produce the same sparse cache
    as the sequential path, and the screen must start dispatching
    before the whole corpus is sketched (two size buckets -> two
    device-sketch chunks; the first chunk completes whole row blocks)."""
    from galah_tpu.engines.native import NativeContext, NativePreclusterer
    from galah_tpu.utils import metrics
    from galah_tpu.utils.synth import make_families

    d1 = tmp_path / "small"
    d2 = tmp_path / "big"
    p_small, _ = make_families(
        str(d1), n_families=4, members_per_family=4,
        genome_length=24_000, within_ani=0.97, seed=5,
    )
    p_big, _ = make_families(
        str(d2), n_families=4, members_per_family=4,
        genome_length=60_000, within_ani=0.97, seed=6,
    )
    # Small bucket first: its chunk sketches first, completing the
    # leading row blocks while the big bucket still sketches.
    paths = sorted(p_small) + sorted(p_big)

    def run(pipeline: str):
        monkeypatch.setenv("GALAH_TPU_PIPELINE", pipeline)
        monkeypatch.setenv("GALAH_TPU_DEVICE_SKETCH", "1")
        monkeypatch.setenv("GALAH_TPU_SCREEN", "packed")
        monkeypatch.setenv("GALAH_TPU_SCREEN_BLOCK", "8")
        monkeypatch.setenv("GALAH_TPU_SCREEN_TILE_GROUP", "2")
        # Tiny flush threshold: forces several mid-sweep verify
        # flushes so the screen->verify overlap leg is exercised.
        monkeypatch.setenv("GALAH_TPU_VERIFY_FLUSH", "4")
        metrics.reset()
        ctx = NativeContext(max_genome_length=60_000)
        pre = NativePreclusterer(90.0, 0.15, ctx)
        cache = pre.distances(paths)
        for v in ("GALAH_TPU_PIPELINE", "GALAH_TPU_DEVICE_SKETCH",
                  "GALAH_TPU_SCREEN",
                  "GALAH_TPU_SCREEN_BLOCK", "GALAH_TPU_SCREEN_TILE_GROUP",
                  "GALAH_TPU_VERIFY_FLUSH"):
            monkeypatch.delenv(v)
        return dict(cache.items()), dict(metrics.current().counters)

    seq_cache, _ = run("0")
    pipe_cache, counters = run("1")
    assert pipe_cache == seq_cache
    assert len(pipe_cache) >= 4 * 6  # all within-family pairs survive
    # The screen dispatched its first tile before the corpus finished.
    assert "screen_rows_at_first_dispatch" in counters
    assert counters["screen_rows_at_first_dispatch"] < len(paths)


def test_engine_pipelined_contig_mode_matches_sequential(monkeypatch, tmp_path):
    """distances_contigs with the overlap pipeline forced must match
    the sequential contig path (per-contig units keyed by name)."""
    from galah_tpu.engines.native import NativeContext, NativePreclusterer
    from galah_tpu.io.fasta import read_fasta
    from galah_tpu.utils.synth import mutate, random_genome

    from galah_tpu.utils.synth import write_fasta_contigs

    rng = np.random.default_rng(17)
    base = random_genome(rng, 12_000)
    paths = []
    for f in range(3):
        p = tmp_path / f"g{f}.fna"
        # contigs of two length classes -> two device buckets
        contigs = [
            mutate(rng, base, 0.97) if c % 2 == 0
            else random_genome(rng, 30_000)
            for c in range(4)
        ]
        write_fasta_contigs(str(p), contigs, f"g{f}")
        paths.append(str(p))
    contig_names = [
        rec.contig_name for p in paths for rec in read_fasta(p)
    ]

    def run(pipeline: str):
        monkeypatch.setenv("GALAH_TPU_PIPELINE", pipeline)
        monkeypatch.setenv("GALAH_TPU_DEVICE_SKETCH", "1")
        monkeypatch.setenv("GALAH_TPU_SCREEN", "packed")
        monkeypatch.setenv("GALAH_TPU_SCREEN_BLOCK", "8")
        ctx = NativeContext(max_genome_length=30_000)
        pre = NativePreclusterer(90.0, 0.15, ctx)
        cache = pre.distances_contigs(paths, contig_names)
        for v in ("GALAH_TPU_PIPELINE", "GALAH_TPU_DEVICE_SKETCH",
                  "GALAH_TPU_SCREEN",
                  "GALAH_TPU_SCREEN_BLOCK"):
            monkeypatch.delenv(v)
        return dict(cache.items())

    seq_cache = run("0")
    pipe_cache = run("1")
    assert pipe_cache == seq_cache
    assert len(pipe_cache) >= 3  # the mutated-base contigs all relate


def test_pipelined_duplicate_paths_emit_every_index_pair(
    monkeypatch, tmp_path
):
    """The reference emits a duplicate input in every cluster it
    belongs to; the overlapped verify feeder must apply the same
    "emit every index pair per key pair" rule (the shared
    _emit_verified contract)."""
    from galah_tpu.engines.native import NativeContext, NativePreclusterer
    from galah_tpu.utils.synth import make_families

    paths, _ = make_families(
        str(tmp_path / "c"), n_families=2, members_per_family=3,
        genome_length=24_000, within_ani=0.97, seed=8,
    )
    dup = list(paths) + [paths[0]]  # same path at two indices

    def run(pipeline):
        monkeypatch.setenv("GALAH_TPU_PIPELINE", pipeline)
        monkeypatch.setenv("GALAH_TPU_DEVICE_SKETCH", "1")
        monkeypatch.setenv("GALAH_TPU_SCREEN", "packed")
        ctx = NativeContext(max_genome_length=24_000)
        pre = NativePreclusterer(90.0, 0.15, ctx)
        cache = pre.distances(dup)
        for v in ("GALAH_TPU_PIPELINE", "GALAH_TPU_DEVICE_SKETCH",
                  "GALAH_TPU_SCREEN"):
            monkeypatch.delenv(v)
        return dict(cache.items())

    seq = run("0")
    pipe = run("1")
    assert pipe == seq
    # The duplicate index (last) must relate to its family members.
    last = len(dup) - 1
    assert any(last in k for k in pipe)


def test_finish_raises_on_missing_rows():
    from galah_tpu.ops.prefilter import IncrementalPackedScreen

    packed, sizes = _corpus(n=64)
    scr = IncrementalPackedScreen(64, 15, 0.3, 4096, block=64)
    scr.add_host_rows([0, 1], [packed[0], packed[1]],
                      [float(sizes[0]), float(sizes[1])])
    with pytest.raises(RuntimeError, match="rows never fed"):
        scr.finish()
