"""Mid-sweep checkpoint/resume (VERDICT r4 #6).

A killed screen sweep resumed with the same --sweep-checkpoint must
reproduce byte-identical clusters.tsv while re-dispatching only the
tiles the crash lost; a checkpoint from a different corpus must be
ignored. SURVEY §5 names sketches and the sparse distance cache as
first-class persistable artifacts — this extends that to the O(n^2)
sweep itself.
"""

import os

import numpy as np
import pytest


@pytest.fixture()
def corpus(tmp_path):
    from galah_tpu.utils.synth import make_families

    d = tmp_path / "corpus"
    make_families(
        str(d), n_families=6, members_per_family=4,
        genome_length=30_000, within_ani=0.97, seed=9,
    )
    return sorted(str(p) for p in d.iterdir() if p.suffix == ".fna")


def _cluster(paths, out_tsv, ckpt=None, extra_env=None, monkeypatch=None):
    from galah_tpu.cli.main import main as cli_main

    monkeypatch.setenv("GALAH_TPU_SCREEN", "packed")
    monkeypatch.setenv("GALAH_TPU_SCREEN_BLOCK", "8")
    monkeypatch.setenv("GALAH_TPU_SCREEN_TILE_GROUP", "2")
    args = ["cluster", "-f", *paths, "--ani", "95",
            "--output-cluster-definition", out_tsv, "-q"]
    if ckpt:
        args += ["--sweep-checkpoint", ckpt]
    rc = cli_main(args)
    for v in ("GALAH_TPU_SCREEN", "GALAH_TPU_SCREEN_BLOCK",
              "GALAH_TPU_SCREEN_TILE_GROUP"):
        monkeypatch.delenv(v)
    return rc


def test_kill_at_half_then_resume_byte_identical(
    corpus, tmp_path, monkeypatch
):
    import galah_tpu.ops.prefilter as pf

    # Drain each dispatch immediately so mid-sweep results hit the log
    # before the crash (the default window of 16 defers drains, which
    # on this 6-tile toy sweep would defer them all to finish()).
    monkeypatch.setattr(pf, "TILE_WINDOW", 0)

    ref_tsv = str(tmp_path / "ref.tsv")
    assert _cluster(corpus, ref_tsv, monkeypatch=monkeypatch) == 0
    ref_bytes = open(ref_tsv, "rb").read()
    assert ref_bytes

    # Run with a checkpoint and CRASH after ~50% of the tiles: with 24
    # genomes at block=8 there are 3 row blocks -> 6 tiles; die after
    # the 3rd dispatch (single or grouped).
    ckpt = str(tmp_path / "sweep.ckpt")
    calls = {"n": 0}
    orig_single = pf._resident_screen_extract
    orig_group = pf._resident_screen_extract_group

    class Boom(RuntimeError):
        pass

    def crashing(orig):
        def fn(*a, **k):
            calls["n"] += 1
            if calls["n"] > 3:
                raise Boom("injected crash at ~50% of the sweep")
            return orig(*a, **k)
        return fn

    monkeypatch.setattr(pf, "_resident_screen_extract", crashing(orig_single))
    monkeypatch.setattr(
        pf, "_resident_screen_extract_group", crashing(orig_group)
    )
    killed_tsv = str(tmp_path / "killed.tsv")
    # The CLI's fail-fast handler turns the crash into a clean
    # nonzero exit (SURVEY §5); the checkpoint must survive it.
    rc = _cluster(corpus, killed_tsv, ckpt=ckpt, monkeypatch=monkeypatch)
    assert rc != 0
    monkeypatch.setattr(pf, "_resident_screen_extract", orig_single)
    monkeypatch.setattr(pf, "_resident_screen_extract_group", orig_group)
    assert os.path.exists(ckpt)
    logged_half = os.path.getsize(ckpt)
    assert logged_half > 0

    # Resume: tiles already logged replay from the checkpoint; the
    # dispatch counter only pays for the lost remainder.
    calls2 = {"n": 0}

    def counting(orig):
        def fn(*a, **k):
            calls2["n"] += 1
            return orig(*a, **k)
        return fn

    monkeypatch.setattr(pf, "_resident_screen_extract", counting(orig_single))
    monkeypatch.setattr(
        pf, "_resident_screen_extract_group", counting(orig_group)
    )
    resumed_tsv = str(tmp_path / "resumed.tsv")
    assert _cluster(
        corpus, resumed_tsv, ckpt=ckpt, monkeypatch=monkeypatch
    ) == 0
    assert open(resumed_tsv, "rb").read() == ref_bytes
    # The crash run drained and logged the tiles of its 3 completed
    # dispatches; the resume replays them and only re-dispatches the
    # lost remainder (1 tile on this 6-tile sweep) — far fewer than
    # the 4 dispatches of a fresh sweep.
    assert calls2["n"] <= 2


def test_completed_checkpoint_replays_with_zero_dispatches(
    corpus, tmp_path, monkeypatch
):
    import galah_tpu.ops.prefilter as pf

    ckpt = str(tmp_path / "sweep.ckpt")
    t1 = str(tmp_path / "a.tsv")
    assert _cluster(corpus, t1, ckpt=ckpt, monkeypatch=monkeypatch) == 0

    calls = {"n": 0}
    orig_single = pf._resident_screen_extract
    orig_group = pf._resident_screen_extract_group

    def counting(orig):
        def fn(*a, **k):
            calls["n"] += 1
            return orig(*a, **k)
        return fn

    monkeypatch.setattr(pf, "_resident_screen_extract", counting(orig_single))
    monkeypatch.setattr(
        pf, "_resident_screen_extract_group", counting(orig_group)
    )
    t2 = str(tmp_path / "b.tsv")
    assert _cluster(corpus, t2, ckpt=ckpt, monkeypatch=monkeypatch) == 0
    assert open(t2, "rb").read() == open(t1, "rb").read()
    assert calls["n"] == 0  # every tile replayed from the log


def test_mismatched_checkpoint_starts_fresh(corpus, tmp_path, monkeypatch):
    """A log written for a different corpus must not be replayed."""
    from galah_tpu.ops.sweep_checkpoint import (
        SweepCheckpoint,
        sweep_fingerprint,
    )

    ckpt = str(tmp_path / "sweep.ckpt")
    other = SweepCheckpoint(
        ckpt,
        sweep_fingerprint(["other1", "other2"], 4096, 8, 15, 0.3, "f32"),
    )
    other.put(0, 0, np.array([[0, 1]], np.int64),
              np.array([99.0], np.float32))
    other.close()

    ref_tsv = str(tmp_path / "ref.tsv")
    assert _cluster(corpus, ref_tsv, monkeypatch=monkeypatch) == 0
    got_tsv = str(tmp_path / "got.tsv")
    assert _cluster(
        corpus, got_tsv, ckpt=ckpt, monkeypatch=monkeypatch
    ) == 0
    assert open(got_tsv, "rb").read() == open(ref_tsv, "rb").read()


def test_checkpoint_with_overlap_pipeline(corpus, tmp_path, monkeypatch):
    """--sweep-checkpoint must compose with the overlapped pipeline
    (GALAH_TPU_PIPELINE=1): tiles logged by a pipelined run replay in
    a second pipelined run with zero screen dispatches, and the
    replayed pairs still flow through the mid-sweep verify feeder."""
    import galah_tpu.ops.prefilter as pf
    from galah_tpu.cli.main import main as cli_main

    def run(out, ckpt):
        monkeypatch.setenv("GALAH_TPU_PIPELINE", "1")
        monkeypatch.setenv("GALAH_TPU_DEVICE_SKETCH", "1")
        monkeypatch.setenv("GALAH_TPU_SCREEN", "packed")
        monkeypatch.setenv("GALAH_TPU_SCREEN_BLOCK", "8")
        rc = cli_main([
            "cluster", "-f", *corpus, "--ani", "95",
            "--sweep-checkpoint", ckpt,
            "--output-cluster-definition", out, "-q",
        ])
        for v in ("GALAH_TPU_PIPELINE", "GALAH_TPU_DEVICE_SKETCH",
                  "GALAH_TPU_SCREEN",
                  "GALAH_TPU_SCREEN_BLOCK"):
            monkeypatch.delenv(v)
        return rc

    ckpt = str(tmp_path / "pipe.ckpt")
    a = str(tmp_path / "a.tsv")
    assert run(a, ckpt) == 0

    calls = {"n": 0}
    for name in ("_resident_screen_extract", "_resident_screen_extract_group"):
        orig = getattr(pf, name)

        def counting(*args, _orig=orig, **kw):
            calls["n"] += 1
            return _orig(*args, **kw)

        monkeypatch.setattr(pf, name, counting)
    b = str(tmp_path / "b.tsv")
    assert run(b, ckpt) == 0
    assert calls["n"] == 0  # every tile replayed from the log
    assert open(b, "rb").read() == open(a, "rb").read()


def test_sharded_sweep_checkpoint_kill_and_replay(tmp_path, monkeypatch):
    """The mesh-sharded triangle sweep (the multi-device fleet path the
    checkpoint exists for) must also log drained tiles and resume: a
    crash mid-sweep loses only undrained chunks, and a completed log
    replays with ZERO tile dispatches."""
    import numpy as np

    import galah_tpu.parallel.distance as dist

    rng = np.random.default_rng(13)
    n, bits = 96, 4096
    ind = (rng.random((n, bits)) < 0.06).astype(np.uint8)
    ind[:30] = ind[0]
    sizes = ind.sum(axis=1)
    packed = [
        np.packbits(r.astype(bool), bitorder="little").view(np.uint32)
        for r in ind
    ]
    names = [f"g{i}" for i in range(n)]
    monkeypatch.setattr(dist, "TILES_PER_DEVICE", 1)
    # Collect each chunk as it lands so the crash run logs its
    # completed chunks (the default window of 8 would defer every
    # collect past the injected crash on this 3-chunk toy sweep).
    monkeypatch.setattr(dist, "DISPATCH_WINDOW", 0)

    def run(ckpt=None, crash_after=None, count=None):
        orig = dist._tile_screen_fn

        def wrapped(*a, **k):
            fn = orig(*a, **k)

            def counting(*fa, **fk):
                if count is not None:
                    count["n"] += 1
                if crash_after is not None and count["n"] > crash_after:
                    raise RuntimeError("injected sweep crash")
                return fn(*fa, **fk)

            return counting

        monkeypatch.setattr(dist, "_tile_screen_fn", wrapped)
        try:
            return dist.sharded_screen_triangle_packed(
                packed, sizes, 15, 0.3, bits, block=16,
                checkpoint_path=ckpt, unit_names=names,
            )
        finally:
            monkeypatch.setattr(dist, "_tile_screen_fn", orig)

    ref = run(count={"n": 0})
    order = np.lexsort((ref.pairs[:, 1], ref.pairs[:, 0]))

    ckpt = str(tmp_path / "sharded.ckpt")
    c1 = {"n": 0}
    with pytest.raises(RuntimeError, match="injected sweep crash"):
        run(ckpt=ckpt, crash_after=1, count=c1)
    assert os.path.getsize(ckpt) > 0

    c2 = {"n": 0}
    resumed = run(ckpt=ckpt, count=c2)
    r_order = np.lexsort((resumed.pairs[:, 1], resumed.pairs[:, 0]))
    np.testing.assert_array_equal(ref.pairs[order], resumed.pairs[r_order])
    np.testing.assert_array_equal(ref.ani_est[order], resumed.ani_est[r_order])
    # The crash run collected (and logged) its first chunk's tiles,
    # so the resume sweeps strictly fewer chunks than a fresh run.
    fresh = {"n": 0}
    run(count=fresh)
    assert c2["n"] < fresh["n"]

    # Completed log: zero dispatches on replay.
    c3 = {"n": 0}
    replayed = run(ckpt=ckpt, count=c3)
    assert c3["n"] == 0
    p_order = np.lexsort((replayed.pairs[:, 1], replayed.pairs[:, 0]))
    np.testing.assert_array_equal(ref.pairs[order], replayed.pairs[p_order])


def test_truncated_tail_record_ignored(tmp_path):
    from galah_tpu.ops.sweep_checkpoint import (
        SweepCheckpoint,
        sweep_fingerprint,
    )

    fp = sweep_fingerprint(["a", "b", "c"], 4096, 8, 15, 0.3, "f32")
    path = str(tmp_path / "log")
    ck = SweepCheckpoint(path, fp)
    ck.put(0, 0, np.array([[0, 1]], np.int64), np.array([97.5], np.float32))
    ck.put(0, 1, np.array([[0, 2]], np.int64), np.array([96.5], np.float32))
    ck.close()
    # Simulate a crash mid-write: chop the last 6 bytes.
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 6)
    ck2 = SweepCheckpoint(path, fp)
    assert ck2.has(0, 0) is not None
    assert ck2.has(0, 1) is None  # truncated record dropped
    # And it can be re-put after the reopen.
    ck2.put(0, 1, np.array([[0, 2]], np.int64), np.array([96.5], np.float32))
    assert ck2.has(0, 1) is not None
    ck2.close()
    # Crash-resume-CRASH-resume: the reopen must have TRUNCATED the
    # partial tail before appending, or this third load would parse
    # the partial record's intact header and swallow the re-put
    # record's bytes as its body (replaying garbage pairs).
    ck3 = SweepCheckpoint(path, fp)
    got00 = ck3.has(0, 0)
    got01 = ck3.has(0, 1)
    assert got00 is not None and got01 is not None
    np.testing.assert_array_equal(got00[0], [[0, 1]])
    np.testing.assert_array_equal(got01[0], [[0, 2]])
    np.testing.assert_array_equal(got01[1], np.float32([96.5]))
    ck3.close()
