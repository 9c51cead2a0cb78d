"""Smoke test of galah_tpu on one NVIDIA GPU (or four, with --four-cards).

One process runs every phase; any failure exits nonzero. The phases:

- genome: ``galah-tpu cluster`` (through ``galah_tpu.cli.main.main``) on
  512 synthetic 3 Mb MAGs in 64 families at 98% within-family ANI,
  ``--ani 95``; the 64 families must come back exactly;
- contig: ``--cluster-contigs --small-contigs`` on 20,000 5 kb contigs
  in 4,000 families; exact recovery again;
- kernels: each device kernel of that path at its real width, once,
  against the repo's plain reference — screen counts vs a numpy
  popcount oracle, the device sketch vs the host C++ sketcher, both
  verify kernels vs ops/fragment_ani.py:forward_reference;
- gpu_tests: the card-only tests (tests/test_gpu.py, marker `gpu`).

With --four-cards it runs only the multi-device path instead: the
genome corpus through the mesh-sharded sweep with verify over 4 cards,
forced to one card, and row-sharded; the three clusters.tsv must be
byte-identical.

Earlier lines report the device, the card's name and power limit
(nvidia-smi), set-up time (native build, corpus generation, compiles)
and each phase's numbers. The last line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
With no GPU, or outside a checkout of the repository, it exits nonzero
before doing any work.

    python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

GENOMES, GENOME_FAMILIES, GENOME_LENGTH = 512, 64, 3_000_000
CONTIGS, CONTIG_FAMILIES, CONTIG_LENGTH = 20_000, 4_000, 5_000
WITHIN_ANI, SEED = 0.98, 11
# The production screen tile: 8192 rows at 2^18 prefilter bits.
SCREEN_BLOCK, SCREEN_BITS = 8192, 1 << 18


def log(msg: str) -> None:
    print(msg, flush=True)


def family_recovery_errors(tsv_text: str, family_of: dict) -> list:
    """Problems with a clusters.tsv (rep<TAB>member lines) against the
    planted families (member -> family id); [] when every family is
    exactly one cluster and every cluster exactly one family."""
    rep_of = {}
    for line in tsv_text.splitlines():
        if line:
            rep, member = line.split("\t")
            rep_of[member] = rep
    errors = []
    missing = sorted(set(family_of) - set(rep_of))
    if missing:
        errors.append(f"{len(missing)} members missing, e.g. {missing[0]}")
    extra = sorted(set(rep_of) - set(family_of))
    if extra:
        errors.append(f"{len(extra)} unknown members, e.g. {extra[0]}")
    reps_by_family, families_by_rep = {}, {}
    for member, fam in family_of.items():
        if member in rep_of:
            reps_by_family.setdefault(fam, set()).add(rep_of[member])
            families_by_rep.setdefault(rep_of[member], set()).add(fam)
    split = [f for f, r in reps_by_family.items() if len(r) > 1]
    if split:
        errors.append(f"{len(split)} families split, e.g. {split[0]}")
    merged = [r for r, f in families_by_rep.items() if len(f) > 1]
    if merged:
        errors.append(f"{len(merged)} clusters merge families, e.g. {merged[0]}")
    return errors


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


class CompileClock:
    """Sums JAX's backend-compile events (persistent-cache hits do not
    compile, so they do not count)."""

    def __init__(self, jax) -> None:
        self.seconds = 0.0
        self.count = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **kw) -> None:
        if event == "/jax/core/compile/backend_compile_duration":
            self.seconds += duration
            self.count += 1

    def mark(self):
        return self.seconds, self.count


def _memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis: none"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return "memory_analysis: " + json.dumps(
        {f: int(getattr(m, f)) for f in fields if hasattr(m, f)}
    )


def _check_nothing_left(jax, name: str) -> None:
    """No device array may outlive a finished run (a registry or cache
    that pins buffers would show here, on whichever card it sits)."""
    import gc

    gc.collect()
    left = {}
    for a in jax.live_arrays():
        key = ",".join(str(d.id) for d in a.devices())
        left[key] = left.get(key, 0) + int(a.nbytes)
    _check(not left, f"{name}: device arrays left after the run, bytes "
                     f"by device: {left}")
    log(f"[{name}] device arrays left after the run: none")


def _peak_bytes(jax) -> dict:
    return {
        str(d.id): int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
        for d in jax.local_devices()
    }


# --- end-to-end legs ------------------------------------------------------


def run_cli_leg(jax, clock, name: str, argv: list, family_of: dict,
                out_dir: str, env: dict = None) -> bytes:
    from galah_tpu.cli.main import main as cli_main

    tsv = os.path.join(out_dir, f"{name}.tsv")
    mj = os.path.join(out_dir, f"{name}.metrics.json")
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    c0, n0 = clock.mark()
    t0 = time.perf_counter()
    try:
        rc = cli_main([
            *argv, "--output-cluster-definition", tsv,
            "--metrics-json", mj, "-q",
        ])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.perf_counter() - t0
    c1, n1 = clock.mark()
    _check(rc == 0, f"{name}: cluster exited {rc}")
    with open(tsv, "rb") as f:
        data = f.read()
    errors = family_recovery_errors(data.decode(), family_of)
    _check(not errors, f"{name}: family recovery failed: {errors}")
    with open(mj) as f:
        metrics = json.load(f)
    counters = metrics.get("counters", {})
    fallback = counters.get("sketch_host_fallback_units", 0)
    _check(fallback == 0, f"{name}: {fallback} units sketched on the host")
    n_fam = len(set(family_of.values()))
    log(f"[{name}] families recovered exactly: {n_fam}/{n_fam}; "
        f"host-sketched units: {int(fallback)}")
    log(f"[{name}] wall_s={wall:.3f} compile_s={c1 - c0:.3f} "
        f"compiles={n1 - n0} env={json.dumps(env or {})}")
    log(f"[{name}] phases_s={json.dumps(metrics.get('phases_s', {}))}")
    log(f"[{name}] counters={json.dumps(counters, sort_keys=True)}")
    log(f"[{name}] peak_bytes_in_use={json.dumps(_peak_bytes(jax))}")
    _check_nothing_left(jax, name)
    return data


def make_genome_corpus(root: str):
    from galah_tpu.utils.synth import make_families

    t0 = time.perf_counter()
    paths, fams = make_families(
        os.path.join(root, "genomes"), n_families=GENOME_FAMILIES,
        members_per_family=GENOMES // GENOME_FAMILIES,
        genome_length=GENOME_LENGTH, within_ani=WITHIN_ANI, seed=SEED,
    )
    log(f"[setup] genome corpus: {len(paths)} x {GENOME_LENGTH} bp in "
        f"{time.perf_counter() - t0:.1f}s")
    return os.path.join(root, "genomes"), dict(zip(paths, fams))


def make_contig_corpus(root: str):
    from galah_tpu.utils.synth import make_contig_corpus as mk

    t0 = time.perf_counter()
    path = os.path.join(root, "contigs.fna")
    names, fams = mk(
        path, n_families=CONTIG_FAMILIES,
        members_per_family=CONTIGS // CONTIG_FAMILIES,
        contig_length=CONTIG_LENGTH, within_ani=WITHIN_ANI, seed=SEED,
    )
    log(f"[setup] contig corpus: {len(names)} x {CONTIG_LENGTH} bp in "
        f"{time.perf_counter() - t0:.1f}s")
    return path, dict(zip(names, fams))


def genome_argv(corpus_dir: str) -> list:
    return ["cluster", "-d", corpus_dir, "-x", "fna", "--ani", "95"]


# --- kernels at real widths -------------------------------------------------


def _popcount_and(a, b):
    """(len(a), len(b)) popcount(a[i] & b[j]) over uint32 rows (numpy)."""
    import numpy as np

    out = np.empty((a.shape[0], b.shape[0]), np.int64)
    for i in range(a.shape[0]):
        out[i] = np.bitwise_count(a[i][None, :] & b).sum(axis=1)
    return out


def check_screen(jax, jnp) -> None:
    import numpy as np

    from galah_tpu.ops.prefilter import (
        _containment, _resident_screen_extract, _screen_cap_for,
        _screen_counts_packed, _screen_dtype_name,
    )

    block, bits = SCREEN_BLOCK, SCREEN_BITS
    words = bits // 32
    dtn = _screen_dtype_name()
    # Two row blocks at ~6% load (the prefilter's design point); every
    # 64th row of block 1 copies a row of block 0 (planted hits).
    key = jax.random.PRNGKey(SEED)
    x = jax.random.bernoulli(key, 0.06, (2 * block, words, 32))
    x = jnp.sum(x.astype(jnp.uint32) << jnp.arange(32, dtype=jnp.uint32),
                axis=2, dtype=jnp.uint32)
    x = x.at[block::64].set(x[:block:64])
    sizes = jnp.sum(jax.lax.population_count(x), axis=1).astype(jnp.float32)

    counts_fn = jax.jit(lambda a, b: _screen_counts_packed(a, b, dtn))
    t0 = time.perf_counter()
    compiled = counts_fn.lower(x[:block], x[block:]).compile()
    c_s = time.perf_counter() - t0
    counts = compiled(x[:block], x[block:])
    jax.block_until_ready(counts)
    t0 = time.perf_counter()
    jax.block_until_ready(compiled(x[:block], x[block:]))
    dt = time.perf_counter() - t0
    log(f"[kernels] screen counts {dtn} {block}x{block}x{bits}: "
        f"compile_s={c_s:.3f} tile_s={dt:.6f}")
    log(f"[kernels] screen counts {_memory_line(compiled)}")
    xh = np.asarray(x)
    want = _popcount_and(xh[:512], xh[block:block + 512])
    got = np.asarray(counts)[:512, :512]
    _check(np.array_equal(got.astype(np.int64), want),
           "screen counts differ from the numpy popcount oracle")
    log("[kernels] screen counts == numpy popcount oracle on the "
        "512x512 sub-block (exact)")

    cap = _screen_cap_for(block)
    kw = dict(block=block, cap=cap, is_diag=False, dtname=dtn)
    args = (x, sizes, jnp.int32(0), jnp.int32(1), jnp.float32(bits),
            jnp.float32(0.5))
    tile = _resident_screen_extract.lower(*args, **kw).compile()
    log(f"[kernels] production tile {_memory_line(tile)}")
    cnt, ii, jj, vals = (np.asarray(v) for v in tile(*args))
    cont = np.asarray(_containment(counts, sizes[:block], sizes[block:],
                                   float(bits)))
    want_pairs = np.argwhere(cont >= np.float32(0.5))
    _check(0 <= int(cnt) <= cap and int(cnt) == len(want_pairs),
           f"tile extraction count {int(cnt)} vs dense {len(want_pairs)}")
    got_pairs = np.stack([ii[:int(cnt)], jj[:int(cnt)]], axis=1)
    _check(np.array_equal(got_pairs, want_pairs),
           "tile extraction differs from the dense threshold")
    log(f"[kernels] production tile extraction == dense threshold "
        f"({int(cnt)} hits)")


def check_device_sketch(jax, root: str) -> None:
    import numpy as np

    from galah_tpu.io.fasta import read_fasta_sequences
    from galah_tpu.ops.device_sketch import (
        _default_routed, device_sketch_batch,
    )
    from galah_tpu.sketch.fracminhash import (
        NativeSketchParams, sketch_contigs_native, sketch_file_native,
        small_genome_params,
    )
    from galah_tpu.utils.synth import make_contig_corpus, make_families

    def same(dev, host) -> bool:
        return (
            dev.total_len == host.total_len
            and np.array_equal(dev.prefilter_buckets, host.prefilter_buckets)
            and np.array_equal(dev.member_buckets, host.member_buckets)
            and np.array_equal(dev.frag_offsets, host.frag_offsets)
            and np.array_equal(dev.frag_buckets, host.frag_buckets)
        )

    variant = "routed" if _default_routed() else "scatter"
    params = NativeSketchParams()
    paths, _ = make_families(
        os.path.join(root, "sketch_check"), n_families=4,
        members_per_family=1, genome_length=GENOME_LENGTH, seed=SEED + 1,
    )
    seqs = [read_fasta_sequences(p) for p in paths]
    t0 = time.perf_counter()
    dev = device_sketch_batch(paths, seqs, params)
    dt = time.perf_counter() - t0
    host = [sketch_file_native(p, params) for p in paths]
    _check(all(same(d, h) for d, h in zip(dev, host)),
           "device sketch differs from the host C++ sketcher (MAGs)")
    log(f"[kernels] device sketch ({variant}) == host C++ sketcher on "
        f"{len(paths)} x {GENOME_LENGTH} bp (bit-identical; "
        f"first call incl. compile {dt:.2f}s)")

    cparams = small_genome_params()
    cpath = os.path.join(root, "sketch_check_contigs.fna")
    names, _ = make_contig_corpus(cpath, n_families=64,
                                  members_per_family=4,
                                  contig_length=CONTIG_LENGTH, seed=SEED + 2)
    host_c = sketch_contigs_native(cpath, cparams)
    from galah_tpu.io.fasta import read_fasta

    recs = list(read_fasta(cpath))
    dev_c = device_sketch_batch(
        [r.contig_name for r in recs], [[r.seq] for r in recs], cparams
    )
    _check(all(same(d, h) for d, h in zip(dev_c, host_c)),
           "device sketch differs from the host C++ sketcher (contigs)")
    log(f"[kernels] device sketch ({variant}) == host C++ sketcher on a "
        f"{len(names)}-contig batch (bit-identical)")


def _verify_reference(sk_q, sk_r, cfg, fixed_point: bool):
    from galah_tpu.ops.fragment_ani import forward_reference

    return forward_reference(
        sk_r.member_bitmap_words(), sk_r.member_popcount,
        sk_q.frag_buckets, sk_q.frag_offsets, cfg.member_bits, cfg.k,
        cfg.min_fragment_hashes, cfg.min_fragment_identity,
        fixed_point=fixed_point,
    )


def _af_matches(af: float, counts) -> bool:
    """AF is n_aligned / n_usable: the aligned count recovered from the
    device's AF must equal the reference's exactly, and the quotient be
    within 2 float32 ulps of the correctly rounded one (XLA:GPU divides
    by multiplying with a reciprocal)."""
    import numpy as np

    n_aligned, n_usable = counts
    want = np.float32(n_aligned / max(n_usable, 1))
    return (
        round(float(af) * max(n_usable, 1)) == n_aligned
        and abs(np.float32(af) - want) <= 2 * np.spacing(want)
    )


def _compare_verify(label, got, want) -> float:
    """got: {(a, b): (ani, af_fwd, af_rev)}; want: {(a, b): (ani,
    (n_aligned, n_usable) fwd, ... rev)}. Aligned-fragment counts exact
    (AF within 2 ulps), ANI within 1e-4 percentage points. Returns the
    largest ANI difference."""
    worst = 0.0
    for key, (ani, c_f, c_r) in want.items():
        g = got[key]
        _check(_af_matches(g[1], c_f) and _af_matches(g[2], c_r),
               f"{label}: AF differs for {key}: {g} vs {(ani, c_f, c_r)}")
        worst = max(worst, abs(g[0] - ani))
    _check(worst <= 1e-4, f"{label}: ANI differs by {worst} pct points")
    return worst


def check_verify(jax, jnp, root: str) -> None:
    import numpy as np

    from galah_tpu.ops.fragment_ani import (
        FragmentAniConfig, FragmentAniEngine, _forward_hits,
    )
    from galah_tpu.sketch.fracminhash import (
        NativeSketchParams, sketch_contigs_native, sketch_file_native,
        small_genome_params,
    )
    from galah_tpu.utils.synth import make_contig_corpus, make_families

    def engine(params):
        return FragmentAniEngine(FragmentAniConfig(
            k=params.k, member_bits=params.member_bits,
            min_fragment_hashes=params.min_fragment_hashes,
        ))

    def reference(sks, pairs, cfg, fixed_point):
        out = {}
        for a, b in pairs:
            _, ani_f, _, al_f, us_f = _verify_reference(
                sks[a], sks[b], cfg, fixed_point)
            _, ani_r, _, al_r, us_r = _verify_reference(
                sks[b], sks[a], cfg, fixed_point)
            out[(a, b)] = (max(ani_f, ani_r), (al_f, us_f), (al_r, us_r))
        return out

    # Grouped kernel at MAG shape: 2 families x 4 members of 3 Mb.
    params = NativeSketchParams()
    paths, _ = make_families(
        os.path.join(root, "verify_mags"), n_families=2,
        members_per_family=4, genome_length=GENOME_LENGTH,
        within_ani=WITHIN_ANI, seed=SEED + 3,
    )
    sks = {p: sketch_file_native(p, params) for p in paths}
    pairs = [(a, b) for i, a in enumerate(paths) for b in paths[i + 1:]]
    eng = engine(params)
    os.environ["GALAH_TPU_VERIFY"] = "grouped"
    try:
        got = eng.bidirectional(pairs, sks)
    finally:
        os.environ.pop("GALAH_TPU_VERIFY")
    worst = _compare_verify("grouped verify", got,
                            reference(sks, pairs, eng.cfg, False))
    q = sks[paths[0]]
    refs = [sks[p] for p in paths[1:]]
    npad = ((len(q.frag_buckets) + (1 << 14) - 1) >> 14) << 14
    buckets = np.zeros(npad, np.int32)
    buckets[:len(q.frag_buckets)] = q.frag_buckets
    bitmaps = jnp.asarray(np.stack([r.member_bitmap_words() for r in refs]))
    args = (bitmaps, jnp.asarray(buckets),
            jnp.asarray(q.frag_offsets.astype(np.int32)),
            jnp.int32(len(q.frag_buckets)))
    hits = _forward_hits.lower(*args).compile()
    log(f"[kernels] grouped verify hits {_memory_line(hits)}")
    m = np.asarray(hits(*args))
    for r, ref in enumerate(refs):
        want_m = _verify_reference(q, ref, eng.cfg, False)[0]
        _check(np.array_equal(m[r], want_m),
               "grouped verify hit counts differ from the reference")
    log(f"[kernels] grouped verify (MAG shape, {len(pairs)} pairs): hit "
        f"and aligned-fragment counts exact, max |dANI| {worst:.2e} pct "
        "points")

    # Pair-table kernel at contig shape.
    cparams = small_genome_params()
    cpath = os.path.join(root, "verify_contigs.fna")
    names, fams = make_contig_corpus(
        cpath, n_families=32, members_per_family=4,
        contig_length=CONTIG_LENGTH, within_ani=WITHIN_ANI, seed=SEED + 4,
    )
    csks = {s.name: s for s in sketch_contigs_native(cpath, cparams)}
    # Every within-family pair, plus one unrelated pair per contig.
    cpairs = [
        (names[i], names[j]) for i in range(len(names))
        for j in range(i + 1, len(names))
        if fams[i] == fams[j] or j == i + 4
    ]
    ceng = engine(cparams)
    os.environ["GALAH_TPU_VERIFY"] = "pairtable"
    try:
        got = ceng.bidirectional(cpairs, csks)
    finally:
        os.environ.pop("GALAH_TPU_VERIFY")
    worst = _compare_verify("pair-table verify", got,
                            reference(csks, cpairs, ceng.cfg, True))
    log(f"[kernels] pair-table verify (contig shape, {len(cpairs)} pairs): "
        f"aligned-fragment counts exact, max |dANI| {worst:.2e} pct points")


# --- four cards -------------------------------------------------------------


def four_cards(jax, clock, root: str) -> None:
    n = len(jax.devices())
    _check(n == 4, f"--four-cards needs 4 devices, found {n}")
    corpus, family_of = make_genome_corpus(root)
    argv = genome_argv(corpus)
    legs = (
        ("mesh", {}),
        ("single", {"GALAH_TPU_SCREEN": "packed",
                    "GALAH_TPU_VERIFY_DEVICES": "1"}),
        ("rowshard", {"GALAH_TPU_ROWSHARD": "1"}),
    )
    outs = {}
    for name, env in legs:
        outs[name] = run_cli_leg(jax, clock, f"four_cards_{name}", argv,
                                 family_of, root, env=env)
    _check(outs["mesh"] == outs["single"] == outs["rowshard"],
           "mesh, single-device and row-sharded clusters.tsv differ")
    log("[four_cards] mesh, single-device and row-sharded clusters.tsv "
        "are byte-identical")


def run_gpu_tests() -> None:
    """The card-only tests (tests/test_gpu.py, marker `gpu`), in this
    process: every one must pass, none skip."""
    import pytest

    class Tally:
        def __init__(self):
            self.outcomes = []

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome == "skipped":
                self.outcomes.append((report.nodeid, report.outcome))

    os.environ["GALAH_TPU_TESTS_ON_GPU"] = "1"
    tally = Tally()
    t0 = time.perf_counter()
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider",
         os.path.join(HERE, "tests", "test_gpu.py")],
        plugins=[tally],
    )
    passed = [n for n, o in tally.outcomes if o == "passed"]
    _check(rc == 0 and passed and len(passed) == len(tally.outcomes),
           f"card-only tests: rc={rc} outcomes={tally.outcomes}")
    log(f"[gpu_tests] {len(passed)} card-only tests passed in "
        f"{time.perf_counter() - t0:.1f}s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh / single / row-sharded "
                         "comparison")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    try:
        import galah_tpu
    except ImportError:
        print("chip_smoke: galah_tpu not found beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    if os.path.dirname(os.path.dirname(os.path.abspath(
            galah_tpu.__file__))) != HERE:
        print("chip_smoke: galah_tpu does not come from this checkout",
              file=sys.stderr)
        return 2

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r}); "
              "nothing was run", file=sys.stderr)
        return 2
    log(f"platform={dev.platform} device_kind={dev.device_kind} "
        f"device_count={len(jax.devices())}")
    log(f"nvidia-smi: {_nvidia_smi()}")
    run(jax, four=args.four_cards)
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


def run(jax, four: bool = False) -> None:
    """Every phase (or only the four-card one); raises on any failure."""
    import jax.numpy as jnp

    from galah_tpu import native_ext
    from galah_tpu.utils.platform import enable_compile_cache

    log(f"[setup] compile cache: {enable_compile_cache()}")
    clock = CompileClock(jax)
    t0 = time.perf_counter()
    _check(native_ext.get_lib() is not None,
           "native fastaio library did not build or load")
    log(f"[setup] native library ready in {time.perf_counter() - t0:.2f}s")

    with tempfile.TemporaryDirectory(prefix="galah-chip-smoke-") as root:
        if four:
            four_cards(jax, clock, root)
        else:
            corpus, family_of = make_genome_corpus(root)
            run_cli_leg(jax, clock, "genome", genome_argv(corpus),
                        family_of, root)
            cpath, cfam_of = make_contig_corpus(root)
            run_cli_leg(jax, clock, "contig", [
                "cluster", "--cluster-contigs", "--small-contigs",
                "-f", cpath, "--ani", "95",
            ], cfam_of, root)
            c0, n0 = clock.mark()
            t0 = time.perf_counter()
            check_screen(jax, jnp)
            check_device_sketch(jax, root)
            check_verify(jax, jnp, root)
            c1, n1 = clock.mark()
            log(f"[kernels] wall_s={time.perf_counter() - t0:.3f} "
                f"compile_s={c1 - c0:.3f} compiles={n1 - n0}")
            run_gpu_tests()
    total_c, total_n = clock.mark()
    log(f"[setup] total backend compile: {total_c:.3f}s over "
        f"{total_n} programs")


if __name__ == "__main__":
    sys.exit(main())
