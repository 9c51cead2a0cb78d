"""A/B timings for the defaults that pick between two formulations of
one step on an accelerator. Each pair computes the same result (the
script checks that), so the faster one becomes the GPU default and
both times go into PERF.md.

Pairs, at the shapes `chip_smoke.py` runs:

- screen: unpack + dot_general in int8 vs bf16 at the 8192-row,
  2^18-bit tile; HLO summary says whether the dot became a library or
  Triton GEMM and whether the 32x-expanded operand is materialized;
- screen_trace: device kernel times of the int8 screen tile from a
  profiler trace (is the unpack its own fusion, and what share of the
  tile does it take?);
- extract: routed (monotone compaction) vs `jnp.nonzero` extraction of
  the above-cutoff entries of one tile;
- sketch: routed bitonic vs XLA sort/scatter device sketch, at the MAG
  shape (8 x 3 Mb) and the contig shape (4,096 x 5 kb), with compile
  time per program;
- gather: grouped verify with the word gather vs the bit-transposed
  table, at 64 and at 512 refs per dispatch (375k-hash MAG streams);
- upload: member bitmaps uploaded dense vs as bucket lists, for a
  batch of contig sketches;
- e2e: the cluster CLI on chip_smoke.py's contig corpus (20,000 x 5 kb)
  and on a 128 x 3 Mb MAG corpus, with each transport switch flipped
  from its GPU default (device sketch off, one tile or one pair-table
  batch per dispatch, word-bitmap sketch transport, eager host copies,
  uint8 indicator screen), default first and last.

Run on the GPU from the repository root:

    python benchmarks/gpu_defaults_ab.py [--only screen,sketch,...]

Each result is one JSON line on stdout (also appended to
chiprun_out/gpu_defaults_ab.jsonl). With no GPU it exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

OUT = os.path.join("chiprun_out", "gpu_defaults_ab.jsonl")


def _emit(rec: dict) -> None:
    line = json.dumps(rec, sort_keys=True)
    print(line, flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def _mem(compiled) -> dict:
    m = compiled.memory_analysis()
    if m is None:
        return {}
    return {
        k: int(getattr(m, k))
        for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes",
        )
        if hasattr(m, k)
    }


def _timed(jax, fn, args, reps: int):
    """(compile seconds, seconds per call, compiled) for jitted fn."""
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = compiled(*args)
    jax.block_until_ready(out)
    return compile_s, (time.perf_counter() - t0) / reps, compiled


def _hlo_summary(compiled, expanded_shape: str) -> dict:
    txt = compiled.as_text()
    return {
        "cublas_calls": txt.count("__cublas"),
        "triton_gemm_fusions": txt.count("__triton_gemm"),
        "expanded_operand_lines": sum(
            1 for ln in txt.splitlines() if expanded_shape in ln
        ),
    }


def ab_screen(jax, jnp, small: bool) -> None:
    from galah_tpu.ops.prefilter import _screen_counts_packed

    block = 512 if small else 8192
    words = (1 << 12 if small else 1 << 18) // 32
    key = jax.random.PRNGKey(0)
    a = jax.random.bits(key, (block, words), jnp.uint32)
    b = jax.random.bits(jax.random.PRNGKey(1), (block, words), jnp.uint32)
    ref = None
    for dtname in ("int8", "bf16"):
        fn = jax.jit(lambda x, y, d=dtname: _screen_counts_packed(x, y, d))
        c_s, dt, compiled = _timed(jax, fn, (a, b), reps=3 if small else 10)
        got = np.asarray(compiled(a, b))
        if ref is None:
            ref = got
        _emit({
            "ab": "screen", "variant": dtname, "block": block,
            "bits": words * 32, "compile_s": c_s, "seconds": dt,
            "pairs_per_s": block * block / dt,
            "tops": 2.0 * block * block * words * 32 / dt / 1e12,
            "equal_to_int8": bool(np.array_equal(got, ref)),
            "memory": _mem(compiled),
            "hlo": _hlo_summary(
                compiled, f"[{block},{words * 32}]"
            ),
        })


def _sparse_rows(jax, jnp, key, rows: int, words: int, density: float):
    """(rows, words) uint32 packed bitmaps at `density` set bits, with
    every 97th row a copy of row 0 (near-duplicate hits)."""
    bits = jax.random.bernoulli(key, density, (rows, words, 32))
    x = jnp.sum(
        bits.astype(jnp.uint32) << jnp.arange(32, dtype=jnp.uint32),
        axis=2, dtype=jnp.uint32,
    )
    return x.at[1::97].set(x[0])


def device_kernel_times(trace_dir: str, top: int = 8) -> dict:
    """{plane: {line: [(event name, total ns, count), ...]}} over the
    device planes of the newest profiler trace under trace_dir."""
    import glob

    from jax.profiler import ProfileData

    paths = sorted(glob.glob(
        os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True
    ), key=os.path.getmtime)
    out: dict = {}
    for plane in ProfileData.from_file(paths[-1]).planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            agg: dict = {}
            for ev in line.events:
                t, c = agg.get(ev.name, (0, 0))
                agg[ev.name] = (t + ev.duration_ns, c + 1)
            best = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]
            out.setdefault(plane.name, {})[line.name] = [
                (n[:120], t, c) for n, (t, c) in best
            ]
    return out


def ab_screen_trace(jax, jnp, small: bool) -> None:
    """Device kernel times of the int8 screen tile: is the 32x unpack a
    separate fusion, and what share of the tile does it take?"""
    import tempfile

    from galah_tpu.ops.prefilter import _screen_counts_packed

    block = 512 if small else 8192
    words = (1 << 12 if small else 1 << 18) // 32
    a = jax.random.bits(jax.random.PRNGKey(0), (block, words), jnp.uint32)
    b = jax.random.bits(jax.random.PRNGKey(1), (block, words), jnp.uint32)
    fn = jax.jit(lambda x, y: _screen_counts_packed(x, y, "int8"))
    jax.block_until_ready(fn(a, b))
    trace_dir = tempfile.mkdtemp(prefix="galah-screen-trace-")
    with jax.profiler.trace(trace_dir):
        for _ in range(3):
            out = fn(a, b)
        jax.block_until_ready(out)
    _emit({"ab": "screen_trace", "block": block, "calls": 3,
           "kernels": device_kernel_times(trace_dir)})


def ab_extract(jax, jnp, small: bool) -> None:
    from galah_tpu.ops.prefilter import (
        _containment, _extract_above_cutoff, _screen_cap_for,
        _screen_counts_packed,
    )

    block = 512 if small else 8192
    words = (1 << 12 if small else 1 << 18) // 32
    cap = _screen_cap_for(block)
    # ~6% load: the prefilter bitmap's design point (engines/native.py
    # _shrink_bits).
    x = _sparse_rows(jax, jnp, jax.random.PRNGKey(2), block, words, 0.06)
    sizes = jnp.sum(
        jax.lax.population_count(x).astype(jnp.float32), axis=1
    )
    counts = jax.jit(lambda a: _screen_counts_packed(a, a, "int8"))(x)
    cont = _containment(counts, sizes, sizes, float(words * 32))
    rows_i = jnp.arange(block)[:, None]
    mask = (cont >= 0.5) & (jnp.arange(block)[None, :] > rows_i)
    res = {}
    for routed in (True, False):
        for direct in (False, True):
            fn = jax.jit(
                lambda c, m, r=routed, d=direct: _extract_above_cutoff(
                    c, m, cap, direct=d, routed=r
                )
            )
            c_s, dt, compiled = _timed(jax, fn, (cont, mask), reps=20)
            cnt, ii, jj, vals = (np.asarray(v) for v in compiled(cont, mask))
            n = int(cnt) if cnt >= 0 else -int(cnt) - 1
            res[(routed, direct)] = (ii[:n].tolist(), jj[:n].tolist())
            _emit({
                "ab": "extract",
                "variant": "routed" if routed else "nonzero",
                "direct": direct, "block": block, "cnt": int(cnt),
                "compile_s": c_s, "seconds_tile": dt,
                "memory": _mem(compiled),
            })
    _emit({"ab": "extract", "identical": all(
        res[(True, d)] == res[(False, d)] for d in (False, True)
    )})


def _random_genomes(rng, n: int, length: int):
    acgt = np.frombuffer(b"ACGT", np.uint8)
    return [[acgt[rng.integers(0, 4, length)].tobytes()] for _ in range(n)]


def ab_sketch(jax, jnp, small: bool) -> None:
    from galah_tpu.ops.device_sketch import (
        _prepare_batch, _sketch_batch_kernel,
    )
    from galah_tpu.sketch.fracminhash import (
        NativeSketchParams, small_genome_params,
    )

    rng = np.random.default_rng(3)
    shapes = (
        [("mag", NativeSketchParams(), 2, 100_000),
         ("contig", small_genome_params(), 64, 5_000)]
        if small else
        [("mag", NativeSketchParams(), 8, 3_000_000),
         ("contig", small_genome_params(), 4_096, 5_000)]
    )
    for name, params, g, length in shapes:
        seqs = _random_genomes(rng, g, length)
        _, args, kw = _prepare_batch(seqs, params)
        outs = {}
        for routed in (True, False):
            kk = dict(kw)
            psel = kk.pop("max_psel")
            if routed:
                kk.update(routed=True, max_psel=psel)
            fn = jax.jit(lambda *a, kk=kk: _sketch_batch_kernel(*a, **kk))
            try:
                c_s, dt, compiled = _timed(jax, fn, args, reps=3)
            except Exception as e:  # one formulation may not fit
                _emit({"ab": "sketch", "shape": name, "routed": routed,
                       "error": repr(e)[:400]})
                continue
            out = compiled(*args)
            outs[routed] = [np.asarray(o) for o in out[:7]]
            _emit({
                "ab": "sketch", "shape": name, "genomes": g,
                "length": length,
                "variant": "routed" if routed else "scatter",
                "compile_s": c_s, "seconds_batch": dt,
                "bases_per_s": g * length / dt,
                "overflow": bool(np.any(np.asarray(out[7]))),
                "memory": _mem(compiled),
            })
        same = len(outs) == 2 and all(
            np.array_equal(a, b) for a, b in zip(outs[True], outs[False])
        )
        _emit({"ab": "sketch", "shape": name, "identical": same})


def ab_gather(jax, jnp, small: bool) -> None:
    from galah_tpu.ops.fragment_ani import (
        _bit_transpose_table, _forward_kernel, _forward_kernel_bt,
        refs_per_dispatch, FragmentAniConfig,
    )

    member_bits = 1 << (16 if small else 22)
    nhash = 10_000 if small else 375_000
    npad = ((nhash + (1 << 14) - 1) >> 14) << 14
    nfrag = 1024
    kw = dict(bits=member_bits, k=15, min_hashes=8, min_ident=0.8)
    widths = (32, 64) if small else (
        64, refs_per_dispatch(npad, FragmentAniConfig().max_refs_per_dispatch)
    )
    for r in widths:
        key = jax.random.PRNGKey(r)
        bitmaps = jax.random.bits(key, (r, member_bits // 32), jnp.uint32)
        pc = jnp.full((r,), member_bits * 0.25, jnp.float32)
        buckets = jax.random.randint(
            jax.random.PRNGKey(7), (npad,), 0, member_bits, jnp.int32
        )
        offsets = jnp.minimum(
            jnp.arange(nfrag + 1, dtype=jnp.int32) * (nhash // nfrag), nhash
        )
        n = jnp.int32(nhash)
        table = _bit_transpose_table(bitmaps)
        word = jax.jit(lambda *a: _forward_kernel(*a, **kw))
        bt = jax.jit(lambda *a: _forward_kernel_bt(*a, **kw))
        res = {}
        for variant, fn, args in (
            ("word", word, (bitmaps, pc, buckets, offsets, n)),
            ("bt", bt, (table, pc, buckets, offsets, n)),
        ):
            c_s, dt, compiled = _timed(jax, fn, args, reps=5)
            res[variant] = [np.asarray(o) for o in compiled(*args)]
            _emit({
                "ab": "gather", "variant": variant, "refs": r,
                "hashes": nhash, "compile_s": c_s, "seconds": dt,
                "directed_pairs_per_s": r / dt,
                "memory": _mem(compiled),
            })
        _emit({
            "ab": "gather", "refs": r,
            "identical": all(
                np.array_equal(a, b) for a, b in zip(res["word"], res["bt"])
            ),
        })


def ab_upload(jax, jnp, small: bool) -> None:
    from galah_tpu.ops.fragment_ani import _BitmapPool
    from galah_tpu.sketch.fracminhash import (
        small_genome_params, sketch_sequences_native,
    )

    params = small_genome_params()
    rng = np.random.default_rng(5)
    n = 64 if small else 4096
    sks = [
        sketch_sequences_native(f"c{i}", s, params)
        for i, s in enumerate(_random_genomes(rng, n, 5_000))
    ]
    words = params.member_bits // 32
    res = {}
    for mode in ("buckets", "dense"):
        os.environ["GALAH_TPU_BITMAP_UPLOAD"] = mode
        times = []
        for rep in range(3):
            pool = _BitmapPool(words, None, capacity=64, hard_cap=n + 64)
            keys = [(mode, rep, i) for i in range(n)]
            t0 = time.perf_counter()
            pool.ensure(keys, sks)
            jax.block_until_ready(pool.buffer)
            times.append(time.perf_counter() - t0)
        stack, _ = pool.stack(keys[:64], 64)
        res[mode] = np.asarray(stack)
        _emit({
            "ab": "upload", "variant": mode, "contigs": n,
            "seconds_first": times[0], "seconds_warm": min(times[1:]),
        })
    os.environ.pop("GALAH_TPU_BITMAP_UPLOAD", None)
    _emit({
        "ab": "upload",
        "identical": bool(np.array_equal(res["buckets"], res["dense"])),
    })


E2E_VARIANTS = (
    ("default", {}),
    ("host_sketch", {"GALAH_TPU_DEVICE_SKETCH": "0"}),
    ("tile_group_1", {"GALAH_TPU_SCREEN_TILE_GROUP": "1"}),
    ("verify_group_1", {"GALAH_TPU_VERIFY_GROUP": "1"}),
    ("transport_words", {"GALAH_TPU_SKETCH_TRANSPORT": "words"}),
    ("host_copies_eager", {"GALAH_TPU_SKETCH_HOST_COPIES": "eager"}),
    ("indicator_screen", {"GALAH_TPU_SCREEN": "indicator"}),
    ("default_again", {}),
)


def ab_e2e(jax, jnp, small: bool) -> None:
    import tempfile

    import chip_smoke as cs

    if small:
        cs.GENOMES, cs.GENOME_FAMILIES, cs.GENOME_LENGTH = 16, 4, 60_000
        cs.CONTIGS, cs.CONTIG_FAMILIES = 200, 40
    else:
        cs.GENOMES, cs.GENOME_FAMILIES = 128, 16
    clock = cs.CompileClock(jax)
    with tempfile.TemporaryDirectory(prefix="galah-e2e-ab-") as root:
        corpus, gfam = cs.make_genome_corpus(root)
        cpath, cfam = cs.make_contig_corpus(root)
        legs = (
            ("mags", cs.genome_argv(corpus), gfam),
            ("contigs", ["cluster", "--cluster-contigs", "--small-contigs",
                         "-f", cpath, "--ani", "95"], cfam),
        )
        # Two runs of each variant: the first may compile, the second
        # is the warm wall that decides.
        for variant, env in E2E_VARIANTS:
            for leg, argv, fam in legs:
                for rep in (1, 2):
                    c0, n0 = clock.mark()
                    t0 = time.perf_counter()
                    cs.run_cli_leg(jax, clock, f"{leg}_{variant}", argv,
                                   fam, root, env=env)
                    c1, n1 = clock.mark()
                    _emit({"ab": "e2e", "leg": leg, "variant": variant,
                           "rep": rep, "env": env,
                           "wall_s": time.perf_counter() - t0,
                           "compile_s": c1 - c0, "compiles": n1 - n0})


ABS = {
    "screen": ab_screen,
    "screen_trace": ab_screen_trace,
    "extract": ab_extract,
    "sketch": ab_sketch,
    "gather": ab_gather,
    "upload": ab_upload,
    "e2e": ab_e2e,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(ABS))
    ap.add_argument("--small", action="store_true",
                    help="tiny shapes (a rehearsal on the CPU backend)")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from galah_tpu.utils.platform import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.small:
        print(f"no GPU (platform {dev.platform}); refusing to measure",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    from chip_smoke import _nvidia_smi

    _emit({"nvidia_smi": _nvidia_smi() if dev.platform == "gpu" else ""})
    _emit({"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}})
    for name in args.only.split(","):
        t0 = time.perf_counter()
        ABS[name](jax, jnp, args.small)
        _emit({"ab": name, "section_seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
