"""Decompose the e2e verify-phase wall time on the device: per-genome
bitmap builds (batched into the fixed-shape per-device pool,
FragmentAniEngine.bitmap_stack / ops/fragment_ani.py::_BitmapPool)
against the verify kernels themselves. JAX_PLATFORMS=cpu runs it on
the host.

This probe times three back-to-back `bidirectional` runs over the SAME
pair list with synthetic 500kb-genome-shaped sketches (62.5k member
hashes, member_bits 2^22 — the e2e corpus shape):

  run1  cold engine (bitmap builds + stream uploads + any compiles)
  run2  warm bitmap cache (stream uploads + kernel only)
  run3  same (steady-state repeat)
  run4  engine.clear() then again (bitmap builds + streams, compiles
        all cached by now)

run4 - run2 isolates the per-genome bitmap-build cost; run2 is the
irreducible per-verify cost (pair-table has no stream cache).

Usage: python benchmarks/verify_phase_probe.py [--genomes 256]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synth_sketch(rng, name, params):
    from galah_tpu.sketch.fracminhash import NativeSketch

    n_frag = 167
    per_frag = 375
    n = n_frag * per_frag
    frag_buckets = rng.integers(
        0, params.member_bits, size=n, dtype=np.int64
    ).astype(np.int32)
    frag_offsets = (np.arange(n_frag + 1, dtype=np.int64) * per_frag)
    member = np.unique(frag_buckets)
    return NativeSketch(
        name=name,
        total_len=500_000,
        prefilter_buckets=np.unique(
            rng.integers(0, params.prefilter_bits, size=2500).astype(np.int32)
        ),
        frag_buckets=frag_buckets,
        frag_offsets=frag_offsets,
        member_buckets=member,
        params=params,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genomes", type=int, default=256)
    ap.add_argument("--family", type=int, default=8)
    args = ap.parse_args()

    import jax
    from galah_tpu.utils.platform import enable_compile_cache

    enable_compile_cache()

    print(f"backend: {jax.default_backend()}, devices: {len(jax.devices())}")

    from galah_tpu.ops.fragment_ani import FragmentAniConfig, FragmentAniEngine
    from galah_tpu.sketch.fracminhash import NativeSketchParams

    params = NativeSketchParams()
    cfg = FragmentAniConfig(
        k=params.k,
        member_bits=params.member_bits,
        min_fragment_hashes=params.min_fragment_hashes,
    )
    engine = FragmentAniEngine(cfg)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    by_key = {
        f"g{i}": synth_sketch(rng, f"g{i}", params)
        for i in range(args.genomes)
    }
    print(f"synth {args.genomes} sketches: {time.perf_counter()-t0:.1f}s")

    pairs = []
    for base in range(0, args.genomes, args.family):
        fam = [f"g{i}" for i in range(base, min(base + args.family, args.genomes))]
        for a in range(len(fam)):
            for b in range(a + 1, len(fam)):
                pairs.append((fam[a], fam[b]))
    print(f"pairs: {len(pairs)} undirected ({2*len(pairs)} directed)")

    def run(tag):
        t = time.perf_counter()
        out = engine.bidirectional(pairs, by_key)
        dt = time.perf_counter() - t
        vals = np.array([v[0] for v in out.values()])
        print(
            f"{tag}: {dt:.2f}s  ({2*len(pairs)/dt:.0f} directed-pairs/s; "
            f"ani mean {vals.mean():.2f})"
        )
        return dt

    r1 = run("run1 cold            ")
    r2 = run("run2 warm bitmaps    ")
    r3 = run("run3 steady          ")
    engine.clear()
    r4 = run("run4 cleared (no-compile cold)")
    print(
        f"bitmap-build share: {r4 - (r2 + r3) / 2:.2f}s "
        f"({(r4 - (r2 + r3) / 2) / max(r4, 1e-9) * 100:.0f}% of a cold run); "
        f"compile share of run1: {r1 - r4:.2f}s"
    )


if __name__ == "__main__":
    main()
