"""Persistent-cache pre-warmer (VERDICT r4 #7).

A fresh deployment starts with an empty persistent compile cache, so
the first production run pays every compile on the critical path
(PERF.md lists the compile time of each program on an H100). This tool
compiles the production program set into the JAX persistent cache
(utils/platform.py:compile_cache_dir) OFF the critical path (at
install/deploy time), so first runs hit the cache.

Programs are lowered from the PRODUCTION jitted functions with the
exact operand avals and static arguments the engine uses (a wrapper
lambda with baked-in constants would compile a structurally different
module whose cache key production never hits). Shape-stable row
bucketing (ops/prefilter.py alloc_rows) keeps the screen's shape set
small enough for this to cover real corpora: pass the corpus sizes
you expect via --n and the sweep geometry follows the same chooser
production uses. Nothing executes — .lower().compile() only.

Usage:
  python -m galah_tpu.tools.prewarm                  # default set
  python -m galah_tpu.tools.prewarm --n 256 100000   # your corpus sizes
  python -m galah_tpu.tools.prewarm --full           # + sketch kernel
  python -m galah_tpu.tools.prewarm --small-contigs  # contig preset
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _log(msg: str) -> None:
    print(f"prewarm: {msg}", file=sys.stderr, flush=True)


def prewarm_screen(jax, jnp, n_units: int, bits: int) -> int:
    """Compile the resident-screen extract programs for an n_units
    corpus at the given prefilter width — same block chooser, row
    bucketing, cap, dtype, and calling convention as
    IncrementalPackedScreen."""
    from galah_tpu.ops import prefilter as pf

    block = pf._screen_block_for(n_units)
    cap = pf._screen_cap_for(block)
    dtn = pf._screen_dtype_name()
    group = pf._screen_tile_group()
    w = bits // 32
    n_pad = ((n_units + block - 1) // block) * block
    alloc = n_pad
    if os.environ.get("GALAH_TPU_SCREEN_PAD_POW2", "1") != "0":
        alloc = max(block, pf._next_pow2_rows(n_pad))
        if alloc * w * 4 > pf._device_resident_budget():
            alloc = n_pad
    x = jnp.zeros((alloc, w), jnp.uint32)
    s = jnp.zeros((alloc,), jnp.float32)
    n = 0
    for is_diag in (False, True):
        t0 = time.perf_counter()
        bj = 0 if is_diag or alloc // block < 2 else 1
        if group > 1:
            desc = jnp.asarray(pf._screen_group_desc(
                [0] * group, [bj] * group, float(bits), 0.5, group,
            ))
            pf._resident_screen_extract_group.lower(
                x, s, desc, block=block, cap=cap, is_diag=is_diag,
                dtname=dtn,
            ).compile()
            n += 1
        for direct in (False, True):
            pf._resident_screen_extract.lower(
                x, s, jnp.int32(0), jnp.int32(bj),
                block=block, bits_f=float(bits), min_cont=0.5,
                cap=cap, is_diag=is_diag, dtname=dtn, direct=direct,
            ).compile()
            n += 1
        _log(
            f"screen n={n_units} rows={alloc} bits={bits} "
            f"block={block} diag={is_diag}: compiled in "
            f"{time.perf_counter()-t0:.1f}s"
        )
    return n


def prewarm_device_sketch(jax, jnp, params, genome_len: int) -> int:
    """Compile the sketch batch kernel for the clean single-contig
    bucket at genome_len — the same shape derivation as
    device_sketch_batch (P/NB/F pow2, NI=1 when no N-runs or
    separators; batches with N-runs add NI shapes this cannot cover)."""
    from galah_tpu.ops.device_sketch import (
        _batch_genome_cap,
        _default_frag_cap,
        _default_routed,
        _next_pow2,
        _psel_capacity,
        _sel_capacity,
        _sketch_batch_kernel,
        _sketch_sort_scan,
    )

    t0 = time.perf_counter()
    P = _next_pow2(max(genome_len, params.k, 4))
    G = max(1, min((32 << 20) // max(P, 1), _batch_genome_cap(P, params)))
    L = params.fragment_length
    nfull = genome_len // L
    bounds_len = nfull + 1 + (1 if genome_len - nfull * L >= L // 2 else 0)
    NB = _next_pow2(max(bounds_len, 2))
    F = _next_pow2(max(bounds_len - 1, 1))
    SEL = _sel_capacity(P - params.k + 1, params)
    routed = _default_routed()
    kw = dict(
        k=params.k, member_bits=params.member_bits,
        prefilter_bits=params.prefilter_bits,
        gthresh=int(params.genome_threshold),
        fthresh=int(params.fragment_threshold),
        max_frags=F, max_sel=SEL,
    )
    if routed:
        kw.update(
            routed=True,
            max_psel=_psel_capacity(P - params.k + 1, params),
            sort_scan=_sketch_sort_scan(),
        )
    else:
        kw.update(frag_cap=_default_frag_cap(params))
    _sketch_batch_kernel.lower(
        jnp.zeros((G, P // 4), jnp.uint8),
        jnp.zeros((G, 1), jnp.int32),
        jnp.zeros((G,), jnp.int32),
        jnp.zeros((G, NB), jnp.int32),
        jnp.zeros((G, NB), jnp.int32),
        **kw,
    ).compile()
    _log(
        f"device-sketch P={P} G={G} NB={NB} F={F}: compiled in "
        f"{time.perf_counter()-t0:.1f}s"
    )
    return 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, nargs="*", default=None,
                    help="corpus sizes (units) to warm the screen for "
                         "[default: 256 16384]")
    ap.add_argument("--bits", type=int, default=None,
                    help="prefilter bitmap width [default: the "
                         "production default for the chosen preset]")
    ap.add_argument("--small-contigs", action="store_true",
                    help="use the small-genomes/contig preset widths")
    ap.add_argument("--genome-length", type=int, default=1 << 20,
                    help="genome length for the sketch-kernel bucket "
                         "(--full) [default 1Mb]")
    ap.add_argument("--full", action="store_true",
                    help="also compile the device-sketch kernel. The "
                         "verify kernels compile in seconds and are left "
                         "to first use")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from galah_tpu.utils.platform import enable_compile_cache

    enable_compile_cache()
    _log(f"backend={jax.default_backend()}")

    from galah_tpu.sketch.fracminhash import (
        NativeSketchParams,
        small_genome_params,
    )

    params = (
        small_genome_params() if args.small_contigs
        else NativeSketchParams()
    )
    bits = args.bits or params.prefilter_bits
    total = 0
    t0 = time.perf_counter()
    for n_units in (args.n or [256, 16384]):
        total += prewarm_screen(jax, jnp, n_units, bits)
    if args.full:
        total += prewarm_device_sketch(jax, jnp, params, args.genome_length)
    _log(
        f"done: {total} programs in the persistent cache "
        f"({time.perf_counter()-t0:.1f}s)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
