"""Microbench: bitmap-gather layouts for the verify kernel.

The grouped verify kernel's hot op is `jnp.take(bitmaps, word_idx,
axis=1)` with bitmaps (R, W): for each stream element it fetches a
STRIDED COLUMN (R words, stride W*4B). Transposing the stack to (W, R)
makes each lookup one CONTIGUOUS row of R*4B (256B at R=64).

All variants run REPS iterations inside one jit (fori_loop with a real
data dependence between iterations) and fetch ONE scalar at the end,
so the time is device time and not dispatch latency.

On the GPU:   python benchmarks/verify_gather_bench.py
CPU smoke:    GALAH_BENCH_SMALL=1 JAX_PLATFORMS=cpu python ...
"""

import os
import sys

# Make the repo importable when run as `python benchmarks/<name>.py`.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import os
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp

from galah_tpu.utils.platform import enable_compile_cache  # noqa: E402

enable_compile_cache()

SMALL = bool(os.environ.get("GALAH_BENCH_SMALL"))
R = 8 if SMALL else 64
MEMBER_BITS = 1 << (16 if SMALL else 22)
W = MEMBER_BITS // 32
NHASH = 10_000 if SMALL else 375_000
NPAD = ((NHASH + (1 << 14) - 1) >> 14) << 14
F = 1024
K = 15
REPS = 4 if SMALL else 10


def log(m):
    print(f"gather_bench: {m}", file=sys.stderr, flush=True)


@jax.jit
def make_inputs(key):
    k1, k2 = jax.random.split(key)
    bitmaps = jax.random.randint(k1, (R, W), 0, 2**31 - 1, jnp.int32).astype(
        jnp.uint32
    )
    buckets = jax.random.randint(k2, (NPAD,), 0, MEMBER_BITS, jnp.int32)
    offsets = jnp.minimum(
        jnp.arange(F + 1, dtype=jnp.int32) * (NHASH // F), NHASH
    )
    return bitmaps, buckets, offsets


def repeat_in_jit(body):
    """body(buckets) -> f32 scalar. Returns a jitted fn running body
    REPS times with an iteration-to-iteration data dependence (the
    previous result perturbs one stream element, so XLA cannot CSE or
    elide iterations)."""

    @jax.jit
    def run(buckets):
        def step(i, acc):
            # dependence: fold acc into element 0 (valid bucket range
            # is preserved: acc is a small non-negative int)
            b = buckets.at[0].add((acc % 2).astype(jnp.int32))
            return acc + body(b).astype(jnp.int32)

        return jax.lax.fori_loop(0, REPS, step, jnp.int32(0))

    return run


def _kernel_T_body(bitmaps_T, popcounts, buckets, offsets, n, blk=512):
    """Transposed full kernel: per-fragment hit counts for R refs."""
    npad = buckets.shape[0]
    idx = jnp.arange(npad, dtype=jnp.int32)
    valid = idx < n
    word_idx = buckets >> 5
    bit_idx = (buckets & 31).astype(jnp.uint32)
    words = jnp.take(bitmaps_T, word_idx, axis=0)  # (N, R) contiguous rows
    hits = ((words >> bit_idx[:, None]) & jnp.uint32(1)).astype(jnp.int32)
    hits = jnp.where(valid[:, None], hits, 0)
    nb = npad // blk
    h3 = hits.reshape(nb, blk, R)
    intra = jnp.cumsum(h3, axis=1)
    block_tot = intra[:, -1, :]
    block_off = jnp.cumsum(block_tot, axis=0) - block_tot
    h = (intra + block_off[:, None, :]).reshape(npad, R)
    h = jnp.pad(h, ((1, 0), (0, 0)))
    m = jnp.take(h, offsets[1:], axis=0) - jnp.take(h, offsets[:-1], axis=0)
    M = jnp.diff(offsets)[:, None].astype(jnp.float32)
    p = popcounts[None, :] / MEMBER_BITS
    c = jnp.clip((m - M * p) / jnp.maximum(1.0 - p, 1e-6), 0.0, M)
    ident = jnp.power(jnp.maximum(c / jnp.maximum(M, 1.0), 1e-30), 1.0 / K)
    aligned = (M >= 8) & (ident >= 0.8)
    ani = jnp.sum(jnp.where(aligned, ident, 0.0), axis=0) / jnp.maximum(
        jnp.sum(aligned, axis=0), 1
    )
    return ani * 100.0


kernel_T = jax.jit(_kernel_T_body, static_argnames=("blk",))


def timeit(name, fn, buckets, per_iter_items, unit):
    t0 = time.perf_counter()
    int(fn(buckets))
    log(f"{name}: compile+warmup {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    int(fn(buckets))
    dt = (time.perf_counter() - t0) / REPS
    log(
        f"{name}: {dt*1e3:.2f}ms/iter -> "
        f"{per_iter_items/dt/1e9:.2f}G lookups/s, {R/dt:.0f} {unit}"
    )
    return dt


def main():
    log(
        f"backend={jax.default_backend()} R={R} W={W} NHASH={NHASH} "
        f"reps={REPS}"
    )
    bitmaps, buckets, offsets = make_inputs(jax.random.PRNGKey(0))
    bitmaps_T = jnp.asarray(bitmaps.T)
    popcounts = jnp.full((R,), MEMBER_BITS * 0.25, jnp.float32)
    jax.block_until_ready((bitmaps, bitmaps_T, buckets))

    from galah_tpu.ops.fragment_ani import _forward_kernel

    variants = {
        "gather_axis1": repeat_in_jit(
            lambda b: jnp.sum(
                jnp.take(bitmaps, b >> 5, axis=1) & jnp.uint32(1),
                dtype=jnp.int32,
            ).astype(jnp.float32)
        ),
        "gather_axis0T": repeat_in_jit(
            lambda b: jnp.sum(
                jnp.take(bitmaps_T, b >> 5, axis=0) & jnp.uint32(1),
                dtype=jnp.int32,
            ).astype(jnp.float32)
        ),
        # Full-kernel variants sum every pair's ANI: consuming only
        # [0][0] lets XLA narrow the per-ref tail out of the program
        # (~18% at CPU shapes; bench.py carries the same fix). The raw
        # gather rows above already reduce over everything.
        "kernel_current": repeat_in_jit(
            lambda b: jnp.sum(_forward_kernel(
                bitmaps, popcounts, b, offsets, jnp.int32(NHASH),
                bits=MEMBER_BITS, k=K, min_hashes=8,
                min_ident=0.8,
            )[0])
        ),
        "kernel_T": repeat_in_jit(
            lambda b: jnp.sum(_kernel_T_body(
                bitmaps_T, popcounts, b, offsets, jnp.int32(NHASH)
            )[0])
        ),
    }
    for name, fn in variants.items():
        timeit(name, fn, buckets, R * NHASH, "directed-pairs/s")

    # --- bit-transposed path stage decomposition ---
    from galah_tpu.ops.fragment_ani import (
        _bit_transpose_table,
        _forward_kernel_bt,
        _per_fragment_hits,
    )

    r32 = ((R + 31) // 32) * 32
    bm32 = jnp.zeros((r32, W), jnp.uint32).at[:R].set(bitmaps)
    table = jax.jit(_bit_transpose_table)(bm32)
    pc32 = jnp.zeros((r32,), jnp.float32).at[:R].set(popcounts)
    bits_hit = jax.jit(
        lambda key: jax.random.randint(key, (r32, NPAD), 0, 2, jnp.int32)
    )(jax.random.PRNGKey(7))
    jax.block_until_ready((table, bits_hit))
    g32 = r32 // 32
    shifts = jnp.arange(32, dtype=jnp.uint32)

    def bt_gather(b):
        rows = jnp.take(table, b, axis=0)
        return jnp.sum(rows, dtype=jnp.uint32).astype(jnp.float32)

    def bt_expand(b):
        rows = jnp.take(table, b, axis=0)
        bits = (
            (rows.T[:, None, :] >> shifts[None, :, None]) & jnp.uint32(1)
        ).astype(jnp.int32)
        return jnp.sum(bits.reshape(g32 * 32, NPAD), dtype=jnp.int32).astype(
            jnp.float32
        )

    def seg_tail(b):
        # tail alone on a resident random hit matrix; perturb via b[0]
        bh = bits_hit.at[0, 0].set(b[0] % 2)
        return jnp.sum(_per_fragment_hits(bh, offsets)).astype(jnp.float32)

    bt_variants = {
        "bt_gather_rows": bt_gather,
        "bt_gather+expand": bt_expand,
        "seg_tail_only": seg_tail,
        "kernel_bt_full": lambda b: jnp.sum(_forward_kernel_bt(
            table, pc32, b, offsets, jnp.int32(NHASH),
            bits=MEMBER_BITS, k=K, min_hashes=8,
            min_ident=0.8,
        )[0]),
    }
    for name, fn in bt_variants.items():
        timeit(name, repeat_in_jit(fn), buckets, R * NHASH, "directed-pairs/s")

    # Parity check between the two full kernels
    a0, _ = _forward_kernel(
        bitmaps, popcounts, buckets, offsets, jnp.int32(NHASH),
        bits=MEMBER_BITS, k=K, min_hashes=8, min_ident=0.8,
    )
    a1 = kernel_T(bitmaps_T, popcounts, buckets, offsets, jnp.int32(NHASH))
    import numpy as np

    d = np.max(np.abs(np.asarray(a0) - np.asarray(a1)))
    log(f"parity max |dANI| = {d:.6f}")


if __name__ == "__main__":
    main()
