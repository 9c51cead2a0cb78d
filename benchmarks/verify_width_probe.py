"""Verify kernel refs-per-dispatch scaling probe: R = 256 vs 512 /
1024, word and bit-transposed kernels, at 375k-hash MAG streams — how
the per-position gather cost amortizes over the ref axis. Run on the
GPU (JAX_PLATFORMS=cpu for a smoke run); one process at a time.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


ITERS = int(os.environ.get("GALAH_TPU_PROBE_ITERS", "4"))


def main() -> None:
    import jax
    import jax.numpy as jnp
    from galah_tpu.utils.platform import enable_compile_cache

    enable_compile_cache()

    from galah_tpu.ops.fragment_ani import (
        _bit_transpose_table,
        _forward_kernel,
        _forward_kernel_bt,
    )

    MEMBER_BITS = 1 << 22
    W = MEMBER_BITS // 32
    NHASH = 375_000
    NPAD = ((NHASH + (1 << 14) - 1) >> 14) << 14
    F = 1024
    K = 15
    _log(f"verify width probe: backend={jax.default_backend()} iters={ITERS}")

    def _repeat(body):
        # Operands are explicit ARGUMENTS: a closure would bake the
        # (R, W) bitmaps into the HLO as literals — a couple hundred MB
        # of constants that multiply compile time.
        @jax.jit
        def run(bitmaps_or_table, popcounts, buckets, offsets):
            def step(i, acc):
                b = buckets.at[0].set(
                    jnp.minimum(
                        buckets[0] + (acc % 2.0).astype(jnp.int32),
                        MEMBER_BITS - 1,
                    )
                )
                return acc + body(bitmaps_or_table, popcounts, b, offsets)

            return jax.lax.fori_loop(0, ITERS, step, jnp.float32(0.0))

        return run

    def _time(fn, args, name):
        t0 = time.perf_counter()
        float(fn(*args))
        _log(f"{name}: compile+warmup {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        float(fn(*args))
        return (time.perf_counter() - t0) / ITERS

    for R in (256, 512, 1024):
        key = jax.random.PRNGKey(R)

        @jax.jit
        def make_inputs(key, R=R):
            k1, k2 = jax.random.split(key)
            bitmaps = jax.random.randint(
                k1, (R, W), 0, 2**31 - 1, dtype=jnp.int32
            ).astype(jnp.uint32)
            popcounts = jnp.full((R,), MEMBER_BITS * 0.25, jnp.float32)
            buckets = jax.random.randint(
                k2, (NPAD,), 0, MEMBER_BITS, dtype=jnp.int32
            )
            offsets = jnp.minimum(
                jnp.arange(F + 1, dtype=jnp.int32) * (NHASH // F), NHASH
            )
            return bitmaps, popcounts, buckets, offsets

        bitmaps, popcounts, buckets, offsets = make_inputs(key)
        bitmaps.block_until_ready()

        def body(bm, pc, b, off):
            ani, af = _forward_kernel(
                bm, pc, b, off, jnp.int32(NHASH),
                bits=MEMBER_BITS, k=K, min_hashes=8, min_ident=0.8,
            )
            return jnp.sum(ani) + jnp.sum(af)

        try:
            dt = _time(_repeat(body),
                       (bitmaps, popcounts, buckets, offsets), f"word R={R}")
            _log(
                f"word R={R}: {R/dt:.0f} directed-pairs/s "
                f"({R*NHASH/dt/1e9:.2f}G lookups/s, {dt*1e3:.0f}ms/dispatch)"
            )
        except Exception as e:  # noqa: BLE001 — probe records failures
            _log(f"word R={R}: FAILED {type(e).__name__}: {e}")

        # bt kernel at the same R (table build excluded — LRU-amortized)
        try:
            table = _bit_transpose_table(bitmaps)
            table.block_until_ready()

            def body_bt(tb, pc, b, off):
                ani, af = _forward_kernel_bt(
                    tb, pc, b, off, jnp.int32(NHASH),
                    bits=MEMBER_BITS, k=K, min_hashes=8, min_ident=0.8,
                )
                return jnp.sum(ani) + jnp.sum(af)

            dt = _time(_repeat(body_bt),
                       (table, popcounts, buckets, offsets), f"bt R={R}")
            _log(
                f"bt R={R}: {R/dt:.0f} directed-pairs/s "
                f"({dt*1e3:.0f}ms/dispatch)"
            )
        except Exception as e:  # noqa: BLE001
            _log(f"bt R={R}: FAILED {type(e).__name__}: {e}")


if __name__ == "__main__":
    main()
