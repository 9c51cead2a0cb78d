"""Microbench: stage-by-stage profile of the on-device sketch kernel.

The device sketcher (ops/device_sketch.py) is mostly elementwise
integer arithmetic; its time goes to the non-elementwise stages:

  1. kmer_hash   — k-window construction + splitmix64 + threshold
                   selection (pure elementwise; expected fast)
  2. bitmaps     — two scatter-max constructions of the genome-level
                   indicator bitmaps (n=1M updates each into 2^22/2^18)
  3. compaction  — cumsum over n + two scatter-sets compacting the
                   selected (frag, bucket) pairs into SEL slots
  4. sort_dedup  — 2-key lax.sort over SEL + adjacent-diff dedup +
                   flat/counts scatters
  5. cumsum variants — (G, 2^20) axis-1 cumsum vs the hierarchical
                   reshape scan (pair_table._fast_cumsum pattern)

Each stage runs REPS times inside one jit (fori_loop with a real
data dependence) and fetches one scalar, so the time is device time
and not dispatch latency.

On the GPU:   python benchmarks/device_sketch_profile.py
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

from galah_tpu.ops.device_sketch import (
    _lt64,
    _pack_indicator_words,
    _u32,
    mix64_pair,
)
from galah_tpu.ops.pair_table import _fast_cumsum

SMALL = bool(os.environ.get("GALAH_BENCH_SMALL"))
G = 4 if SMALL else 32
P = (1 << 14) if SMALL else (1 << 20)
K = 15
N = P - K + 1
MEMBER_BITS = 1 << (16 if SMALL else 22)
PREFILTER_BITS = 1 << (12 if SMALL else 18)
FRAGMENT_SCALE = 8
GENOME_SCALE = 200
SEL = 1 << (12 if SMALL else 18)
MAX_FRAGS = 1 << (6 if SMALL else 10)
REPS = 2 if SMALL else 8
FTHRESH = int((1 << 64) // FRAGMENT_SCALE)
GTHRESH = int((1 << 64) // GENOME_SCALE)
BIG = jnp.int32(2**30)


def log(m):
    print(f"sketch_profile: {m}", file=sys.stderr, flush=True)


@jax.jit
def make_inputs(key):
    ks = jax.random.split(key, 4)
    codes = jax.random.randint(ks[0], (G, P), 0, 4, jnp.int32).astype(
        jnp.uint8
    )
    # Post-hash intermediates with matching distributions, generated
    # independently so each stage can be timed without the others.
    fsel = jax.random.uniform(ks[1], (G, N)) < (1.0 / FRAGMENT_SCALE)
    gsel = fsel & (
        jax.random.uniform(ks[2], (G, N)) < (FRAGMENT_SCALE / GENOME_SCALE)
    )
    mbucket = jax.random.randint(ks[3], (G, N), 0, MEMBER_BITS, jnp.int32)
    frag = jnp.broadcast_to(
        jnp.minimum(
            jnp.arange(N, dtype=jnp.int32) // (P // MAX_FRAGS), MAX_FRAGS - 1
        )[None],
        (G, N),
    )
    return codes, fsel, gsel, mbucket, frag


def repeat_in_jit(body, perturb):
    """body(x) -> i32 scalar per call; perturb(x, acc) reinjects the
    accumulator so XLA cannot CSE iterations."""

    @jax.jit
    def run(x):
        def step(i, acc):
            return acc + body(perturb(x, acc))

        return jax.lax.fori_loop(0, REPS, step, jnp.int32(0))

    return run


def timeit(name, fn, x, work_elems):
    t0 = time.time()
    r = int(fn(x))
    compile_s = time.time() - t0
    t0 = time.time()
    r = int(fn(x))
    dt = (time.time() - t0) / REPS
    log(
        f"{name}: {dt * 1e3:.2f}ms/iter  "
        f"({work_elems / dt / 1e6:.0f}M elems/s)  "
        f"[compile+warm {compile_s:.1f}s, chk={r}]"
    )
    return dt


# ---- stage bodies (each vmapped over G) ----


def kmer_hash_one(codes):
    c32 = (codes & jnp.uint8(3)).astype(jnp.uint32)
    invalid = codes >= jnp.uint8(4)
    fwd = jnp.zeros(N, dtype=jnp.uint32)
    rev = jnp.zeros(N, dtype=jnp.uint32)
    bad = jnp.zeros(N, dtype=bool)
    for j in range(K):
        cj = jax.lax.slice(c32, (j,), (j + N,))
        fwd = (fwd << _u32(2)) | cj
        rev = rev | ((_u32(3) - cj) << _u32(2 * j))
        bad = bad | jax.lax.slice(invalid, (j,), (j + N,))
    canon = jnp.minimum(fwd, rev)
    hi, lo = mix64_pair(jnp.zeros_like(canon), canon)
    fsel = ~bad & _lt64(hi, lo, FTHRESH)
    gsel = ~bad & _lt64(hi, lo, GTHRESH)
    mb = (lo & _u32(MEMBER_BITS - 1)).astype(jnp.int32)
    return (
        jnp.sum(fsel.astype(jnp.int32))
        + jnp.sum(gsel.astype(jnp.int32))
        + jnp.sum(mb, dtype=jnp.int32)
    )


def bitmaps_one(fsel, gsel, mbucket):
    mem_ind = jnp.zeros(MEMBER_BITS, dtype=jnp.uint32)
    mem_ind = mem_ind.at[jnp.where(fsel, mbucket, MEMBER_BITS)].max(
        jnp.uint32(1), mode="drop"
    )
    pbucket = mbucket & jnp.int32(PREFILTER_BITS - 1)
    pref_ind = jnp.zeros(PREFILTER_BITS, dtype=jnp.uint32)
    pref_ind = pref_ind.at[jnp.where(gsel, pbucket, PREFILTER_BITS)].max(
        jnp.uint32(1), mode="drop"
    )
    mw = _pack_indicator_words(mem_ind)
    pw = _pack_indicator_words(pref_ind)
    return (
        jnp.sum(mem_ind, dtype=jnp.int32)
        + jnp.sum(pref_ind, dtype=jnp.int32)
        + (jnp.sum(mw, dtype=jnp.uint32) + jnp.sum(pw, dtype=jnp.uint32))
        .astype(jnp.int32)
    )


def compaction_one(fsel, frag, mbucket):
    stream_sel = fsel & (frag >= 0)
    sel_pos = jnp.cumsum(stream_sel.astype(jnp.int32)) - 1
    scatter_to = jnp.where(stream_sel, sel_pos, SEL)
    cfrag = jnp.full(SEL, BIG, dtype=jnp.int32)
    cfrag = cfrag.at[scatter_to].set(frag, mode="drop")
    cbucket = jnp.full(SEL, BIG, dtype=jnp.int32)
    cbucket = cbucket.at[scatter_to].set(mbucket, mode="drop")
    return jnp.sum(cfrag ^ cbucket, dtype=jnp.int32)


def compaction_fast_one(fsel, frag, mbucket):
    stream_sel = fsel & (frag >= 0)
    sel_pos = _fast_cumsum(stream_sel.astype(jnp.int32)) - 1
    scatter_to = jnp.where(stream_sel, sel_pos, SEL)
    cfrag = jnp.full(SEL, BIG, dtype=jnp.int32)
    cfrag = cfrag.at[scatter_to].set(frag, mode="drop")
    cbucket = jnp.full(SEL, BIG, dtype=jnp.int32)
    cbucket = cbucket.at[scatter_to].set(mbucket, mode="drop")
    return jnp.sum(cfrag ^ cbucket, dtype=jnp.int32)


def sort_dedup_one(cfrag, cbucket):
    sfrag, sbucket = jax.lax.sort((cfrag, cbucket), num_keys=2)
    prev_f = jnp.concatenate([jnp.array([-1], jnp.int32), sfrag[:-1]])
    prev_b = jnp.concatenate([jnp.array([-1], jnp.int32), sbucket[:-1]])
    is_real = sfrag < BIG
    first = is_real & ((sfrag != prev_f) | (sbucket != prev_b))
    out_pos = jnp.cumsum(first.astype(jnp.int32)) - 1
    flat = jnp.zeros(SEL, dtype=jnp.int32)
    flat = flat.at[jnp.where(first, out_pos, SEL)].set(sbucket, mode="drop")
    counts = jnp.zeros(MAX_FRAGS, dtype=jnp.int32)
    counts = counts.at[jnp.where(first, sfrag, MAX_FRAGS)].add(
        1, mode="drop"
    )
    return jnp.sum(flat, dtype=jnp.int32) + jnp.sum(counts, dtype=jnp.int32)


def cumsum_xla_one(x):
    return jnp.cumsum(x)[-1]


def cumsum_fast_one(x):
    return _fast_cumsum(x)[-1]


# ---- candidate-optimization stages (GALAH_PROFILE_ALT=1) ----

KEY_PAD = jnp.uint32(0xFFFFFFFF)


_FIT_BITS = min(
    MEMBER_BITS.bit_length() - 1, 31 - (MAX_FRAGS - 1).bit_length()
)


def sort_dedup_1key_one(cfrag, cbucket):
    """Same dedup via a single combined uint32 key. Production requires
    max_frags * member_bits <= 2^31 so the pad key stays distinct; for
    timing at shapes past that bound the bucket is masked to _FIT_BITS
    (identical sort cost, slightly different dedup counts)."""
    real = cfrag < BIG
    key = jnp.where(
        real,
        (cfrag.astype(jnp.uint32) << _u32(_FIT_BITS))
        | (cbucket.astype(jnp.uint32) & _u32((1 << _FIT_BITS) - 1)),
        KEY_PAD,
    )
    skey = jax.lax.sort(key)
    prev = jnp.concatenate([jnp.array([KEY_PAD], jnp.uint32), skey[:-1]])
    is_real = skey != KEY_PAD
    first = is_real & (skey != prev)
    out_pos = jnp.cumsum(first.astype(jnp.int32)) - 1
    sbucket = (skey & _u32((1 << _FIT_BITS) - 1)).astype(jnp.int32)
    sfrag = (skey >> _u32(_FIT_BITS)).astype(jnp.int32)
    flat = jnp.zeros(SEL, dtype=jnp.int32)
    flat = flat.at[jnp.where(first, out_pos, SEL)].set(sbucket, mode="drop")
    counts = jnp.zeros(MAX_FRAGS, dtype=jnp.int32)
    counts = counts.at[jnp.where(first, sfrag, MAX_FRAGS)].add(
        1, mode="drop"
    )
    return jnp.sum(flat, dtype=jnp.int32) + jnp.sum(counts, dtype=jnp.int32)


def fused_sort_n_one(fsel, frag, mbucket):
    """Skip scatter-compaction: sort the combined key over all N
    positions directly (padding sorts last), then dedup + compact via
    the same first-of-run scatters."""
    stream_sel = fsel & (frag >= 0)
    key = jnp.where(
        stream_sel,
        (frag.astype(jnp.uint32) << _u32(_FIT_BITS))
        | (mbucket.astype(jnp.uint32) & _u32((1 << _FIT_BITS) - 1)),
        KEY_PAD,
    )
    skey = jax.lax.sort(key)
    prev = jnp.concatenate([jnp.array([KEY_PAD], jnp.uint32), skey[:-1]])
    is_real = skey != KEY_PAD
    first = is_real & (skey != prev)
    out_pos = jnp.cumsum(first.astype(jnp.int32)) - 1
    sbucket = (skey & _u32((1 << _FIT_BITS) - 1)).astype(jnp.int32)
    sfrag = (skey >> _u32(_FIT_BITS)).astype(jnp.int32)
    flat = jnp.zeros(SEL, dtype=jnp.int32)
    flat = flat.at[jnp.where(first, out_pos, SEL)].set(sbucket, mode="drop")
    counts = jnp.zeros(MAX_FRAGS, dtype=jnp.int32)
    counts = counts.at[
        jnp.where(first, jnp.minimum(sfrag, MAX_FRAGS), MAX_FRAGS)
    ].add(1, mode="drop")
    return jnp.sum(flat, dtype=jnp.int32) + jnp.sum(counts, dtype=jnp.int32)


def bitmaps_small_one(cbucket):
    """Member-bitmap scatter fed from the SEL-compacted stream instead
    of all N positions (4x fewer updates at these shapes; the prefilter
    bitmap's gsel stream is ~25x smaller again)."""
    sel = cbucket < BIG
    mem_ind = jnp.zeros(MEMBER_BITS, dtype=jnp.uint32)
    mem_ind = mem_ind.at[jnp.where(sel, cbucket, MEMBER_BITS)].max(
        jnp.uint32(1), mode="drop"
    )
    mw = _pack_indicator_words(mem_ind)
    return (
        jnp.sum(mem_ind, dtype=jnp.int32)
        + jnp.sum(mw, dtype=jnp.uint32).astype(jnp.int32)
    )


def main():
    codes, fsel, gsel, mbucket, frag = make_inputs(jax.random.PRNGKey(0))
    codes.block_until_ready()
    backend = jax.devices()[0].platform
    log(f"backend={backend} G={G} P={P} SEL={SEL} reps={REPS}")
    bases = G * P

    # 1. kmer+hash (elementwise floor)
    fn = repeat_in_jit(
        lambda c: jnp.sum(jax.vmap(kmer_hash_one)(c), dtype=jnp.int32),
        lambda c, a: c.at[0, 0].set((a % 4).astype(jnp.uint8)),
    )
    timeit("kmer_hash", fn, codes, bases)

    # 2. bitmap scatters
    fn = repeat_in_jit(
        lambda mb: jnp.sum(
            jax.vmap(bitmaps_one)(fsel, gsel, mb), dtype=jnp.int32
        ),
        lambda mb, a: mb.at[0, 0].set(a % MEMBER_BITS),
    )
    timeit("bitmaps(2x scatter-max n->bits)", fn, mbucket, 2 * bases)

    # 3. compaction (cumsum + 2 scatter-sets)
    fn = repeat_in_jit(
        lambda mb: jnp.sum(
            jax.vmap(compaction_one)(fsel, frag, mb), dtype=jnp.int32
        ),
        lambda mb, a: mb.at[0, 0].set(a % MEMBER_BITS),
    )
    timeit("compaction(xla cumsum)", fn, mbucket, bases)

    fn = repeat_in_jit(
        lambda mb: jnp.sum(
            jax.vmap(compaction_fast_one)(fsel, frag, mb), dtype=jnp.int32
        ),
        lambda mb, a: mb.at[0, 0].set(a % MEMBER_BITS),
    )
    timeit("compaction(fast cumsum)", fn, mbucket, bases)

    # 4. sort + dedup at SEL
    key = jax.random.PRNGKey(1)
    cfrag = jax.random.randint(key, (G, SEL), 0, MAX_FRAGS, jnp.int32)
    cbucket = jax.random.randint(
        jax.random.PRNGKey(2), (G, SEL), 0, MEMBER_BITS, jnp.int32
    )
    fn = repeat_in_jit(
        lambda cb: jnp.sum(
            jax.vmap(sort_dedup_one)(cfrag, cb), dtype=jnp.int32
        ),
        lambda cb, a: cb.at[0, 0].set(a % MEMBER_BITS),
    )
    timeit("sort_dedup(SEL 2-key)", fn, cbucket, G * SEL)

    # 5. cumsum variants over (G, N)
    x = (fsel & True).astype(jnp.int32)
    fn = repeat_in_jit(
        lambda v: jnp.sum(jax.vmap(cumsum_xla_one)(v), dtype=jnp.int32),
        lambda v, a: v.at[0, 0].set(a % 2),
    )
    timeit("cumsum_xla (G,N)", fn, x, bases)
    fn = repeat_in_jit(
        lambda v: jnp.sum(jax.vmap(cumsum_fast_one)(v), dtype=jnp.int32),
        lambda v, a: v.at[0, 0].set(a % 2),
    )
    timeit("cumsum_fast (G,N)", fn, x, bases)

    # 0. full production kernel (current ops/device_sketch.py), at the
    # same logical shape — packed 2-bit input, default MAG params.
    from galah_tpu.ops.device_sketch import _sketch_batch_kernel
    from galah_tpu.sketch.fracminhash import NativeSketchParams

    params = NativeSketchParams()
    if not SMALL:
        nfrag = P // params.fragment_length
        NB2 = 1 << int(nfrag + 1).bit_length()
        bounds_np = jnp.asarray(
            jnp.minimum(
                jnp.arange(NB2, dtype=jnp.int32) * params.fragment_length,
                P,
            )
        )
        b2f = jnp.where(
            jnp.arange(NB2, dtype=jnp.int32) < nfrag,
            jnp.arange(NB2, dtype=jnp.int32),
            -1,
        )
        packed_codes = jax.jit(
            lambda key: jax.random.randint(
                key, (G, P // 4), 0, 256, jnp.int32
            ).astype(jnp.uint8)
        )(jax.random.PRNGKey(9))
        packed_codes.block_until_ready()
        bounds_b = jnp.broadcast_to(bounds_np[None], (G, NB2))
        b2f_b = jnp.broadcast_to(b2f[None], (G, NB2))
        inv1 = jnp.full((G, 1), P, jnp.int32)
        lens = jnp.full((G,), P, jnp.int32)
        from galah_tpu.ops.device_sketch import (
            _frag_capacity,
            _sel_capacity,
        )

        SELP = _sel_capacity(P - params.k + 1, params)  # production sizing

        def make_prod_body(cap):
            def prod_body(c):
                out = _sketch_batch_kernel(
                    c, inv1, lens, bounds_b, b2f_b,
                    k=params.k, member_bits=params.member_bits,
                    prefilter_bits=params.prefilter_bits,
                    gthresh=int(params.genome_threshold),
                    fthresh=int(params.fragment_threshold),
                    max_frags=nfrag, max_sel=SELP,
                    frag_cap=cap,
                )
                # Consume every output (incl. both overflow flags), or
                # XLA dead-code-eliminates the dedup sort / bitmap
                # packing / per-fragment counting from the measurement.
                acc = (
                    jnp.sum(out[0], dtype=jnp.uint32)
                    + jnp.sum(out[2], dtype=jnp.uint32)
                ).astype(jnp.int32)
                return (
                    acc
                    + jnp.sum(out[1], dtype=jnp.int32)
                    + jnp.sum(out[3], dtype=jnp.int32)
                    + jnp.sum(out[4], dtype=jnp.int32)
                    + jnp.sum(out[5], dtype=jnp.int32)
                    + jnp.sum(out[6], dtype=jnp.int32)
                    + jnp.sum(out[7].astype(jnp.int32))
                    + jnp.sum(out[8].astype(jnp.int32))
                )

            return prod_body

        for label, cap in (
            ("production_kernel[segmented]", _frag_capacity(params)),
            ("production_kernel[globalsort]", 0),
        ):
            fn = repeat_in_jit(
                make_prod_body(cap),
                lambda c, a: c.at[0, 0].set((a % 256).astype(jnp.uint8)),
            )
            dt = timeit(label, fn, packed_codes, bases)
            log(f"{label} = {bases / dt / 1e6:.0f}M bases/s")

    if os.environ.get("GALAH_PROFILE_ALT"):
        fn = repeat_in_jit(
            lambda cb: jnp.sum(
                jax.vmap(sort_dedup_1key_one)(cfrag, cb), dtype=jnp.int32
            ),
            lambda cb, a: cb.at[0, 0].set(a % MEMBER_BITS),
        )
        timeit("sort_dedup_1key(SEL)", fn, cbucket, G * SEL)

        fn = repeat_in_jit(
            lambda mb: jnp.sum(
                jax.vmap(fused_sort_n_one)(fsel, frag, mb), dtype=jnp.int32
            ),
            lambda mb, a: mb.at[0, 0].set(a % MEMBER_BITS),
        )
        timeit("fused_sort_n(no compaction)", fn, mbucket, bases)

        fn = repeat_in_jit(
            lambda cb: jnp.sum(
                jax.vmap(bitmaps_small_one)(cb), dtype=jnp.int32
            ),
            lambda cb, a: cb.at[0, 0].set(a % MEMBER_BITS),
        )
        timeit("bitmaps_small(scatter SEL->bits)", fn, cbucket, G * SEL)

    log("done")


if __name__ == "__main__":
    main()
