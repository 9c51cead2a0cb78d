"""Benchmark: genome-pairs/s of the all-vs-all sketch screen on one
GPU, plus (stderr) the verify-stage kernels, the device sketcher and a
small end-to-end dereplication.

Prints ONE JSON line to stdout: {"metric", "value", "unit",
"vs_baseline", "device"} — the production screen tile. The other
benches report to stderr. The device (platform, device_kind, count) is
named on stderr and in the JSON line; with no GPU the bench exits
nonzero and prints no result.

Baseline note: the reference (galah) publishes no numbers (BASELINE.md);
its compute engine skani sweeps ~1e6 genome-pairs/s on a 32-core host
for triangle mode (order-of-magnitude from the skani paper's
50k-genomes-in-minutes claim; see BASELINE.md). vs_baseline is
pairs_per_s / 1e6 against that documented estimate.

Timing: each kernel's repeat loop runs INSIDE one jit (fori_loop with
an iteration-to-iteration data dependence — the previous result
perturbs one input element, so XLA cannot hoist or CSE the body) and
one scalar is fetched at the end, so the time is device time. Inputs
are generated on device. GALAH_BENCH=screen skips the stderr extras;
GALAH_BENCH=tilesweep times the screen tile at every edge (the rows
of ops/prefilter.py:_SCREEN_TILE_RATE).
"""

import json
import os
import sys
import time


def _log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


# --- per-kernel drift guard -------------------------------------------------
# Every kernel bench records its rate here; at the end each is compared
# against the checked-in expected-rate table for this device_kind
# (benchmarks/expected_rates.json) and any >1.5x deviation prints a
# loud DRIFT line on stderr.

_MEASURED: dict = {}


def _record(name: str, value: float) -> float:
    _MEASURED[name] = value
    return value


def check_drift(measured: dict, table: dict, log=_log) -> list:
    """Compare measured rates against the expected-rate table; returns
    the list of drifted metric names (and logs a DRIFT line for each).
    Table entries: {name: {"expect": rate, "factor": tolerance}};
    default tolerance factor 1.5 (flagged when measured < expect/f or
    > expect*f — an unexplained jump UP usually means the bench stopped
    measuring what it thinks it measures)."""
    drifted = []
    for name, spec in table.items():
        if name.startswith("_") or name not in measured:
            continue
        expect = float(spec["expect"])
        factor = float(spec.get("factor", 1.5))
        got = measured[name]
        if got <= 0 or expect <= 0:
            continue
        ratio = got / expect
        if ratio > factor or ratio < 1.0 / factor:
            drifted.append(name)
            log(
                f"DRIFT: {name} measured {got:.3g} vs expected "
                f"{expect:.3g} ({ratio:.2f}x, tolerance {factor:.2g}x) "
                "— investigate, then update "
                "benchmarks/expected_rates.json"
            )
    return drifted


def expected_rates(device_kind: str) -> dict:
    """The expected-rate table of one device_kind from
    benchmarks/expected_rates.json; a device missing there is an error
    (measure it with this bench, then add it)."""
    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "benchmarks",
        "expected_rates.json",
    )
    with open(path) as f:
        devices = json.load(f)["devices"]
    if device_kind not in devices:
        raise KeyError(
            f"no expected rates for device {device_kind!r} in {path}"
        )
    return devices[device_kind]


def _check_drift_from_file(device_kind: str) -> None:
    if not check_drift(_MEASURED, expected_rates(device_kind)):
        _log("drift check: all kernels within tolerance")


def e2e_device_estimate(counters: dict, measured: dict) -> dict:
    """Per-phase device-time estimate for the e2e run: the run's OWN
    deterministic work counters priced at the SAME run's in-jit kernel
    rates. Both inputs are immune to host noise (counters by
    construction, the rates by the repeat-in-jit methodology), so the
    guard on the summed estimate trips on real kernel slowdowns and
    pipeline-glue regressions while staying silent across wall-clock
    noise.
    Returns {phase: seconds} for the phases whose counter AND rate are
    both present."""
    out = {}
    for work, rate_name, phase in (
        ("screen_pairs_computed", "screen_production", "screen"),
        ("verify_directed_pairtable", "verify_pairtable", "verify"),
        ("verify_directed_grouped", "verify_grouped", "verify_large"),
        ("sketch_bases", "device_sketch", "sketch"),
    ):
        w = counters.get(work, 0.0)
        r = measured.get(rate_name, 0.0)
        if w and r:
            out[phase] = out.get(phase, 0.0) + w / r
    return out


def _small() -> bool:
    """GALAH_BENCH_SMALL=1 shrinks shapes for CPU smoke tests."""
    return bool(os.environ.get("GALAH_BENCH_SMALL"))


def _iters() -> int:
    return 3 if _small() else 10


def _repeat_in_jit(jax, jnp, body, perturb):
    """Return jitted fn running `body(x) -> f32 scalar` _iters() times
    with a data dependence between iterations: `perturb(x, bit)` folds
    the previous result's low bit back into the input so XLA cannot
    hoist or CSE the body out of the loop. One dispatch, one scalar."""
    return _repeat_in_jit_args(jax, jnp, body, perturb)


def _time_reps(fn, x, name):
    """Compile+warmup, then time one repeated-body dispatch; returns
    seconds per body iteration."""
    return _time_reps_args(fn, (x,), name)


def _repeat_in_jit_args(jax, jnp, body, perturb):
    """_repeat_in_jit for bodies with extra operands passed as jit
    ARGUMENTS. A closure would bake the operands into the HLO as
    literals — at verify shapes that is >100MB of constants, which
    multiplies compile time."""

    @jax.jit
    def run(x, *extras):
        def step(i, acc):
            return acc + body(perturb(x, acc % 2.0), *extras)

        return jax.lax.fori_loop(0, _iters(), step, jnp.float32(0.0))

    return run


def _time_reps_args(fn, args, name):
    """_time_reps over a tuple of positional operands."""
    t0 = time.perf_counter()
    float(fn(*args))
    _log(f"{name} compile+warmup {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    float(fn(*args))
    return (time.perf_counter() - t0) / _iters()


def bench_screen_matmul(jax, jnp, dtname=None):
    """Kernel-only matmul screen at production shape, in the screen's
    default matmul dtype (int8 on the GPU, exact for 0/1 counts;
    GALAH_TPU_SCREEN_DTYPE / the dtname arg override)."""
    N = 512 if _small() else 8192
    B = 1 << (12 if _small() else 17)
    K = 15

    if dtname is None:
        from galah_tpu.ops.prefilter import _screen_dtype_name

        dtname = _screen_dtype_name()
    dtype = {"int8": jnp.int8, "bf16": jnp.bfloat16, "f32": jnp.float32}[
        dtname
    ]
    acc = jnp.int32 if dtname == "int8" else jnp.float32

    @jax.jit
    def make_inputs(key):
        x = jax.random.bernoulli(key, 0.1, (N, B)).astype(dtype)
        sizes = jnp.sum(x.astype(jnp.float32), axis=1)
        return x, sizes

    t_setup = time.perf_counter()
    x, sizes = make_inputs(jax.random.PRNGKey(0))
    x.block_until_ready()
    _log(f"screen inputs ready in {time.perf_counter() - t_setup:.1f}s")

    def screen(xs):
        counts = jax.lax.dot_general(
            xs,
            xs,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=acc,
        ).astype(jnp.float32)
        a = sizes[:, None]
        b = sizes[None, :]
        bits_f = float(B)
        c1 = jnp.maximum(counts - a * b / bits_f, 0.0)
        c = jnp.maximum(counts - (a - c1) * (b - c1) / bits_f, 0.0)
        cont = jnp.minimum(c / jnp.maximum(jnp.minimum(a, b), 1.0), 1.0)
        ani = jnp.power(jnp.maximum(cont, 1e-30), 1.0 / K) * 100.0
        # sparse-extraction proxy: count of above-threshold pairs
        return jnp.sum(ani >= 85.0).astype(jnp.float32)

    run = _repeat_in_jit(
        jax, jnp, screen, lambda xs, bit: xs.at[0, 0].set(bit.astype(dtype))
    )
    dt = _time_reps(run, x, f"screen[{dtname}]")
    pairs_per_s = _record(f"screen_matmul_{dtname}", N * (N - 1) / 2 / dt)
    _log(
        f"screen_matmul[{dtname}]: {pairs_per_s/1e6:.1f}M pairs/s "
        f"({dt*1e3:.0f}ms/sweep)"
    )
    return pairs_per_s


def bench_screen_production(jax, jnp, block=None, record_name=None):
    """HEADLINE: the PRODUCTION screen tile — resident packed matrix ->
    dynamic tile slice -> unpack + int8 matrix product -> collision
    correction -> sparse extraction.
    This is everything a real sweep pays per off-diagonal tile, and
    every pair it computes is a useful pair, so block^2/dt is the
    sweep's genome-pairs/s. bench_screen_matmul isolates the
    matmul+epilogue on pre-materialized operands for the kernel-only
    record. block overrides the tile edge (the _SCREEN_TILE_RATE
    staleness sweep measures every table edge this way)."""
    from galah_tpu.ops.prefilter import (
        _resident_screen_extract,
        _screen_dtype_name,
    )

    from galah_tpu.ops.prefilter import _screen_block_for, _screen_cap_for

    B = 1 << (12 if _small() else 17)
    W = B // 32
    BLOCK = block or (512 if _small() else _screen_block_for(1 << 20))
    N_PAD = 2 * BLOCK  # one full off-diagonal (BLOCK x BLOCK) tile
    CAP = 1024 if _small() and not block else _screen_cap_for(BLOCK)
    dtn = _screen_dtype_name()

    @jax.jit
    def mk(key):
        x = jax.random.randint(
            key, (N_PAD, W), 0, 2**31 - 1, jnp.int32
        ).astype(jnp.uint32)
        return x, jnp.full((N_PAD,), B * 0.1, jnp.float32)

    x, s = mk(jax.random.PRNGKey(5))
    x.block_until_ready()
    nblk = max(2, N_PAD // BLOCK)
    tiles = tuple(
        (bi, bi + 1) for bi in range(0, nblk - 1, 2)
    ) or ((0, 1),)

    def body(xx):
        acc = jnp.float32(0.0)
        for bi, bj in tiles:
            cnt, ii, jj, vals = _resident_screen_extract(
                xx, s, jnp.int32(bi), jnp.int32(bj),
                jnp.float32(B), jnp.float32(0.9),
                block=BLOCK, cap=CAP, is_diag=False, dtname=dtn,
            )
            acc = (
                acc + cnt.astype(jnp.float32)
                + jnp.sum(ii).astype(jnp.float32)
                + jnp.sum(jj).astype(jnp.float32)
                + jnp.sum(vals).astype(jnp.float32)
            )
        return acc

    run = _repeat_in_jit(
        jax, jnp, body,
        lambda xx, bit: xx.at[0, 0].set(bit.astype(jnp.uint32)),
    )
    dt = _time_reps(run, x, "screen_production") / len(tiles)
    pairs_per_s = _record(
        record_name or "screen_production", BLOCK * BLOCK / dt
    )
    _log(
        f"screen_production[{dtn},block={BLOCK}]: "
        f"{pairs_per_s/1e6:.1f}M pairs/s "
        f"({dt*1e3:.2f}ms/tile incl. unpack + sparse extraction)"
    )
    # Model-vs-measured: the block chooser's cost model rides on the
    # _SCREEN_TILE_RATE table; print the deviation so staleness is
    # visible in every run.
    from galah_tpu.ops.prefilter import _tile_rates

    model = _tile_rates().get(BLOCK) if not _small() else None
    if model:
        _log(
            f"screen tile model check: table[{BLOCK}]={model/1e6:.0f}M "
            f"measured={pairs_per_s/1e6:.0f}M "
            f"({pairs_per_s/model*100:.0f}% of model)"
        )
    return pairs_per_s


TILE_EDGES = (1024, 2048, 4096, 8192)


def bench_tile_rate_sweep(jax, jnp):
    """Time the production tile at every edge in TILE_EDGES and print
    the measured row for ops/prefilter.py:_SCREEN_TILE_RATE beside the
    row in the table (GALAH_BENCH=tilesweep; each edge compiles its own
    program). Refresh the table when any edge is >10% off."""
    from galah_tpu.ops.prefilter import _SCREEN_TILE_RATE

    kind = jax.devices()[0].device_kind
    table = _SCREEN_TILE_RATE.get(kind, {})
    row = {}
    for edge in TILE_EDGES:
        row[edge] = bench_screen_production(
            jax, jnp, block=edge, record_name=f"screen_production_{edge}"
        )
        model = table.get(edge)
        _log(
            f"tile-rate sweep: edge {edge} "
            + (f"table={model/1e6:.0f}M " if model else "table=none ")
            + f"measured={row[edge]/1e6:.0f}M"
        )
    _log(f"tile-rate sweep: measured row for {kind!r}: "
         + json.dumps({e: float(f"{r:.4g}") for e, r in row.items()}))
    return row


def bench_verify_grouped(jax, jnp):
    """Verify stage, grouped one-query-many-refs kernel: directed
    pairs/s at a realistic MAG shape (3Mb genome -> ~375k fragment
    hashes) at the dispatch width production actually picks for this
    stream (the max_refs_per_dispatch cap chunked down by the
    256M-element intermediate budget — 512 at 375k hashes; the
    per-index gather cost amortizes across the ref axis)."""
    from galah_tpu.ops.fragment_ani import FragmentAniConfig, _forward_kernel

    MEMBER_BITS = 1 << (16 if _small() else 22)
    W = MEMBER_BITS // 32
    NHASH = 10_000 if _small() else 375_000
    NPAD = ((NHASH + (1 << 14) - 1) >> 14) << 14
    F = 1024  # ~3Mb / 3kb fragments
    K = 15
    if _small():
        R = 8
    else:
        # The width production picks (shared formula).
        from galah_tpu.ops.fragment_ani import refs_per_dispatch

        R = refs_per_dispatch(
            NPAD, FragmentAniConfig().max_refs_per_dispatch
        )

    @jax.jit
    def make_inputs(key):
        k1, k2 = jax.random.split(key)
        bitmaps = jax.random.randint(
            k1, (R, W), 0, 2**31 - 1, dtype=jnp.int32
        ).astype(jnp.uint32)
        popcounts = jnp.full((R,), MEMBER_BITS * 0.25, jnp.float32)
        buckets = jax.random.randint(k2, (NPAD,), 0, MEMBER_BITS, dtype=jnp.int32)
        offsets = jnp.minimum(
            jnp.arange(F + 1, dtype=jnp.int32) * (NHASH // F), NHASH
        )
        return bitmaps, popcounts, buckets, offsets

    bitmaps, popcounts, buckets, offsets = make_inputs(jax.random.PRNGKey(2))
    bitmaps.block_until_ready()

    def body(b, bm, pc, off):
        ani, af = _forward_kernel(
            bm, pc, b, off, jnp.int32(NHASH),
            bits=MEMBER_BITS, k=K, min_hashes=8, min_ident=0.8,
        )
        # Sum every pair's result so XLA cannot narrow the computation
        # to ref 0 (measured ~18% inflation when consuming only [0]).
        return jnp.sum(ani) + jnp.sum(af)

    run = _repeat_in_jit_args(
        jax, jnp, body,
        lambda b, bit: b.at[0].set(
            jnp.minimum(b[0] + bit.astype(jnp.int32), MEMBER_BITS - 1)
        ),
    )
    dt = _time_reps_args(
        run, (buckets, bitmaps, popcounts, offsets), "verify"
    )
    pairs_per_s = _record("verify_grouped", R / dt)
    hashes_per_s = R * NHASH / dt
    _log(
        f"verify_grouped: {pairs_per_s:.0f} directed-pairs/s at "
        f"{NHASH//1000}k-hash streams x {R} refs/dispatch "
        f"({hashes_per_s/1e9:.2f}G hash-lookups/s, "
        f"{dt*1e3:.0f}ms/dispatch)"
    )
    return pairs_per_s


def bench_verify_grouped_bt(jax, jnp):
    """Verify stage, bit-transposed grouped kernel at the NARROW
    dispatch shape where it is the production auto-default (rpad <=
    64): bitmap lookups gather one (R//32)-word row per stream
    position from the bucket-major table (table build excluded: it is
    LRU-amortized across queries in production)."""
    from galah_tpu.ops.fragment_ani import (
        _bit_transpose_table,
        _forward_kernel_bt,
    )

    R = 32 if _small() else 64
    MEMBER_BITS = 1 << (16 if _small() else 22)
    W = MEMBER_BITS // 32
    NHASH = 10_000 if _small() else 375_000
    NPAD = ((NHASH + (1 << 14) - 1) >> 14) << 14
    F = 1024
    K = 15

    @jax.jit
    def make_inputs(key):
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
        return _bit_transpose_table(bitmaps), popcounts, buckets, offsets

    table, popcounts, buckets, offsets = make_inputs(jax.random.PRNGKey(4))
    table.block_until_ready()

    def body(b, tb, pc, off):
        ani, af = _forward_kernel_bt(
            tb, pc, b, off, jnp.int32(NHASH),
            bits=MEMBER_BITS, k=K, min_hashes=8, min_ident=0.8,
        )
        return jnp.sum(ani) + jnp.sum(af)

    run = _repeat_in_jit_args(
        jax, jnp, body,
        lambda b, bit: b.at[0].set(
            jnp.minimum(b[0] + bit.astype(jnp.int32), MEMBER_BITS - 1)
        ),
    )
    dt = _time_reps_args(
        run, (buckets, table, popcounts, offsets), "verify_bt"
    )
    pairs_per_s = _record("verify_grouped_bt", R / dt)
    hashes_per_s = R * NHASH / dt
    _log(
        f"verify_grouped_bt: {pairs_per_s:.0f} directed-pairs/s at "
        f"{NHASH//1000}k-hash streams ({hashes_per_s/1e9:.2f}G "
        f"bit-lookups/s, {dt*1e3:.0f}ms/dispatch)"
    )
    return pairs_per_s


def bench_verify_pairtable(jax, jnp):
    """Verify stage, pair-table kernel: directed small-contig pairs/s
    in one fixed-shape dispatch."""
    import numpy as np

    from galah_tpu.ops.pair_table import _pair_table_kernel, PairTableConfig

    cfg = PairTableConfig(
        member_bits=1 << 16, k=15, min_fragment_hashes=8,
        min_fragment_identity=0.8,
    )
    W = cfg.member_bits // 32
    P = cfg.max_pairs           # 4096 directed pairs
    HASHES_PER_SRC = 512        # ~4kb contig at fragment scale 8
    FRAGS_PER_SRC = 16
    NSRC = min(cfg.max_bitmaps, 256)
    uh = NSRC * HASHES_PER_SRC
    uf = NSRC * FRAGS_PER_SRC

    rng = np.random.default_rng(0)
    ustream = np.zeros(cfg.max_unique_hashes, np.int32)
    ustream[:uh] = rng.integers(0, cfg.member_bits, uh)
    ufrag_offsets = np.full(cfg.max_unique_frags + 1, uh, np.int32)
    ufrag_offsets[: uf + 1] = np.arange(uf + 1) * (HASHES_PER_SRC // FRAGS_PER_SRC)
    pair_src = rng.integers(0, NSRC, P)
    pair_ref = rng.integers(0, NSRC, P).astype(np.int32)
    pair_src_start = (pair_src * HASHES_PER_SRC).astype(np.int32)
    pair_ufrag_start = (pair_src * FRAGS_PER_SRC).astype(np.int32)
    flat_start = np.arange(P + 1, dtype=np.int32) * HASHES_PER_SRC
    fragflat_start = np.arange(P + 1, dtype=np.int32) * FRAGS_PER_SRC
    n_flat = P * HASHES_PER_SRC
    n_flat_frags = P * FRAGS_PER_SRC
    assert n_flat <= cfg.max_flat_hashes and n_flat_frags <= cfg.max_flat_frags

    import jax.numpy as jnp2

    bitmaps = jnp2.asarray(
        rng.integers(0, 2**32, (cfg.max_bitmaps, W), dtype=np.uint32)
    )
    popcounts = jnp2.full((cfg.max_bitmaps,), cfg.member_bits * 0.25, jnp2.float32)
    args = [
        jnp2.asarray(ustream), jnp2.asarray(ufrag_offsets), bitmaps, popcounts,
        jnp2.asarray(pair_src_start), jnp2.asarray(flat_start),
        jnp2.asarray(pair_ufrag_start), jnp2.asarray(fragflat_start),
        jnp2.asarray(pair_ref), jnp2.asarray(pair_ref),
        jnp2.int32(n_flat), jnp2.int32(n_flat_frags),
    ]

    # The PRODUCTION domain shapes for this fill (shared formula) — the
    # bench must measure exactly what a real dispatch compiles.
    # A bench passing the (raised, 2^23) cap while production bucketed
    # the domain to the 2^21 fill once paid 4x the iota/cumsum work of
    # any real dispatch and read as a 3.4x kernel regression.
    from galah_tpu.ops.pair_table import flat_domain_shapes

    flatn, flatf = flat_domain_shapes(n_flat, n_flat_frags, cfg)

    def body(us):
        ani, af = _pair_table_kernel(
            us, *args[1:], flatn=flatn, flatf=flatf,
            bits=cfg.member_bits, k=cfg.k,
            min_hashes=cfg.min_fragment_hashes,
            min_ident=cfg.min_fragment_identity,
        )
        return jnp.sum(ani) + jnp.sum(af)  # keep every pair live

    run = _repeat_in_jit(
        jax, jnp2, body,
        lambda us, bit: us.at[0].set(
            jnp2.minimum(us[0] + bit.astype(jnp2.int32), cfg.member_bits - 1)
        ),
    )
    dt = _time_reps(run, args[0], "pairtable")
    pairs_per_s = _record("verify_pairtable", P / dt)
    _log(
        f"verify_pairtable: {pairs_per_s/1e3:.1f}K directed-pairs/s "
        f"(contig shape, {dt*1e3:.0f}ms/dispatch)"
    )
    return pairs_per_s


def bench_device_sketch(jax, jnp):
    """On-device FracMinHash sketching: bases/s through the production
    batch kernel (ops/device_sketch.py) at a 32 x 1Mb-genome shape."""
    import numpy as np

    from galah_tpu.ops.device_sketch import (
        _default_frag_cap,
        _default_routed,
        _psel_capacity,
        _sel_capacity,
        _sketch_batch_kernel,
        _sketch_sort_scan,
    )
    from galah_tpu.sketch.fracminhash import NativeSketchParams

    G = 4 if _small() else 32
    P = 1 << (16 if _small() else 20)  # padded genome length
    params = NativeSketchParams()
    frag_len = params.fragment_length
    nfrag = P // frag_len
    NB = 1 << int(nfrag + 1).bit_length()
    SEL = _sel_capacity(P - params.k + 1, params)  # production sizing

    bounds_np = np.full((G, NB), P, np.int32)
    bin2frag_np = np.full((G, NB), -1, np.int32)
    bounds_np[:, :nfrag + 1] = np.arange(nfrag + 1, dtype=np.int32) * frag_len
    bin2frag_np[:, :nfrag] = np.arange(nfrag, dtype=np.int32)

    @jax.jit
    def make_codes(key):
        # 2-bit packed bases (4/byte), the kernel's wire format.
        return jax.random.randint(
            key, (G, P // 4), 0, 256, dtype=jnp.int32
        ).astype(jnp.uint8)

    codes = make_codes(jax.random.PRNGKey(3))
    codes.block_until_ready()
    bounds = jnp.asarray(bounds_np)
    bin2frag = jnp.asarray(bin2frag_np)
    inv_idx = jnp.full((G, 1), P, jnp.int32)
    lengths = jnp.full((G,), P, jnp.int32)

    routed = _default_routed()  # the production formulation

    # The fixed operands are jit ARGUMENTS: closed over, XLA would
    # constant-fold through them for about a minute at compile time.
    def body(c, inv_idx, lengths, bounds, bin2frag):
        out = _sketch_batch_kernel(
            c, inv_idx, lengths, bounds, bin2frag,
            k=params.k, member_bits=params.member_bits,
            prefilter_bits=params.prefilter_bits,
            gthresh=int(params.genome_threshold),
            fthresh=int(params.fragment_threshold),
            max_frags=nfrag, max_sel=SEL,
            routed=routed,
            max_psel=_psel_capacity(P - params.k + 1, params),
            frag_cap=0 if routed else _default_frag_cap(params),
            sort_scan=routed and _sketch_sort_scan(),
        )
        # Consume EVERY output (pref/member words, flat, offsets,
        # counters, both overflow flags): summing only one would let
        # XLA dead-code-eliminate the dedup sort, bitmap packing, or
        # the segmented path's per-fragment counting.
        acc = (
            jnp.sum(out[0], dtype=jnp.uint32)
            + jnp.sum(out[2], dtype=jnp.uint32)
        ).astype(jnp.int32)
        acc = (
            acc
            + jnp.sum(out[1], dtype=jnp.int32)
            + jnp.sum(out[3], dtype=jnp.int32)
            + jnp.sum(out[4], dtype=jnp.int32)
            + jnp.sum(out[5], dtype=jnp.int32)
            + jnp.sum(out[6], dtype=jnp.int32)
            + jnp.sum(out[7].astype(jnp.int32))
            + jnp.sum(out[8].astype(jnp.int32))
        )
        return acc.astype(jnp.float32)

    run = _repeat_in_jit_args(
        jax, jnp, body,
        lambda c, bit: c.at[0, 0].set(bit.astype(jnp.uint8)),
    )
    dt = _time_reps_args(
        run, (codes, inv_idx, lengths, bounds, bin2frag), "device_sketch"
    )
    bases_per_s = _record("device_sketch", G * P / dt)
    _log(
        f"device_sketch[{'routed' if routed else 'scatter'}]: "
        f"{bases_per_s/1e6:.0f}M bases/s "
        f"({G}x{P>>20 or 1}Mb, {dt*1e3:.0f}ms/batch)"
    )
    return bases_per_s


def bench_e2e(jax, jnp):
    """Pipeline-level drift canary: a small synthetic dereplication
    (sketch -> screen -> cluster -> verify -> outputs) through the real
    CLI, one stderr line with wall + phase split + exact-recovery flag.
    The stdout JSON stays a kernel number (stable, compute-bound); this
    line makes end-to-end regressions visible without waiting for the
    manually-run scale benches."""
    import json as _json
    import shutil
    import tempfile

    from galah_tpu.cli.main import main as cli_main
    from galah_tpu.utils.synth import make_families

    genomes, families, length = (16, 4, 50_000) if _small() else (
        256, 32, 500_000
    )
    corpus = tempfile.mkdtemp(prefix="galah-bench-e2e-")
    td = tempfile.mkdtemp(prefix="galah-bench-e2e-out-")
    try:
        t0 = time.perf_counter()
        make_families(
            corpus, n_families=families,
            members_per_family=genomes // families,
            genome_length=length, within_ani=0.98, seed=11,
        )
        gen_s = time.perf_counter() - t0
        clusters_tsv = os.path.join(td, "clusters.tsv")
        metrics_json = os.path.join(td, "metrics.json")
        t0 = time.perf_counter()
        rc = cli_main([
            "cluster", "-d", corpus, "-x", "fna", "--ani", "95",
            "--output-cluster-definition", clusters_tsv,
            "--metrics-json", metrics_json, "-q",
        ])
        wall = time.perf_counter() - t0
        if rc != 0:
            _log(f"e2e: cluster exited {rc}")
            return 0.0
        reps = {}
        with open(clusters_tsv) as f:
            for line in f:
                rep, member = line.rstrip("\n").split("\t")
                reps[member] = rep
        fams = {}
        for m, r in reps.items():
            fams.setdefault(os.path.basename(m).split("_")[0], set()).add(r)
        exact = (
            len(set(reps.values())) == families
            and all(len(r) == 1 for r in fams.values())
        )
        with open(metrics_json) as f:
            mj = _json.load(f)
        phases = mj.get("phases_s", {})
        counters = mj.get("counters", {})
        phase_str = " ".join(
            f"{k}={v:.1f}s" for k, v in sorted(phases.items())
        )
        rate = _record("e2e_pairs_per_s", genomes * (genomes - 1) / 2 / wall)
        _log(
            f"e2e: {genomes}x{length//1000}kb derep {wall:.1f}s wall "
            f"({rate/1e3:.1f}K pairs/s e2e; gen {gen_s:.1f}s; "
            f"{phase_str}) families_exact={exact}"
        )
        # Noise-immune guard inputs: the e2e drift guard additionally
        # pins (a) deterministic pipeline-shape counters (dispatches /
        # pairs computed / directed verifies — a glue regression like
        # lost adoption or a broken tile scheduler moves these even
        # when wall-clock noise hides the cost) and (b) a device-time
        # estimate: the SAME work priced at THIS run's in-jit kernel
        # rates, so a real kernel slowdown moves it 1:1 while host
        # noise does not.
        for nm in (
            "screen_dispatch_rpcs",
            "screen_pairs_computed",
            "verify_directed_pairtable",
            "verify_directed_grouped",
        ):
            if nm in counters:
                _record(f"e2e_{nm}", counters[nm])
        dev_s = e2e_device_estimate(counters, _MEASURED)
        if dev_s:
            total_dev = sum(dev_s.values())
            _record("e2e_device_estimate_s", total_dev)
            _log(
                "e2e device-time estimate (work x this run's kernel "
                f"rates): {total_dev:.2f}s — "
                + " ".join(f"{k}={v:.2f}s" for k, v in sorted(dev_s.items()))
                + "; counters: "
                + " ".join(
                    f"{k}={counters[k]:.0f}" for k in (
                        "screen_dispatch_rpcs", "screen_pairs_computed",
                        "verify_directed_pairtable",
                        "verify_directed_grouped", "sketch_bases",
                    ) if k in counters
                )
            )
        return rate
    finally:
        shutil.rmtree(corpus, ignore_errors=True)
        shutil.rmtree(td, ignore_errors=True)


def main() -> None:
    import galah_tpu  # noqa: F401  (applies the numpy allocator tuning)
    import jax
    import jax.numpy as jnp

    from galah_tpu.utils.platform import enable_compile_cache, require_gpu

    dev = require_gpu()
    enable_compile_cache()
    device = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    _log(f"device={json.dumps(device)}")
    which = os.environ.get("GALAH_BENCH", "all")

    if which == "tilesweep":
        # Per-edge _SCREEN_TILE_RATE sweep; still prints the required
        # single JSON line (the 8192 edge's rate).
        row = bench_tile_rate_sweep(jax, jnp)
        chosen = row[max(row)]
        print(json.dumps({
            "metric": "screen_genome_pairs_per_s",
            "value": round(chosen, 1),
            "unit": "pairs/s",
            "vs_baseline": round(chosen / 1e6, 3),
            "device": device,
        }))
        return

    # Headline = the PRODUCTION tile rate (packed input, unpack +
    # matmul, extraction — what a real sweep achieves), not the
    # idealized pre-unpacked matmul (bench_screen_matmul, kept below
    # for the kernel-only record).
    pairs_per_s = bench_screen_production(jax, jnp)

    if which != "screen":
        for name, fn in (
            ("screen_matmul_only", bench_screen_matmul),
            # The other matmul dtype, for the shoot-out record (the
            # headline above runs the production default).
            ("screen_alt_dtype", lambda jx, jn: bench_screen_matmul(
                jx, jn, dtname="bf16",
            )),
            ("verify_grouped", bench_verify_grouped),
            ("verify_grouped_bt", bench_verify_grouped_bt),
            ("verify_pairtable", bench_verify_pairtable),
            ("device_sketch", bench_device_sketch),
            ("e2e", bench_e2e),
        ):
            try:
                fn(jax, jnp)
            except Exception as e:  # extras never break the headline
                _log(f"{name} bench failed: {e!r}")

    if not _small():
        _check_drift_from_file(dev.device_kind)

    baseline_pairs_per_s = 1e6  # 32-core skani triangle, documented estimate
    print(
        json.dumps(
            {
                "metric": "screen_genome_pairs_per_s",
                "value": round(pairs_per_s, 1),
                "unit": "pairs/s",
                "vs_baseline": round(pairs_per_s / baseline_pairs_per_s, 3),
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
