"""All-vs-all sketch-intersection screen.

The reference's O(n^2) sketch-distance pass happens inside `skani
triangle` or finch's dense loop (src/finch.rs:75-95). Here it is an
matrix product: genome sketches become 0/1 bucket-indicator
rows, and pairwise intersection counts are a blocked matmul
S_i @ S_j^T with f32 accumulation (exact for counts < 2^24). Bucket
collisions are corrected analytically before converting the max
containment c/min(|A|,|B|) to an ANI estimate cont**(1/k).

Single-device blocked sweep here; the multi-host sharded sweep built on
the same block kernel lives in galah_tpu.parallel.
"""

from __future__ import annotations

import logging
import math
from collections import deque
from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class ScreenResult:
    """Above-cutoff candidate pairs with containment-ANI estimates."""

    pairs: np.ndarray      # (P, 2) int64 — indices (i < j for triangle mode)
    ani_est: np.ndarray    # (P,) float32 — percentage scale


def pack_indicator(buckets: np.ndarray, bits: int) -> np.ndarray:
    """Sorted distinct bucket indices -> (bits/32,) uint32 bitmap, bit
    (bucket & 31) of word (bucket >> 5)."""
    words = np.zeros(bits // 32, dtype=np.uint32)
    np.bitwise_or.at(
        words, buckets >> 5, np.uint32(1) << (buckets & 31).astype(np.uint32)
    )
    return words


def _unpack_bits(x_packed: jax.Array, dt) -> jax.Array:
    """(n, W) uint32 packed bitmap -> (n, W*32) 0/1 in dtype dt,
    word-major bit-minor (the inverse of pack_indicator)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    bits = (x_packed[:, :, None] >> shifts) & jnp.uint32(1)
    return bits.astype(dt).reshape(x_packed.shape[0], -1)


# bits_f/min_cont are TRACED (not static): every distinct threshold or
# sketch width would otherwise recompile the kernel.
@partial(
    jax.jit,
    static_argnames=("block", "cap", "is_diag", "dtname", "direct"),
)
def _resident_screen_extract(
    x_all: jax.Array,   # (n_pad, W) uint32 — full packed matrix, resident
    sizes: jax.Array,   # (n_pad,) f32
    bi: jax.Array,      # () int32 block row index
    bj: jax.Array,      # () int32 block col index
    bits_f: jax.Array,   # () f32 — traced
    min_cont: jax.Array,  # () f32 — traced
    *,
    block: int,
    cap: int,
    is_diag: bool,
    dtname: str,
    direct: bool = False,
):
    """Screen one (block x block) tile out of the resident packed
    matrix (uploaded once for the whole sweep) with on-device sparse
    extraction (direct=True forces the plain-nonzero extraction — the
    drain's re-dispatch for row-overflowing tiles)."""
    w = x_all.shape[1]
    si = jax.lax.dynamic_slice(x_all, (bi * block, 0), (block, w))
    sj = jax.lax.dynamic_slice(x_all, (bj * block, 0), (block, w))
    a = jax.lax.dynamic_slice(sizes, (bi * block,), (block,))
    b = jax.lax.dynamic_slice(sizes, (bj * block,), (block,))
    counts = _screen_counts_packed(si, sj, dtname)
    cont = _containment(counts, a, b, bits_f)
    mask = cont >= min_cont
    if is_diag:
        rows_i = jax.lax.broadcasted_iota(jnp.int32, (block, block), 0)
        cols_j = jax.lax.broadcasted_iota(jnp.int32, (block, block), 1)
        mask = mask & (cols_j > rows_i)
    cnt, ii, jj, vals = _extract_above_cutoff(cont, mask, cap, direct)
    return cnt, ii, jj, vals.astype(jnp.bfloat16)


@partial(
    jax.jit,
    static_argnames=("block", "cap", "is_diag", "dtname"),
)
def _resident_screen_extract_group(
    x_all, sizes, desc, *,
    block: int, cap: int, is_diag: bool, dtname: str,
):
    """K tiles of the resident sweep in ONE dispatch (lax.map over the
    (bi, bj) lists), compacted into ONE packed int32 result buffer.
    Grouping divides the dispatch and fetch count by K; the compaction
    divides the result-fetch bytes by ~K*10/6 more (the K*(cap,)
    per-tile buffers are typically <1% full — survivors concatenate
    into a single (cap,) region via a monotone searchsorted gather, so
    the fetch is one buffer of K + cap + cap/2 int32 words instead of
    4K buffers of cap words).

    Layout: [cnts (K,) int32 | codes (cap,) int32 = ii*block + jj |
    vals (cap/2,) int32 = two bf16 bit patterns per word]. Per-tile
    survivor order (row-major) is preserved, so decoding is
    bit-identical to per-tile dispatches. Tiles whose cnt is the
    row-overflow marker (<0) or exceeds cap contribute zero entries
    (the drain re-extracts/denses them — same contract as single
    tiles); if the group's total survivors exceed cap the host
    re-dispatches the tiles singly (detectable from the cnts alone).

    desc is ONE packed int32 upload per dispatch: [bis (K,) | bjs (K,) | bits f32 bits |
    min_cont f32 bits | nreal]. Tiles past nreal are remainder padding
    (repeats of the first tile); they are excluded from the compaction
    and the cap accounting so a full remainder tile can't spuriously
    overflow the group."""
    k_grp = (desc.shape[0] - 3) // 2
    bis = desc[:k_grp]
    bjs = desc[k_grp : 2 * k_grp]
    bits_f = jax.lax.bitcast_convert_type(desc[2 * k_grp], jnp.float32)
    min_cont = jax.lax.bitcast_convert_type(
        desc[2 * k_grp + 1], jnp.float32
    )
    nreal = desc[2 * k_grp + 2]
    cnts, iis, jjs, vss = jax.lax.map(
        lambda t: _resident_screen_extract(
            x_all, sizes, t[0], t[1], bits_f, min_cont,
            block=block, cap=cap, is_diag=is_diag, dtname=dtname,
        ),
        (bis, bjs),
    )
    k_tiles = cnts.shape[0]
    cnts = cnts.astype(jnp.int32)
    real = jnp.arange(k_tiles, dtype=jnp.int32) < nreal
    valid = jnp.where(real & (cnts >= 0) & (cnts <= cap), cnts, 0)
    off = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(valid, dtype=jnp.int32)]
    )
    total = off[-1]
    d = jnp.arange(cap, dtype=jnp.int32)
    t_of = jnp.clip(
        jnp.searchsorted(off, d, side="right").astype(jnp.int32) - 1,
        0, k_tiles - 1,
    )
    src = jnp.clip(t_of * cap + (d - off[t_of]), 0, k_tiles * cap - 1)
    ok = d < jnp.minimum(total, cap)
    codes = jnp.where(
        ok,
        iis.reshape(-1)[src] * block + jjs.reshape(-1)[src],
        0,
    ).astype(jnp.int32)
    v16 = jax.lax.bitcast_convert_type(
        vss.reshape(-1)[src], jnp.uint16
    ).astype(jnp.uint32)
    v16 = jnp.where(ok, v16, 0)
    vals_pk = jax.lax.bitcast_convert_type(
        v16[0::2] | (v16[1::2] << 16), jnp.int32
    )
    return jnp.concatenate([cnts, codes, vals_pk])


def _screen_group_desc(bis, bjs, bits_f: float, min_cont_f: float,
                       nreal: int):
    """One packed int32 upload for a tile group (see
    _resident_screen_extract_group's desc layout)."""
    scal = np.array([bits_f, min_cont_f], np.float32).view(np.int32)
    return np.concatenate([
        np.asarray(bis, np.int32), np.asarray(bjs, np.int32), scal,
        np.array([nreal], np.int32),
    ])


def _decode_group_result(buf: np.ndarray, k_tiles: int, cap: int,
                         block: int, nreal: int):
    """Host-side decode of _resident_screen_extract_group's packed
    buffer. Returns (cnts, per_tile) where per_tile is a list of
    (cnt, ii, jj, vals) ready for _drain_tile — or (cnts, None) when
    the group's survivors overflowed the shared cap region and the
    caller must re-dispatch the tiles singly. Padded tiles (index >=
    nreal) contribute nothing, mirroring the kernel."""
    import ml_dtypes

    cnts = buf[:k_tiles]
    valid = np.where((cnts >= 0) & (cnts <= cap), cnts, 0)
    valid[nreal:] = 0
    if int(valid.sum()) > cap:
        return cnts, None
    codes = buf[k_tiles : k_tiles + cap]
    vp = buf[k_tiles + cap :].view(np.uint32)
    v16 = np.empty(cap, np.uint16)
    v16[0::2] = (vp & 0xFFFF).astype(np.uint16)
    v16[1::2] = (vp >> 16).astype(np.uint16)
    vals = v16.view(ml_dtypes.bfloat16)
    per_tile = []
    off = 0
    for t in range(k_tiles):
        v = int(valid[t])
        per_tile.append((
            int(cnts[t]),
            (codes[off : off + v] // block).astype(np.int32),
            (codes[off : off + v] % block).astype(np.int32),
            vals[off : off + v],
        ))
        off += v
    return cnts, per_tile


def _screen_tile_group() -> int:
    """Tiles per resident-screen dispatch. >1 amortizes per-dispatch
    and per-fetch cost; 1 keeps per-tile dispatches (CPU default:
    lax.map would serialize what XLA:CPU parallelizes across calls).
    With the compacted group fetch the result bytes are flat in K, so
    K trades device serialization and group-overflow probability
    against dispatch count; the GPU's value is measured end to end in
    PERF.md. GALAH_TPU_SCREEN_TILE_GROUP overrides."""
    import os

    env = os.environ.get("GALAH_TPU_SCREEN_TILE_GROUP")
    if env:
        return max(1, int(env))
    from galah_tpu.utils.platform import backend_default

    return backend_default(cpu=1, gpu=16)


@partial(jax.jit, static_argnames=("cap", "is_diag", "dtname"))
def _block_screen_extract_packed(
    si_pk: jax.Array,
    sj_pk: jax.Array,
    a: jax.Array,
    b: jax.Array,
    bits_f: jax.Array,   # () f32 — traced (see note above)
    min_cont: jax.Array,  # () f32 — traced
    *,
    cap: int,
    is_diag: bool,
    dtname: str,
):
    """Fused screen block with ON-DEVICE sparse extraction: only the
    above-cutoff entries (bounded by `cap`) come back to the host —
    candidate counts are tiny relative to the n^2 sweep, so this cuts
    device->host traffic by orders of magnitude. Returns
    (count, rows (cap,), cols (cap,), cont_vals (cap,) bf16); if count
    exceeds cap the caller falls back to a dense pull for the block."""
    counts = _screen_counts_packed(si_pk, sj_pk, dtname)
    cont = _containment(counts, a, b, bits_f)
    mask = cont >= min_cont
    if is_diag:
        bi, bj = cont.shape
        rows_i = jax.lax.broadcasted_iota(jnp.int32, (bi, bj), 0)
        cols_j = jax.lax.broadcasted_iota(jnp.int32, (bi, bj), 1)
        mask = mask & (cols_j > rows_i)
    cnt, ii, jj, vals = _extract_above_cutoff(cont, mask, cap)
    return cnt, ii, jj, vals.astype(jnp.bfloat16)


@partial(jax.jit, static_argnames=("cap", "is_diag", "dtname"))
def _block_screen_extract_u8(
    si_u8: jax.Array,
    sj_u8: jax.Array,
    a: jax.Array,
    b: jax.Array,
    bits_f: jax.Array,
    min_cont: jax.Array,
    *,
    cap: int,
    is_diag: bool,
    dtname: str,
):
    """_block_screen_extract_packed for uint8 indicator blocks (the CPU
    backend's wire format): on-device sparse extraction so the
    indicator sweep stops pulling dense block^2 tiles to host."""
    dt = _screen_dt(dtname)
    counts = _screen_matmul(si_u8.astype(dt), sj_u8.astype(dt))
    cont = _containment(counts, a, b, bits_f)
    mask = cont >= min_cont
    if is_diag:
        bi, bj = cont.shape
        rows_i = jax.lax.broadcasted_iota(jnp.int32, (bi, bj), 0)
        cols_j = jax.lax.broadcasted_iota(jnp.int32, (bi, bj), 1)
        mask = mask & (cols_j > rows_i)
    cnt, ii, jj, vals = _extract_above_cutoff(cont, mask, cap)
    return cnt, ii, jj, vals.astype(jnp.bfloat16)


@partial(jax.jit, static_argnames=("dtname",))
def _block_containment_u8(
    si_u8: jax.Array, sj_u8: jax.Array, a: jax.Array, b: jax.Array, bits_f,
    *, dtname: str,
) -> jax.Array:
    """Fused screen block: uint8 indicators in (cast to the matmul dtype
    on device), collision-corrected containment out as bf16."""
    dt = _screen_dt(dtname)
    counts = _screen_matmul(si_u8.astype(dt), sj_u8.astype(dt))
    return _containment(counts, a, b, bits_f).astype(jnp.bfloat16)


@partial(jax.jit, static_argnames=("dtname",))
def _block_containment_packed(
    si_pk: jax.Array, sj_pk: jax.Array, a: jax.Array, b: jax.Array, bits_f,
    *, dtname: str,
) -> jax.Array:
    """Fused screen block over packed uint32 bitmaps: 32x less
    host->device traffic than uint8 indicators; unpacked to the matmul
    dtype on device so a matrix product still does the counts."""
    counts = _screen_counts_packed(si_pk, sj_pk, dtname)
    return _containment(counts, a, b, bits_f).astype(jnp.bfloat16)


@jax.jit
def _containment(counts: jax.Array, a: jax.Array, b: jax.Array, bits_f: float):
    """Collision-corrected max containment.

    counts: (bi, bj); a: (bi,) sizes; b: (bj,) sizes.
    Two-step correction: E[c_obs] ~= c + (a-c)(b-c)/B.
    """
    a = a[:, None]
    b = b[None, :]
    c1 = jnp.maximum(counts - a * b / bits_f, 0.0)
    c = jnp.maximum(counts - (a - c1) * (b - c1) / bits_f, 0.0)
    denom = jnp.maximum(jnp.minimum(a, b), 1.0)
    return jnp.minimum(c / denom, 1.0)


# Production-tile rates (pairs computed/s) per tile edge, keyed by
# jax device_kind: packed unpack + int8 dot + collision correction +
# extraction at 2^17 bits, timed by bench.py (GALAH_BENCH=tilesweep —
# rerun it after any kernel change). Bigger tiles run closer to the GEMM's peak but pad
# the corpus to a coarser multiple; _screen_block_for trades the two
# off. A device missing here is an error: measure it first.
_SCREEN_TILE_RATE = {
    # NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md).
    "NVIDIA H100 80GB HBM3": {
        1024: 2.154e9,
        2048: 2.919e9,
        4096: 4.988e9,
        8192: 5.714e9,
    },
}


def _tile_rates() -> dict:
    """The _SCREEN_TILE_RATE row of the first device."""
    kind = jax.devices()[0].device_kind
    if kind not in _SCREEN_TILE_RATE:
        raise RuntimeError(
            f"no screen tile rates for device {kind!r}; run "
            "GALAH_BENCH=tilesweep python bench.py on it and add them "
            "to ops/prefilter.py:_SCREEN_TILE_RATE"
        )
    return _SCREEN_TILE_RATE[kind]


def _screen_block_for(n: int) -> int:
    """Tile edge for the single-device sweeps: the edge minimizing the
    sweep's modeled device time — triangle tile count at that edge
    times pairs per tile, divided by the device's measured per-edge
    production tile rate (_SCREEN_TILE_RATE). Padding waste is thereby
    priced against GEMM efficiency. CPU keeps 1024 (cache-sized).
    GALAH_TPU_SCREEN_BLOCK overrides."""
    import os

    env = os.environ.get("GALAH_TPU_SCREEN_BLOCK")
    if env:
        return int(env)
    from galah_tpu.utils.platform import backend_default

    if backend_default(cpu=True, gpu=False):
        return 1024
    best, best_cost = 1024, float("inf")
    for b, rate in sorted(_tile_rates().items()):
        t = max(1, -(-n // b))
        computed = t * (t + 1) / 2 * b * b
        cost = computed / rate
        # Strict < prefers the SMALLER edge on ties; near-ties go to
        # the larger edge (fewer dispatches) via a 2% tolerance.
        if cost < best_cost * 0.98:
            best, best_cost = b, cost
    return best


def _next_pow2_rows(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _screen_cap_for(block: int) -> int:
    """Per-tile sparse-extraction capacity, scaled linearly with the
    tile edge: the cap-sized value gather is per-index bound, so a
    quadratic cap costs real milliseconds per tile while overflow
    (dense recompute) remains corpus-rare at linear scaling."""
    return 16384 * max(1, block // 1024)


# Share of the device memory limit the resident screen matrix may take.
RESIDENT_SHARE = 0.5


def _device_resident_budget() -> int:
    """Device-memory budget for keeping the packed matrix resident:
    RESIDENT_SHARE of the smallest local device's memory limit
    (utils.platform.device_memory_limit; the mesh-sharded sweeps make
    the matrix resident on every device)."""
    from galah_tpu.utils.platform import device_memory_limit

    limit = min(device_memory_limit(d) for d in jax.local_devices())
    return int(limit * RESIDENT_SHARE)


# In-flight tile dispatches before the oldest result is drained: keeps
# device->host results bounded (window * cap entries) while still
# pipelining dispatch latency.
TILE_WINDOW = 16

# Hit-row capacity of the two-level sparse extraction (see
# _extract_above_cutoff). Tiles whose hits span more rows take the
# direct-nonzero branch.
ROW_SEL = 128


def _compact_hits(sub_mask, row_ids, sub_cont, cap: int, cols_n: int):
    """Scatter-free hit extraction over one (rows, cols) tile view:
    route (row*cols + col, cont) pairs where sub_mask is set to the
    front with monotone compaction (ops/routing.py) instead of XLA's
    ~85M-elements/s nonzero lowering, and carry the values along so no
    per-index (per-gather-bound) cont[ii, jj] lookup remains. Hits come
    out in row-major order; slots past the live count are zeros."""
    from galah_tpu.ops.pair_table import _fast_cumsum
    from galah_tpu.ops.routing import monotone_compact_tiled

    col_ids = jax.lax.broadcasted_iota(jnp.int32, sub_mask.shape, 1)
    combined = row_ids * jnp.int32(cols_n) + col_ids
    (ci, cv), _ = monotone_compact_tiled(
        sub_mask.reshape(-1),
        [combined.reshape(-1), sub_cont.reshape(-1)],
        [0, jnp.float32(0.0)],
        cumsum_fn=_fast_cumsum,
    )
    ci = ci[:cap]
    return ci // cols_n, ci % cols_n, cv[:cap]


def _extract_above_cutoff(cont, mask, cap: int, direct: bool = False,
                          routed: Optional[bool] = None):
    """(cnt, ii, jj, vals) of up-to-cap above-cutoff tile entries.

    Real sweeps are sparse: most tiles have hits in few ROWS, so
    compact the hit rows first (a nonzero over `rows` elements + a row
    gather) and extract over only (row_sel, cols). That second-level
    extraction is either ROUTED (monotone compaction, values carried
    along — no nonzero over row_sel*cols and no per-index cont[ii, jj]
    gather) or a plain `jnp.nonzero`. The GPU takes the routed one and
    the CPU backend nonzero (numpy-grade lowering, and the 22-pass
    routing would lose); both times on an H100 are in PERF.md.
    `routed` forces either path for tests. (A lax.cond fallback to the
    direct extraction defeats the win, so overflow is signalled
    instead.)

    Tiles whose hits span more than row_sel rows (e.g. near-duplicate
    family blocks) return cnt = -(true_cnt + 1); the extracted entries
    cover only the first row_sel hit rows, and the caller re-extracts
    that tile with direct=True (a second device dispatch — no dense
    host pull) or densely. Hits are emitted in row-major order; with
    a non-negative cnt <= cap the extraction is complete and exact.
    """
    rows_n, cols_n = mask.shape
    cnt = jnp.sum(mask)
    # Row capacity scales with the tile (rows/16, floor ROW_SEL): the
    # first-level nonzero's domain grows with it, and overflow falls
    # back to a direct re-extraction anyway.
    row_sel = min(rows_n, max(ROW_SEL, rows_n // 16))
    if routed is None:
        from galah_tpu.utils.platform import backend_default

        routed = backend_default(cpu=False, gpu=True)

    if direct or row_sel == rows_n:
        if routed:
            row_ids = jax.lax.broadcasted_iota(jnp.int32, mask.shape, 0)
            ii, jj, vals = _compact_hits(mask, row_ids, cont, cap, cols_n)
            return cnt, ii, jj, vals
        ii, jj = jnp.nonzero(mask, size=cap, fill_value=0)
        ii = ii.astype(jnp.int32)
        jj = jj.astype(jnp.int32)
        return cnt, ii, jj, cont[ii, jj]

    row_has = jnp.any(mask, axis=1)
    nrows = jnp.sum(row_has)
    rows = jnp.nonzero(row_has, size=row_sel, fill_value=0)[0]
    valid = jnp.arange(row_sel) < jnp.minimum(nrows, row_sel)
    sub = mask[rows] & valid[:, None]
    cnt_enc = jnp.where(nrows > row_sel, -(cnt + 1), cnt)
    if routed:
        row_ids = jnp.broadcast_to(
            rows.astype(jnp.int32)[:, None], sub.shape
        )
        ii, jj, vals = _compact_hits(sub, row_ids, cont[rows], cap, cols_n)
        return cnt_enc, ii, jj, vals
    idx = jnp.nonzero(sub.reshape(-1), size=cap, fill_value=0)[0]
    ii = rows[idx // cols_n].astype(jnp.int32)
    jj = (idx % cols_n).astype(jnp.int32)
    return cnt_enc, ii, jj, cont[ii, jj]


_SCREEN_DTYPES = {
    "int8": jnp.int8,
    "bf16": jnp.bfloat16,
    "f32": jnp.float32,
}


def _screen_dtype_name() -> str:
    """Matmul input dtype for the screen, resolved per call.

    The GPU takes int8 (int8 x int8 -> int32, exact for 0/1 counts):
    on an H100 the 8192-row tile at 2^18 bits ran 2.0x faster than in
    bf16 (PERF.md). The CPU keeps f32 (XLA's CPU int8 dot is slower
    than its f32 GEMM). GALAH_TPU_SCREEN_DTYPE overrides (int8|bf16|
    f32). The name is threaded into the jitted screen kernels as a
    STATIC argument so each variant compiles and caches its own
    program.
    """
    import os

    mode = os.environ.get("GALAH_TPU_SCREEN_DTYPE")
    if mode in _SCREEN_DTYPES:
        return mode
    from galah_tpu.utils.platform import backend_default

    return backend_default(cpu="f32", gpu="int8")


def _screen_dt(dtname: str):
    """Static dtype-name -> jnp dtype. Callers must pass an explicit
    name (resolve via _screen_dtype_name() once per sweep): the name is
    part of the jit cache key, so an env-resolved default baked in at
    first trace would silently survive later env changes."""
    return _SCREEN_DTYPES[dtname]


def _screen_matmul(xu: jax.Array, yu: jax.Array) -> jax.Array:
    """Pairwise intersection counts between indicator rows as one
    matrix product, returned as f32. int8 inputs accumulate in int32
    (exact; counts <= bits < 2^31); float inputs accumulate in f32.

    The float paths are exact even where the GPU runs an f32 product in
    TF32 or feeds bf16 operands to the tensor cores: the operands are 0
    or 1, which TF32 and bf16 represent exactly, every product is 0 or
    1, and the sums are accumulated in f32. A count is at most the row
    width (<= 2^18 prefilter bits by default, and below 2^24 for any
    width the CLI accepts), and every integer below 2^24 is exact in
    f32, so no partial sum is ever rounded."""
    acc = jnp.int32 if xu.dtype == jnp.int8 else jnp.float32
    counts = jax.lax.dot_general(
        xu,
        yu,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=acc,
    )
    return counts.astype(jnp.float32)


def _screen_counts_packed(si_pk: jax.Array, sj_pk: jax.Array,
                          dtname: str) -> jax.Array:
    """Intersection counts (f32) between two PACKED uint32 blocks:
    both operands unpacked to 0/1 in the dtype `dtname` names, then one
    dot_general (XLA fuses the unpack into the operands of the product).
    Counts are exact integers in every dtype (see _screen_matmul)."""
    dt = _screen_dt(dtname)
    return _screen_matmul(_unpack_bits(si_pk, dt), _unpack_bits(sj_pk, dt))


def _drain_tile(
    res,
    *,
    cap: int,
    row0: int,
    col0: int,
    inv_k: float,
    min_cont_f: float,
    dense_cont,
    pairs: List[np.ndarray],
    anis: List[np.ndarray],
    reextract=None,
    diag: bool = False,
    keep_rows: Optional[int] = None,
    keep_cols: Optional[int] = None,
) -> None:
    """Decode one tile's sparse extraction result and emit its pairs —
    the single implementation of the overflow contract every screen
    sweep shares.

    res is _extract_above_cutoff's (cnt, ii, jj, vals): cnt < 0 is the
    two-level extraction's row-overflow signal (true count = -cnt - 1;
    resolved by `reextract()` when the sweep can re-dispatch a direct
    device extraction, else by the dense path), cnt > cap overflowed
    the tile's output capacity (recompute via `dense_cont()`, a
    () -> (rows, cols) f32 containment matrix). The dense path applies
    the same f32-rounded cutoff as the on-device extraction, so the
    surviving pair set never depends on whether a tile overflowed.
    Emitted indices are rebased by row0/col0; keep_rows/keep_cols drop
    padding rows when the sweep's blocks are zero-padded (ragged-block
    sweeps pass None)."""
    cnt, ii, jj, vals = res
    cnt = int(cnt)
    if cnt < 0:
        true_cnt = -cnt - 1
        if reextract is not None and true_cnt <= cap:
            cnt, ii, jj, vals = reextract()
            cnt = int(cnt)
        else:
            cnt = cap + 1
    if cnt > cap:
        cont = dense_cont()
        if diag:
            cont[np.tril_indices(cont.shape[0])] = -1.0  # -1: a cutoff of 0 must still drop self/reversed pairs
        hit = np.argwhere(cont >= min_cont_f)
        gi = hit[:, 0] + row0
        gj = hit[:, 1] + col0
        v = cont[hit[:, 0], hit[:, 1]]
    else:
        gi = np.asarray(ii[:cnt]) + row0
        gj = np.asarray(jj[:cnt]) + col0
        v = np.asarray(vals[:cnt]).astype(np.float32)
    if keep_rows is not None:
        keep = (gi < keep_rows) & (gj < keep_cols)
        gi, gj, v = gi[keep], gj[keep], v[keep]
    if len(gi):
        pairs.append(np.stack([gi, gj], axis=1).astype(np.int64))
        anis.append((v ** inv_k * 100.0).astype(np.float32))


def screen_triangle(
    indicators: Sequence[np.ndarray],
    sizes: np.ndarray,
    k: int,
    min_containment: float,
    block: int = 1024,
    cache_blocks: bool = True,
) -> ScreenResult:
    """Lower-triangle all-vs-all screen over one genome set.

    indicators: list-like of per-genome (B,) uint8 0/1 rows; may be a
    lazy view (low-memory mode) — rows are materialized per block.
    cache_blocks keeps every device block resident (n*B total on
    device); low-memory mode sets it False so only the current row
    block is cached and column blocks stream.
    """
    n = len(indicators)
    bits = len(indicators[0]) if n else 0
    pairs: List[np.ndarray] = []
    anis: List[np.ndarray] = []
    if n == 0:
        return ScreenResult(np.empty((0, 2), np.int64), np.empty(0, np.float32))
    inv_k = 1.0 / k

    sizes_f = sizes.astype(np.float32)
    nblocks = math.ceil(n / block)
    dtn = _screen_dtype_name()
    if cache_blocks and n * bits > _device_resident_budget():
        logger.info(
            "Indicator matrix (%d x %d) exceeds the device budget; "
            "streaming column blocks", n, bits,
        )
        cache_blocks = False
    dev_blocks = {}

    def make_block(bi: int) -> jax.Array:
        lo, hi = bi * block, min((bi + 1) * block, n)
        mat = np.stack([indicators[t] for t in range(lo, hi)])
        return jnp.asarray(mat)  # uint8; cast to matmul dtype on device

    def get_block(bi: int) -> jax.Array:
        if bi not in dev_blocks:
            dev_blocks[bi] = make_block(bi)
        return dev_blocks[bi]

    cap = _screen_cap_for(block)
    min_cont_f = float(np.float32(min_containment))

    def drain(item) -> None:
        # Sparse on-device extraction (row-overflow or cap-overflow
        # tiles fall back to a dense pull of that one tile) — the
        # indicator sweep no longer pays O(n^2/block^2) dense pulls.
        bi, bj, si, sj, ai, aj, res = item
        _drain_tile(
            res, cap=cap, row0=bi * block, col0=bj * block, inv_k=inv_k,
            min_cont_f=min_cont_f,
            dense_cont=lambda: np.array(
                _block_containment_u8(si, sj, ai, aj, float(bits), dtname=dtn)
            ).astype(np.float32),
            diag=bi == bj, pairs=pairs, anis=anis,
        )

    # The pending window pins its tiles' block arrays; when blocks
    # stream (low-memory / over-budget) a deep window would pin
    # window-many distinct blocks and defeat the streaming bound, so
    # cap it at one extra in-flight dispatch there.
    window = TILE_WINDOW if cache_blocks else 1
    pending: deque = deque()
    for bi in range(nblocks):
        si = get_block(bi) if cache_blocks else make_block(bi)
        ai = jnp.asarray(sizes_f[bi * block : bi * block + si.shape[0]])
        for bj in range(bi, nblocks):
            if bj == bi:
                sj = si
            elif cache_blocks:
                sj = get_block(bj)
            else:
                sj = make_block(bj)
            aj = jnp.asarray(sizes_f[bj * block : bj * block + sj.shape[0]])
            res = _block_screen_extract_u8(
                si, sj, ai, aj, jnp.float32(bits), jnp.float32(min_cont_f),
                cap=cap, is_diag=bi == bj, dtname=dtn,
            )
            pending.append((bi, bj, si, sj, ai, aj, res))
            if len(pending) > window:
                drain(pending.popleft())
    while pending:
        drain(pending.popleft())
    dev_blocks.clear()

    if pairs:
        return ScreenResult(np.concatenate(pairs), np.concatenate(anis))
    return ScreenResult(np.empty((0, 2), np.int64), np.empty(0, np.float32))


@partial(jax.jit, donate_argnums=(0, 1))
def _inc_adopt_rows(x, s, src, src_rows, dst_rows, size_vals):
    """Device-to-device incremental matrix fill:
    x[dst_rows[b]] = src[src_rows[b]], s[dst_rows[b]] = size_vals[b].
    Index arrays are pow2-padded with duplicates of their first entry
    (identical values at a duplicate index — order-independent)."""
    return (
        x.at[dst_rows].set(jnp.take(src, src_rows, axis=0)),
        s.at[dst_rows].set(size_vals),
    )


@partial(jax.jit, donate_argnums=(0, 1))
def _inc_fill_rows(x, s, dense, dst_rows, size_vals):
    """Host-upload incremental matrix fill (rows the device didn't
    sketch: shadow-stolen chunks, overflow fallbacks, store hits)."""
    return (
        x.at[dst_rows].set(dense),
        s.at[dst_rows].set(size_vals),
    )


class IncrementalPackedScreen:
    """Resident packed triangle screen fed row-incrementally.

    The sequential resident sweep is the degenerate case (feed every
    row, then finish()); the incremental case is the sketch->screen
    pipeline overlap: sketch batches add their rows as they complete —
    device-to-device for device-born prefilter rows, one dense upload
    per host batch — and any tile whose two row blocks are complete
    dispatches IMMEDIATELY, so screen dispatches interleave with the
    remaining sketch uploads instead of the whole screen waiting for
    the last sketch (the reference gets this handoff for free inside
    one process: reference src/skani.rs:270-304); overlap moves the e2e
    wall from sum(phases) toward max(phase) + tail.

    Grouped dispatches, padded remainder groups, the compacted group
    fetch, caps, overflow fallbacks, and drain semantics are the SAME
    code for both cases — screen_triangle_packed's resident branch
    delegates here, so per-tile results are bit-identical no matter
    when rows arrived. Thread use: feeders may call add_* from a
    worker thread (the device-sketch sink); calls are serialized by an
    internal lock. finish() must be called after feeding completes
    (join your feeder first)."""

    def __init__(
        self,
        n: int,
        k: int,
        min_containment: float,
        bits: int,
        block: int = 0,
        row_width: int = 0,
        checkpoint_path: str = None,
        unit_names=None,
    ) -> None:
        import threading

        if n <= 0:
            raise ValueError("IncrementalPackedScreen needs n >= 1")
        self.n = n
        self.inv_k = 1.0 / k
        self.bits = bits
        self.block = block or _screen_block_for(n)
        self.cap = _screen_cap_for(self.block)
        self.min_cont_f = float(np.float32(min_containment))
        self.dtn = _screen_dtype_name()
        self.w = row_width or bits // 32
        self.n_pad = ((n + self.block - 1) // self.block) * self.block
        self.nblocks = self.n_pad // self.block
        self.group = _screen_tile_group()
        # Row allocation is bucketed to a power of two (>= n_pad):
        # the extract programs' shapes include the resident matrix, so
        # without bucketing EVERY corpus size compiles its own program.
        # Bucketing
        # bounds the shape set logarithmically and makes it
        # pre-warmable (tools/prewarm.py). Tiles still enumerate over
        # the REAL nblocks, so no padding tile is ever dispatched —
        # the only cost is zeros in HBM, and the bucket falls back to
        # the exact size when it would not fit the device budget.
        # GALAH_TPU_SCREEN_PAD_POW2=0 disables.
        import os as _os

        alloc = self.n_pad
        if _os.environ.get("GALAH_TPU_SCREEN_PAD_POW2", "1") != "0":
            alloc = max(self.block, _next_pow2_rows(self.n_pad))
            if alloc * self.w * 4 > _device_resident_budget():
                alloc = self.n_pad
        self.alloc_rows = alloc
        self._x = jnp.zeros((self.alloc_rows, self.w), jnp.uint32)
        self._s = jnp.zeros((self.alloc_rows,), jnp.float32)
        self._pending: deque = deque()
        self._bufs = {True: [], False: []}
        self._pairs: List[np.ndarray] = []
        self._anis: List[np.ndarray] = []
        self._added = np.zeros(n, dtype=bool)
        self._left = [
            min(self.block, n - b * self.block) for b in range(self.nblocks)
        ]
        self._complete_order: List[int] = []
        self._is_complete = [False] * self.nblocks
        self._lock = threading.Lock()
        self._finished = False
        # Overlap instrumentation: rows fed when the first tile
        # dispatched (None until then; < n proves the screen started
        # before the corpus finished sketching).
        self.rows_at_first_dispatch: Optional[int] = None
        self.rows_added = 0
        # Optional screen->verify overlap hook: called with each
        # drained tile's (pairs (P,2) int64, ani_est (P,) f32) as soon
        # as the tile is decoded — the downstream verify stage can
        # start while the sweep (and the sketch feed) continues. Called
        # on whichever thread drains (feeder thread mid-feed, caller
        # thread in finish()).
        self.on_pairs = None
        # In-flight window before the oldest result drains. The
        # sequential sweep keeps the deep TILE_WINDOW (drains are pure
        # serialized tail work there), but an INCREMENTALLY-fed sweep
        # shrinks it: draining early moves result fetches, decodes and
        # the verify feeder's flushes into the sketch-feed wall — on
        # the 100k-contig chip run the deep window deferred every
        # drain to finish(), leaving a 146s post-sketch tail that this
        # overlap exists to hide. GALAH_TPU_PIPELINE_WINDOW overrides.
        self.window = TILE_WINDOW
        # Mid-sweep checkpoint (ops/sweep_checkpoint.py): drained tile
        # results append to an on-disk log; a resumed sweep replays
        # logged tiles instead of re-dispatching them.
        self._ckpt = None
        self.tiles_restored = 0
        if checkpoint_path:
            from galah_tpu.ops.sweep_checkpoint import (
                SweepCheckpoint,
                sweep_fingerprint,
            )

            if unit_names is None or len(unit_names) != n:
                raise ValueError(
                    "checkpoint_path requires unit_names (one per row)"
                )
            self._ckpt = SweepCheckpoint(
                checkpoint_path,
                sweep_fingerprint(
                    unit_names, bits, self.block, k,
                    self.min_cont_f, self.dtn,
                ),
            )

    # ---- feeding -----------------------------------------------------

    def _note_added(self, idxs: Sequence[int]) -> List[int]:
        """Mark rows added; return block ids that just completed."""
        done = []
        for i in idxs:
            if self._added[i]:
                continue
            self._added[i] = True
            self.rows_added += 1
            b = i // self.block
            self._left[b] -= 1
            if self._left[b] == 0:
                self._is_complete[b] = True
                done.append(b)
        return done

    def _schedule(self, new_blocks: Sequence[int]) -> None:
        """Enqueue every tile both of whose row blocks are complete and
        that became ready with `new_blocks`; issue full groups."""
        for b in new_blocks:
            self._complete_order.append(b)
            tiles = sorted(
                (min(b, c), max(b, c)) for c in self._complete_order
            )
            for bi, bj in tiles:
                self._enqueue(bi, bj)

    def _dedupe_new(self, idxs: Sequence[int]) -> List[int]:
        fresh = []
        for i in idxs:
            if not self._added[i]:
                fresh.append(i)
        return fresh

    def _incremental_window(self) -> None:
        import os as _os

        env = _os.environ.get("GALAH_TPU_PIPELINE_WINDOW")
        self.window = max(1, int(env)) if env else 2

    def add_device_rows(
        self, idxs: Sequence[int], src, src_rows: Sequence[int],
        sizes: Sequence[float],
    ) -> None:
        """Adopt device-born packed rows: matrix[idxs[b]] =
        src[src_rows[b]] (zero host round trip). Duplicate/already-
        added indices are skipped."""
        with self._lock:
            self._check_open()
            self._incremental_window()
            fresh = [
                (i, r, sz)
                for i, r, sz in zip(idxs, src_rows, sizes)
                if not self._added[i]
            ]
            if not fresh:
                return
            bpad = max(8, 1 << (len(fresh) - 1).bit_length())
            dst = np.full(bpad, fresh[0][0], np.int32)
            srow = np.full(bpad, fresh[0][1], np.int32)
            szs = np.full(bpad, fresh[0][2], np.float32)
            for b, (i, r, sz) in enumerate(fresh):
                dst[b], srow[b], szs[b] = i, r, sz
            self._x, self._s = _inc_adopt_rows(
                self._x, self._s, src, jnp.asarray(srow),
                jnp.asarray(dst), jnp.asarray(szs),
            )
            self._schedule(self._note_added([i for i, _, _ in fresh]))

    def add_host_rows(
        self, idxs: Sequence[int], rows: Sequence[np.ndarray],
        sizes: Sequence[float],
    ) -> None:
        """Upload host-packed rows (pack_indicator output) in chunks."""
        with self._lock:
            self._check_open()
            self._incremental_window()
            fresh = [
                (i, row, sz)
                for i, row, sz in zip(idxs, rows, sizes)
                if not self._added[i]
            ]
            step = max(8, (64 << 20) // (self.w * 4))
            for lo in range(0, len(fresh), step):
                chunk = fresh[lo : lo + step]
                bpad = max(8, 1 << (len(chunk) - 1).bit_length())
                dense = np.zeros((bpad, self.w), np.uint32)
                dst = np.full(bpad, chunk[0][0], np.int32)
                szs = np.full(bpad, chunk[0][2], np.float32)
                for b, (i, row, sz) in enumerate(chunk):
                    dense[b], dst[b], szs[b] = row, i, sz
                dense[len(chunk):] = dense[0]
                self._x, self._s = _inc_fill_rows(
                    self._x, self._s, jax.device_put(dense),
                    jnp.asarray(dst), jnp.asarray(szs),
                )
                self._schedule(
                    self._note_added([i for i, _, _ in chunk])
                )

    def set_prebuilt(self, x_all, s_dev) -> None:
        """Degenerate case: the whole matrix arrives at once (host
        assembly or engines/native.py's device-born matrix_builder).
        Tiles enqueue in the canonical (bi, bj >= bi) sweep order."""
        with self._lock:
            self._check_open()
            if self.rows_added:
                raise RuntimeError(
                    "set_prebuilt after incremental rows were added"
                )
            self._x, self._s = x_all, s_dev
            self._added[:] = True
            self.rows_added = self.n
            self._left = [0] * self.nblocks
            self._is_complete = [True] * self.nblocks
            self._complete_order = list(range(self.nblocks))
            for bi in range(self.nblocks):
                for bj in range(bi, self.nblocks):
                    self._enqueue(bi, bj)

    def _enqueue(self, bi: int, bj: int) -> None:
        """Buffer a ready tile for dispatch — or replay it from the
        sweep checkpoint (byte-identical: a tile's result is a pure
        function of its two completed row blocks)."""
        if self._ckpt is not None:
            got = self._ckpt.has(bi, bj)
            if got is not None:
                pairs, anis = got
                self.tiles_restored += 1
                if len(pairs):
                    self._pairs.append(pairs)
                    self._anis.append(anis)
                    if self.on_pairs is not None:
                        self.on_pairs(pairs, anis)
                return
        self._bufs[bi == bj].append((bi, bj))
        self._issue(self._bufs[bi == bj], bi == bj, force=False)

    def missing_rows(self) -> List[int]:
        """Indices never fed (snapshot) — the caller back-fills these
        with host-packed rows before finish() (shadow-stolen chunks,
        overflow fallbacks, store-cached genomes, abandoned workers)."""
        with self._lock:
            return [int(i) for i in np.nonzero(~self._added)[0]]

    def _check_open(self) -> None:
        if self._finished:
            raise RuntimeError("IncrementalPackedScreen already finished")

    # ---- dispatch / drain -------------------------------------------

    def _issue(self, buf, is_diag: bool, force: bool) -> None:
        # Tiles dispatch in GROUPS of `group` per call (lax.map), which
        # amortizes per-dispatch and per-fetch cost. Diagonal and
        # off-diagonal tiles batch separately (is_diag is static);
        # remainder groups of 2..group-1 tiles are padded to the full
        # group size with repeats of their first tile (padding excluded
        # from compaction and cap accounting), and only a lone nreal==1
        # remainder goes as a single-tile dispatch — so exactly two
        # compiled shapes exist per (block, cap, dtname, is_diag).
        from galah_tpu.utils import metrics

        group = self.group
        while len(buf) >= group or (force and buf):
            if self.rows_at_first_dispatch is None:
                self.rows_at_first_dispatch = self.rows_added
            nreal = min(len(buf), group)
            # Deterministic pipeline-shape counters: dispatches and
            # pairs computed depend only on the corpus, so the e2e drift
            # guard can pin them tightly where wall clock is noisy
            # (bench.py).
            m = metrics.current()
            m.count("screen_dispatch_rpcs", 1)
            m.count(
                "screen_pairs_computed", nreal * self.block * self.block
            )
            grp = buf[:nreal]
            del buf[:nreal]
            if nreal == 1:
                bi, bj = grp[0]
                res = _resident_screen_extract(
                    self._x, self._s, jnp.int32(bi), jnp.int32(bj),
                    block=self.block, bits_f=float(self.bits),
                    min_cont=self.min_cont_f, cap=self.cap,
                    is_diag=is_diag, dtname=self.dtn,
                )
                self._pending.append(("s", grp[0], res))
            else:
                padded = grp + [grp[0]] * (group - nreal)
                res = _resident_screen_extract_group(
                    self._x, self._s,
                    jnp.asarray(_screen_group_desc(
                        [t[0] for t in padded],
                        [t[1] for t in padded],
                        float(self.bits), self.min_cont_f, nreal,
                    )),
                    block=self.block, cap=self.cap, is_diag=is_diag,
                    dtname=self.dtn,
                )
                self._pending.append(("g", padded, nreal, res))
            while len(self._pending) > self.window:
                self._drain(self._pending.popleft())

    def _drain_one(self, bi: int, bj: int, res) -> None:
        def dense_cont():
            lo_i, lo_j = bi * self.block, bj * self.block
            return np.array(
                _block_containment_packed(
                    self._x[lo_i : lo_i + self.block],
                    self._x[lo_j : lo_j + self.block],
                    self._s[lo_i : lo_i + self.block],
                    self._s[lo_j : lo_j + self.block],
                    float(self.bits), dtname=self.dtn,
                )
            ).astype(np.float32)

        # Late-bound self._x: a tile only reads its two row blocks,
        # which are complete (and never rewritten) by dispatch time —
        # re-extraction against a LATER matrix version is identical.
        reextract = lambda: _resident_screen_extract(  # noqa: E731
            self._x, self._s, jnp.int32(bi), jnp.int32(bj),
            block=self.block, bits_f=float(self.bits),
            min_cont=self.min_cont_f, cap=self.cap, is_diag=bj == bi,
            dtname=self.dtn, direct=True,
        )
        before = len(self._pairs)
        _drain_tile(
            res, cap=self.cap, row0=bi * self.block,
            col0=bj * self.block, inv_k=self.inv_k,
            min_cont_f=self.min_cont_f, dense_cont=dense_cont,
            reextract=reextract, diag=bi == bj,
            keep_rows=self.n, keep_cols=self.n,
            pairs=self._pairs, anis=self._anis,
        )
        got_new = len(self._pairs) > before
        if self.on_pairs is not None and got_new:
            self.on_pairs(self._pairs[-1], self._anis[-1])
        if self._ckpt is not None:
            self._ckpt.put(
                bi, bj,
                self._pairs[-1] if got_new
                else np.empty((0, 2), np.int64),
                self._anis[-1] if got_new
                else np.empty(0, np.float32),
            )

    def _drain(self, item) -> None:
        if item[0] == "g":
            # Grouped tiles: ONE packed-buffer pull, decoded per tile;
            # only the first nreal tiles are real (padding repeats the
            # first tile and is excluded from the cap accounting).
            _, grp, nreal, res = item
            _, per_tile = _decode_group_result(
                np.asarray(res), len(grp), self.cap, self.block, nreal
            )
            if per_tile is None:
                # Group-cap overflow (survivors > cap across the K
                # tiles): re-dispatch singly — rare, dense corpora only.
                from galah_tpu.utils import metrics

                m = metrics.current()
                for bi, bj in grp[:nreal]:
                    m.count("screen_dispatch_rpcs", 1)
                    m.count(
                        "screen_pairs_computed", self.block * self.block
                    )
                    res1 = _resident_screen_extract(
                        self._x, self._s, jnp.int32(bi), jnp.int32(bj),
                        block=self.block, bits_f=float(self.bits),
                        min_cont=self.min_cont_f, cap=self.cap,
                        is_diag=bj == bi, dtname=self.dtn,
                    )
                    self._drain_one(bi, bj, res1)
            else:
                for t, (bi, bj) in enumerate(grp[:nreal]):
                    self._drain_one(bi, bj, per_tile[t])
        else:
            _, (bi, bj), res = item
            self._drain_one(bi, bj, res)

    def finish(self) -> ScreenResult:
        with self._lock:
            self._check_open()
            self._finished = True
            if self.rows_added != self.n:
                missing = int(self.n - self.rows_added)
                raise RuntimeError(
                    f"screen finish() with {missing} rows never fed"
                )
            self._issue(self._bufs[True], True, force=True)
            self._issue(self._bufs[False], False, force=True)
            while self._pending:
                self._drain(self._pending.popleft())
            if self._ckpt is not None:
                self._ckpt.close()
            if self._pairs:
                return ScreenResult(
                    np.concatenate(self._pairs),
                    np.concatenate(self._anis),
                )
            return ScreenResult(
                np.empty((0, 2), np.int64), np.empty(0, np.float32)
            )


def screen_triangle_packed(
    packed: Sequence[np.ndarray],
    sizes: np.ndarray,
    k: int,
    min_containment: float,
    bits: int,
    block: int = 0,
    cache_blocks: bool = True,
    matrix_builder=None,
    checkpoint_path: str = None,
    unit_names=None,
) -> ScreenResult:
    """Lower-triangle screen over packed uint32 bitmaps with on-device
    unpacking — the default path: same matmul as screen_triangle at
    1/32nd the host->device transfer. block=0 picks the measured-best
    tile edge for the backend (_screen_block_for).

    matrix_builder(n_pad) -> (x_all, s_dev) | None: optional resident-
    matrix supplier (engines/native.py builds it from device-born
    sketch rows so the packed matrix never crosses the host link).
    checkpoint_path + unit_names enable the mid-sweep tile log
    (ops/sweep_checkpoint.py; resident mode only — the streaming
    branch recomputes)."""
    n = len(packed)
    if n == 0:
        return ScreenResult(np.empty((0, 2), np.int64), np.empty(0, np.float32))
    pairs: List[np.ndarray] = []
    anis: List[np.ndarray] = []
    inv_k = 1.0 / k
    sizes_f = sizes.astype(np.float32)
    w = getattr(packed, "row_width", None) or len(packed[0])
    block = block or _screen_block_for(n)
    cap = _screen_cap_for(block)
    min_cont_f = float(np.float32(min_containment))
    dtn = _screen_dtype_name()

    # Resident mode: one upload of the whole packed matrix, device-side
    # tile slicing (unless it would not fit the device's HBM budget or
    # low-memory streaming was requested). The sweep itself delegates
    # to IncrementalPackedScreen — this sequential call is its
    # degenerate everything-at-once case, so the grouped-dispatch /
    # drain machinery exists exactly once.
    fits = n * w * 4 <= _device_resident_budget()
    if cache_blocks and fits:
        scr = IncrementalPackedScreen(
            n, k, min_containment, bits, block=block, row_width=w,
            checkpoint_path=checkpoint_path, unit_names=unit_names,
        )
        # Build at the bucketed row count so the compiled program
        # shape is stable across corpus sizes (see alloc_rows).
        n_alloc = scr.alloc_rows
        built = matrix_builder(n_alloc) if matrix_builder is not None else None
        if built is not None:
            scr.set_prebuilt(*built)
        else:
            x_all_np = np.zeros((n_alloc, w), dtype=np.uint32)
            for t in range(n):
                x_all_np[t] = packed[t]
            s_all = np.zeros(n_alloc, dtype=np.float32)
            s_all[:n] = sizes_f
            scr.set_prebuilt(jnp.asarray(x_all_np), jnp.asarray(s_all))
            del x_all_np
        return scr.finish()

    if cache_blocks:
        # Caching every block would pin the same bytes the resident
        # check just refused — stream column blocks instead.
        logger.info(
            "Packed matrix (%d x %d words) exceeds the device budget; "
            "streaming column blocks", n, w,
        )
        cache_blocks = False
    if checkpoint_path:
        logger.warning(
            "--sweep-checkpoint only applies to the resident sweep; "
            "this streaming sweep will NOT checkpoint mid-sweep"
        )

    def make_block(bi: int) -> Tuple[jax.Array, jax.Array]:
        lo, hi = bi * block, min((bi + 1) * block, n)
        mat = np.stack([packed[t] for t in range(lo, hi)])
        return jnp.asarray(mat), jnp.asarray(sizes_f[lo:hi])

    def drain_one(bi: int, bj: int, res) -> None:
        def dense_cont():
            si, ai = make_block(bi)
            sj, aj = (si, ai) if bj == bi else make_block(bj)
            return np.array(
                _block_containment_packed(si, sj, ai, aj, float(bits),
                                          dtname=dtn)
            ).astype(np.float32)

        # Streaming mode re-pulls densely on row overflow (no resident
        # matrix to re-extract from).
        _drain_tile(
            res, cap=cap, row0=bi * block, col0=bj * block, inv_k=inv_k,
            min_cont_f=min_cont_f, dense_cont=dense_cont,
            reextract=None, diag=bi == bj,
            keep_rows=n, keep_cols=n, pairs=pairs, anis=anis,
        )

    # Sliding-window issue/drain: at most TILE_WINDOW tile results are
    # in flight, so device result buffers and host pulls stay O(window)
    # for arbitrarily long sweeps.
    pending: deque = deque()
    for bi in range(math.ceil(n / block)):
        si, ai = make_block(bi)
        for bj in range(bi, math.ceil(n / block)):
            if bj == bi:
                sj, aj = si, ai
            else:
                sj, aj = make_block(bj)
            res = _block_screen_extract_packed(
                si, sj, ai, aj, float(bits), min_cont_f,
                cap=cap, is_diag=bj == bi, dtname=dtn,
            )
            # Do NOT keep the device blocks alive in the window — in
            # streaming (low-memory) mode that would pin every
            # tile's buffers; overflow re-makes them instead.
            pending.append(("s", (bi, bj), res))
            if len(pending) > TILE_WINDOW:
                _, (dbi, dbj), dres = pending.popleft()
                drain_one(dbi, dbj, dres)
    while pending:
        _, (dbi, dbj), dres = pending.popleft()
        drain_one(dbi, dbj, dres)

    if pairs:
        return ScreenResult(np.concatenate(pairs), np.concatenate(anis))
    return ScreenResult(np.empty((0, 2), np.int64), np.empty(0, np.float32))


def screen_rectangle_packed(
    query_packed: Sequence[np.ndarray],
    query_sizes: np.ndarray,
    ref_packed: Sequence[np.ndarray],
    ref_sizes: np.ndarray,
    k: int,
    min_containment: float,
    bits: int,
    block: int = 0,
    cache_blocks: bool = True,
) -> ScreenResult:
    """Cross-group screen over packed bitmaps (reference-genome mode)
    using the resident matrix + on-device sparse extraction: queries and
    refs concatenate into one resident matrix and tiles address
    (query-block, ref-block) index ranges. Returned pairs are
    (query_idx, ref_idx). When the matrix exceeds the device budget or
    cache_blocks=False (--low-memory), blocks stream from the host
    instead — same semantics, bounded device memory."""
    nq, nr = len(query_packed), len(ref_packed)
    if nq == 0 or nr == 0:
        return ScreenResult(np.empty((0, 2), np.int64), np.empty(0, np.float32))
    w = getattr(query_packed, "row_width", None) or len(query_packed[0])
    inv_k = 1.0 / k
    block = block or _screen_block_for(max(nq, nr))
    cap = _screen_cap_for(block)
    min_cont_f = float(np.float32(min_containment))
    dtn = _screen_dtype_name()

    nq_pad = ((nq + block - 1) // block) * block
    nr_pad = ((nr + block - 1) // block) * block
    if not cache_blocks or (nq_pad + nr_pad) * w * 4 > _device_resident_budget():
        if cache_blocks:
            logger.info(
                "Rectangle packed matrix (%d rows x %d words) exceeds "
                "the device budget; streaming blocks", nq_pad + nr_pad, w,
            )
        return _screen_rectangle_streaming(
            query_packed, query_sizes, ref_packed, ref_sizes,
            k, min_containment, bits, block, cap,
        )
    x_all_np = np.zeros((nq_pad + nr_pad, w), dtype=np.uint32)
    for t in range(nq):
        x_all_np[t] = query_packed[t]
    for t in range(nr):
        x_all_np[nq_pad + t] = ref_packed[t]
    s_all = np.zeros(nq_pad + nr_pad, dtype=np.float32)
    s_all[:nq] = query_sizes.astype(np.float32)
    s_all[nq_pad : nq_pad + nr] = ref_sizes.astype(np.float32)
    x_all = jnp.asarray(x_all_np)
    s_dev = jnp.asarray(s_all)
    del x_all_np

    pairs: List[np.ndarray] = []
    anis: List[np.ndarray] = []

    ref_block0 = nq_pad // block

    def drain_one(bi: int, bj: int, res) -> None:
        def dense_cont():
            lo_i, lo_j = bi * block, nq_pad + bj * block
            return np.array(
                _block_containment_packed(
                    x_all[lo_i : lo_i + block],
                    x_all[lo_j : lo_j + block],
                    s_dev[lo_i : lo_i + block],
                    s_dev[lo_j : lo_j + block],
                    float(bits),
                    dtname=dtn,
                )
            ).astype(np.float32)

        _drain_tile(
            res, cap=cap, row0=bi * block, col0=bj * block, inv_k=inv_k,
            min_cont_f=min_cont_f, dense_cont=dense_cont,
            reextract=lambda: _resident_screen_extract(
                x_all, s_dev, jnp.int32(bi), jnp.int32(ref_block0 + bj),
                block=block, bits_f=float(bits), min_cont=min_cont_f,
                cap=cap, is_diag=False, dtname=dtn, direct=True,
            ),
            keep_rows=nq, keep_cols=nr, pairs=pairs, anis=anis,
        )

    def drain(item) -> None:
        if item[0] == "g":
            _, grp, nreal, res = item
            _, per_tile = _decode_group_result(
                np.asarray(res), len(grp), cap, block, nreal
            )
            if per_tile is None:
                for bi, bj in grp[:nreal]:
                    res1 = _resident_screen_extract(
                        x_all, s_dev, jnp.int32(bi),
                        jnp.int32(ref_block0 + bj),
                        block=block, bits_f=float(bits),
                        min_cont=min_cont_f, cap=cap, is_diag=False,
                        dtname=dtn,
                    )
                    drain_one(bi, bj, res1)
            else:
                for t, (bi, bj) in enumerate(grp[:nreal]):
                    drain_one(bi, bj, per_tile[t])
        else:
            _, (bi, bj), res = item
            drain_one(bi, bj, res)

    # Tiles dispatch in GROUPS per RPC exactly as in the triangle sweep
    # above (all rectangle tiles share is_diag=False, so a single
    # compiled group shape per (block, cap, dtname) exists here).
    pending: deque = deque()
    group = _screen_tile_group()
    buf: List = []

    def issue(force: bool) -> None:
        while len(buf) >= group or (force and buf):
            nreal = min(len(buf), group)
            grp = buf[:nreal]
            del buf[:nreal]
            if nreal == 1:
                bi, bj = grp[0]
                res = _resident_screen_extract(
                    x_all, s_dev, jnp.int32(bi), jnp.int32(ref_block0 + bj),
                    block=block, bits_f=float(bits),
                    min_cont=min_cont_f, cap=cap, is_diag=False,
                    dtname=dtn,
                )
                pending.append(("s", grp[0], res))
            else:
                padded = grp + [grp[0]] * (group - nreal)
                res = _resident_screen_extract_group(
                    x_all, s_dev,
                    jnp.asarray(_screen_group_desc(
                        [t[0] for t in padded],
                        [ref_block0 + t[1] for t in padded],
                        float(bits), min_cont_f, nreal,
                    )),
                    block=block, cap=cap, is_diag=False, dtname=dtn,
                )
                pending.append(("g", padded, nreal, res))
            while len(pending) > TILE_WINDOW:
                drain(pending.popleft())

    for bi in range(nq_pad // block):
        for bj in range(nr_pad // block):
            buf.append((bi, bj))
            issue(force=False)
    issue(force=True)
    while pending:
        drain(pending.popleft())

    if pairs:
        return ScreenResult(np.concatenate(pairs), np.concatenate(anis))
    return ScreenResult(np.empty((0, 2), np.int64), np.empty(0, np.float32))


def _screen_rectangle_streaming(
    query_packed, query_sizes, ref_packed, ref_sizes,
    k: int, min_containment: float, bits: int, block: int, cap: int,
) -> ScreenResult:
    """Streaming rectangle screen: query and ref blocks materialize
    from host per tile (the reference-mode analog of the triangle's
    low-memory streaming; reference src/skani.rs:502-687 likewise
    streams queries against the on-disk ref sketch DB)."""
    nq, nr = len(query_packed), len(ref_packed)
    inv_k = 1.0 / k
    min_cont_f = float(np.float32(min_containment))
    dtn = _screen_dtype_name()
    qs = query_sizes.astype(np.float32)
    rs = ref_sizes.astype(np.float32)

    def make_q(bi: int):
        lo, hi = bi * block, min((bi + 1) * block, nq)
        return (
            jnp.asarray(np.stack([query_packed[t] for t in range(lo, hi)])),
            jnp.asarray(qs[lo:hi]),
        )

    def make_r(bj: int):
        lo, hi = bj * block, min((bj + 1) * block, nr)
        return (
            jnp.asarray(np.stack([ref_packed[t] for t in range(lo, hi)])),
            jnp.asarray(rs[lo:hi]),
        )

    pairs: List[np.ndarray] = []
    anis: List[np.ndarray] = []

    def drain(item) -> None:
        # Row overflow (cnt < 0) has no resident matrix to re-extract
        # from here: dense re-make of the tile's blocks instead.
        bi, bj, res = item

        def dense_cont():
            si, ai = make_q(bi)
            sj, aj = make_r(bj)
            return np.array(
                _block_containment_packed(si, sj, ai, aj, float(bits),
                                          dtname=dtn)
            ).astype(np.float32)

        _drain_tile(
            res, cap=cap, row0=bi * block, col0=bj * block, inv_k=inv_k,
            min_cont_f=min_cont_f, dense_cont=dense_cont,
            pairs=pairs, anis=anis,
        )

    pending: deque = deque()
    for bi in range(math.ceil(nq / block)):
        si, ai = make_q(bi)
        for bj in range(math.ceil(nr / block)):
            sj, aj = make_r(bj)
            res = _block_screen_extract_packed(
                si, sj, ai, aj, float(bits), min_cont_f,
                cap=cap, is_diag=False, dtname=dtn,
            )
            pending.append((bi, bj, res))
            if len(pending) > TILE_WINDOW:
                drain(pending.popleft())
    while pending:
        drain(pending.popleft())

    if pairs:
        return ScreenResult(np.concatenate(pairs), np.concatenate(anis))
    return ScreenResult(np.empty((0, 2), np.int64), np.empty(0, np.float32))


def screen_rectangle(
    query_indicators: Sequence[np.ndarray],
    query_sizes: np.ndarray,
    ref_indicators: Sequence[np.ndarray],
    ref_sizes: np.ndarray,
    k: int,
    min_containment: float,
    block: int = 1024,
) -> ScreenResult:
    """Cross-group screen (reference-genome mode: the reference compares
    non-reference genomes only against the reference sketch DB,
    src/skani.rs:502-687). Returned pairs are (query_idx, ref_idx)."""
    nq, nr = len(query_indicators), len(ref_indicators)
    if nq == 0 or nr == 0:
        return ScreenResult(np.empty((0, 2), np.int64), np.empty(0, np.float32))
    bits = len(query_indicators[0])
    inv_k = 1.0 / k
    dtn = _screen_dtype_name()
    cap = _screen_cap_for(block)
    min_cont_f = float(np.float32(min_containment))
    pairs: List[np.ndarray] = []
    anis: List[np.ndarray] = []

    def drain(item) -> None:
        # On-device sparse extraction; dense pull only per overflowing
        # tile (same structure as the triangle sweep).
        qlo, rlo, sq, sr, aq, ar, res = item
        _drain_tile(
            res, cap=cap, row0=qlo, col0=rlo, inv_k=inv_k,
            min_cont_f=min_cont_f,
            dense_cont=lambda: np.array(
                _block_containment_u8(sq, sr, aq, ar, float(bits), dtname=dtn)
            ).astype(np.float32),
            pairs=pairs, anis=anis,
        )

    pending: deque = deque()
    for qlo in range(0, nq, block):
        qhi = min(qlo + block, nq)
        sq = jnp.asarray(np.stack([query_indicators[t] for t in range(qlo, qhi)]))
        aq = jnp.asarray(query_sizes[qlo:qhi].astype(np.float32))
        for rlo in range(0, nr, block):
            rhi = min(rlo + block, nr)
            sr = jnp.asarray(
                np.stack([ref_indicators[t] for t in range(rlo, rhi)])
            )
            ar = jnp.asarray(ref_sizes[rlo:rhi].astype(np.float32))
            res = _block_screen_extract_u8(
                sq, sr, aq, ar, jnp.float32(bits), jnp.float32(min_cont_f),
                cap=cap, is_diag=False, dtname=dtn,
            )
            pending.append((qlo, rlo, sq, sr, aq, ar, res))
            # blocks are rebuilt per tile (no cache), so keep the
            # window shallow: each pending tile pins its block arrays
            if len(pending) > 1:
                drain(pending.popleft())
    while pending:
        drain(pending.popleft())

    if pairs:
        return ScreenResult(np.concatenate(pairs), np.concatenate(anis))
    return ScreenResult(np.empty((0, 2), np.int64), np.empty(0, np.float32))
