"""Scatter-free data movement primitives.

Written for a compiler whose scatter, gather-by-index and sort ran as
serialized loops far below memory speed. Every data movement the
sketch pipeline needs is in fact a MONOTONE routing or a small fixed
sorting network, and both have O(log) formulations built entirely from
power-of-two shifts and elementwise selects that stream at memory
bandwidth. On the GPU, XLA's own sort and scatter win for the device
sketcher (PERF.md), which now defaults to them; the screen extraction
and the sketch-product transport still use monotone_compact:

- monotone_compact: move masked elements to the front. Element i's
  left-distance d_i = i - rank_i (= unselected count before i) is
  nondecreasing, so processing distance bits LOW to HIGH moves each
  element by 2^b exactly when bit b of its remaining distance is set,
  and no two live elements ever collide (proof: a collision at step b
  needs remaining distances r_X <= r_Y with bit b set on X and clear
  on Y at positions 2^b apart, forcing original d_Y > d_X against
  monotonicity). log2(N) passes of shift+select.

- monotone_expand: the mirror image — move element j RIGHT to
  dests[j], requiring dests strictly increasing over live elements
  that sit COMPACTED at the front (then d_j = dests_j - j is
  nondecreasing). Used to build sorted-set bitmaps and fragment grids
  without scatter.

- bitonic_sort: Batcher's bitonic network over a power-of-two minor
  axis as log^2 reshape/flip/min/max stages. The XOR-partner exchange
  at distance j is a free reshape to (..., W/2j, 2, j) plus a
  middle-axis swap — no lane shuffles, no gathers. Multi-key
  (lexicographic) variants carry payload arrays through the same
  compare-exchanges.

These primitives give the routed device sketcher
(ops/device_sketch.py, GALAH_TPU_SKETCH_KERNEL=routed) its compaction,
per-fragment dedup and bitmap construction without scatters; the
reference delegates this entire stage to host CPUs (skani sketching,
reference src/skani.rs:270-290).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp


def _shift_left(x: jax.Array, sh: int, fill) -> jax.Array:
    """x[..., i] <- x[..., i+sh]; vacated tail filled with `fill`."""
    pad = jnp.full(x.shape[:-1] + (sh,), fill, dtype=x.dtype)
    return jnp.concatenate([x[..., sh:], pad], axis=-1)


def _shift_right(x: jax.Array, sh: int, fill) -> jax.Array:
    """x[..., i] <- x[..., i-sh]; vacated head filled with `fill`."""
    pad = jnp.full(x.shape[:-1] + (sh,), fill, dtype=x.dtype)
    return jnp.concatenate([pad, x[..., :-sh]], axis=-1)


def monotone_compact(
    mask: jax.Array,
    arrays: Sequence[jax.Array],
    pads: Sequence,
    cumsum_fn=None,
) -> Tuple[List[jax.Array], jax.Array]:
    """Move elements where mask is True to the front of the minor axis,
    preserving order; slots past the live count become `pads`.

    mask: (..., N) bool. arrays: same-shape integer arrays to route
    together. Returns (routed_arrays, n_live) with n_live of shape
    (...,). Cost: ceil(log2(N)) shift+select passes per array.

    cumsum_fn: optional minor-axis inclusive prefix sum for a 1D int32
    array (e.g. ops.pair_table._fast_cumsum, the hierarchical 2D scan).
    """
    n = mask.shape[-1]
    if cumsum_fn is not None:
        rank = cumsum_fn(mask.astype(jnp.int32))
    else:
        rank = jnp.cumsum(mask.astype(jnp.int32), axis=-1)
    n_live = rank[..., -1]
    # exclusive rank = selected strictly before i
    excl = rank - mask.astype(jnp.int32)
    iota = jax.lax.broadcasted_iota(jnp.int32, mask.shape, mask.ndim - 1)
    d = jnp.where(mask, iota - excl, 0)
    vals = [
        jnp.where(mask, a, jnp.asarray(p, dtype=a.dtype))
        for a, p in zip(arrays, pads)
    ]
    nbits = max(1, (n - 1).bit_length())
    for b in range(nbits):
        sh = 1 << b
        if sh >= n:
            break
        d_arr = _shift_left(d, sh, 0)
        take = ((d_arr >> b) & 1) == 1
        vacate = ((d >> b) & 1) == 1
        vals = [
            jnp.where(
                take,
                _shift_left(v, sh, p),
                jnp.where(vacate, jnp.asarray(p, dtype=v.dtype), v),
            )
            for v, p in zip(vals, pads)
        ]
        d = jnp.where(take, d_arr - sh, jnp.where(vacate, 0, d))
    return vals, n_live


def monotone_expand(
    values: jax.Array,
    dests: jax.Array,
    n_live,
    out_size: int,
    pad,
) -> jax.Array:
    """Scatter-free expansion: out[dests[j]] = values[j] for j < n_live,
    `pad` elsewhere.

    REQUIRES: live entries compacted at the front of the minor axis
    (j < n_live) and dests strictly increasing over them, with
    dests[j] >= j (guaranteed when dests are sorted distinct
    non-negatives: the j-th smallest is >= j). values/dests: (..., M);
    out: (..., out_size). Cost: ceil(log2(out_size)) passes.
    """
    m = values.shape[-1]
    assert m <= out_size, (m, out_size)
    iota = jax.lax.broadcasted_iota(jnp.int32, values.shape, values.ndim - 1)
    live = iota < n_live[..., None]
    x = jnp.where(live, values, jnp.asarray(pad, dtype=values.dtype))
    d = jnp.where(live, dests - iota, 0)
    if m < out_size:
        zshape = values.shape[:-1] + (out_size - m,)
        x = jnp.concatenate(
            [x, jnp.full(zshape, pad, dtype=values.dtype)], axis=-1
        )
        d = jnp.concatenate([d, jnp.zeros(zshape, jnp.int32)], axis=-1)
    # Bits HIGH to LOW: the mirror of compaction's low-to-high order.
    # (For right-moves with nondecreasing distances, low-to-high CAN
    # collide — e.g. dests [1, 3] from positions [0, 1]: at b=0 the
    # first element lands on the still-waiting second. High-to-low is
    # provably collision-free: a collision at step b forces, via the
    # mod-2^{b+1} remainders, position order to contradict either
    # d-monotonicity or target order.)
    nbits = max(1, (out_size - 1).bit_length())
    for b in reversed(range(nbits)):
        sh = 1 << b
        if sh >= out_size:
            continue
        d_arr = _shift_right(d, sh, 0)
        take = ((d_arr >> b) & 1) == 1
        vacate = ((d >> b) & 1) == 1
        x = jnp.where(
            take,
            _shift_right(x, sh, pad),
            jnp.where(vacate, jnp.asarray(pad, dtype=x.dtype), x),
        )
        d = jnp.where(take, d_arr - sh, jnp.where(vacate, 0, d))
    return x


# ---------------------------------------------------------------------------
# Tiled (lane-aligned) variants.
#
# Arrays tiled as (sublane, 128-lane) blocks: a shift or XOR-exchange
# at distance < 128 along the minor axis forces lane-crossing relayouts
# every pass, and most passes have small distances (log-shift routing
# spends 7 of 20 passes below 128; a bitonic network spends ~60% of its
# stages there). The fix: view the flat axis as an (R, C=128) matrix.
# Distances >= C move whole rows (free leading-axis reshapes); for
# distances < C, transpose once to (C, R) — the small distance now
# addresses the LEADING axis, so every pass is lane-aligned — and
# transpose back when distances grow. Two transposes per routing call,
# ~2 per bitonic merge phase; each costs one memory pass.
# ---------------------------------------------------------------------------

_LANES = 128


def _tshift_left(xt: jax.Array, sh: int, fill) -> jax.Array:
    """Flat left-shift by sh < C on the transposed (..., C, R) view:
    column c reads column c+sh, except the top sh columns wrap to
    columns c+sh-C of the NEXT row (a one-step minor-axis shift of an
    (sh, R) sliver)."""
    main = xt[..., sh:, :]
    wrap = _shift_left(xt[..., :sh, :], 1, fill)
    return jnp.concatenate([main, wrap], axis=-2)


def _tshift_right(xt: jax.Array, sh: int, fill) -> jax.Array:
    """Mirror of _tshift_left: column c reads c-sh, bottom sh columns
    wrap to the previous row."""
    main = xt[..., : xt.shape[-2] - sh, :]
    wrap = _shift_right(xt[..., xt.shape[-2] - sh :, :], 1, fill)
    return jnp.concatenate([wrap, main], axis=-2)


def _rowshift_left(xn: jax.Array, rows: int, fill) -> jax.Array:
    pad = jnp.full(xn.shape[:-2] + (rows, xn.shape[-1]), fill, xn.dtype)
    return jnp.concatenate([xn[..., rows:, :], pad], axis=-2)


def _rowshift_right(xn: jax.Array, rows: int, fill) -> jax.Array:
    pad = jnp.full(xn.shape[:-2] + (rows, xn.shape[-1]), fill, xn.dtype)
    return jnp.concatenate([pad, xn[..., : xn.shape[-2] - rows, :]], axis=-2)


def _use_tiled(n: int) -> bool:
    return n >= 4 * _LANES and n % _LANES == 0


def monotone_compact_tiled(
    mask: jax.Array,
    arrays: Sequence[jax.Array],
    pads: Sequence,
    cumsum_fn=None,
) -> Tuple[List[jax.Array], jax.Array]:
    """monotone_compact with lane-aligned passes: small-distance passes
    (2^b < 128) run on the transposed (C, R) view, large ones as row
    shifts on the (R, C) view. Bit-identical to monotone_compact."""
    n = mask.shape[-1]
    if not _use_tiled(n):
        return monotone_compact(mask, arrays, pads, cumsum_fn=cumsum_fn)
    C = _LANES
    R = n // C
    if cumsum_fn is not None:
        rank = cumsum_fn(mask.astype(jnp.int32))
    else:
        rank = jnp.cumsum(mask.astype(jnp.int32), axis=-1)
    n_live = rank[..., -1]
    excl = rank - mask.astype(jnp.int32)
    iota = jax.lax.broadcasted_iota(jnp.int32, mask.shape, mask.ndim - 1)
    d = jnp.where(mask, iota - excl, 0)
    vals = [
        jnp.where(mask, a, jnp.asarray(p, dtype=a.dtype))
        for a, p in zip(arrays, pads)
    ]

    def t(x):  # (..., n) -> (..., C, R)
        return jnp.swapaxes(x.reshape(*x.shape[:-1], R, C), -1, -2)

    def un(xt):  # (..., C, R) -> (..., n)
        return jnp.swapaxes(xt, -1, -2).reshape(*xt.shape[:-2], n)

    d = t(d)
    vals = [t(v) for v in vals]
    lane_bits = C.bit_length() - 1
    nbits = max(1, (n - 1).bit_length())
    for b in range(min(lane_bits, nbits)):
        sh = 1 << b
        d_arr = _tshift_left(d, sh, 0)
        take = ((d_arr >> b) & 1) == 1
        vacate = ((d >> b) & 1) == 1
        vals = [
            jnp.where(
                take,
                _tshift_left(v, sh, p),
                jnp.where(vacate, jnp.asarray(p, dtype=v.dtype), v),
            )
            for v, p in zip(vals, pads)
        ]
        d = jnp.where(take, d_arr - sh, jnp.where(vacate, 0, d))
    # large passes: row shifts on the untransposed view
    d = jnp.swapaxes(d, -1, -2)
    vals = [jnp.swapaxes(v, -1, -2) for v in vals]
    for b in range(lane_bits, nbits):
        sh = 1 << b
        if sh >= n:
            break
        rows = sh // C
        d_arr = _rowshift_left(d, rows, 0)
        take = ((d_arr >> b) & 1) == 1
        vacate = ((d >> b) & 1) == 1
        vals = [
            jnp.where(
                take,
                _rowshift_left(v, rows, p),
                jnp.where(vacate, jnp.asarray(p, dtype=v.dtype), v),
            )
            for v, p in zip(vals, pads)
        ]
        d = jnp.where(take, d_arr - sh, jnp.where(vacate, 0, d))
    vals = [v.reshape(*v.shape[:-2], n) for v in vals]
    return vals, n_live


def monotone_expand_tiled(
    values: jax.Array,
    dests: jax.Array,
    n_live,
    out_size: int,
    pad,
) -> jax.Array:
    """monotone_expand with lane-aligned passes (bits HIGH->LOW: row
    shifts first, then the small distances on the transposed view)."""
    if not _use_tiled(out_size):
        return monotone_expand(values, dests, n_live, out_size, pad)
    C = _LANES
    R = out_size // C
    m = values.shape[-1]
    assert m <= out_size, (m, out_size)
    iota = jax.lax.broadcasted_iota(jnp.int32, values.shape, values.ndim - 1)
    live = iota < n_live[..., None]
    x = jnp.where(live, values, jnp.asarray(pad, dtype=values.dtype))
    d = jnp.where(live, dests - iota, 0)
    if m < out_size:
        zshape = values.shape[:-1] + (out_size - m,)
        x = jnp.concatenate(
            [x, jnp.full(zshape, pad, dtype=values.dtype)], axis=-1
        )
        d = jnp.concatenate([d, jnp.zeros(zshape, jnp.int32)], axis=-1)
    x = x.reshape(*x.shape[:-1], R, C)
    d = d.reshape(*d.shape[:-1], R, C)
    lane_bits = C.bit_length() - 1
    nbits = max(1, (out_size - 1).bit_length())
    for b in reversed(range(lane_bits, nbits)):
        sh = 1 << b
        if sh >= out_size:
            continue
        rows = sh // C
        d_arr = _rowshift_right(d, rows, 0)
        take = ((d_arr >> b) & 1) == 1
        vacate = ((d >> b) & 1) == 1
        x = jnp.where(
            take,
            _rowshift_right(x, rows, pad),
            jnp.where(vacate, jnp.asarray(pad, dtype=x.dtype), x),
        )
        d = jnp.where(take, d_arr - sh, jnp.where(vacate, 0, d))
    x = jnp.swapaxes(x, -1, -2)
    d = jnp.swapaxes(d, -1, -2)
    for b in reversed(range(min(lane_bits, nbits))):
        sh = 1 << b
        d_arr = _tshift_right(d, sh, 0)
        take = ((d_arr >> b) & 1) == 1
        vacate = ((d >> b) & 1) == 1
        x = jnp.where(
            take,
            _tshift_right(x, sh, pad),
            jnp.where(vacate, jnp.asarray(pad, dtype=x.dtype), x),
        )
        d = jnp.where(take, d_arr - sh, jnp.where(vacate, 0, d))
    x = jnp.swapaxes(x, -1, -2)
    return x.reshape(*x.shape[:-2], out_size)


def _exchange_tiled_rows(
    arrays: Sequence[jax.Array], kk: int, j: int, n_keys: int, C: int
) -> List[jax.Array]:
    """Compare-exchange at distance j >= C on the (..., R, C) view:
    partner rows differ by dj = j // C."""
    dj = j // C
    r = arrays[0].shape[-2]
    lead = arrays[0].shape[:-2]
    parts = [
        a.reshape(*lead, r // (2 * dj), 2, dj, C) for a in arrays
    ]
    a_lo = [h[..., 0, :, :] for h in parts]
    a_hi = [h[..., 1, :, :] for h in parts]
    # direction bit log2(kk) of i = row*C + c; kk >= 2j >= 2C so it is
    # a row bit determined by the block coordinate a: row = a*2dj + ...
    u = jax.lax.broadcasted_iota(
        jnp.int32, (r // (2 * dj), 1, 1), 0
    )
    asc = ((u * (2 * dj)) & (kk // C)) == 0
    return _apply_exchange(a_lo, a_hi, asc, n_keys, lead, r, C, axis_pair=-3)


def _exchange_tiled_t(
    arrays: Sequence[jax.Array], kk: int, j: int, n_keys: int, C: int
) -> List[jax.Array]:
    """Compare-exchange at distance j < C on the transposed (..., C, R)
    view: partner columns differ by j along the leading axis."""
    rr = arrays[0].shape[-1]
    lead = arrays[0].shape[:-2]
    parts = [
        a.reshape(*lead, C // (2 * j), 2, j, rr) for a in arrays
    ]
    a_lo = [h[..., 0, :, :] for h in parts]
    a_hi = [h[..., 1, :, :] for h in parts]
    if kk < C:
        # direction bit is a c bit -> from the block coordinate
        u = jax.lax.broadcasted_iota(
            jnp.int32, (C // (2 * j), 1, 1), 0
        )
        asc = ((u * (2 * j)) & kk) == 0
    else:
        # direction bit is a row bit -> from the last axis (logical row)
        u = jax.lax.broadcasted_iota(jnp.int32, (1, 1, rr), 2)
        asc = (u & (kk // C)) == 0
    return _apply_exchange(a_lo, a_hi, asc, n_keys, lead, C, rr, axis_pair=-3)


def _apply_exchange(a_lo, a_hi, asc, n_keys, lead, d0, d1, axis_pair):
    gt = a_lo[0] > a_hi[0]
    if n_keys > 1:
        eq = a_lo[0] == a_hi[0]
        for k in range(1, n_keys):
            gt = gt | (eq & (a_lo[k] > a_hi[k]))
            if k + 1 < n_keys:
                eq = eq & (a_lo[k] == a_hi[k])
    swap = jnp.where(asc, gt, ~gt)
    out = []
    for lo, hi in zip(a_lo, a_hi):
        new_lo = jnp.where(swap, hi, lo)
        new_hi = jnp.where(swap, lo, hi)
        out.append(
            jnp.stack([new_lo, new_hi], axis=axis_pair).reshape(
                *lead, d0, d1
            )
        )
    return out


def bitonic_sort_tiled(
    arrays: Sequence[jax.Array], n_keys: int = 1
) -> List[jax.Array]:
    """bitonic_sort with every compare-exchange lane-aligned: stages at
    distance >= 128 exchange rows of the (R, 128) view, stages below
    run on the transposed (128, R) view, switching layouts lazily
    (~2 transposes per merge phase). Bit-identical to bitonic_sort."""
    arrays = list(arrays)
    w = arrays[0].shape[-1]
    assert w & (w - 1) == 0, f"bitonic width {w} not a power of two"
    C = _LANES
    if w < 4 * C:
        return bitonic_sort(arrays, n_keys)
    lead = arrays[0].shape[:-1]
    r = w // C
    # start in T layout (the first phases are all small-distance)
    cur = [
        jnp.swapaxes(a.reshape(*lead, r, C), -1, -2) for a in arrays
    ]
    in_t = True

    def to_t(xs):
        return [jnp.swapaxes(x, -1, -2) for x in xs]

    kk = 2
    while kk <= w:
        j = kk // 2
        while j >= 1:
            if j >= C:
                if in_t:
                    cur = to_t(cur)
                    in_t = False
                cur = _exchange_tiled_rows(cur, kk, j, n_keys, C)
            else:
                if not in_t:
                    cur = to_t(cur)
                    in_t = True
                cur = _exchange_tiled_t(cur, kk, j, n_keys, C)
            j //= 2
        kk *= 2
    if in_t:
        cur = to_t(cur)
    return [x.reshape(*lead, w) for x in cur]


def _lex_gt(a_keys: Sequence[jax.Array], b_keys: Sequence[jax.Array]):
    """Lexicographic a > b over parallel key arrays."""
    gt = a_keys[0] > b_keys[0]
    if len(a_keys) > 1:
        eq = a_keys[0] == b_keys[0]
        for k in range(1, len(a_keys)):
            gt = gt | (eq & (a_keys[k] > b_keys[k]))
            if k + 1 < len(a_keys):
                eq = eq & (a_keys[k] == b_keys[k])
    return gt


def bitonic_sort_scan(
    arrays: Sequence[jax.Array], n_keys: int = 1
) -> List[jax.Array]:
    """bitonic_sort_tiled compiled as fori_loops instead of log^2(W)
    unrolled stages — bit-identical results (same compare-exchange
    network in the same order, including equal-key payload swaps in
    descending blocks).

    Why: the unrolled network generates enormous HLO — at the device
    sketcher's production widths (2^17-2^18) each sort is ~170 stages
    of ~8 ops per carried array, and cold compiles take minutes per
    shape bucket. Here each merge phase is TWO small loop
    bodies (row-distance stages on the (R, 128) view, sub-lane stages
    on the transposed view) with the exchange distance as a TRACED
    value: partners are fetched with dynamic rolls along the
    SECOND-minor axis (sublane-cheap, lane-aligned — never a minor-axis
    shuffle), so every pass stays at memory speed while the compiled
    program has O(log W) small bodies instead of O(log^2 W) stages.

    Correctness of the roll-fetch: at exchange distance j (a power of
    two), an element with bit j clear pairs UP (i+j stays inside its
    2j block, so the roll's wraparound entries are never selected) and
    an element with bit j set pairs DOWN; `where` picks the right roll.
    """
    arrays = list(arrays)
    w = arrays[0].shape[-1]
    assert w & (w - 1) == 0, f"bitonic width {w} not a power of two"
    C = _LANES
    if w < 4 * C:
        return bitonic_sort(arrays, n_keys)
    lead = arrays[0].shape[:-1]
    r = w // C
    lane_bits = C.bit_length() - 1

    def t(xs):  # (..., R, C) <-> (..., C, R)
        return [jnp.swapaxes(x, -1, -2) for x in xs]

    # Row-layout direction/partner masks come from the row index; the
    # transposed layout uses the column index for distances < C and the
    # row index (its minor axis) for kk >= C.
    row_iota_rc = jax.lax.broadcasted_iota(
        jnp.int32, (*([1] * len(lead)), r, 1), len(lead)
    )
    col_iota_cr = jax.lax.broadcasted_iota(
        jnp.int32, (*([1] * len(lead)), C, 1), len(lead)
    )
    row_iota_cr = jax.lax.broadcasted_iota(
        jnp.int32, (*([1] * len(lead)), 1, r), len(lead) + 1
    )

    def exchange(arrs, axis_iota, dist, dir_mask):
        """One compare-exchange at traced roll distance `dist` along
        axis -2; dir_mask True where the block sorts ascending;
        axis_iota indexes axis -2 (for the pair-bit test)."""
        has_bit = (axis_iota & dist) != 0
        partners = []
        for a in arrs:
            up = jnp.roll(a, -dist, axis=-2)
            down = jnp.roll(a, dist, axis=-2)
            partners.append(jnp.where(has_bit, down, up))
        g_self = _lex_gt(arrs[:n_keys], partners[:n_keys])
        g_partner = _lex_gt(partners[:n_keys], arrs[:n_keys])
        g = jnp.where(has_bit, g_partner, g_self)  # gt(lo, hi) everywhere
        swap = jnp.where(dir_mask, g, ~g)
        return [
            jnp.where(swap, p, a) for a, p in zip(arrs, partners)
        ]

    cur = [x.reshape(*lead, r, C) for x in arrays]
    in_t = False
    kk = 2
    while kk <= w:
        n_row = max(0, kk.bit_length() - 1 - lane_bits)  # stages with j >= C
        n_sub = min(kk.bit_length() - 1, lane_bits)      # stages with j < C
        if n_row:
            if in_t:
                cur = t(cur)
                in_t = False
            kr = kk // C  # >= 2 whenever n_row > 0
            dirm = (row_iota_rc & kr) == 0

            # j = kk >> (1+s) for s in [0, n_row): all >= C
            def row_body(s, arrs, kk=kk, dirm=dirm):
                jr = (kk >> (1 + s)) // C
                return exchange(arrs, row_iota_rc, jr, dirm)

            cur = jax.lax.fori_loop(0, n_row, row_body, cur)
        if n_sub:
            if not in_t:
                cur = t(cur)
                in_t = True
            if kk >= C:
                dirm = (row_iota_cr & (kk // C)) == 0
            else:
                dirm = (col_iota_cr & kk) == 0
            j0 = min(kk >> 1, C >> 1)

            def sub_body(s, arrs, j0=j0, dirm=dirm):
                return exchange(arrs, col_iota_cr, j0 >> s, dirm)

            cur = jax.lax.fori_loop(0, n_sub, sub_body, cur)
        kk *= 2
    if in_t:
        cur = t(cur)
    return [x.reshape(*lead, w) for x in cur]


def _exchange(
    arrays: Sequence[jax.Array], kk: int, j: int, n_keys: int
) -> List[jax.Array]:
    """One bitonic compare-exchange stage: partner = i ^ j, ascending
    within blocks where (i & kk) == 0. Lexicographic on the first
    n_keys arrays; the rest ride along as payload."""
    w = arrays[0].shape[-1]
    lead = arrays[0].shape[:-1]
    halves = [a.reshape(*lead, w // (2 * j), 2, j) for a in arrays]
    a_lo = [h[..., 0, :] for h in halves]
    a_hi = [h[..., 1, :] for h in halves]
    # ascending iff bit log2(kk) of the element index is 0; that bit is
    # constant within a pair (it is >= log2(2j)) and depends only on
    # the block coordinate u: i = u*2j + v*j + w.
    u = jax.lax.broadcasted_iota(jnp.int32, (w // (2 * j), 1), 0)
    asc = (u * (2 * j) & kk) == 0
    gt = a_lo[0] > a_hi[0]
    if n_keys > 1:
        eq = a_lo[0] == a_hi[0]
        for k in range(1, n_keys):
            gt = gt | (eq & (a_lo[k] > a_hi[k]))
            if k + 1 < n_keys:
                eq = eq & (a_lo[k] == a_hi[k])
    swap = jnp.where(asc, gt, ~gt)
    out = []
    for lo, hi in zip(a_lo, a_hi):
        new_lo = jnp.where(swap, hi, lo)
        new_hi = jnp.where(swap, lo, hi)
        out.append(
            jnp.stack([new_lo, new_hi], axis=-2).reshape(*lead, w)
        )
    return out


def bitonic_sort(
    arrays: Sequence[jax.Array], n_keys: int = 1
) -> List[jax.Array]:
    """Sort along the minor axis (width must be a power of two) by the
    first n_keys arrays lexicographically, carrying the rest as
    payload. log2(W)*(log2(W)+1)/2 elementwise stages, no scatters."""
    arrays = list(arrays)
    w = arrays[0].shape[-1]
    assert w & (w - 1) == 0, f"bitonic width {w} not a power of two"
    kk = 2
    while kk <= w:
        j = kk // 2
        while j >= 1:
            arrays = _exchange(arrays, kk, j, n_keys)
            j //= 2
        kk *= 2
    return arrays
