"""Mesh-sharded all-vs-all sketch screen (tiled, sparse-extracting).

The packed bitmap matrix is made resident on every device (replicated;
at the 300k-genome north star with shrunk bitmaps this is ~1-5GB, well
inside one GPU's memory) and the upper-triangle TILE list is sharded
across the mesh: each device sweeps its own (block x block) tiles with
the intersection matmul and extracts the sparse above-cutoff pairs
ON DEVICE. Only (count, idx, idx, val) tuples bounded by `cap` per tile
ever leave a device, so host memory is O(candidates), never O(n^2) —
the property that lets the screen reach the reference's "arbitrarily
many genomes" configs (skani's sketch-then-stream search,
reference src/skani.rs:229-377) at device speed.

Dispatches are chunked (fixed tile count per dispatch -> one compiled
shape) and drained through a bounded in-flight window. Multi-host runs
allgather only the sparse chunk results over DCN.

The host-side greedy clustering then proceeds identically regardless of
device count, which is the distributed invariant the tests pin (same
clusters.tsv for any mesh size).
"""

from __future__ import annotations

import logging
import math
from collections import deque
from functools import partial
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from galah_tpu.ops.prefilter import (
    ScreenResult,
    _block_containment_packed,
    _containment,
    _device_resident_budget,
    _drain_tile,
    _extract_above_cutoff,
    _resident_screen_extract,
    _screen_block_for,
    _screen_cap_for,
    _screen_counts_packed,
    _screen_dt,
    _screen_dtype_name,
    _screen_matmul,
    _unpack_bits,
)

logger = logging.getLogger(__name__)

# Tiles per device per dispatch: large enough that dispatch overhead
# amortizes, small enough that a chunk's sparse output stays tiny.
TILES_PER_DEVICE = 8
# In-flight dispatch window (results drain once this many are issued).
DISPATCH_WINDOW = 8
# Row-sharded sweep: per-device per-stage compacted output capacity.
ROWSHARD_STAGE_CAP = 1 << 15


_TILE_FN_CACHE: dict = {}


def _tile_screen_fn(mesh: Mesh, block: int, cap: int, dtname: str):
    """Build (and cache) the jitted sharded tile sweep for one mesh,
    tile edge, and extraction cap. The bitmap width, containment cutoff
    and tile count are traced, so one compilation serves every run.

    Formulation: shard_map over every mesh axis — each device owns an
    equal slice of the (T, 3) [(bi, bj, valid)] tile list and scans it
    sequentially, slicing tiles out of the replicated packed matrix.
    (A vmap+GSPMD formulation of the same sweep compiled ~300x slower
    and batched the dynamic slices into gathers; the scan body compiles
    once and executes per-tile.)
    """
    key = (mesh, block, cap, dtname)
    fn = _TILE_FN_CACHE.get(key)
    if fn is not None:
        return fn

    axes = tuple(mesh.axis_names)

    def tile_body(x_all, sizes, bits_f, min_cont, tij):
        bi, bj, valid = tij[0], tij[1], tij[2]
        w = x_all.shape[1]
        si = jax.lax.dynamic_slice(x_all, (bi * block, 0), (block, w))
        sj = jax.lax.dynamic_slice(x_all, (bj * block, 0), (block, w))
        a = jax.lax.dynamic_slice(sizes, (bi * block,), (block,))
        b = jax.lax.dynamic_slice(sizes, (bj * block,), (block,))
        counts = _screen_counts_packed(si, sj, dtname)
        cont = _containment(counts, a, b, bits_f)
        rows_i = jax.lax.broadcasted_iota(jnp.int32, (block, block), 0)
        cols_j = jax.lax.broadcasted_iota(jnp.int32, (block, block), 1)
        mask = (cont >= min_cont) & ((bi != bj) | (cols_j > rows_i))
        mask = mask & (valid > 0)
        cnt, ii, jj, vals = _extract_above_cutoff(cont, mask, cap)
        return (
            cnt.astype(jnp.int32),
            ii,
            jj,
            vals.astype(jnp.bfloat16),
        )

    def local_fn(x_all, sizes, bits_f, min_cont, tiles):
        def scan_body(carry, tij):
            return carry, tile_body(x_all, sizes, bits_f, min_cont, tij)

        _, outs = jax.lax.scan(scan_body, 0, tiles)
        return outs

    fn = jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(), P(), P(), P(), P(axes, None)),
            out_specs=(P(axes), P(axes, None), P(axes, None), P(axes, None)),
        )
    )
    _TILE_FN_CACHE[key] = fn
    return fn


def _pick_block(n: int, block: int) -> int:
    """Shrink the tile edge for small inputs so tiny runs don't pay a
    (1024 x 1024) matmul for 24 genomes."""
    if n >= block:
        return block
    return max(128, 1 << (max(n - 1, 1)).bit_length())


def sharded_screen_triangle_packed(
    packed: Sequence[np.ndarray],
    sizes: np.ndarray,
    k: int,
    min_containment: float,
    bits: int,
    mesh: Optional[Mesh] = None,
    block: int = 0,
    cap: int = 0,
    checkpoint_path: Optional[str] = None,
    unit_names=None,
) -> ScreenResult:
    """Upper-triangle all-vs-all screen over packed uint32 bitmaps with
    the tile list sharded across `mesh`. block/cap of 0 pick the
    measured-best tile edge for the backend (_screen_block_for).

    packed: list-like of per-genome (W,) uint32 rows (may be lazy —
    rows materialize once while building the resident matrix).
    sizes: (n,) bucket counts.
    checkpoint_path + unit_names: mid-sweep tile log
    (ops/sweep_checkpoint.py) — logged tiles replay instead of
    re-dispatching. Single-process only: the lockstep multi-process
    contract requires every process to dispatch the identical tile
    list, and per-host logs could diverge; with several processes the
    checkpoint is ignored with a warning."""
    if mesh is None:
        from galah_tpu.parallel.mesh import make_mesh

        mesh = make_mesh()
    n = len(packed)
    if n == 0:
        return ScreenResult(np.empty((0, 2), np.int64), np.empty(0, np.float32))
    w = getattr(packed, "row_width", None) or len(packed[0])
    block = _pick_block(n, block or _screen_block_for(n))
    cap = cap or _screen_cap_for(block)

    # Replicating the resident matrix is fastest while it fits; past
    # the per-device HBM budget, row-shard it so capacity scales with
    # device count (GALAH_TPU_ROWSHARD=1/0 forces either way).
    import os as _os

    rowshard_env = _os.environ.get("GALAH_TPU_ROWSHARD")
    n_pad_est = ((n + block - 1) // block) * block
    if rowshard_env != "0" and (
        rowshard_env == "1"
        or n_pad_est * w * 4 > _device_resident_budget()
    ):
        logger.info(
            "Row-sharding the resident packed matrix (%d rows x %d words "
            "> per-device budget)", n, w,
        )
        if checkpoint_path:
            logger.warning(
                "--sweep-checkpoint is not supported by the row-sharded "
                "sweep; this run will NOT checkpoint mid-sweep"
            )
        return sharded_screen_triangle_rowsharded(
            packed, sizes, k, min_containment, bits, mesh=mesh,
            # the row-sharded sweep broadcasts one column block per
            # stage over the mesh — keep its tiles at 1024 so the psum
            # payload and per-slot stage buffers stay modest
            block=min(block, 1024),
        )

    n_pad = ((n + block - 1) // block) * block
    nblocks = n_pad // block

    checkpoint = None
    if checkpoint_path:
        if jax.process_count() > 1:
            logger.warning(
                "--sweep-checkpoint is ignored on multi-process runs "
                "of the sharded sweep (per-host logs would break the "
                "lockstep dispatch contract)"
            )
        elif unit_names is None:
            logger.warning(
                "--sweep-checkpoint needs unit names; ignored"
            )
        else:
            from galah_tpu.ops.sweep_checkpoint import (
                SweepCheckpoint,
                sweep_fingerprint,
            )

            checkpoint = SweepCheckpoint(
                checkpoint_path,
                sweep_fingerprint(
                    unit_names, bits, block, k,
                    float(np.float32(min_containment)),
                    _screen_dtype_name(),
                ),
            )

    tiles = [(bi, bj) for bi in range(nblocks) for bj in range(bi, nblocks)]
    restored_pairs: List[np.ndarray] = []
    restored_anis: List[np.ndarray] = []
    if checkpoint is not None and len(checkpoint):
        # Replay logged tiles BEFORE materializing/uploading the
        # resident matrix: a completed log must return without paying
        # the multi-GB replicated device_put at all.
        remaining = []
        for bi, bj in tiles:
            got = checkpoint.has(bi, bj)
            if got is None:
                remaining.append((bi, bj))
            else:
                p, a = got
                if len(p):
                    restored_pairs.append(p)
                    restored_anis.append(a)
        logger.info(
            "Sweep checkpoint: %d/%d tiles replayed",
            len(tiles) - len(remaining), len(tiles),
        )
        tiles = remaining
        if not tiles:
            checkpoint.close()
            if restored_pairs:
                return ScreenResult(
                    np.concatenate(restored_pairs),
                    np.concatenate(restored_anis),
                )
            return ScreenResult(
                np.empty((0, 2), np.int64), np.empty(0, np.float32)
            )

    # Materialize the resident matrix only when tiles remain to sweep
    # (rows may be lazy; a completed checkpoint replay never pays this
    # build or its replicated device upload).
    x_np = np.zeros((n_pad, w), dtype=np.uint32)
    for t in range(n):
        x_np[t] = packed[t]
    s_np = np.zeros((n_pad,), dtype=np.float32)
    s_np[:n] = sizes.astype(np.float32)

    res = _replicated_tile_sweep(
        x_np, s_np, tiles, mesh, block, cap, bits,
        float(np.float32(min_containment)), 1.0 / k,
        col0_blocks=0, n_rows=n, n_cols=n, checkpoint=checkpoint,
    )
    if restored_pairs:
        return ScreenResult(
            np.concatenate(restored_pairs + [res.pairs]),
            np.concatenate(restored_anis + [res.ani_est]),
        )
    return res


def _replicated_tile_sweep(
    x_np: np.ndarray,
    s_np: np.ndarray,
    tiles: List[Tuple[int, int]],
    mesh: Mesh,
    block: int,
    cap: int,
    bits: int,
    min_cont_static: float,
    inv_k: float,
    *,
    col0_blocks: int,
    n_rows: int,
    n_cols: int,
    checkpoint=None,
) -> ScreenResult:
    """Shared driver for the replicated-resident tile sweeps (triangle
    AND rectangle): make the packed matrix resident on every device,
    dispatch the sharded tile kernel over chunked tile lists, drain
    through a bounded in-flight window, and decode the two-level
    extraction — row-overflow re-dispatch, then dense-pull fallback —
    under the lockstep multi-process contract (every process executes
    the identical re-dispatches, so collectives stay aligned).

    Tiles address the resident matrix with GLOBAL block indices
    (bi, bjg). Emitted column indices are rebased by `col0_blocks`
    (0 for the triangle; the query block count for the rectangle, whose
    refs live at rows [nq_pad, ...) of the concatenated matrix) and
    rows/cols are kept below n_rows/n_cols (padding dropped)."""
    n_devices = math.prod(mesh.shape.values())
    # Equal tile share per device per dispatch; tiny runs use one tile
    # per device so padding lanes don't multiply the work.
    tiles_per_device = min(
        TILES_PER_DEVICE, (len(tiles) + n_devices - 1) // n_devices
    )
    chunk_tiles = n_devices * tiles_per_device

    rep = NamedSharding(mesh, P())
    axes = tuple(mesh.axis_names)
    mat_sh = NamedSharding(mesh, P(axes, None))
    x_all = jax.device_put(x_np, rep)
    s_all = jax.device_put(s_np, rep)
    del x_np

    dtn = _screen_dtype_name()
    fn = _tile_screen_fn(mesh, block, cap, dtn)
    bits_dev = jnp.float32(bits)
    min_cont_dev = jnp.float32(min_cont_static)
    multiproc = jax.process_count() > 1

    pairs: List[np.ndarray] = []
    anis: List[np.ndarray] = []

    def collect(tile_chunk, outs):
        if multiproc:
            from jax.experimental import multihost_utils

            cnt, ii, jj, vals = (
                multihost_utils.process_allgather(o, tiled=True) for o in outs
            )
        else:
            cnt, ii, jj, vals = outs
        cnt = np.asarray(cnt)
        ii = np.asarray(ii)
        jj = np.asarray(jj)
        vals = np.asarray(vals).astype(np.float32)
        for t, (bi, bjg) in enumerate(tile_chunk):
            before = len(pairs)

            def dense_cont(bi=bi, bjg=bjg):
                lo_i, lo_j = bi * block, bjg * block
                return np.array(
                    _block_containment_packed(
                        x_all[lo_i : lo_i + block],
                        x_all[lo_j : lo_j + block],
                        s_all[lo_i : lo_i + block],
                        s_all[lo_j : lo_j + block],
                        float(bits),
                        dtname=dtn,
                    )
                ).astype(np.float32)

            # Row-overflow re-extracts directly (the matrix is resident,
            # only sparse results move); every process executes the
            # identical re-dispatch (lockstep contract, as for the
            # dense pull).
            _drain_tile(
                (cnt[t], ii[t], jj[t], vals[t]),
                cap=cap, row0=bi * block,
                col0=(bjg - col0_blocks) * block, inv_k=inv_k,
                min_cont_f=min_cont_static, dense_cont=dense_cont,
                reextract=lambda bi=bi, bjg=bjg: _resident_screen_extract(
                    x_all, s_all, jnp.int32(bi), jnp.int32(bjg),
                    block=block, bits_f=float(bits),
                    min_cont=min_cont_static, cap=cap,
                    is_diag=bi == bjg, dtname=dtn, direct=True,
                ),
                diag=bi == bjg, keep_rows=n_rows, keep_cols=n_cols,
                pairs=pairs, anis=anis,
            )
            if checkpoint is not None:
                got_new = len(pairs) > before
                checkpoint.put(
                    bi, bjg,
                    pairs[-1] if got_new else np.empty((0, 2), np.int64),
                    anis[-1] if got_new else np.empty(0, np.float32),
                )

    pending: deque = deque()
    tij = np.zeros((chunk_tiles, 3), dtype=np.int32)
    for lo in range(0, len(tiles), chunk_tiles):
        tile_chunk = tiles[lo : lo + chunk_tiles]
        tij[:] = 0
        for t, (bi, bjg) in enumerate(tile_chunk):
            tij[t] = (bi, bjg, 1)
        outs = fn(
            x_all, s_all, bits_dev, min_cont_dev,
            jax.device_put(tij.copy(), mat_sh),
        )
        pending.append((tile_chunk, outs))
        if len(pending) > DISPATCH_WINDOW:
            collect(*pending.popleft())
    while pending:
        collect(*pending.popleft())
    if checkpoint is not None:
        checkpoint.close()

    if pairs:
        return ScreenResult(np.concatenate(pairs), np.concatenate(anis))
    return ScreenResult(np.empty((0, 2), np.int64), np.empty(0, np.float32))


def sharded_screen_rectangle_packed(
    query_packed: Sequence[np.ndarray],
    query_sizes: np.ndarray,
    ref_packed: Sequence[np.ndarray],
    ref_sizes: np.ndarray,
    k: int,
    min_containment: float,
    bits: int,
    mesh: Optional[Mesh] = None,
    block: int = 0,
    cap: int = 0,
) -> ScreenResult:
    """Reference-genome (rectangular) screen with the
    query-block x ref-block tile list sharded across `mesh` — the
    mesh-scaled equivalent of the reference's stream-queries-against-
    ref-DB search (src/skani.rs:502-687; SURVEY P9).

    Queries and refs concatenate into one replicated resident matrix
    (queries at rows [0, nq_pad), refs at [nq_pad, ...)), and the tile
    sweep reuses the triangle's shard_map kernel: ref tiles carry block
    index nq_pad/block + bj, which never equals a query block index, so
    the kernel's diagonal mask reduces to the plain cutoff. Only sparse
    (count, ii, jj, val) tuples leave a device. Returned pairs are
    (query_idx, ref_idx). Past the per-device HBM budget the sweep
    switches to the row-sharded variant (same GALAH_TPU_ROWSHARD
    override as the triangle)."""
    if mesh is None:
        from galah_tpu.parallel.mesh import make_mesh

        mesh = make_mesh()
    nq, nr = len(query_packed), len(ref_packed)
    if nq == 0 or nr == 0:
        return ScreenResult(np.empty((0, 2), np.int64), np.empty(0, np.float32))
    w = getattr(query_packed, "row_width", None) or len(query_packed[0])
    block = _pick_block(max(nq, nr), block or _screen_block_for(max(nq, nr)))
    cap = cap or _screen_cap_for(block)

    import os as _os

    rowshard_env = _os.environ.get("GALAH_TPU_ROWSHARD")
    n_pad_est = (
        ((nq + block - 1) // block) + ((nr + block - 1) // block)
    ) * block
    if rowshard_env != "0" and (
        rowshard_env == "1"
        or n_pad_est * w * 4 > _device_resident_budget()
    ):
        logger.info(
            "Row-sharding the resident rectangle matrix (%d+%d rows x %d "
            "words > per-device budget)", nq, nr, w,
        )
        return sharded_screen_rectangle_rowsharded(
            query_packed, query_sizes, ref_packed, ref_sizes,
            k, min_containment, bits, mesh=mesh, block=min(block, 1024),
        )

    nq_pad = ((nq + block - 1) // block) * block
    nr_pad = ((nr + block - 1) // block) * block
    nqb, nrb = nq_pad // block, nr_pad // block

    x_np = np.zeros((nq_pad + nr_pad, w), dtype=np.uint32)
    for t in range(nq):
        x_np[t] = query_packed[t]
    for t in range(nr):
        x_np[nq_pad + t] = ref_packed[t]
    s_np = np.zeros((nq_pad + nr_pad,), dtype=np.float32)
    s_np[:nq] = query_sizes.astype(np.float32)
    s_np[nq_pad : nq_pad + nr] = ref_sizes.astype(np.float32)

    # Tiles address the concatenated matrix: (query block bi, global
    # ref block nqb + bj).
    tiles = [(bi, nqb + bj) for bi in range(nqb) for bj in range(nrb)]
    return _replicated_tile_sweep(
        x_np, s_np, tiles, mesh, block, cap, bits,
        float(np.float32(min_containment)), 1.0 / k,
        col0_blocks=nqb, n_rows=nq, n_cols=nr,
    )


def _rowshard_stage_fn(mesh: Mesh, block: int, cap: int, slots: int,
                       stage_cap: int, dtname: str):
    """Build (and cache) the jitted one-column-stage sweep for the
    ROW-SHARDED resident matrix.

    Layout: global row blocks are distributed cyclically — block g is
    owned by device g % n_dev at local slot g // n_dev — so per-stage
    triangle work (all blocks g <= cb against column block cb) is
    balanced within one tile across devices. Each stage:

      1. the owner of column block cb contributes its slice, psum
         broadcasts it to every device (ICI),
      2. every device scans its local slots, computing only valid
         triangle tiles (lax.cond skips g > cb), extracting sparse
         above-cutoff hits on device,
      3. hits are compacted into one fixed-size per-device stream with
         a running-offset dynamic_update_slice; only (cnts, stream)
         leave the device.

    Per-device residency is O(n*W / n_dev) — the property that lets the
    screen reach the 300k-genome multi-host north star (the role skani's
    sketch-then-stream search plays at scale, reference
    src/skani.rs:229-377). Column stage index cb, the row-block limit
    max_row_block (cb for the triangle schedule; the last query block
    for the rectangle), and the real block count are traced, so one
    compilation serves every stage, schedule, and run.
    """
    key = ("rowshard", mesh, block, cap, slots, stage_cap, dtname)
    fn = _TILE_FN_CACHE.get(key)
    if fn is not None:
        return fn

    axes = tuple(mesh.axis_names)
    n_dev = math.prod(mesh.shape.values())

    def local_fn(x_local, s_local, bits_f, min_cont, cb, max_row_block,
                 nblocks_real):
        w = x_local.shape[1]
        idx = jnp.int32(0)
        for ax in axes:
            idx = idx * mesh.shape[ax] + jax.lax.axis_index(ax)
        owner = cb % n_dev
        cslot = cb // n_dev
        blk = jax.lax.dynamic_slice(x_local, (cslot * block, 0), (block, w))
        sblk = jax.lax.dynamic_slice(s_local, (cslot * block,), (block,))
        col_x = jax.lax.psum(
            jnp.where(idx == owner, blk, jnp.zeros_like(blk)), axes
        )
        col_s = jax.lax.psum(jnp.where(idx == owner, sblk, 0.0), axes)
        dt = _screen_dt(dtname)
        col_unpacked = _unpack_bits(col_x, dt)
        rows_i = jax.lax.broadcasted_iota(jnp.int32, (block, block), 0)
        cols_j = jax.lax.broadcasted_iota(jnp.int32, (block, block), 1)

        def compute(s):
            si = jax.lax.dynamic_slice(x_local, (s * block, 0), (block, w))
            a = jax.lax.dynamic_slice(s_local, (s * block,), (block,))
            g = idx + s * n_dev
            counts = _screen_matmul(_unpack_bits(si, dt), col_unpacked)
            cont = _containment(counts, a, col_s, bits_f)
            mask = (cont >= min_cont) & ((g != cb) | (cols_j > rows_i))
            # Direct nonzero here (not the two-level extraction): the
            # host-side stream replay must agree with the kernel's
            # stored counts, which the row-overflow sentinel would
            # complicate; this path's per-stage cost is dominated by
            # the column psum broadcast anyway.
            cnt = jnp.sum(mask).astype(jnp.int32)
            ii, jj = jnp.nonzero(mask, size=cap, fill_value=0)
            return (
                cnt,
                ii.astype(jnp.int32),
                jj.astype(jnp.int32),
                cont[ii, jj].astype(jnp.bfloat16),
            )

        def _vary(tree):
            # shard_map requires cond branches / scan carries to agree
            # on varying-over-mesh-axes types; constants start unvarying.
            return jax.tree.map(
                lambda v: jax.lax.pcast(v, axes, to="varying"), tree
            )

        def skip(s):
            return _vary(
                (
                    jnp.int32(0),
                    jnp.zeros((cap,), jnp.int32),
                    jnp.zeros((cap,), jnp.int32),
                    jnp.zeros((cap,), jnp.bfloat16),
                )
            )

        def scan_body(carry, s):
            off, out_ii, out_jj, out_vals = carry
            g = idx + s * n_dev
            valid = (g <= max_row_block) & (g < nblocks_real)
            cnt, ii, jj, vals = jax.lax.cond(valid, compute, skip, s)
            woff = jnp.minimum(off, stage_cap - cap)

            # Write ONLY when this slot stored hits: an empty/skipped
            # slot's cap-sized zero buffer would otherwise land at the
            # clamped woff and silently clobber the tail of earlier
            # segments once off > stage_cap - cap — a clobber the host
            # replay (which flags only stored>0 clamped writes) cannot
            # detect.
            def write(bufs):
                o_ii, o_jj, o_v = bufs
                return (
                    jax.lax.dynamic_update_slice(o_ii, ii, (woff,)),
                    jax.lax.dynamic_update_slice(o_jj, jj, (woff,)),
                    jax.lax.dynamic_update_slice(o_v, vals, (woff,)),
                )

            out_ii, out_jj, out_vals = jax.lax.cond(
                cnt > 0, write, lambda bufs: bufs, (out_ii, out_jj, out_vals)
            )
            return (off + jnp.minimum(cnt, cap), out_ii, out_jj, out_vals), cnt

        init = _vary(
            (
                jnp.int32(0),
                jnp.zeros((stage_cap,), jnp.int32),
                jnp.zeros((stage_cap,), jnp.int32),
                jnp.zeros((stage_cap,), jnp.bfloat16),
            )
        )
        (_, out_ii, out_jj, out_vals), cnts = jax.lax.scan(
            scan_body, init, jnp.arange(slots, dtype=jnp.int32)
        )
        return cnts, out_ii, out_jj, out_vals

    fn = jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(axes, None), P(axes), P(), P(), P(), P(), P()),
            out_specs=(P(axes), P(axes), P(axes), P(axes)),
        )
    )
    _TILE_FN_CACHE[key] = fn
    return fn


def _host_block(packed, n: int, w: int, g: int, block: int) -> np.ndarray:
    """Materialize row block g (original genome order) from host rows,
    zero-padded past n."""
    out = np.zeros((block, w), np.uint32)
    lo = g * block
    for j in range(max(0, min(n - lo, block))):
        out[j] = packed[lo + j]
    return out


def _dense_tile_hits(
    packed, sizes_pad, n, w, bits, g, cb, block, min_containment, dtname,
    col0_blocks=0,
):
    """Recompute one overflowing tile densely (device matmul on two
    host-assembled blocks) and return its above-cutoff hits. Row/column
    block indices g/cb address the resident layout; emitted column
    indices are rebased by col0_blocks (0 for the triangle, the query
    block count for the rectangle)."""
    xi = jnp.asarray(_host_block(packed, n, w, g, block))
    xj = jnp.asarray(_host_block(packed, n, w, cb, block))
    a = jnp.asarray(sizes_pad[g * block : (g + 1) * block])
    b = jnp.asarray(sizes_pad[cb * block : (cb + 1) * block])
    cont = np.array(
        _block_containment_packed(xi, xj, a, b, float(bits), dtname=dtname)
    ).astype(np.float32)
    if g == cb:
        cont[np.tril_indices(cont.shape[0])] = -1.0  # -1: a cutoff of 0 must still drop self/reversed pairs
    hit = np.argwhere(cont >= min_containment)
    gi = hit[:, 0] + g * block
    gj = hit[:, 1] + (cb - col0_blocks) * block
    return gi, gj, cont[hit[:, 0], hit[:, 1]]


def sharded_screen_triangle_rowsharded(
    packed: Sequence[np.ndarray],
    sizes: np.ndarray,
    k: int,
    min_containment: float,
    bits: int,
    mesh: Optional[Mesh] = None,
    block: int = 1024,
    cap: int = 8192,
    stage_cap: int = ROWSHARD_STAGE_CAP,
) -> ScreenResult:
    """Upper-triangle all-vs-all screen with the packed matrix ROW-
    SHARDED across the mesh (cyclic block ownership): per-device HBM is
    O(n*W / n_dev), so capacity grows with devices/hosts instead of
    being capped by one device's memory as in the replicated sweep."""
    if mesh is None:
        from galah_tpu.parallel.mesh import make_mesh

        mesh = make_mesh()
    n = len(packed)
    if n == 0:
        return ScreenResult(np.empty((0, 2), np.int64), np.empty(0, np.float32))
    w = getattr(packed, "row_width", None) or len(packed[0])
    block = _pick_block(n, block)

    nblocks_real = (n + block - 1) // block
    sizes_pad = np.zeros((nblocks_real * block,), np.float32)
    sizes_pad[:n] = np.asarray(sizes, np.float32)

    # Triangle schedule: column stage cb sweeps row blocks g <= cb.
    stages = [(cb, cb) for cb in range(nblocks_real)]
    return _rowshard_sweep(
        packed, n, w, sizes_pad, nblocks_real, stages, mesh, block, cap,
        stage_cap, bits, float(np.float32(min_containment)), 1.0 / k,
        col0_blocks=0, n_rows=n, n_cols=n,
    )


def _rowshard_sweep(
    packed,
    n: int,
    w: int,
    sizes_pad: np.ndarray,
    nblocks_real: int,
    stages: List[Tuple[int, int]],
    mesh: Mesh,
    block: int,
    cap: int,
    stage_cap: int,
    bits: int,
    min_cont_static: float,
    inv_k: float,
    *,
    col0_blocks: int,
    n_rows: int,
    n_cols: int,
) -> ScreenResult:
    """Shared driver for the ROW-SHARDED sweeps (triangle AND
    rectangle): distribute row blocks cyclically over the mesh, stream
    one column stage at a time through a psum broadcast, replay each
    device's compacted hit stream on host, and recompute overflowing
    tiles (or clobbered device-stages) densely.

    `stages` lists (cb, max_row_block) column stages: cb is the column
    block's GLOBAL index in the resident layout, max_row_block the last
    row block the stage sweeps (cb itself for the triangle schedule;
    the last query block for the rectangle, whose ref columns live past
    the query rows). Emitted column indices are rebased by col0_blocks
    and rows/cols kept below n_rows/n_cols (padding dropped)."""
    stage_cap = max(stage_cap, 2 * cap)
    axes = tuple(mesh.axis_names)
    n_dev = math.prod(mesh.shape.values())
    slots = (nblocks_real + n_dev - 1) // n_dev
    n_local = slots * block
    total = n_dev * n_local

    x_sh = NamedSharding(mesh, P(axes, None))
    s_sh = NamedSharding(mesh, P(axes))

    def _fill_rows(start: int, stop: int, width: Optional[int]) -> np.ndarray:
        """Rows [start, stop) of the block-permuted global matrix:
        permuted block p = d*slots + s holds original block
        g = d + s*n_dev (cyclic ownership)."""
        shape = (stop - start, w) if width else (stop - start,)
        out = np.zeros(shape, np.uint32 if width else np.float32)
        p0 = start // block
        for p in range(p0, (stop + block - 1) // block):
            d, s = divmod(p, slots)
            g = d + s * n_dev
            lo = max(start, p * block) - start
            if g >= nblocks_real:
                continue
            if width:
                out[lo : lo + block] = _host_block(packed, n, w, g, block)
            else:
                out[lo : lo + block] = sizes_pad[g * block : (g + 1) * block]
        return out

    def cb_x(index):
        sl = index[0]
        start = sl.start or 0
        stop = sl.stop if sl.stop is not None else total
        assert start % block == 0 and stop % block == 0, (start, stop)
        return _fill_rows(start, stop, w)

    def cb_s(index):
        sl = index[0]
        start = sl.start or 0
        stop = sl.stop if sl.stop is not None else total
        assert start % block == 0 and stop % block == 0, (start, stop)
        return _fill_rows(start, stop, None)

    x_all = jax.make_array_from_callback((total, w), x_sh, cb_x)
    s_all = jax.make_array_from_callback((total,), s_sh, cb_s)

    dtn = _screen_dtype_name()
    fn = _rowshard_stage_fn(mesh, block, cap, slots, stage_cap, dtn)
    bits_dev = jnp.float32(bits)
    min_cont_dev = jnp.float32(min_cont_static)
    nblocks_dev = jnp.int32(nblocks_real)
    multiproc = jax.process_count() > 1

    pairs: List[np.ndarray] = []
    anis: List[np.ndarray] = []

    def emit(gi, gj, v):
        keep = (gi < n_rows) & (gj < n_cols)
        gi, gj, v = gi[keep], gj[keep], v[keep]
        if len(gi):
            pairs.append(np.stack([gi, gj], axis=1).astype(np.int64))
            anis.append(
                (np.asarray(v, np.float32) ** inv_k * 100.0).astype(np.float32)
            )

    def collect(cb, mrb, outs):
        if multiproc:
            from jax.experimental import multihost_utils

            cnts, ii, jj, vals = (
                multihost_utils.process_allgather(o, tiled=True) for o in outs
            )
        else:
            cnts, ii, jj, vals = outs
        cnts = np.asarray(cnts)
        ii = np.asarray(ii)
        jj = np.asarray(jj)
        vals = np.asarray(vals).astype(np.float32)
        for d in range(n_dev):
            # Replay the device's running offset to locate each slot's
            # segment in the compacted stream; fall back to dense
            # recompute per overflowing tile, or for the whole device-
            # stage if the stream itself overflowed (clobbered writes).
            segs = []  # (g, off, stored)
            off = 0
            clobbered = False
            for s in range(slots):
                g = d + s * n_dev
                if g > mrb or g >= nblocks_real:
                    continue
                c = int(cnts[d * slots + s])
                stored = min(c, cap)
                if stored and off > stage_cap - cap:
                    clobbered = True
                segs.append((g, c, off))
                off += stored
            if clobbered:
                logger.warning(
                    "row-sharded screen: stage %d device %d stream "
                    "overflow (%d hits > %d); dense recompute",
                    cb, d, off, stage_cap,
                )
            base_i = d * stage_cap
            for g, c, soff in segs:
                if clobbered or c > cap:
                    gi, gj, v = _dense_tile_hits(
                        packed, sizes_pad, n, w, bits, g, cb, block,
                        min_cont_static, dtname=dtn, col0_blocks=col0_blocks,
                    )
                    emit(gi, gj, v)
                else:
                    gi = ii[base_i + soff : base_i + soff + c] + g * block
                    gj = (
                        jj[base_i + soff : base_i + soff + c]
                        + (cb - col0_blocks) * block
                    )
                    emit(gi, gj, vals[base_i + soff : base_i + soff + c])

    pending: deque = deque()
    for cb, mrb in stages:
        outs = fn(
            x_all, s_all, bits_dev, min_cont_dev, jnp.int32(cb),
            jnp.int32(mrb), nblocks_dev,
        )
        pending.append((cb, mrb, outs))
        if len(pending) > DISPATCH_WINDOW:
            collect(*pending.popleft())
    while pending:
        collect(*pending.popleft())

    if pairs:
        return ScreenResult(np.concatenate(pairs), np.concatenate(anis))
    return ScreenResult(np.empty((0, 2), np.int64), np.empty(0, np.float32))


class _ConcatRows:
    """List-like view of the rectangle's concatenated resident layout
    (query rows, zero padding to a block boundary, then ref rows)
    without materializing the full matrix on host — rows materialize
    one block at a time inside _host_block / _fill_rows."""

    def __init__(self, query_packed, nq_pad: int, ref_packed, w: int):
        self._q = query_packed
        self._nq = len(query_packed)
        self._nq_pad = nq_pad
        self._r = ref_packed
        self._zero = np.zeros((w,), np.uint32)

    def __len__(self) -> int:
        return self._nq_pad + len(self._r)

    def __getitem__(self, i: int) -> np.ndarray:
        if i < self._nq:
            return self._q[i]
        if i < self._nq_pad:
            return self._zero
        return self._r[i - self._nq_pad]


def sharded_screen_rectangle_rowsharded(
    query_packed: Sequence[np.ndarray],
    query_sizes: np.ndarray,
    ref_packed: Sequence[np.ndarray],
    ref_sizes: np.ndarray,
    k: int,
    min_containment: float,
    bits: int,
    mesh: Optional[Mesh] = None,
    block: int = 1024,
    cap: int = 8192,
    stage_cap: int = ROWSHARD_STAGE_CAP,
) -> ScreenResult:
    """Reference-genome (rectangular) screen with the concatenated
    query+ref matrix ROW-SHARDED across the mesh: per-device HBM is
    O((nq+nr)*W / n_dev), so reference-mode capacity grows with
    devices/hosts exactly like the triangle's row-sharded sweep — the
    at-scale form of the reference's stream-queries-against-ref-DB
    search (src/skani.rs:502-687; SURVEY P9). Each column stage psum-
    broadcasts one REF block and sweeps every QUERY row block against
    it; returned pairs are (query_idx, ref_idx)."""
    if mesh is None:
        from galah_tpu.parallel.mesh import make_mesh

        mesh = make_mesh()
    nq, nr = len(query_packed), len(ref_packed)
    if nq == 0 or nr == 0:
        return ScreenResult(np.empty((0, 2), np.int64), np.empty(0, np.float32))
    w = getattr(query_packed, "row_width", None) or len(query_packed[0])
    block = _pick_block(max(nq, nr), block)

    nq_pad = ((nq + block - 1) // block) * block
    nqb = nq_pad // block
    n = nq_pad + nr
    nblocks_real = (n + block - 1) // block

    packed = _ConcatRows(query_packed, nq_pad, ref_packed, w)
    sizes_pad = np.zeros((nblocks_real * block,), np.float32)
    sizes_pad[:nq] = np.asarray(query_sizes, np.float32)
    sizes_pad[nq_pad : nq_pad + nr] = np.asarray(ref_sizes, np.float32)

    # Rectangle schedule: one column stage per REF block, each sweeping
    # every query row block (max_row_block = nqb - 1).
    stages = [(cb, nqb - 1) for cb in range(nqb, nblocks_real)]
    return _rowshard_sweep(
        packed, n, w, sizes_pad, nblocks_real, stages, mesh, block, cap,
        stage_cap, bits, float(np.float32(min_containment)), 1.0 / k,
        col0_blocks=nqb, n_rows=nq, n_cols=nr,
    )


def sharded_screen_triangle(
    indicators: np.ndarray,
    sizes: np.ndarray,
    k: int,
    min_containment: float,
    mesh: Optional[Mesh] = None,
) -> ScreenResult:
    """Dense 0/1 indicator convenience wrapper: packs rows into uint32
    bitmaps and runs the tiled sharded sweep."""
    indicators = np.asarray(indicators)
    n, bits = indicators.shape
    if bits % 32 != 0:
        raise ValueError(f"indicator width {bits} not a multiple of 32")
    packed = np.packbits(
        indicators.astype(bool), axis=1, bitorder="little"
    ).view(np.uint32)
    return sharded_screen_triangle_packed(
        list(packed), np.asarray(sizes), k, min_containment, bits, mesh=mesh
    )
