"""Fragment-containment ANI — the high-precision verify stage.

Replaces the reference's per-pair external ANI subprocesses
(`skani dist` src/skani.rs:718-788, `fastANI` src/fastani.rs:82-152)
with batched on-device computation:

- the query genome's fragment-level FracMinHash buckets are tested for
  membership in the reference genome's bucket bitmap (a gather + bit
  test), giving per-fragment shared-k-mer counts via segment sums;
- per-fragment identity = (corrected containment)**(1/k);
- a direction's ANI is the mean identity of aligned fragments
  (identity >= min_identity), and its aligned fraction is the aligned
  fragment count over usable fragments — fragment-count AF semantics,
  exactly the combination galah applies to fastANI output
  (max of the two directions' ANI, AF pass if either direction passes;
  src/fastani.rs:31-73).

Batch shapes are padded to coarse buckets so XLA compiles a handful of
program shapes; pair batches are grouped one-query-many-refs, matching
the greedy clusterer's access pattern (src/clusterer.rs:262-296).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import partial
from typing import List, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from galah_tpu import defaults
from galah_tpu.sketch.fracminhash import NativeSketch

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class FragmentAniConfig:
    k: int = 15
    member_bits: int = defaults.NATIVE_MEMBER_BITS
    min_fragment_hashes: int = 8
    min_fragment_identity: float = defaults.NATIVE_FRAGMENT_MIN_IDENTITY
    # Refs per grouped dispatch: the gather's per-position cost
    # amortizes over the ref axis (benchmarks/verify_width_probe.py
    # measures the scaling). Long streams are still chunked down by the
    # 256M-element (R x NPAD) intermediate budget in one_to_many_async,
    # so 1024 engages fully only for shorter genomes / strain-level rep
    # sets.
    max_refs_per_dispatch: int = 1024
    # LRU bounds on device-side per-genome caches (bitmaps are
    # member_bits/8 bytes each; query streams scale with genome size).
    max_cached_bitmaps: int = 512
    max_cached_queries: int = 128


def refs_per_dispatch(npad: int, cap: int) -> int:
    """Grouped-verify dispatch width for a stream padded to `npad`
    hashes: the configured cap chunked down by a 256M-element budget on
    the (R, NPAD) hit-matrix intermediates (~1GB of int32), floored at
    8 and rounded DOWN to a power of two (the kernels pad the ref axis
    UP to one, which would otherwise overshoot the budget by up to 2x
    right after the division). Shared by one_to_many_async and
    bench.py's verify bench so the bench always measures the width
    production actually picks."""
    r_chunk = max(8, min(cap, (256 << 20) // max(1, npad)))
    return 1 << (r_chunk.bit_length() - 1)


def _round_up(x: int, m: int) -> int:
    return max(m, ((x + m - 1) // m) * m)


def _verify_gather_mode() -> str:
    """How the grouped kernel tests stream buckets against ref bitmaps:

    - "bt": gather one (R//32)-word row per stream position from a
      bucket-major bit-transposed table (one gather yields every ref's
      bit); the table build is 5 elementwise butterfly passes,
      amortized across every query verified against the same ref group
      (LRU-cached).
    - "word": gather one bitmap word per (ref, position).
    - "auto": bt for rpad <= 64, word above.

    The GPU picks bt: on an H100 (375k-hash streams, table build
    excluded as it is LRU-amortized) it ran 1.9x faster than the word
    gather at 64 refs and 15x faster at 512 (PERF.md). The CPU picks
    word (its row gathers are memcpy-speed and the transpose is pure
    overhead). GALAH_TPU_VERIFY_GATHER=bt|word|auto forces one;
    results are bit-identical either way."""
    import os

    mode = os.environ.get("GALAH_TPU_VERIFY_GATHER")
    if mode in ("bt", "word", "auto"):
        return mode
    from galah_tpu.utils.platform import backend_default

    return backend_default(cpu="word", gpu="bt")


def verify_devices():
    """Local devices the verify stage fans independent dispatches over
    (round-robin). Across processes the pair list is partitioned
    separately (see bidirectional); this helper only governs the local
    fan-out. GALAH_TPU_VERIFY_DEVICES caps it (1 restores the
    single-device behavior)."""
    import os

    devs = jax.local_devices(backend=jax.default_backend())
    cap = os.environ.get("GALAH_TPU_VERIFY_DEVICES")
    if cap is not None:
        devs = devs[: max(1, int(cap))]
    return devs


def _placed(device):
    """Context manager placing array creation and jit execution on
    `device` (no-op for None)."""
    import contextlib

    return (
        jax.default_device(device)
        if device is not None
        else contextlib.nullcontext()
    )


def _ani_af_from_counts(m, M, popcount, bits, k, min_hashes, min_ident):
    """m: (..., F) hit counts; M: (..., F) fragment hash counts;
    popcount: (...,) ref bitmap popcount. Returns (ani_pct, af)."""
    p = (popcount / bits)[..., None]
    Mf = M.astype(jnp.float32)
    c = (m.astype(jnp.float32) - Mf * p) / jnp.maximum(1.0 - p, 1e-6)
    c = jnp.clip(c, 0.0, Mf)
    usable = M >= min_hashes
    cont = c / jnp.maximum(Mf, 1.0)
    ident = jnp.power(jnp.maximum(cont, 1e-30), 1.0 / k)
    aligned = usable & (ident >= min_ident)
    n_aligned = jnp.sum(aligned, axis=-1)
    n_usable = jnp.sum(usable, axis=-1)
    ani = jnp.sum(jnp.where(aligned, ident, 0.0), axis=-1) / jnp.maximum(
        n_aligned, 1
    )
    af = n_aligned / jnp.maximum(n_usable, 1)
    return ani * 100.0, af


_SEG_LANE = 512


def _per_fragment_hits(bits_hit: jax.Array, offsets: jax.Array) -> jax.Array:
    """Per-fragment hit counts from a (R, NPAD) 0/1 hit matrix and
    (F+1,) stream offsets (NPAD a multiple of 512), without a full
    (R, NPAD) prefix scan.

    A full minor-axis cumsum over the hit matrix would be the grouped
    kernel's bound once gathers are cheap, yet a
    prefix is only needed AT THE 2F+2 offset positions, so: 512-lane
    block sums (one memory-speed reduce), an exclusive cumsum over the
    tiny (R, NB) block totals, and per-offset intra-block remainders as
    masked row sums of the gathered boundary blocks. Integer math,
    bit-identical to the cumsum formulation (pinned by
    tests/test_pair_table.py::test_bt_kernel_parity_direct)."""
    npad = bits_hit.shape[1]
    assert npad % _SEG_LANE == 0, npad
    nb = npad // _SEG_LANE
    blocks = bits_hit.reshape(-1, nb, _SEG_LANE)
    bsum = jnp.sum(blocks, axis=2)                      # (R, NB)
    bcum_excl = jnp.pad(
        jnp.cumsum(bsum, axis=1), ((0, 0), (1, 0))
    )[:, :-1]                                           # (R, NB)
    ob = offsets // _SEG_LANE                           # (F+1,)
    orem = offsets % _SEG_LANE
    # offsets == npad (stream end / padding) would index block nb:
    # clamp to nb-1 and extend the mask to the full lane width, making
    # H(npad) the grand total.
    adj = ob >= nb
    ob_c = jnp.minimum(ob, nb - 1)
    orem_adj = jnp.where(adj, _SEG_LANE, orem)
    lane = jnp.arange(_SEG_LANE, dtype=jnp.int32)
    mask = (lane[None, :] < orem_adj[:, None]).astype(jnp.int32)  # (F+1, L)
    gathered = jnp.take(blocks, ob_c, axis=1)           # (R, F+1, L)
    intra = jnp.einsum(
        "rjl,jl->rj", gathered, mask, preferred_element_type=jnp.int32
    )
    h = jnp.take(bcum_excl, ob_c, axis=1) + intra       # (R, F+1)
    return h[:, 1:] - h[:, :-1]


@partial(jax.jit, static_argnames=("words",))
def _bitmap_from_buckets(buckets: jax.Array, words: int) -> jax.Array:
    """(M,) int32 distinct bucket indices -> (words,) uint32 packed
    membership bitmap. Padding slots carry index words*32 (out of
    range) and are dropped by the scatter. Distinct buckets set
    distinct bits, so add == bitwise-or: bit-identical to the host
    packing (NativeSketch.member_bitmap_words)."""
    word_idx = buckets >> 5
    val = jnp.uint32(1) << (buckets & 31).astype(jnp.uint32)
    return (
        jnp.zeros((words,), jnp.uint32)
        .at[word_idx]
        .add(val, mode="drop")
    )


@partial(jax.jit, static_argnames=("words",), donate_argnums=(0,))
def _pool_fill_buckets(pool, buckets2d, rows, counts, words: int):
    """Scatter B genomes' distinct bucket lists into pool rows.

    buckets2d (B, M): int32, uint16 (narrow transport for member_bits
    <= 2^16) or (B, 3M) uint8 (packed 24-bit transport, exact device
    decode — ops/pair_table.py::_pack24). counts (B,) int32 masks each
    row's padding tail (zero-filled on the wire; masked slots scatter
    out of range and drop). rows (B,) int32 — padding entries point at
    the trash row. Distinct buckets set distinct bits, so add == or:
    bit-identical to the host packing."""
    if buckets2d.dtype == jnp.uint8:
        from galah_tpu.ops.pair_table import _unpack24

        buckets2d = _unpack24(buckets2d)
    elif buckets2d.dtype != jnp.int32:
        buckets2d = buckets2d.astype(jnp.int32)
    b, m = buckets2d.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (b, m), 1)
    valid = col < counts[:, None]
    word_idx = jnp.where(valid, buckets2d >> 5, words)  # OOB -> dropped
    val = jnp.uint32(1) << (buckets2d & 31).astype(jnp.uint32)
    bm = (
        jnp.zeros((b, words), jnp.uint32)
        .at[jnp.arange(b, dtype=jnp.int32)[:, None], word_idx]
        .add(val, mode="drop")
    )
    return pool.at[rows].set(bm)


@partial(jax.jit, donate_argnums=(0,))
def _pool_fill_dense(pool, dense, rows):
    return pool.at[rows].set(dense)


@partial(jax.jit, donate_argnums=(0,))
def _pool_adopt(pool, src, src_rows, dst_rows):
    """Device-to-device pool fill: pool[dst_rows[b]] = src[src_rows[b]].
    Both index arrays are pow2-padded; padding dst entries point at the
    trash row 0. Adopts device-born member bitmaps with zero host
    round trip."""
    return pool.at[dst_rows].set(jnp.take(src, src_rows, axis=0))


@partial(jax.jit, static_argnames=("extra",))
def _pool_grow(pool, extra: int):
    # No donation: the output shape differs from the input, so the
    # buffer could never be reused and XLA warns on every grow.
    return jnp.concatenate(
        [pool, jnp.zeros((extra, pool.shape[1]), jnp.uint32)]
    )


@jax.jit
def _pool_stack(pool, rows):
    return jnp.take(pool, rows, axis=0)


class _BitmapPool:
    """Fixed-shape device-side member-bitmap cache.

    One (C, W) uint32 device array holds up to C genomes' member
    bitmaps as rows; a host-side LRU maps genome key -> row. Row 0 is
    the fill trash row (padding writes land there), row 1 stays
    all-zero (stack padding). Fills batch every missing genome of a
    request into pow2-bucketed (B, M) uploads and ONE jitted scatter
    per shape bucket; per-dispatch ref stacks are ONE row gather.

    Why not per-genome cached (W,) arrays assembled with jnp.stack: a
    stack with N operands is a DISTINCT XLA program per N — the counts
    vary with the corpus, so every verify run would recompile them.
    Every program the pool executes has a pow2-bucketed static shape,
    so the persistent compile cache holds across runs AND corpora.
    """

    RESERVED = 2

    def __init__(self, words: int, device, capacity: int, hard_cap: int):
        from collections import OrderedDict

        self.words = words
        self.device = device
        self.capacity = capacity
        self.hard_cap = max(hard_cap, capacity)
        self._rows: "OrderedDict[object, int]" = OrderedDict()
        self._next = self.RESERVED
        self._popc = np.zeros(self.RESERVED + capacity, np.float32)
        with _placed(device):
            self._pool = jnp.zeros(
                (self.RESERVED + capacity, words), jnp.uint32
            )

    def _grow_to(self, new_cap: int) -> None:
        extra = new_cap - self.capacity
        with _placed(self.device):
            self._pool = _pool_grow(self._pool, extra=extra)
        self._popc = np.concatenate(
            [self._popc, np.zeros(extra, np.float32)]
        )
        self.capacity = new_cap

    def _row_for(self, key) -> int:
        if self._next < self.RESERVED + self.capacity:
            r = self._next
            self._next += 1
        else:
            _, r = self._rows.popitem(last=False)  # LRU evict
        self._rows[key] = r
        return r

    def would_evict(self, keys) -> bool:
        """Whether ensure(keys) could reassign any existing row —
        callers holding prepared row ids across dispatches flush
        before a mutating ensure (grouped verify dispatches capture
        rows at prepare time; an eviction would silently repoint
        them). Mirrors ensure()'s growth rule exactly; growth itself
        preserves rows and is safe."""
        seen = set(keys)
        missing = sum(1 for k in seen if k not in self._rows)
        if not missing:
            return False
        cap = self.capacity
        want = min(
            max(len(self._rows) + missing, cap),
            max(self.hard_cap, len(seen)),
        )
        if want > cap:
            cap = 1 << (want - 1).bit_length()
        return self._next + missing > self.RESERVED + cap

    def ensure(self, keys, sketches) -> None:
        """Make every (key, sketch) resident; one request's keys are
        guaranteed to coexist (the pool grows past hard_cap if a single
        request demands it)."""
        missing: List[Tuple] = []
        seen = set()
        for k, s in zip(keys, sketches):
            if k in seen:
                continue
            seen.add(k)
            if k in self._rows:
                self._rows.move_to_end(k)
            else:
                missing.append((k, s))
        if not missing:
            return
        # Grow geometrically up to hard_cap (amortized; bounded program
        # count), and unconditionally to fit a single oversized request
        # — eviction below then never touches this request's keys,
        # because present ones were just moved to the LRU tail and the
        # missing ones are inserted behind them.
        want = min(
            max(len(self._rows) + len(missing), self.capacity),
            max(self.hard_cap, len(seen)),
        )
        if want > self.capacity:
            self._grow_to(1 << (want - 1).bit_length())

        from galah_tpu.ops.pair_table import (
            _pack24,
            _stream_packing_enabled,
        )

        # Bytes per bucket index on the wire: uint16 for member spaces
        # <= 2^16, packed 24-bit below 2^24, int32 above. The dense
        # cutover compares ACTUAL wire bytes (bucket_bytes * mpad vs
        # 4 * words), so enabling stream packing widens the range where
        # the buckets upload stays the smaller one.
        if not _stream_packing_enabled():
            bucket_bytes = 4
        elif self.words * 32 <= (1 << 16):
            bucket_bytes = 2
        elif self.words * 32 < (1 << 24):
            bucket_bytes = 3
        else:
            bucket_bytes = 4
        mode = _bitmap_upload_mode()
        groups: dict = {}
        for k, s in missing:
            r = self._row_for(k)
            self._popc[r] = float(s.member_popcount)
            mb = s.member_buckets
            mpad = max(1 << 12, 1 << (max(len(mb), 1) - 1).bit_length())
            dense = mode == "dense" or (
                mode == "auto" and mpad * bucket_bytes >= self.words * 4
            )
            groups.setdefault((dense, 0 if dense else mpad), []).append(
                (s, r)
            )
        for (dense, mpad), items in groups.items():
            # Bound one upload to ~64MB.
            step = max(8, (64 << 20) // (((mpad or self.words)) * 4))
            for lo in range(0, len(items), step):
                chunk = items[lo : lo + step]
                bpad = max(8, 1 << (len(chunk) - 1).bit_length())
                rows = np.zeros(bpad, np.int32)  # padding -> trash row 0
                rows[: len(chunk)] = [r for _, r in chunk]
                with _placed(self.device):
                    if dense:
                        buf = np.zeros((bpad, self.words), np.uint32)
                        for i, (s, _) in enumerate(chunk):
                            buf[i] = s.member_bitmap_words()
                        self._pool = _pool_fill_dense(
                            self._pool,
                            jax.device_put(buf, self.device),
                            jax.device_put(rows, self.device),
                        )
                    else:
                        counts = np.zeros(bpad, np.int32)
                        buf = np.zeros((bpad, mpad), np.int32)
                        for i, (s, _) in enumerate(chunk):
                            mb = s.member_buckets
                            buf[i, : len(mb)] = mb
                            counts[i] = len(mb)
                        if bucket_bytes == 2:
                            buf = buf.astype(np.uint16)
                        elif bucket_bytes == 3:
                            buf = _pack24(buf)
                        self._pool = _pool_fill_buckets(
                            self._pool,
                            jax.device_put(buf, self.device),
                            jax.device_put(rows, self.device),
                            jax.device_put(counts, self.device),
                            words=self.words,
                        )

    def adopt(self, keys, src_dev, src_rows, popcounts) -> None:
        """Make keys resident by copying rows of a device-born (G, W)
        bitmap array into the pool (no host round trip). popcounts are
        host floats (known from the host-side sketch mirror)."""
        todo = []
        for i, k in enumerate(keys):
            if k in self._rows:
                self._rows.move_to_end(k)
            else:
                todo.append(i)
        if not todo:
            return
        want = min(
            max(len(self._rows) + len(todo), self.capacity),
            max(self.hard_cap, len(todo)),
        )
        if want > self.capacity:
            self._grow_to(1 << (want - 1).bit_length())
        step = 4096
        for lo in range(0, len(todo), step):
            chunk = todo[lo : lo + step]
            bpad = max(8, 1 << (len(chunk) - 1).bit_length())
            srows = np.zeros(bpad, np.int32)
            drows = np.zeros(bpad, np.int32)  # padding -> trash row 0
            for b, i in enumerate(chunk):
                r = self._row_for(keys[i])
                self._popc[r] = float(popcounts[i])
                srows[b] = src_rows[i]
                drows[b] = r
            with _placed(self.device):
                self._pool = _pool_adopt(
                    self._pool,
                    src_dev,
                    jax.device_put(srows, self.device),
                    jax.device_put(drows, self.device),
                )

    def row_map(self, keys, gpad: int) -> Tuple[np.ndarray, np.ndarray]:
        """(rows (gpad,) int32, popcounts (gpad,) f32) for `keys`
        (must be resident) — the no-gather alternative to stack():
        kernels address the pool buffer (`self.buffer`, read at issue
        time — fills donate and replace it) directly through the row
        ids. Padding rows map to the all-zero reserved row 1."""
        rows = np.ones(gpad, np.int32)
        pc = np.zeros(gpad, np.float32)
        for i, k in enumerate(keys):
            r = self._rows[k]
            self._rows.move_to_end(k)
            rows[i] = r
            pc[i] = self._popc[r]
        return rows, pc

    @property
    def buffer(self) -> jax.Array:
        return self._pool

    def stack(self, keys, gpad: int) -> Tuple[jax.Array, np.ndarray]:
        """(gpad, W) uint32 bitmap stack + (gpad,) f32 popcounts for
        `keys` (must be resident); padding rows are zero bitmaps."""
        rows = np.ones(gpad, np.int32)  # padding -> zero row 1
        pc = np.zeros(gpad, np.float32)
        for i, k in enumerate(keys):
            r = self._rows[k]
            self._rows.move_to_end(k)
            rows[i] = r
            pc[i] = self._popc[r]
        with _placed(self.device):
            bm = _pool_stack(
                self._pool, jax.device_put(rows, self.device)
            )
        return bm, pc


@partial(jax.jit, donate_argnums=(0,))
def _arena_fill(arena, vals2d, dsts, counts):
    """Scatter B ragged rows into the 1D arena: row b's first counts[b]
    entries land at arena[dsts[b]:dsts[b]+counts[b]]. vals2d (B, S)
    int32/uint16 or (B, 3S) uint8 (24-bit transport); masked tail slots
    scatter out of bounds and drop."""
    if vals2d.dtype == jnp.uint8:
        from galah_tpu.ops.pair_table import _unpack24

        vals2d = _unpack24(vals2d)
    elif vals2d.dtype != jnp.int32:
        vals2d = vals2d.astype(jnp.int32)
    b, s = vals2d.shape
    cap = arena.shape[0]
    col = jax.lax.broadcasted_iota(jnp.int32, (b, s), 1)
    idx = jnp.where(col < counts[:, None], dsts[:, None] + col, cap)
    return arena.at[idx.reshape(-1)].set(
        vals2d.reshape(-1), mode="drop"
    )


@partial(jax.jit, donate_argnums=(0,))
def _arena_adopt(arena, src2d, rows, dsts, counts, base):
    """Device-to-device arena fill from a batched source array: row
    rows[b] of src2d, plus per-row constant base[b], lands at
    arena[dsts[b]:...]. Used to adopt device-born sketch products
    (fragment streams: base 0; absolute frag offsets: base = the
    stream's arena offset) with zero host round trip."""
    vals2d = jnp.take(src2d, rows, axis=0).astype(jnp.int32)
    b, s = vals2d.shape
    cap = arena.shape[0]
    col = jax.lax.broadcasted_iota(jnp.int32, (b, s), 1)
    idx = jnp.where(col < counts[:, None], dsts[:, None] + col, cap)
    return arena.at[idx.reshape(-1)].set(
        (vals2d + base[:, None]).reshape(-1), mode="drop"
    )


class StreamArena:
    """Persistent per-device arena for pair-table verify streams.

    The pair-table kernel addresses unique source streams through
    per-pair offset descriptors (pair_src_start / pair_ufrag_start), so
    the `ustream` / `ufrag_offsets` operands need not be per-dispatch
    uploads at all: this arena keeps every recently-used genome's
    fragment stream and (absolute) fragment offsets resident in HBM.
    A genome's stream is uploaded at most once per residency window —
    repeat visits by the greedy clusterer (reference
    src/clusterer.rs:182-259 re-pairs reps across calls) and by later
    dispatches cost zero transfer — and device-born sketches are
    adopted with no host round trip at all (`adopt`). This is the
    device-resident analog of skani's in-process sketch->search handoff
    (reference src/skani.rs:270-304).

    Allocation is append-only with whole-arena reset when full (the
    simple policy is safe: one dispatch's unique streams are bounded by
    PairTableConfig.max_unique_hashes, far below the capacity, so a
    reset always makes room; a corpus larger than the arena degrades to
    roughly today's upload-per-dispatch behavior, never worse).
    """

    # Physical buffers carry slack past the logical capacity so the
    # grouped-path query reads (dynamic_slice at the genome's offset,
    # size rounded up to the 2^14/2^9 padding buckets) never clamp-
    # shift near the top of the arena.
    HASH_SLACK = 1 << 14
    OFFS_SLACK = (1 << 9) + 1

    def __init__(
        self,
        device,
        hash_capacity: int,
        frag_capacity: int,
    ) -> None:
        self.device = device
        self.hash_capacity = hash_capacity
        self.frag_capacity = frag_capacity
        self._map: dict = {}  # key -> (hash_off, offs_off)
        self._hash_top = 0
        self._offs_top = 0
        with _placed(device):
            self._hash = jnp.zeros(
                (hash_capacity + self.HASH_SLACK,), jnp.int32
            )
            self._offs = jnp.zeros(
                (frag_capacity + self.OFFS_SLACK,), jnp.int32
            )

    @property
    def buffers(self):
        return self._hash, self._offs

    def reset(self) -> None:
        self._map.clear()
        self._hash_top = 0
        self._offs_top = 0

    def span(self, key):
        """(hash_off, offs_off) if key is currently resident."""
        return self._map.get(key)

    def would_reset(self, keys, sketches_by_key) -> bool:
        """Whether ensure(keys) would reset the arena (exact — _alloc
        pads nothing). Callers holding prepared spans across dispatches
        flush before a resetting ensure; fills never move existing
        spans, so only resets invalidate."""
        need_h = need_f = 0
        seen: set = set()
        for k in keys:
            if k in self._map or k in seen:
                continue
            seen.add(k)
            sk = sketches_by_key[k]
            nh, nf = len(sk.frag_buckets), sk.n_fragments
            if nh > self.hash_capacity or nf + 1 > self.frag_capacity:
                continue
            need_h += nh
            need_f += nf + 1
        return (
            self._hash_top + need_h > self.hash_capacity
            or self._offs_top + need_f > self.frag_capacity
        )

    def _alloc(self, key, nh: int, nf: int):
        """Reserve arena space for a stream of nh hashes / nf+1 offset
        slots; resets the arena when full. Returns (hash_off, offs_off)
        or None when the stream alone exceeds capacity."""
        if nh > self.hash_capacity or nf + 1 > self.frag_capacity:
            return None
        if (
            self._hash_top + nh > self.hash_capacity
            or self._offs_top + nf + 1 > self.frag_capacity
        ):
            logger.info(
                "stream arena full (%d/%d hashes); resetting",
                self._hash_top, self.hash_capacity,
            )
            self.reset()
        span = (self._hash_top, self._offs_top)
        self._map[key] = span
        self._hash_top += nh
        self._offs_top += nf + 1
        return span

    def ensure(self, keys, sketches_by_key) -> dict:
        """Make every key's stream resident (host-upload path); returns
        {key: (hash_off, offs_off)}. Keys whose streams don't fit the
        arena at all are absent from the result (callers fall back to
        a per-dispatch upload). Uploads are batched by pow2 shape
        buckets with the narrow transports (uint16 / packed 24-bit).

        Reset safety: _alloc may reset the arena mid-request, dropping
        BOTH earlier allocations of this request and previously-
        resident keys the request relies on. Each attempt therefore
        recomputes what's missing from the CURRENT map (so evicted
        pre-request residents are re-allocated too), and every key
        allocated in ANY attempt is (re)filled at its final span."""
        uniq = list(dict.fromkeys(keys))

        def fits(sk):
            return (
                len(sk.frag_buckets) <= self.hash_capacity
                and sk.n_fragments + 1 <= self.frag_capacity
            )

        fresh: set = set()
        for attempt in (0, 1):
            for k in uniq:
                if k not in self._map and fits(sketches_by_key[k]):
                    sk = sketches_by_key[k]
                    self._alloc(k, len(sk.frag_buckets), sk.n_fragments)
                    fresh.add(k)
            if all(
                k in self._map
                for k in uniq
                if fits(sketches_by_key[k])
            ):
                break
            self.reset()
        self._fill_host(
            [
                (k, sketches_by_key[k])
                for k in uniq
                if k in fresh and k in self._map
            ]
        )
        return {k: self._map[k] for k in keys if k in self._map}

    def _transport(self, member_bits_hint: int):
        from galah_tpu.ops.pair_table import _stream_packing_enabled

        if not _stream_packing_enabled():
            return "i32"
        if member_bits_hint <= (1 << 16):
            return "u16"
        if member_bits_hint < (1 << 24):
            return "p24"
        return "i32"

    def _fill_host(self, items) -> None:
        if not items:
            return
        import numpy as _np

        from galah_tpu.ops.pair_table import _pack24

        # Group stream uploads by pow2 length bucket; offsets likewise.
        groups: dict = {}
        ogroups: dict = {}
        for k, sk in items:
            h_off, o_off = self._map[k]
            nh = len(sk.frag_buckets)
            nf = sk.n_fragments
            spad = max(1 << 9, 1 << max(nh - 1, 1).bit_length())
            fpad = max(1 << 7, 1 << max(nf, 1).bit_length())
            groups.setdefault(spad, []).append((sk, h_off, nh))
            ogroups.setdefault(fpad, []).append((sk, o_off, h_off, nf))
        # Transport decided by the sketch params (int32 when unknown).
        any_sk = items[0][1]
        bits_hint = (
            any_sk.params.member_bits
            if any_sk.params is not None
            else (1 << 24)
        )
        tname = self._transport(bits_hint)
        for spad, rows in groups.items():
            step = max(8, (64 << 20) // (spad * 4))
            for lo in range(0, len(rows), step):
                chunk = rows[lo : lo + step]
                bpad = max(8, 1 << (len(chunk) - 1).bit_length())
                buf = _np.zeros((bpad, spad), _np.int32)
                dsts = _np.full(bpad, self.hash_capacity, _np.int32)
                counts = _np.zeros(bpad, _np.int32)
                for i, (sk, h_off, nh) in enumerate(chunk):
                    buf[i, :nh] = sk.frag_buckets
                    dsts[i] = h_off
                    counts[i] = nh
                if tname == "u16":
                    wire = buf.astype(_np.uint16)
                elif tname == "p24":
                    wire = _pack24(buf)
                else:
                    wire = buf
                with _placed(self.device):
                    self._hash = _arena_fill(
                        self._hash,
                        jax.device_put(wire, self.device),
                        jax.device_put(dsts, self.device),
                        jax.device_put(counts, self.device),
                    )
        for fpad, rows in ogroups.items():
            step = max(8, (64 << 20) // ((fpad + 1) * 4))
            for lo in range(0, len(rows), step):
                chunk = rows[lo : lo + step]
                bpad = max(8, 1 << (len(chunk) - 1).bit_length())
                buf = _np.zeros((bpad, fpad + 1), _np.int32)
                dsts = _np.full(bpad, self.frag_capacity, _np.int32)
                counts = _np.zeros(bpad, _np.int32)
                for i, (sk, o_off, h_off, nf) in enumerate(chunk):
                    # Absolute offsets: within-stream + arena position,
                    # so the kernel's base arithmetic is unchanged.
                    buf[i, : nf + 1] = (
                        sk.frag_offsets.astype(_np.int64) + h_off
                    ).astype(_np.int32)
                    dsts[i] = o_off
                    counts[i] = nf + 1
                with _placed(self.device):
                    self._offs = _arena_fill(
                        self._offs,
                        jax.device_put(buf, self.device),
                        jax.device_put(dsts, self.device),
                        jax.device_put(counts, self.device),
                    )

    def adopt(
        self, keys, flat_dev, offsets_dev, rows, n_unique, n_frags
    ) -> None:
        """Adopt device-born sketch products: keys[i]'s stream is row
        rows[i] of flat_dev (G, SEL) with n_unique[i] valid entries and
        offsets row rows[i] of offsets_dev (G, F+1) with n_frags[i]+1
        valid slots. Zero host round trip; entries already resident are
        skipped."""
        import numpy as _np

        todo = [
            i for i, k in enumerate(keys)
            if k not in self._map
        ]
        if not todo:
            return
        for attempt in (0, 1):
            for i in todo:
                if keys[i] not in self._map:
                    self._alloc(keys[i], int(n_unique[i]), int(n_frags[i]))
            if all(
                keys[i] in self._map for i in todo
                if int(n_unique[i]) <= self.hash_capacity
                and int(n_frags[i]) + 1 <= self.frag_capacity
            ):
                break
            self.reset()
        live = [i for i in todo if keys[i] in self._map]
        if not live:
            return
        step = 1024
        for lo in range(0, len(live), step):
            chunk = live[lo : lo + step]
            bpad = max(8, 1 << (len(chunk) - 1).bit_length())
            src_rows = _np.zeros(bpad, _np.int32)
            h_dsts = _np.full(bpad, self.hash_capacity, _np.int32)
            o_dsts = _np.full(bpad, self.frag_capacity, _np.int32)
            h_counts = _np.zeros(bpad, _np.int32)
            o_counts = _np.zeros(bpad, _np.int32)
            base = _np.zeros(bpad, _np.int32)
            for b, i in enumerate(chunk):
                h_off, o_off = self._map[keys[i]]
                src_rows[b] = rows[i]
                h_dsts[b] = h_off
                o_dsts[b] = o_off
                h_counts[b] = int(n_unique[i])
                o_counts[b] = int(n_frags[i]) + 1
                base[b] = h_off
            with _placed(self.device):
                put = lambda a: jax.device_put(a, self.device)
                self._hash = _arena_adopt(
                    self._hash, flat_dev, put(src_rows), put(h_dsts),
                    put(h_counts), put(_np.zeros(bpad, _np.int32)),
                )
                self._offs = _arena_adopt(
                    self._offs, offsets_dev, put(src_rows), put(o_dsts),
                    put(o_counts), put(base),
                )

    def spans(self, keys):
        """{key: (hash_off, offs_off)} for resident keys only."""
        return {k: self._map[k] for k in keys if k in self._map}


@partial(jax.jit, static_argnames=("npad", "fpad"))
def _query_from_arena(hash_arena, offs_arena, h_off, o_off, n, f,
                      npad: int, fpad: int):
    """Build one genome's grouped-verify query arrays from its
    resident arena span (device-to-device; no stream re-upload).
    Returns ((npad,) int32 buckets zero-masked past n, (fpad+1,) int32
    stream-relative offsets padded with n) — bit-identical to the host
    upload path. The arena's physical slack guarantees the dynamic
    slices never clamp-shift."""
    b = jax.lax.dynamic_slice(hash_arena, (h_off,), (npad,))
    idx = jnp.arange(npad, dtype=jnp.int32)
    b = jnp.where(idx < n, b, 0)
    o = jax.lax.dynamic_slice(offs_arena, (o_off,), (fpad + 1,))
    oi = jnp.arange(fpad + 1, dtype=jnp.int32)
    o = jnp.where(oi <= f, o - h_off, n)
    return b, o


# Shares of the device memory limit (utils.platform.device_memory_limit)
# that the verify caches may take on an accelerator: the member-bitmap
# pool and the fragment-stream arena.
BITMAP_POOL_SHARE = 1 / 8
ARENA_SHARE = 1 / 32


def _arena_capacities():
    """(hash_capacity, frag_capacity) defaults. On the GPU the int32
    hash arena takes ARENA_SHARE of the device memory limit (a power of
    two; ~2^29 hashes = 2 GiB on an 80 GB card, ~7000 MAG-scale streams)
    and the offsets arena 1/16 of that; on the CPU (tests; host RAM)
    2^22 and 2^18. Env: GALAH_TPU_ARENA_HASHES / GALAH_TPU_ARENA_FRAGS."""
    import os

    from galah_tpu.utils.platform import backend_default, device_memory_limit

    hc = os.environ.get("GALAH_TPU_ARENA_HASHES")
    fc = os.environ.get("GALAH_TPU_ARENA_FRAGS")
    if backend_default(cpu=True, gpu=False):
        dh = 1 << 22
    else:
        want = int(device_memory_limit() * ARENA_SHARE) // 4
        dh = 1 << max(22, want.bit_length() - 1)
    df = dh >> 4
    return (int(hc) if hc else dh, int(fc) if fc else df)


def _bitmap_upload_mode() -> str:
    """How member bitmaps reach the device:

    - "buckets": upload the sorted distinct bucket list (2-4 bytes per
      member hash) and scatter bits on device — smaller than the dense
      bitmap whenever the genome has fewer members than bits/32;
    - "dense": upload host-packed bitmap words.
    - "auto": per genome, whichever is fewer bytes.

    The GPU takes auto: on an H100, 4,096 5-kb contig bitmaps went up
    3.0x faster as bucket lists than dense (PERF.md), and MAG-scale
    bitmaps, whose lists are larger, still go dense. The CPU always
    uploads dense (no transfer cost; the scatter is pure overhead).
    GALAH_TPU_BITMAP_UPLOAD forces one; results are bit-identical."""
    import os

    mode = os.environ.get("GALAH_TPU_BITMAP_UPLOAD")
    if mode in ("buckets", "dense"):
        return mode
    from galah_tpu.utils.platform import backend_default

    return backend_default(cpu="dense", gpu="auto")


@jax.jit
def _bit_transpose_table(bitmaps: jax.Array) -> jax.Array:
    """(R, W) uint32 ref bitmaps (R a multiple of 32) -> bucket-major
    bit table T: (W*32, R//32) uint32 with

        (T[b, g] >> r) & 1 == (bitmaps[32*g + r, b >> 5] >> (b & 31)) & 1

    i.e. row b holds ALL refs' membership bits for bucket b. The
    grouped verify kernel then fetches R bits per stream position with
    ONE R//32-word row gather instead of R separate word gathers —
    32x fewer gathered bytes (benchmarks/verify_gather_bench.py times
    both gathers).

    Construction is a butterfly (SWAR) 32x32 bit-matrix transpose
    vectorized over bitmap words and ref groups: 5 mask/shift/xor
    passes, no scatters or sorts.
    """
    r, w = bitmaps.shape
    assert r % 32 == 0, r
    x = bitmaps.reshape(r // 32, 32, w)

    def transpose32(blk):  # (32, W): out[s] bit r == blk[r] bit s
        j = 16
        m = jnp.uint32(0x0000FFFF)
        while j:
            xr = blk.reshape(-1, 2, j, w)
            upper, lower = xr[:, 0], xr[:, 1]
            t = ((upper >> jnp.uint32(j)) ^ lower) & m
            lower = lower ^ t
            upper = upper ^ (t << jnp.uint32(j))
            blk = jnp.stack([upper, lower], axis=1).reshape(32, w)
            j >>= 1
            m = m ^ (m << jnp.uint32(j))
        return blk

    y = jax.vmap(transpose32)(x)               # (G, 32, W); [g, s, w]
    # T[32w + s, g] = y[g, s, w]
    return y.transpose(2, 1, 0).reshape(w * 32, r // 32)


@partial(
    jax.jit,
    static_argnames=("bits", "k", "min_hashes", "min_ident"),
)
def _forward_kernel_bt_packed(*args, **kwargs):
    """_forward_kernel_bt with (ani, af) concatenated into one (2R,)
    buffer: one result fetch per chunk instead of two slice-dispatches
    plus two fetches (see ops/pair_table.py::_pair_table_kernel_packed)."""
    ani, af = _forward_kernel_bt(*args, **kwargs)
    return jnp.concatenate([ani, af])


@partial(
    jax.jit,
    static_argnames=("bits", "k", "min_hashes", "min_ident"),
)
def _forward_kernel_bt(
    table,        # (bits, R//32) uint32 — bucket-major bit table
    popcounts,    # (R,) f32
    buckets,      # (N,) int32 (padded; invalid -> 0)
    offsets,      # (F+1,) int32 fragment offsets, padded by repeating n
    n,            # () int32 — true hash count
    bits: int,
    k: int,
    min_hashes: int,
    min_ident: float,
):
    """Bit-transposed variant of _forward_kernel: one row gather per
    stream position retrieves every ref's membership bit at once."""
    npad = buckets.shape[0]
    g32 = table.shape[1]
    idx = jnp.arange(npad, dtype=jnp.int32)
    valid = idx < n
    M = jnp.diff(offsets)

    rows = jnp.take(table, buckets, axis=0)     # (N, G32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits_hit = (
        (rows.T[:, None, :] >> shifts[None, :, None]) & jnp.uint32(1)
    ).astype(jnp.int32)                          # (G32, 32, N)
    bits_hit = bits_hit.reshape(g32 * 32, npad)  # (R, N)
    bits_hit = jnp.where(valid[None, :], bits_hit, 0)
    m = _per_fragment_hits(bits_hit, offsets)
    return _ani_af_from_counts(
        m, M[None, :], popcounts, float(bits), k, min_hashes, min_ident
    )


@partial(
    jax.jit,
    static_argnames=("bits", "k", "min_hashes", "min_ident"),
)
def _forward_kernel_packed(*args, **kwargs):
    """_forward_kernel with (ani, af) concatenated into one (2R,)
    buffer — same single-fetch rationale as _forward_kernel_bt_packed."""
    ani, af = _forward_kernel(*args, **kwargs)
    return jnp.concatenate([ani, af])


@partial(
    jax.jit,
    static_argnames=("bits", "k", "min_hashes", "min_ident"),
)
def _forward_kernel(
    bitmaps,      # (R, W) uint32
    popcounts,    # (R,) f32
    buckets,      # (N,) int32 (padded; invalid -> 0)
    offsets,      # (F+1,) int32 fragment offsets, padded by repeating n
    n,            # () int32 — true hash count
    bits: int,
    k: int,
    min_hashes: int,
    min_ident: float,
):
    """One query's fragments against R reference bitmaps.

    Validity mask and per-fragment counts are derived on device from
    the compact offsets array — the fragment stream upload is just
    (buckets, offsets), halving host->device traffic."""
    m = _forward_hits(bitmaps, buckets, offsets, n)
    return _ani_af_from_counts(
        m, jnp.diff(offsets)[None, :], popcounts, float(bits), k,
        min_hashes, min_ident,
    )


@jax.jit
def _forward_hits(bitmaps, buckets, offsets, n):
    """(R, F) per-fragment hit counts of one query stream against R
    reference bitmaps (the word-gather half of _forward_kernel).

    Per-fragment hit counts use block-segmented prefixes
    (_per_fragment_hits) rather than a scatter-add segment sum or a
    full minor-axis cumsum: fragments are contiguous stream ranges and
    both alternatives cost a full pass over the (R, N) hit matrix."""
    npad = buckets.shape[0]
    valid = jnp.arange(npad, dtype=jnp.int32) < n
    word_idx = buckets >> 5
    bit_idx = (buckets & 31).astype(jnp.uint32)
    words = jnp.take(bitmaps, word_idx, axis=1)          # (R, N)
    bits_hit = ((words >> bit_idx[None, :]) & jnp.uint32(1)).astype(jnp.int32)
    bits_hit = jnp.where(valid[None, :], bits_hit, 0)
    return _per_fragment_hits(bits_hit, offsets)


def forward_reference(
    bitmap_words: np.ndarray,  # (W,) uint32 — the reference's bitmap
    popcount: float,
    buckets: np.ndarray,       # (n,) int32 — query stream
    offsets: np.ndarray,       # (F+1,) int32 fragment offsets
    bits: int,
    k: int,
    min_hashes: int,
    min_ident: float,
    fixed_point: bool = False,
):
    """Plain numpy reference of one directed verify: (per-fragment hit
    counts (F,), ani_pct, af, n_aligned, n_usable). Same float32
    arithmetic as the device kernels; the aligned-identity sum is taken
    in float64, or in the pair-table kernel's 2^-14 fixed point when
    fixed_point is set; af is the correctly rounded quotient."""
    buckets = np.asarray(buckets, np.int64)
    hit = (bitmap_words[buckets >> 5] >> (buckets & 31).astype(np.uint32)) & 1
    h = np.concatenate([[0], np.cumsum(hit, dtype=np.int64)])
    offsets = np.asarray(offsets, np.int64)
    m = (h[offsets[1:]] - h[offsets[:-1]]).astype(np.int32)
    M = np.diff(offsets).astype(np.int32)
    p = np.float32(popcount) / np.float32(bits)
    Mf = M.astype(np.float32)
    c = (m.astype(np.float32) - Mf * p) / np.maximum(
        np.float32(1.0) - p, np.float32(1e-6)
    )
    c = np.clip(c, np.float32(0.0), Mf)
    usable = M >= min_hashes
    cont = c / np.maximum(Mf, np.float32(1.0))
    ident = np.power(
        np.maximum(cont, np.float32(1e-30)), np.float32(1.0 / k)
    ).astype(np.float32)
    aligned = usable & (ident >= np.float32(min_ident))
    n_aligned = int(aligned.sum())
    if fixed_point:
        fx = np.round(ident[aligned] * np.float32(1 << 14)).astype(np.int64)
        sum_ident = float(fx.sum()) / float(1 << 14)
    else:
        sum_ident = float(ident[aligned].astype(np.float64).sum())
    n_usable = int(usable.sum())
    ani = sum_ident / max(n_aligned, 1) * 100.0
    af = n_aligned / max(n_usable, 1)
    return m, ani, af, n_aligned, n_usable


class FragmentAniEngine:
    """Stateful device-side pair-ANI evaluator over NativeSketch data.

    Caches per-genome device arrays (bitmaps, fragment streams) across
    calls, since the greedy clusterer revisits the same genomes many
    times (src/clusterer.rs:182-259 re-pairs reps repeatedly)."""

    def __init__(self, cfg: FragmentAniConfig) -> None:
        from collections import OrderedDict

        self.cfg = cfg
        self._pools: dict = {}  # device id -> _BitmapPool
        self._arenas: dict = {}  # device id -> StreamArena
        self._adopted: set = set()  # keys with device-born products
        self._query_cache: "OrderedDict[object, Tuple]" = OrderedDict()
        self._table_cache: "OrderedDict[object, Tuple]" = OrderedDict()

    def clear(self) -> None:
        self._pools.clear()
        self._arenas.clear()
        self._adopted.clear()
        self._query_cache.clear()
        self._table_cache.clear()

    def adopt_batch(self, keys, sketches, dev) -> None:
        """Adopt one device-sketch batch's products into the default-
        device caches with zero host round trip: member bitmaps fill
        the bitmap pool, fragment streams + absolute offsets fill the
        stream arena (serving pair-table dispatches directly and
        grouped-path query arrays lazily via _query_from_arena). The
        host sketch mirrors remain the fallback everywhere (non-default
        devices, arena evictions, other processes). This is the
        device-resident handoff the reference gets for free by running
        in one process (src/skani.rs:270-304)."""
        rows = list(range(len(keys)))
        self._pool(None).adopt(
            keys, dev["member_words"], rows,
            [s.member_popcount for s in sketches],
        )
        self.stream_arena(None).adopt(
            keys, dev["flat"], dev["offsets"], rows,
            [len(s.frag_buckets) for s in sketches],
            [s.n_fragments for s in sketches],
        )
        self._adopted.update(keys)

    def stream_arena(self, device) -> "StreamArena":
        did = device.id if device is not None else -1
        arena = self._arenas.get(did)
        if arena is None:
            hc, fc = _arena_capacities()
            arena = StreamArena(device, hc, fc)
            self._arenas[did] = arena
        return arena

    def _verify_devices(self):
        return verify_devices()

    def _lru_cap(self, per_device_cap: int) -> int:
        """Cache entries are keyed by (genome, device), so the global
        LRU bound scales with the fan-out width — the memory each cap
        describes is per-device."""
        return per_device_cap * max(1, len(verify_devices()))

    def _pool(self, device) -> _BitmapPool:
        did = device.id if device is not None else -1
        pool = self._pools.get(did)
        if pool is None:
            words = self.cfg.member_bits // 32
            hard_cap = self.cfg.max_cached_bitmaps
            from galah_tpu.utils.platform import (
                backend_default,
                device_memory_limit,
            )

            if backend_default(cpu=False, gpu=True):
                # The GPU sizes bitmap residency to BITMAP_POOL_SHARE
                # of the device memory limit: the config's 512 floor
                # thrashes (re-uploads) on 2048+ genome corpora.
                budget = device_memory_limit(device) * BITMAP_POOL_SHARE
                hard_cap = max(hard_cap, int(budget) // (words * 4))
            pool = _BitmapPool(
                words,
                device,
                capacity=64,
                hard_cap=hard_cap,
            )
            self._pools[did] = pool
        return pool

    def bitmap_stack(
        self, keys, sketches, gpad: int, device=None
    ) -> Tuple[jax.Array, np.ndarray]:
        """(gpad, W) uint32 member-bitmap stack + (gpad,) f32 popcounts
        for `keys`, from the per-device fixed-shape pool (padding rows
        are zero bitmaps / zero popcounts)."""
        pool = self._pool(device)
        pool.ensure(keys, sketches)
        return pool.stack(list(keys), gpad)

    def bitmap_pool_rows(
        self, keys, sketches, gpad: int, device=None, flush_cb=None
    ):
        """(pool, (gpad,) rows, (gpad,) popcounts) for `keys` —
        bitmap_stack without the per-dispatch stack-gather dispatch
        (see _BitmapPool.row_map; read pool.buffer at issue time).
        flush_cb, when given, is invoked BEFORE an ensure that could
        evict existing rows (grouped dispatches hold prepared row ids
        until issue)."""
        pool = self._pool(device)
        if flush_cb is not None and pool.would_evict(keys):
            flush_cb()
        pool.ensure(keys, sketches)
        rows, pc = pool.row_map(list(keys), gpad)
        return pool, rows, pc

    def _ref_table(self, keys, chunk, rpad, device=None):
        """Bit-transposed table (and popcounts) for one ref group,
        LRU-cached by the ref-key tuple: the greedy clusterer verifies
        many queries against the same rep sets, so the 5-pass butterfly
        build amortizes to ~zero."""
        ck = (keys, rpad, device.id if device is not None else -1)
        if ck in self._table_cache:
            self._table_cache.move_to_end(ck)
            return self._table_cache[ck]
        W = self.cfg.member_bits // 32
        table_bytes = rpad * W * 4
        cap = max(2, (256 << 20) // max(1, table_bytes)) * max(
            1, len(verify_devices())
        )
        while len(self._table_cache) >= cap:
            self._table_cache.popitem(last=False)
        bm, pc = self.bitmap_stack(list(keys), list(chunk), rpad, device)
        with _placed(device):
            table = _bit_transpose_table(bm)
        self._table_cache[ck] = (table, pc)
        return self._table_cache[ck]

    def _query_arrays(self, key, sk: NativeSketch, device=None):
        raw_key = key
        key = (key, device.id if device is not None else -1)
        if key in self._query_cache:
            self._query_cache.move_to_end(key)
        else:
            cap = self._lru_cap(self.cfg.max_cached_queries)
            while len(self._query_cache) >= cap:
                self._query_cache.popitem(last=False)
            n = len(sk.frag_buckets)
            f = sk.n_fragments
            npad = _round_up(n, 1 << 14)
            fpad = _round_up(f, 1 << 9)
            if device is None and raw_key in self._adopted:
                span = self.stream_arena(None).span(raw_key)
                if span is not None:
                    # Device-born and still arena-resident: build the
                    # padded query arrays on device (bit-identical to
                    # the upload path; tests pin device-sketch parity).
                    arena = self.stream_arena(None)
                    h_arena, o_arena = arena.buffers
                    b_dev, o_dev = _query_from_arena(
                        h_arena, o_arena,
                        jnp.int32(span[0]), jnp.int32(span[1]),
                        jnp.int32(n), jnp.int32(f),
                        npad=npad, fpad=fpad,
                    )
                    self._query_cache[key] = (
                        b_dev, o_dev,
                        jax.device_put(np.int32(n), device),
                        fpad,
                    )
                    return self._query_cache[key]
            buckets = np.zeros(npad, dtype=np.int32)
            buckets[:n] = sk.frag_buckets
            offsets = np.full(fpad + 1, n, dtype=np.int32)
            offsets[: f + 1] = sk.frag_offsets
            from galah_tpu.ops.pair_table import (
                _pack24,
                _stream_packing_enabled,
                _unpack24_jit,
                _widen_u16_jit,
            )

            if self.cfg.member_bits <= (1 << 16) and _stream_packing_enabled():
                # uint16 transport (2 bytes/bucket — 33% smaller than
                # pack24) fits whenever the member space does; padding
                # slots are zeros and the kernel masks them by n.
                with _placed(device):
                    buckets_dev = _widen_u16_jit(
                        jax.device_put(buckets.astype(np.uint16), device)
                    )
            elif self.cfg.member_bits < (1 << 24) and _stream_packing_enabled():
                # Ship 3 bytes per bucket to the device; decode once
                # on device so every consumer still sees int32.
                with _placed(device):
                    buckets_dev = _unpack24_jit(
                        jax.device_put(_pack24(buckets), device)
                    )
            else:
                buckets_dev = jax.device_put(buckets, device)
            self._query_cache[key] = (
                buckets_dev,
                jax.device_put(offsets, device),
                jax.device_put(np.int32(n), device),
                fpad,
            )
        return self._query_cache[key]

    def one_to_many_async(
        self,
        query: NativeSketch,
        query_key,
        refs: Sequence[NativeSketch],
        ref_keys: Sequence,
        device=None,
    ) -> List[Tuple]:
        """Issue ANI/AF dispatches of `query`'s fragments against each
        ref's bitmap without blocking. Returns a list of
        (packed_dev (2*rpad,) f32 = [ani | af], rpad, chunk_len) —
        convert after issuing everything so device round trips pipeline
        instead of serializing; one fetch per chunk.

        `device` places the whole group (inputs and execution) on one
        local device so independent source groups run on different
        chips concurrently."""
        cfg = self.cfg
        buckets, offsets, n, fpad = self._query_arrays(
            query_key, query, device
        )
        # Bound the (R, N) hit-matrix intermediates to ~1GB of int32:
        # very long streams get fewer refs per dispatch.
        # GALAH_TPU_VERIFY_REFS overrides the width cap
        # (benchmarks/verify_width_probe.py times the widths).
        import os as _os

        r_cap = int(
            _os.environ.get("GALAH_TPU_VERIFY_REFS", 0)
        ) or cfg.max_refs_per_dispatch
        npad = int(buckets.shape[0])
        r_chunk = refs_per_dispatch(npad, r_cap)
        placed = _placed(device)
        mode = _verify_gather_mode()
        out = []
        for lo in range(0, len(refs), r_chunk):
            chunk = refs[lo : lo + r_chunk]
            keys = ref_keys[lo : lo + r_chunk]
            kw = dict(
                bits=cfg.member_bits,
                k=cfg.k,
                min_hashes=cfg.min_fragment_hashes,
                min_ident=cfg.min_fragment_identity,
            )
            # bt pads the ref axis to a 32-word multiple; respect the
            # same intermediate budget as r_chunk — for very long
            # streams (r_chunk < 8 refs of padding headroom) the word
            # kernel's floor-8 padding is the safe choice.
            rpad_bt = max(32, 1 << (len(chunk) - 1).bit_length())
            bt_fits = rpad_bt * npad <= (256 << 20)
            use_bt = bt_fits and (
                mode == "bt" or (mode == "auto" and rpad_bt <= 64)
            )
            if use_bt:
                # One row gather per position serves all refs.
                table, pc = self._ref_table(
                    tuple(keys), chunk, rpad_bt, device
                )
                with placed:
                    packed = _forward_kernel_bt_packed(
                        table, pc, buckets, offsets, n, **kw
                    )
                out.append((packed, rpad_bt, len(chunk)))
                continue
            # Bucket the ref-count axis to powers of two (floor 8) so
            # the kernel compiles for a handful of shapes, not every
            # chunk length.
            rpad = max(8, 1 << (len(chunk) - 1).bit_length())
            bm, pc = self.bitmap_stack(list(keys), list(chunk), rpad, device)
            with placed:
                packed = _forward_kernel_packed(
                    bm,
                    pc,
                    buckets,
                    offsets,
                    n,
                    **kw,
                )
            out.append((packed, rpad, len(chunk)))
        return out

    @staticmethod
    def _unpack_chunks(chunks) -> Tuple[np.ndarray, np.ndarray]:
        """Fetch each chunk's packed [ani | af] buffer once and split."""
        anis, afs = [], []
        for packed, rpad, ln in chunks:
            buf = np.asarray(packed)
            anis.append(buf[:ln])
            afs.append(buf[rpad : rpad + ln])
        return np.concatenate(anis), np.concatenate(afs)

    def one_to_many(
        self,
        query: NativeSketch,
        query_key,
        refs: Sequence[NativeSketch],
        ref_keys: Sequence,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """ANI/AF of `query`'s fragments against each ref's bitmap.
        Returns (ani_pct (R,), af (R,))."""
        chunks = self.one_to_many_async(query, query_key, refs, ref_keys)
        return self._unpack_chunks(chunks)

    def pair_ani(
        self,
        query: NativeSketch,
        query_key,
        refs: Sequence[NativeSketch],
        ref_keys: Sequence,
    ) -> List[Tuple[float, float, float]]:
        """Bidirectional ANI for (query, ref) pairs sharing the query.

        Returns per ref: (ani_pct = max of directions, af_fwd, af_rev)
        — galah's fastANI combination semantics (src/fastani.rs:44-68).
        """
        if not refs:
            return []
        sketches_by_key = {query_key: query}
        for k_, s in zip(ref_keys, refs):
            sketches_by_key[k_] = s
        res = self.bidirectional(
            [(query_key, rk) for rk in ref_keys], sketches_by_key
        )
        return [res[(query_key, rk)] for rk in ref_keys]

    def _pair_table(self):
        if not hasattr(self, "_pair_table_verifier"):
            from galah_tpu.ops.pair_table import (
                PairTableConfig,
                PairTableVerifier,
            )

            cfg = self.cfg
            # Size the bitmap-stack capacity to a ~256MB device budget
            # so the raised flat cap (not the bitmap count) binds
            # pairs/dispatch for medium genomes; small-bitmap (contig)
            # runs fit many more pairs per dispatch either way.
            bitmap_bytes = cfg.member_bits // 8
            max_bitmaps = max(64, min(1024, (256 << 20) // bitmap_bytes))
            # Dispatch sizing: PairTableConfig's 2^23 flat-hash cap.
            self._pair_table_verifier = PairTableVerifier(
                PairTableConfig(
                    member_bits=cfg.member_bits,
                    k=cfg.k,
                    min_fragment_hashes=cfg.min_fragment_hashes,
                    min_fragment_identity=cfg.min_fragment_identity,
                    max_bitmaps=max_bitmaps,
                ),
                self.bitmap_stack,
                arena_fn=self.stream_arena,
                pool_rows_fn=self.bitmap_pool_rows,
            )
        return self._pair_table_verifier

    def bidirectional(self, pairs, sketches_by_key):
        """Bidirectional ANI over arbitrary key pairs; in multi-process
        runs the pair list is partitioned round-robin across processes
        and the (ani, af, af) results allgathered, so verify throughput
        scales with hosts like the sharded screen does.

        Lockstep contract (same as the sharded screen's collect path):
        every process must call this with the IDENTICAL pair list —
        guaranteed because the host-side clustering is deterministic
        and runs identically on every process. GALAH_TPU_MP_VERIFY=0
        restores redundant per-process computation."""
        nproc = jax.process_count()
        if nproc > 1 and len(pairs) > 0:
            from galah_tpu.parallel.mp import governed_flag

            partition = governed_flag("GALAH_TPU_MP_VERIFY")
        else:
            partition = False
        if partition:
            from jax.experimental import multihost_utils

            pairs_list = list(pairs)
            me = jax.process_index()
            mine = pairs_list[me::nproc]
            local = self._bidirectional_local(mine, sketches_by_key)
            chunk = (len(pairs_list) + nproc - 1) // nproc
            vals = np.full((chunk, 3), np.nan, dtype=np.float32)
            for i, pr in enumerate(mine):
                vals[i] = local[pr]
            gathered = np.asarray(
                multihost_utils.process_allgather(vals, tiled=True)
            ).reshape(nproc, chunk, 3)
            out = {}
            for p in range(nproc):
                for i in range(chunk):
                    gidx = p + i * nproc
                    if gidx >= len(pairs_list):
                        break
                    a, ff, fr = gathered[p, i]
                    out[pairs_list[gidx]] = (float(a), float(ff), float(fr))
            return out
        return self._bidirectional_local(pairs, sketches_by_key)

    def _bidirectional_local(self, pairs, sketches_by_key):
        """Bidirectional ANI over arbitrary key pairs.

        Two execution strategies, both single-upload per genome:
        - pair-table kernel (default for small/medium streams): many
          directed pairs per fixed-shape dispatch — dispatch count is
          O(total hashes / budget), not O(genomes);
        - grouped forward kernel (large streams): one dispatch per
          source, streams never duplicated across its targets; source
          groups round-robin over all local devices so verify scales
          with chips like the screen does (GALAH_TPU_VERIFY_DEVICES=1
          pins it to one).
        GALAH_TPU_VERIFY=pairtable|grouped forces one.

        Routing is per (undirected) pair: a pair goes through the
        pair-table kernel only when BOTH endpoints' streams fit its
        budget, else both directions go through the grouped kernel —
        so max(fwd, rev) never mixes the two kernels' numerics (the
        pair-table accumulates identities in 2^-14 fixed point, the
        grouped kernel in f32) for one pair, and one oversized genome
        in a small-contig corpus only reroutes the pairs it touches.

        Returns {(a, b): (ani_pct, af_a_dir, af_b_dir)}."""
        import os
        from collections import defaultdict

        directed_set = set()
        for a, b in pairs:
            directed_set.add((a, b))
            directed_set.add((b, a))

        mode = os.environ.get("GALAH_TPU_VERIFY")
        small_pairs: list = []
        large_pairs: list = []
        if mode == "grouped":
            large_pairs = sorted(directed_set)
        elif mode == "pairtable":
            small_pairs = sorted(directed_set)
        else:
            thresh = self._pair_table().cfg.max_flat_hashes // 8
            small_d, large_d = set(), set()
            for a, b in pairs:
                both_small = (
                    len(sketches_by_key[a].frag_buckets) <= thresh
                    and len(sketches_by_key[b].frag_buckets) <= thresh
                )
                (small_d if both_small else large_d).update(
                    ((a, b), (b, a))
                )
            small_pairs = sorted(small_d)
            large_pairs = sorted(large_d)

        # Band-immune work counters for the e2e drift guard (bench.py):
        # directed-pair counts per kernel are deterministic for a given
        # corpus, unlike the wall clock.
        from galah_tpu.utils import metrics as _metrics

        _m = _metrics.current()
        if small_pairs:
            _m.count("verify_directed_pairtable", len(small_pairs))
        if large_pairs:
            _m.count("verify_directed_grouped", len(large_pairs))

        fwd = {}
        if small_pairs:
            fwd.update(self._pair_table().run(small_pairs, sketches_by_key))
        if large_pairs:
            directed = defaultdict(set)
            for a, b in large_pairs:
                directed[a].add(b)
            # Issue every dispatch first (async), then collect: round
            # trips pipeline instead of paying dispatch latency per
            # group. Source groups are independent, so they round-robin
            # over the local devices (stable assignment -> deterministic
            # caching; identical f32 math on every device of a platform
            # -> identical results at any device count).
            devs = self._verify_devices()
            issued = []
            for i, src in enumerate(sorted(directed)):
                targets = sorted(directed[src])
                chunks = self.one_to_many_async(
                    sketches_by_key[src],
                    src,
                    [sketches_by_key[t] for t in targets],
                    targets,
                    device=devs[i % len(devs)] if len(devs) > 1 else None,
                )
                issued.append((src, targets, chunks))
            for src, targets, chunks in issued:
                anis, afs = self._unpack_chunks(chunks)
                for t, x, y in zip(targets, anis, afs):
                    fwd[(src, t)] = (float(x), float(y))
        out = {}
        for a, b in pairs:
            ani_f, af_f = fwd[(a, b)]
            ani_r, af_r = fwd[(b, a)]
            out[(a, b)] = (max(ani_f, ani_r), af_f, af_r)
        return out
