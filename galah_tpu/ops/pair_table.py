"""Pair-table verify kernel: many genome pairs per fixed-shape dispatch.

The grouped one-query-many-refs formulation (ops/fragment_ani.py) costs
one dispatch per source genome — fine for thousands of large genomes,
pathological for 100k small contigs (dispatch latency dominates). This
kernel evaluates an arbitrary batch of directed (source, target) pairs
in ONE dispatch:

- unique source fragment streams are concatenated and uploaded once per
  dispatch; when a source has many targets its stream is NOT duplicated
  on the host — tiny per-pair descriptor triples reconstruct the
  flat hash->pair mapping on device via prefix sums over pair regions;
- unique target bitmaps are stacked on device from the engine's LRU
  cache (no re-upload);
- per-fragment hit counts come from one flat gather + segment sum; the
  containment/identity/AF epilogue reduces per pair.

Every dispatch has the same (capped) shapes, so the whole verify stage
compiles exactly once per sketch-parameter configuration.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class PairTableConfig:
    member_bits: int
    k: int
    min_fragment_hashes: int
    min_fragment_identity: float
    # Dispatch capacities (pow4-bucketed compiled shapes; the caps are
    # the largest bucket). The flat cap dominates pairs/dispatch for
    # medium genomes: 2^23 packs ~134 directed 500kb-genome pairs per
    # dispatch (62.5k hashes each), amortizing per-dispatch cost;
    # 2^23 x ~10 int32 temporaries = ~320MB device peak per dispatch.
    max_flat_hashes: int = 1 << 23      # flat (pair-duplicated) hash slots
    max_flat_frags: int = 1 << 16       # flat fragment slots
    max_pairs: int = 1 << 12            # directed pairs per dispatch
    max_unique_hashes: int = 1 << 22    # concatenated unique stream slots
    max_unique_frags: int = 1 << 16
    max_bitmaps: int = 256              # distinct target bitmaps


def _shape_bucket(n: int, floor: int, cap: int) -> int:
    """Smallest power-of-FOUR multiple of `floor` >= n, capped at `cap`.

    The unique-stream buffers were fixed at their caps, so every
    dispatch uploaded the full 8MB ustream even when <15% was filled.
    Pow4 buckets bound the compile-shape count at ~5 per buffer while
    capping pad waste at 4x; full dispatches still hit the cap
    shape."""
    b = floor
    while b < n:
        b <<= 2
    return min(b, cap)


def _bucket_level(n: int, floor: int) -> int:
    """Pow4 bucket level: smallest L with floor << 2L >= n."""
    lvl = 0
    b = floor
    while b < n:
        b <<= 2
        lvl += 1
    return lvl


def flat_domain_shapes(fh: int, ff: int, cfg: "PairTableConfig"):
    """(flatn, flatf) compiled-domain shapes for a dispatch with fh
    filled flat hash slots and ff filled flat fragment slots.

    The hash and fragment domains share ONE pow4 size level (the max
    the two fills need) instead of bucketing independently: the
    fragment domain is <= 2^16 everywhere — its cumsums are negligible
    next to the hash domain's — so coupling costs ~nothing while
    cutting the compiled-shape product from #hash_buckets x
    #frag_buckets to #levels (mixed-size corpora otherwise pay a large
    cold compile bill). Shared with bench.py so the bench always
    measures the exact domain production dispatches (a bench passing
    the raised cap while production bucketed to the fill once read as a
    3.4x regression)."""
    lvl = max(
        _bucket_level(fh, 1 << 15),
        _bucket_level(ff, 1 << 10),
    )
    return (
        min((1 << 15) << (2 * lvl), cfg.max_flat_hashes),
        min((1 << 10) << (2 * lvl), cfg.max_flat_frags),
    )


def unique_domain_shapes(uh: int, uf: int, cfg: "PairTableConfig"):
    """(ubkt, fbkt) upload-buffer shapes for uh unique hash slots and
    uf unique fragment slots; one shared pow4 level, as in
    flat_domain_shapes (the fragment offsets buffer is <= 256KB — its
    padding is free next to the MB-scale ustream)."""
    lvl = max(
        _bucket_level(uh, 1 << 15),
        _bucket_level(uf, 1 << 10),
    )
    return (
        min((1 << 15) << (2 * lvl), cfg.max_unique_hashes),
        min((1 << 10) << (2 * lvl), cfg.max_unique_frags),
    )


def _pack24(a: np.ndarray) -> np.ndarray:
    """Pack non-negative int32 values < 2^24 into 3 bytes each.

    Bucket indices only need log2(member_bits) bits, so the int32
    transport wastes 25% of the upload for the default 2^22-bit member
    space. The
    device decode (reshape + 3 shifts) is exact, so results are
    bit-identical to the int32 path."""
    flat = np.ascontiguousarray(a, dtype="<u4").reshape(-1)
    return (
        flat.view(np.uint8).reshape(-1, 4)[:, :3].reshape(a.shape[:-1] + (-1,))
    ).copy()


def _unpack24(packed):
    """Device-side inverse of _pack24: (..., 3*M) uint8 -> (..., M) int32."""
    b3 = packed.reshape(packed.shape[:-1] + (-1, 3)).astype(jnp.int32)
    return b3[..., 0] | (b3[..., 1] << 8) | (b3[..., 2] << 16)


_unpack24_jit = jax.jit(_unpack24)

# uint16 -> int32 widen for the narrow stream transport (member spaces
# <= 2^16): decode once on device so every consumer sees int32.
_widen_u16_jit = jax.jit(lambda x: x.astype(jnp.int32))


def _stream_packing_enabled() -> bool:
    import os

    return os.environ.get("GALAH_TPU_STREAM_PACK", "1") != "0"


def _fast_cumsum(x):
    """Inclusive prefix sum of a long 1D array via a 2D hierarchical
    scan: reshaping to (rows, cols), scanning the minor axis and adding
    row offsets keeps every scan short (bit-identical to jnp.cumsum for
    integers)."""
    n = x.shape[0]
    if n <= 1 << 14:
        return jnp.cumsum(x)
    cols = 8192
    pad = (-n) % cols
    if pad:
        x = jnp.pad(x, (0, pad))
    x2 = x.reshape(-1, cols)
    c = jnp.cumsum(x2, axis=1)
    offs = jnp.pad(jnp.cumsum(c[:, -1])[:-1], (1, 0))
    out = (c + offs[:, None]).reshape(-1)
    return out[:n] if pad else out


@partial(
    jax.jit,
    static_argnames=("flatn", "flatf", "bits", "k", "min_hashes", "min_ident"),
)
def _pair_table_kernel_packed(*args, **kwargs):
    """_pair_table_kernel with its two (P,) f32 outputs concatenated
    into one (2P,) buffer: every host-visible array costs a fetch and
    slicing a device array to `len(batch)` costs a dispatch — returning
    one full-size packed buffer turns 2 slice-dispatches + 2 fetches
    per verify batch into 1 fetch (the (2P,) buffer is ~32KB; latency
    dominates bytes). The host slices after the fetch."""
    ani, af = _pair_table_kernel(*args, **kwargs)
    return jnp.concatenate([ani, af])


@partial(
    jax.jit,
    static_argnames=("flatn", "flatf", "bits", "k", "min_hashes", "min_ident"),
)
def _pair_table_kernel(
    ustream,              # (U,) int32 — concatenated unique source streams
    ufrag_offsets,        # (UF+1,) int32 — global fragment offsets into ustream
    bitmaps,              # (G, W) uint32 — stacked unique target bitmaps
    popcounts,            # (G,) f32
    pair_src_start,       # (P,) int32
    pair_flat_start,      # (P+1,) int32 — ascending; padded with n_flat
    pair_ufrag_start,     # (P,) int32
    pair_fragflat_start,  # (P+1,) int32 — ascending; padded with n_flat_frags
    pair_ref,             # (P,) int32 — rows into popcounts
    pair_row,             # (P,) int32 — rows into bitmaps (== pair_ref for a
                          #   per-dispatch stack; pool rows when bitmaps IS
                          #   the persistent pool, which skips the per-batch
                          #   stack-gather dispatch entirely)
    n_flat,               # () int32
    n_flat_frags,         # () int32
    flatn: int,
    flatf: int,
    bits: int,
    k: int,
    min_hashes: int,
    min_ident: float,
):
    """Returns (ani_pct (P,), af (P,)) for the directed pairs."""
    if ustream.dtype == jnp.uint8:
        ustream = _unpack24(ustream)
    U = ustream.shape[0]
    UF = ufrag_offsets.shape[0] - 1
    P = pair_src_start.shape[0]
    G, W = bitmaps.shape
    assert flatf * (1 << 14) < (1 << 31), "fixed-point ident sum would overflow"

    def boundary_ids(starts, domain):
        """For each i in [0, domain): (number of starts <= i) - 1 —
        searchsorted(starts, iota, 'right') - 1, but built from a tiny
        scatter + prefix sum: searchsorted costs log(K) gather passes
        over the full domain, the scatter touches only len(starts)
        elements."""
        marks = jnp.zeros((domain,), jnp.int32).at[
            jnp.clip(starts, 0, domain - 1)
        ].add(jnp.where(starts < domain, 1, 0))
        return _fast_cumsum(marks) - 1

    def segment_broadcast(starts, values, domain):
        """out[i] = values[p] for the largest p with starts[p] <= i —
        i.e. table[searchsorted-1] for a sorted index, without the
        per-element gather over the whole domain: scatter value *diffs*
        at the
        segment starts and prefix-sum. Duplicate starts (empty
        segments) accumulate so the last segment wins, matching
        side='right'. Positions before starts[0] read values[0] iff
        starts[0] == 0 (always true for these tables)."""
        d = jnp.concatenate([values[:1], values[1:] - values[:-1]])
        arr = jnp.zeros((domain,), jnp.int32).at[
            jnp.clip(starts, 0, domain - 1)
        ].add(jnp.where(starts < domain, d, 0))
        return _fast_cumsum(arr)

    # --- flat hash space ---
    # Per-element pair attributes come from segment broadcasts over the
    # (sorted) pair regions — no pair_of gather chain.
    flat_idx = jnp.arange(flatn, dtype=jnp.int32)
    valid_h = flat_idx < n_flat
    pfs_b = segment_broadcast(pair_flat_start, pair_flat_start, flatn)
    pss_b = segment_broadcast(
        pair_flat_start, jnp.concatenate([pair_src_start, pair_src_start[-1:]]),
        flatn,
    )
    row = segment_broadcast(
        pair_flat_start, jnp.concatenate([pair_row, pair_row[-1:]]), flatn
    )
    rel = flat_idx - pfs_b
    upos = jnp.clip(pss_b + rel, 0, U - 1)
    bucket = ustream[upos].astype(jnp.int32)
    word_idx = row * W + (bucket >> 5)
    words = jnp.take(bitmaps.reshape(-1), word_idx)
    hit = ((words >> (bucket & 31).astype(jnp.uint32)) & jnp.uint32(1)).astype(
        jnp.int32
    )
    hit = jnp.where(valid_h, hit, 0)

    # --- per-fragment hit counts via cumsum + boundary gathers ---
    # Fragments are contiguous flat ranges, so a prefix scan + two
    # gathers replaces the scatter-add segment sum.
    frag_idx = jnp.arange(flatf, dtype=jnp.int32)
    valid_f = frag_idx < n_flat_frags
    fpair = jnp.clip(boundary_ids(pair_fragflat_start, flatf), 0, P - 1)
    # Global unique-fragment id of flat fragment f, then its flat hash
    # range: flat position of stream pos u (pair p) is
    # pair_flat_start[p] + u - pair_src_start[p].
    uf = jnp.clip(
        pair_ufrag_start[fpair] + (frag_idx - pair_fragflat_start[fpair]),
        0,
        UF - 1,
    )
    base = pair_flat_start[fpair] - pair_src_start[fpair]
    f_start = jnp.clip(base + ufrag_offsets[uf], 0, flatn)
    f_end = jnp.clip(base + ufrag_offsets[uf + 1], 0, flatn)
    f_start = jnp.where(valid_f, f_start, 0)
    f_end = jnp.where(valid_f, f_end, 0)
    hcum = jnp.pad(_fast_cumsum(hit), (1, 0))  # (flatn+1,) hits before t
    m = hcum[f_end] - hcum[f_start]
    Mf = f_end - f_start

    # --- per-fragment epilogue ---
    p = popcounts[pair_ref[fpair]] / float(bits)
    Mfloat = Mf.astype(jnp.float32)
    c = (m.astype(jnp.float32) - Mfloat * p) / jnp.maximum(1.0 - p, 1e-6)
    c = jnp.clip(c, 0.0, Mfloat)
    usable = valid_f & (Mf >= min_hashes)
    cont = c / jnp.maximum(Mfloat, 1.0)
    ident = jnp.power(jnp.maximum(cont, 1e-30), 1.0 / k)
    aligned = usable & (ident >= min_ident)

    # --- per-pair reduction, same cumsum trick over the frag axis ---
    # ident is accumulated in 2^-14 fixed point so the prefix sum stays
    # exact (f32 prefix sums drift ~1e-7 * sum * log n, enough to move
    # ANI by hundredths of a point on 64k-fragment batches).
    ident_fx = jnp.where(aligned, jnp.round(ident * (1 << 14)), 0.0).astype(
        jnp.int32
    )
    acum = jnp.pad(_fast_cumsum(aligned.astype(jnp.int32)), (1, 0))
    ucum = jnp.pad(_fast_cumsum(usable.astype(jnp.int32)), (1, 0))
    icum = jnp.pad(_fast_cumsum(ident_fx), (1, 0))
    lo = pair_fragflat_start[:P]
    hi = pair_fragflat_start[1:]
    n_aligned = acum[hi] - acum[lo]
    n_usable = ucum[hi] - ucum[lo]
    sum_ident = (icum[hi] - icum[lo]).astype(jnp.float32) / float(1 << 14)
    ani = sum_ident / jnp.maximum(n_aligned, 1) * 100.0
    af = n_aligned / jnp.maximum(n_usable, 1)
    return ani, af


def _split_desc(desc, g: int, p: int):
    """Unpack one dispatch's packed int32 descriptor row (see
    _pack_desc: [popc-bits (g,) | psrc (p,) | pfs (p+1,) | puf (p,) |
    pffs (p+1,) | pref (p,) | prow (p,) | nfl | nff]). One packed
    upload replaces nine per-operand device_puts per dispatch."""
    popc = jax.lax.bitcast_convert_type(desc[:g], jnp.float32)
    o = g
    psrc = desc[o : o + p]
    o += p
    pfs = desc[o : o + p + 1]
    o += p + 1
    puf = desc[o : o + p]
    o += p
    pffs = desc[o : o + p + 1]
    o += p + 1
    pref = desc[o : o + p]
    o += p
    prow = desc[o : o + p]
    o += p
    return popc, psrc, pfs, puf, pffs, pref, prow, desc[o], desc[o + 1]


def _pack_desc(popc, psrc, pfs, puf, pffs, pref, prow, nfl, nff):
    """Host-side inverse of _split_desc (one (C,) int32 row)."""
    return np.concatenate([
        np.ascontiguousarray(popc, dtype=np.float32).view(np.int32),
        psrc, pfs, puf, pffs, pref, prow,
        np.array([nfl, nff], np.int32),
    ])


@partial(
    jax.jit,
    static_argnames=("g", "p", "flatn", "flatf", "bits", "k",
                     "min_hashes", "min_ident"),
)
def _pair_table_kernel_desc(
    ustream, uoff, bitmaps, desc, *,
    g: int, p: int, flatn: int, flatf: int, bits: int, k: int,
    min_hashes: int, min_ident: float,
):
    """Single dispatch from one packed descriptor row."""
    return _pair_table_kernel_packed(
        ustream, uoff, bitmaps, *_split_desc(desc, g, p),
        flatn=flatn, flatf=flatf, bits=bits, k=k,
        min_hashes=min_hashes, min_ident=min_ident,
    )


@partial(
    jax.jit,
    static_argnames=("g", "p", "flatn", "flatf", "bits", "k",
                     "min_hashes", "min_ident"),
)
def _pair_table_group_kernel(
    ustream, uoff, bitmaps, desc_k, *,
    g: int, p: int, flatn: int, flatf: int, bits: int, k: int,
    min_hashes: int, min_ident: float,
):
    """K pair-table dispatches in ONE program (lax.map over the packed
    (K, C) descriptor rows): with the arena holding the streams and the
    pool holding the bitmaps, a dispatch's own operands are a few KB of
    descriptors — so per-dispatch cost is the verify stage's floor.
    Grouping divides it by K, and the single
    packed descriptor upload replaces 9 per-operand device_puts per
    dispatch. Returns (K, 2P) packed [ani | af] rows — one fetch for
    the whole group. Bit-identical to single dispatches: the mapped
    body IS the single-dispatch kernel."""
    return jax.lax.map(
        lambda d: _pair_table_kernel_packed(
            ustream, uoff, bitmaps, *_split_desc(d, g, p),
            flatn=flatn, flatf=flatf, bits=bits, k=k,
            min_hashes=min_hashes, min_ident=min_ident,
        ),
        desc_k,
    )


def _verify_group() -> int:
    """Pair-table dispatches per device call (upper bound; see
    _group_cap_for_shape). GALAH_TPU_VERIFY_GROUP overrides; default 1
    on CPU (lax.map would serialize what XLA:CPU runs concurrently);
    the GPU's value is measured end to end in PERF.md."""
    import os

    env = os.environ.get("GALAH_TPU_VERIFY_GROUP")
    if env:
        return max(1, int(env))
    from galah_tpu.utils.platform import backend_default

    return backend_default(cpu=1, gpu=8)


def _group_cap_for_shape(flatn: int, member_bits: int) -> int:
    """Shape-aware group size: batching K gather-heavy MAG dispatches
    (2^22-bit members; the per-pair word gathers span a ~512MB pool)
    into one program serializes them for little saving, while
    small-member contig dispatches (2^16 bits, 8KB rows, gather-light)
    amortize per-dispatch cost. Group only the small-member class;
    shrink K when the flat domain is below the contig-class cap
    anyway."""
    if member_bits > (1 << 16):
        return 1
    return max(1, min(8, (1 << 26) // max(flatn, 1)))


def _pool_direct_enabled() -> bool:
    """Whether pair-table dispatches address the persistent bitmap
    pool directly through per-pair row ids (default) instead of
    gathering a per-dispatch stack first. GALAH_TPU_POOL_DIRECT=0
    restores the stack path (bit-identical; the bitmap words read are
    the same either way)."""
    import os

    return os.environ.get("GALAH_TPU_POOL_DIRECT", "1") != "0"


def _arena_enabled() -> bool:
    """Whether pair-table dispatches read unique streams from the
    persistent device arena (ops/fragment_ani.py::StreamArena) instead
    of re-uploading them per dispatch. GALAH_TPU_ARENA=0 restores the
    per-dispatch upload (bit-identical; the kernel is unchanged)."""
    import os

    return os.environ.get("GALAH_TPU_ARENA", "1") != "0"


class PairTableVerifier:
    """Host-side batcher for the pair-table kernel."""

    def __init__(
        self, cfg: PairTableConfig, bitmap_stack_fn, arena_fn=None,
        pool_rows_fn=None,
    ) -> None:
        """bitmap_stack_fn(keys, sketches, gpad, device=None) ->
        ((gpad, W) uint32 device bitmap stack, (gpad,) f32 host
        popcounts); padding rows are zero bitmaps.
        arena_fn(device) -> StreamArena (optional): when provided (and
        GALAH_TPU_ARENA != 0), unique source streams are read from the
        persistent per-device arena — uploaded at most once per genome
        per residency window, or adopted device-to-device from the
        device sketcher — instead of once per dispatch.
        pool_rows_fn(keys, sketches, gpad, device=None) ->
        ((C, W) uint32 device pool, (gpad,) int32 host rows, (gpad,)
        f32 host popcounts) (optional): when provided, the kernel
        addresses the persistent bitmap pool directly through per-pair
        row ids — no per-batch stack-gather dispatch and no (gpad, W)
        stack materialization."""
        self.cfg = cfg
        self._bitmap_stack_fn = bitmap_stack_fn
        self._arena_fn = arena_fn
        self._pool_rows_fn = pool_rows_fn

    def _plan_batches(
        self, directed_pairs: Sequence[Tuple], sketches_by_key: Dict
    ) -> List[List[Tuple]]:
        """Pack directed pairs into dispatch-sized batches (pure host
        planning, no device calls): pairs group by source so unique
        streams amortize; a batch closes when any capacity would
        overflow."""
        cfg = self.cfg
        batches: List[List[Tuple]] = []
        batch: List[Tuple] = []
        usage = _Usage()

        def src_cost(key):
            sk = sketches_by_key[key]
            return len(sk.frag_buckets), sk.n_fragments

        from collections import defaultdict

        by_src = defaultdict(list)
        for s, t in directed_pairs:
            by_src[s].append(t)

        def flush():
            nonlocal batch, usage
            if batch:
                batches.append(batch)
                batch = []
                usage = _Usage()

        for src in sorted(by_src):
            nh, nf = src_cost(src)
            if nh > cfg.max_flat_hashes or nf > cfg.max_flat_frags:
                raise ValueError(
                    f"source stream too large for pair table: {nh} hashes"
                )
            for tgt in sorted(by_src[src]):
                add_unique = 0 if usage.has_src == src else 1
                need_uh = nh if add_unique else 0
                need_uf = nf if add_unique else 0
                new_bitmap = 0 if tgt in usage.bitmaps else 1
                if (
                    usage.flat_h + nh > cfg.max_flat_hashes
                    or usage.flat_f + nf > cfg.max_flat_frags
                    or usage.uniq_h + need_uh > cfg.max_unique_hashes
                    or usage.uniq_f + need_uf > cfg.max_unique_frags
                    or usage.n_pairs + 1 > cfg.max_pairs
                    or len(usage.bitmaps) + new_bitmap > cfg.max_bitmaps
                ):
                    flush()
                    # after flush the source stream must be re-added
                if usage.has_src != src:
                    usage.uniq_h += nh
                    usage.uniq_f += nf
                    usage.has_src = src
                usage.flat_h += nh
                usage.flat_f += nf
                usage.n_pairs += 1
                usage.bitmaps.add(tgt)
                batch.append((src, tgt))
        flush()
        return batches

    def run(
        self,
        directed_pairs: Sequence[Tuple],
        sketches_by_key: Dict,
    ) -> Dict[Tuple, Tuple[float, float]]:
        """Evaluate directed (src, tgt) pairs; returns
        {(src, tgt): (ani_pct, af_src_direction)}.

        Dispatches are issued in GROUPS of _verify_group() per RPC
        when the arena + pool-direct paths are live (their prepared
        descriptors are tiny, so K dispatches share one program and
        one result fetch); a group flushes early when the next batch
        would reset the arena or evict pool rows (prepared spans/rows
        must stay valid until issue), when its static shapes differ,
        or when a batch needs the upload fallback."""
        cfg = self.cfg
        results: Dict[Tuple, Tuple[float, float]] = {}
        batches = self._plan_batches(directed_pairs, sketches_by_key)

        # Dispatches are independent fixed-shape programs: round-robin
        # them over the local devices like the grouped kernel's source
        # groups (ops/fragment_ani.py::verify_devices).
        from galah_tpu.ops.fragment_ani import verify_devices

        devs = verify_devices()
        import os

        gcap_forced = bool(os.environ.get("GALAH_TPU_VERIFY_GROUP"))
        gcap = _verify_group()
        # Device-assignment stride: block batches per device only as
        # wide as grouping can actually engage for this config —
        # single-dispatch classes (MAG member widths) keep the plain
        # per-batch round-robin so all local devices stay busy.
        stride = (
            gcap
            if gcap_forced
            else min(
                gcap,
                _group_cap_for_shape(cfg.max_flat_hashes, cfg.member_bits),
            )
        )

        issued: List[Tuple] = []
        group: List[Dict] = []
        gkey = None

        def flush_group():
            nonlocal group, gkey
            if not group:
                return
            if len(group) == 1:
                issued.append(
                    ("s", group[0]["batch"], self._issue_single(group[0]))
                )
            else:
                issued.append((
                    "g",
                    [p["batch"] for p in group],
                    self._issue_group(group),
                ))
            group, gkey = [], None

        for i, batch in enumerate(batches):
            # Blocked round-robin: consecutive batches share a device
            # for `stride` steps so groups can form; with stride=1
            # (CPU, or single-dispatch shape classes) this is the
            # plain per-batch round-robin.
            dev = (
                devs[(i // stride) % len(devs)] if len(devs) > 1 else None
            )
            p = self._prepare(batch, sketches_by_key, dev, flush_group)
            if p is None:
                flush_group()
                issued.append(
                    ("s", batch, self._dispatch(batch, sketches_by_key, dev))
                )
                continue
            key = (p["devid"], p["flatn"], p["flatf"], p["G"])
            cap_here = (
                gcap
                if gcap_forced
                else min(
                    gcap,
                    _group_cap_for_shape(p["flatn"], cfg.member_bits),
                )
            )
            if gkey is not None and (key != gkey or len(group) >= cap_here):
                flush_group()
            if gkey is None:
                gkey = key
            group.append(p)
            if len(group) >= cap_here:
                flush_group()
        flush_group()

        P = cfg.max_pairs
        for kind, b, out in issued:
            buf = np.asarray(out)
            if kind == "s":
                for i, pr in enumerate(b):
                    results[pr] = (float(buf[i]), float(buf[P + i]))
            else:
                for t, bt in enumerate(b):
                    for i, pr in enumerate(bt):
                        results[pr] = (
                            float(buf[t, i]), float(buf[t, P + i])
                        )
        return results

    def _dispatch(self, batch: List[Tuple], sketches_by_key: Dict, device=None):
        cfg = self.cfg

        # unique sources in batch order
        src_order: List = []
        src_info: Dict = {}
        for s, _ in batch:
            if s not in src_info:
                src_order.append(s)
                sk = sketches_by_key[s]
                src_info[s] = sk

        # Stream placement: persistent device arena (default — each
        # stream is resident once per window, dispatches upload only
        # the tiny pair descriptors) or per-dispatch upload.
        arena = None
        spans: Dict = {}
        if self._arena_fn is not None and _arena_enabled():
            arena = self._arena_fn(device)
            spans = arena.ensure(src_order, src_info)
            if any(s not in spans for s in src_order):
                arena, spans = None, {}  # oversized stream: upload path

        if arena is not None:
            src_start = {s: spans[s][0] for s in src_order}
            src_ufrag_start = {s: spans[s][1] for s in src_order}
            ustream_dev, ufrag_dev = arena.buffers
        else:
            uoff_parts = [np.zeros(1, dtype=np.int32)]
            ustream_parts = []
            src_start = {}
            src_ufrag_start = {}
            uh = 0
            uf = 0
            for s in src_order:
                sk = src_info[s]
                src_start[s] = uh
                src_ufrag_start[s] = uf
                ustream_parts.append(sk.frag_buckets.astype(np.int32))
                uoff_parts.append(
                    (sk.frag_offsets[1:] + uh).astype(np.int32)
                )
                uh += len(sk.frag_buckets)
                uf += sk.n_fragments

            # Narrow stream transport when bucket indices fit: uint16
            # (small-contig configs) or packed 24-bit (default 2^22
            # member space) — fewer upload bytes, and the device
            # decode is exact.
            pack24 = (1 << 16) < cfg.member_bits < (1 << 24) and (
                _stream_packing_enabled()
            )
            stream_dtype = (
                np.uint16 if cfg.member_bits <= (1 << 16) else np.int32
            )
            # Upload only the filled prefix, pow4-bucketed: everything
            # past uh/uf feeds masked lanes only (valid_h/valid_f), so
            # the kernel result is bit-identical at any buffer length
            # >= the fill.
            ubkt, fbkt = unique_domain_shapes(uh, uf, cfg)
            ustream = np.zeros(ubkt, dtype=stream_dtype)
            if uh:
                ustream[:uh] = np.concatenate(ustream_parts).astype(
                    stream_dtype
                )
            if pack24:
                ustream = _pack24(ustream)
            ufrag_offsets = np.full(fbkt + 1, uh, dtype=np.int32)
            uoff = np.concatenate(uoff_parts)
            ufrag_offsets[: len(uoff)] = uoff

        # distinct bitmaps
        tgt_order: List = []
        tgt_row: Dict = {}
        for _, t in batch:
            if t not in tgt_row:
                tgt_row[t] = len(tgt_order)
                tgt_order.append(t)
        # Pow4-bucketed stack height: a full dispatch at the default
        # member space would gather a 256MB cap-sized stack even for a
        # 2-target batch; the kernel reads G from the operand shape.
        # Pow4 (not pow2) keeps the compiled-shape product bounded
        # (the gather overshoot is an on-device HBM pass, cheap).
        G = min(_shape_bucket(len(tgt_order), 8, cfg.max_bitmaps), cfg.max_bitmaps)
        from galah_tpu.ops.fragment_ani import _placed

        placed = _placed(device)
        if self._pool_rows_fn is not None and _pool_direct_enabled():
            pool, row_of, popcounts = self._pool_rows_fn(
                tgt_order, [sketches_by_key[t] for t in tgt_order], G,
                device,
            )
            bitmaps = pool.buffer
        else:
            bitmaps, popcounts = self._bitmap_stack_fn(
                tgt_order, [sketches_by_key[t] for t in tgt_order], G,
                device,
            )
            row_of = None

        # per-pair descriptors
        P = cfg.max_pairs
        pair_src_start = np.zeros(P, dtype=np.int32)
        pair_ufrag_start = np.zeros(P, dtype=np.int32)
        pair_ref = np.zeros(P, dtype=np.int32)
        pair_row = np.zeros(P, dtype=np.int32)
        if row_of is not None:
            # Padding pairs address the pool's zero row (row 1), never
            # a live genome's bitmap.
            pair_row[:] = 1
        flat_start = np.zeros(P + 1, dtype=np.int32)
        fragflat_start = np.zeros(P + 1, dtype=np.int32)
        fh = 0
        ff = 0
        for i, (s, t) in enumerate(batch):
            sk = src_info[s]
            pair_src_start[i] = src_start[s]
            pair_ufrag_start[i] = src_ufrag_start[s]
            pair_ref[i] = tgt_row[t]
            pair_row[i] = (
                row_of[tgt_row[t]] if row_of is not None else tgt_row[t]
            )
            flat_start[i] = fh
            fragflat_start[i] = ff
            fh += len(sk.frag_buckets)
            ff += sk.n_fragments
        flat_start[len(batch):] = fh
        fragflat_start[len(batch):] = ff

        # The flat (pair-duplicated) domain is pow4-bucketed like the
        # unique buffers: positions past fh/ff feed masked lanes only,
        # so results are bit-identical at any domain >= the fill, small
        # dispatches don't pay the full cap's iota/cumsum work, and
        # raising the cap costs partially-filled dispatches nothing.
        flatn, flatf = flat_domain_shapes(fh, ff, cfg)
        if arena is not None:
            with placed:
                us_op, uo_op = ustream_dev, ufrag_dev
        else:
            with placed:
                us_op = jnp.asarray(ustream)
                uo_op = jnp.asarray(ufrag_offsets)
        with placed:
            out = _pair_table_kernel_packed(
                us_op,
                uo_op,
                bitmaps,
                jnp.asarray(popcounts),
                jnp.asarray(pair_src_start),
                jnp.asarray(flat_start),
                jnp.asarray(pair_ufrag_start),
                jnp.asarray(fragflat_start),
                jnp.asarray(pair_ref),
                jnp.asarray(pair_row),
                jnp.int32(fh),
                jnp.int32(ff),
                flatn=flatn,
                flatf=flatf,
                bits=cfg.member_bits,
                k=cfg.k,
                min_hashes=cfg.min_fragment_hashes,
                min_ident=cfg.min_fragment_identity,
            )
        return out

    def _prepare(
        self, batch: List[Tuple], sketches_by_key: Dict, device, flush_cb
    ) -> Optional[Dict]:
        """Build one dispatch's descriptors against the persistent
        arena + pool (host work only; ensure() fills are content-
        preserving). Returns None when the batch needs the upload
        fallback. flush_cb runs BEFORE any arena reset or pool
        eviction so already-prepared dispatches issue while their
        spans/row ids are still valid; the device buffers themselves
        are read at issue time (fills donate and replace them)."""
        cfg = self.cfg
        if (
            self._arena_fn is None
            or not _arena_enabled()
            or self._pool_rows_fn is None
            or not _pool_direct_enabled()
        ):
            return None

        src_order: List = []
        src_info: Dict = {}
        for s, _ in batch:
            if s not in src_info:
                src_order.append(s)
                src_info[s] = sketches_by_key[s]
        tgt_order: List = []
        tgt_row: Dict = {}
        for _, t in batch:
            if t not in tgt_row:
                tgt_row[t] = len(tgt_order)
                tgt_order.append(t)

        arena = self._arena_fn(device)
        if arena.would_reset(src_order, src_info):
            flush_cb()
        spans = arena.ensure(src_order, src_info)
        if any(s not in spans for s in src_order):
            return None  # oversized stream: upload path

        G = min(
            _shape_bucket(len(tgt_order), 8, cfg.max_bitmaps),
            cfg.max_bitmaps,
        )
        pool, row_of, popc = self._pool_rows_fn(
            tgt_order, [sketches_by_key[t] for t in tgt_order], G,
            device, flush_cb=flush_cb,
        )

        P = cfg.max_pairs
        psrc = np.zeros(P, dtype=np.int32)
        puf = np.zeros(P, dtype=np.int32)
        pref = np.zeros(P, dtype=np.int32)
        prow = np.ones(P, dtype=np.int32)  # padding -> zero row 1
        pfs = np.zeros(P + 1, dtype=np.int32)
        pffs = np.zeros(P + 1, dtype=np.int32)
        fh = 0
        ff = 0
        for i, (s, t) in enumerate(batch):
            sk = src_info[s]
            psrc[i] = spans[s][0]
            puf[i] = spans[s][1]
            pref[i] = tgt_row[t]
            prow[i] = row_of[tgt_row[t]]
            pfs[i] = fh
            pffs[i] = ff
            fh += len(sk.frag_buckets)
            ff += sk.n_fragments
        pfs[len(batch):] = fh
        pffs[len(batch):] = ff
        flatn, flatf = flat_domain_shapes(fh, ff, cfg)
        return dict(
            batch=list(batch), device=device, devid=id(device),
            arena=arena, pool=pool,
            desc=_pack_desc(popc, psrc, pfs, puf, pffs, pref, prow,
                            fh, ff),
            nfl=fh, flatn=flatn, flatf=flatf, G=G,
        )

    def _kernel_statics(self) -> Dict:
        cfg = self.cfg
        return dict(
            bits=cfg.member_bits, k=cfg.k,
            min_hashes=cfg.min_fragment_hashes,
            min_ident=cfg.min_fragment_identity,
        )

    def _issue_single(self, p: Dict):
        from galah_tpu.ops.fragment_ani import _placed

        us, uo = p["arena"].buffers
        with _placed(p["device"]):
            return _pair_table_kernel_desc(
                us, uo, p["pool"].buffer, jnp.asarray(p["desc"]),
                g=p["G"], p=self.cfg.max_pairs,
                flatn=p["flatn"], flatf=p["flatf"],
                **self._kernel_statics(),
            )

    def _issue_group(self, ps: List[Dict]):
        from galah_tpu.ops.fragment_ani import _placed

        p0 = ps[0]
        us, uo = p0["arena"].buffers
        with _placed(p0["device"]):
            return _pair_table_group_kernel(
                us, uo, p0["pool"].buffer,
                jnp.asarray(np.stack([p["desc"] for p in ps])),
                g=p0["G"], p=self.cfg.max_pairs,
                flatn=p0["flatn"], flatf=p0["flatf"],
                **self._kernel_statics(),
            )


class _Usage:
    def __init__(self) -> None:
        self.flat_h = 0
        self.flat_f = 0
        self.uniq_h = 0
        self.uniq_f = 0
        self.n_pairs = 0
        self.bitmaps = set()
        self.has_src = None
