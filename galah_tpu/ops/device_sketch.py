"""On-device FracMinHash sketching (canonical k-mers + splitmix64).

Moves the sketch stage — the reference delegates it to skani/finch on
host CPUs (src/skani.rs:270-290, src/finch.rs:55-72) and galah_tpu's
host path runs it in threaded C++ (native/fastaio.cpp) — onto the
accelerator itself. One upload of 2-bit-encoded sequence per genome replaces
per-genome host hashing; canonical k-mer construction, the splitmix64
finalizer, FracMinHash selection, bitmap construction and per-fragment
dedup/compaction all run on device, bit-identical to the host
implementation (galah_tpu/sketch/fracminhash.py, sketch/kmers.py).

Why on the device: k-mer hashing is pure elementwise integer
arithmetic over the sequence, which XLA fuses into a handful of passes
over the input; the device hashes sequence far faster than the host
cores that feed it (PERF.md).

The 64-bit splitmix64 finalizer runs on (hi, lo) uint32 lane pairs
with exact carry propagation (validated element-for-element against
the numpy uint64 implementation in tests/test_device_sketch.py).

Layout notes:
- A genome's contigs are concatenated with one invalid byte between
  them: any k-window containing the separator is dropped, so no k-mer
  spans a contig boundary — same semantics as the host's per-contig
  loop.
- Fragment assignment reuses the host rule (k-mer belongs to the
  fragment containing its start position; k-mers past the last
  fragment boundary are counted in the genome-level sets but not in
  any fragment). The host precomputes, per genome, a sorted boundary
  list and a bin -> fragment map (-1 for separator/trailing bins);
  on device the bin of every position is a scatter + prefix sum.
- Per-fragment dedup = lexicographic sort by (fragment, bucket) +
  adjacent-difference compaction, exactly np.unique on
  frag * member_bits + bucket without ever forming the 64-bit key.

Two formulations compute the same outputs: _sketch_one (XLA sort and
scatter; the default) and _sketch_one_routed (scatter-free monotone
routing and bitonic networks, ops/routing.py; GALAH_TPU_SKETCH_KERNEL=
routed). Prefix sums use the hierarchical 2D scan
(ops/pair_table.py::_fast_cumsum), and the dedup sort runs on a single
combined uint32 key (frag << bucket_bits | bucket) whenever
max_frags * member_bits fits in 31 bits — always true for contig /
small-genome sketches — falling back to the two-key sort for large
multi-Mb genomes.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from galah_tpu.ops.pair_table import _fast_cumsum
from galah_tpu.sketch.fracminhash import (
    NativeSketch,
    NativeSketchParams,
    _fragment_boundaries,
)
from galah_tpu.sketch.kmers import encode_bases

logger = logging.getLogger(__name__)

_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB


def _u32(x: int):
    return jnp.uint32(x & 0xFFFFFFFF)


def _mul32x32(a, b: int):
    """Full 32x32 -> 64 product of a uint32 array with a constant.
    Returns (hi, lo) uint32; exact via 16-bit limbs."""
    a0 = a & _u32(0xFFFF)
    a1 = a >> _u32(16)
    b0 = _u32(b & 0xFFFF)
    b1 = _u32((b >> 16) & 0xFFFF)
    p = a0 * b0
    q = a1 * b0
    r = a0 * b1
    s = a1 * b1
    t = (p >> _u32(16)) + (q & _u32(0xFFFF)) + (r & _u32(0xFFFF))
    lo = (p & _u32(0xFFFF)) | ((t & _u32(0xFFFF)) << _u32(16))
    hi = s + (q >> _u32(16)) + (r >> _u32(16)) + (t >> _u32(16))
    return hi, lo


def _mul64_const(hi, lo, c: int):
    """(hi, lo) * c mod 2**64 for a 64-bit constant c."""
    c_lo = c & 0xFFFFFFFF
    c_hi = (c >> 32) & 0xFFFFFFFF
    out_hi, out_lo = _mul32x32(lo, c_lo)
    out_hi = out_hi + lo * _u32(c_hi) + hi * _u32(c_lo)
    return out_hi, out_lo


def _shr64(hi, lo, r: int):
    """(hi, lo) >> r for 0 < r < 32."""
    return hi >> _u32(r), (lo >> _u32(r)) | (hi << _u32(32 - r))


def _xor64(ahi, alo, bhi, blo):
    return ahi ^ bhi, alo ^ blo


def mix64_pair(hi, lo):
    """splitmix64 finalizer on (hi, lo) uint32 pairs — exactly
    galah_tpu.sketch.fracminhash.mix64 without native uint64."""
    hi, lo = _xor64(hi, lo, *_shr64(hi, lo, 30))
    hi, lo = _mul64_const(hi, lo, _M1)
    hi, lo = _xor64(hi, lo, *_shr64(hi, lo, 27))
    hi, lo = _mul64_const(hi, lo, _M2)
    hi, lo = _xor64(hi, lo, *_shr64(hi, lo, 31))
    return hi, lo


def _lt64(hi, lo, t: int):
    t_hi = _u32((t >> 32) & 0xFFFFFFFF)
    t_lo = _u32(t & 0xFFFFFFFF)
    return (hi < t_hi) | ((hi == t_hi) & (lo < t_lo))


def _pack_indicator_words(ind):
    """(bits,) 0/1 uint8 indicator -> (bits//32,) uint32 words, bit
    (bucket & 31) of word (bucket >> 5) — host pack_indicator layout.
    The indicator stays uint8 in HBM (4x less traffic than uint32 for
    the multi-MB member bitmaps); widening happens in-register here."""
    bits = ind.shape[0]
    w = ind.reshape(bits // 32, 32).astype(jnp.uint32)
    return jnp.sum(w << jnp.arange(32, dtype=jnp.uint32)[None, :],
                   axis=1, dtype=jnp.uint32)


def _hash_front(
    packed, inv_idx, length, bounds, bin2frag, *, k, gthresh, fthresh,
    member_bits,
):
    """Shared front half: unpack 2-bit codes, canonical k-mers,
    splitmix64, FracMinHash selection masks, member bucket, and the
    fragment id of every position. Pure elementwise + one prefix sum —
    the cheap part of the kernel (5.3G bases/s measured)."""
    P = packed.shape[0] * 4
    n = P - k + 1
    c32 = jnp.stack(
        [(packed >> jnp.uint8(2 * j)) & jnp.uint8(3) for j in range(4)],
        axis=1,
    ).reshape(P).astype(jnp.uint32)
    invalid = jnp.zeros(P, dtype=bool)
    invalid = invalid.at[inv_idx].set(True, mode="drop")
    invalid = invalid | (jnp.arange(P, dtype=jnp.int32) >= length)

    fwd = jnp.zeros(n, dtype=jnp.uint32)
    rev = jnp.zeros(n, dtype=jnp.uint32)
    bad = jnp.zeros(n, dtype=bool)
    for j in range(k):
        cj = jax.lax.slice(c32, (j,), (j + n,))
        fwd = (fwd << _u32(2)) | cj
        rev = rev | ((_u32(3) - cj) << _u32(2 * j))
        bad = bad | jax.lax.slice(invalid, (j,), (j + n,))
    canon = jnp.minimum(fwd, rev)
    kvalid = ~bad

    hi, lo = mix64_pair(jnp.zeros_like(canon), canon)
    fsel = kvalid & _lt64(hi, lo, fthresh)
    gsel = kvalid & _lt64(hi, lo, gthresh)
    mbucket = (lo & _u32(member_bits - 1)).astype(jnp.int32)

    # Fragment id of each position, WITHOUT the n-element gather the
    # first formulation paid (bin2frag[pos_bin] gathers one row per
    # position — ~300ms per 33.5M-base batch at XLA's per-index gather
    # floor): scatter the per-boundary VALUE DIFFS at the (few hundred)
    # boundary positions and prefix-sum, so frag(pos) equals the
    # bin2frag of the last boundary <= pos directly. Boundaries at
    # positions >= n (the last fragment end can land inside the final
    # k-1 bases) are a suffix and are dropped by the scatter; no valid
    # k-mer starts there.
    diffs = jnp.concatenate(
        [bin2frag[:1], bin2frag[1:] - bin2frag[:-1]]
    )
    dmarks = jnp.zeros(n, dtype=jnp.int32)
    dmarks = dmarks.at[bounds].add(diffs, mode="drop")
    frag = _fast_cumsum(dmarks)
    return fsel, gsel, mbucket, frag


def _sketch_one(
    packed,       # (P//4,) uint8; 4 x 2-bit base codes per byte,
                  #  little-endian within the byte (pos 4i+j at bits 2j)
    inv_idx,      # (NI,) int32 positions of non-ACGT bases/separators
                  #  within [0, length); padding = P (dropped)
    length,       # () int32 live length; positions >= length are invalid
    bounds,       # (NB,) int32 sorted fragment-bin boundaries (global
                  #  concatenated coordinates); padding = P (out of range)
    bin2frag,     # (NB,) int32 fragment id per bin, -1 = not a fragment
    *,
    k: int,
    member_bits: int,
    prefilter_bits: int,
    gthresh: int,
    fthresh: int,
    max_frags: int,
    max_sel: int,
    frag_cap: int,
):
    P = packed.shape[0] * 4
    n = P - k + 1
    fsel, gsel, mbucket, frag = _hash_front(
        packed, inv_idx, length, bounds, bin2frag,
        k=k, gthresh=gthresh, fthresh=fthresh, member_bits=member_bits,
    )

    # Compact ALL selected hashes once (fsel ⊇ gsel since
    # genome_scale >= fragment_scale — asserted by the batch entry);
    # every later stage runs over SEL slots instead of n positions.
    # The payload carries the member bucket plus a gsel flag one bit
    # above it; out-of-fragment positions get frag=BIG so they feed the
    # genome-level bitmaps but never the per-fragment stream.
    BIG = jnp.int32(2**30)
    sel_pos = _fast_cumsum(fsel.astype(jnp.int32)) - 1
    n_sel = sel_pos[-1] + 1
    overflow = n_sel > max_sel
    scatter_to = jnp.where(fsel, sel_pos, max_sel)
    cfrag = jnp.full(max_sel, BIG, dtype=jnp.int32)
    cfrag = cfrag.at[scatter_to].set(
        jnp.where(frag >= 0, frag, BIG), mode="drop"
    )
    pay = mbucket | jnp.where(gsel, jnp.int32(member_bits), 0)
    cpay = jnp.full(max_sel, BIG, dtype=jnp.int32)
    cpay = cpay.at[scatter_to].set(pay, mode="drop")

    # Genome-level sets as bitmaps (scatter-max of ones, dedup free),
    # fed from the compacted stream: ~fragment_scale x fewer updates
    # than scattering all n positions.
    real = cpay < BIG
    cbucket = jnp.where(real, cpay & jnp.int32(member_bits - 1), BIG)
    mem_ind = jnp.zeros(member_bits, dtype=jnp.uint8)
    mem_ind = mem_ind.at[jnp.where(real, cbucket, member_bits)].max(
        jnp.uint8(1), mode="drop"
    )
    gflag = real & ((cpay & jnp.int32(member_bits)) != 0)
    pref_ind = jnp.zeros(prefilter_bits, dtype=jnp.uint8)
    pref_ind = pref_ind.at[
        jnp.where(gflag, cpay & jnp.int32(prefilter_bits - 1),
                  prefilter_bits)
    ].max(jnp.uint8(1), mode="drop")
    member_words = _pack_indicator_words(mem_ind)
    pref_words = _pack_indicator_words(pref_ind)
    member_pop = jnp.sum(mem_ind, dtype=jnp.int32)
    n_pref = jnp.sum(pref_ind, dtype=jnp.int32)

    # Per-fragment dedup (np.unique on frag * member_bits + bucket).
    #
    # Segmented path (default): positions ascend through the compacted
    # stream, so entries of one fragment are CONTIGUOUS — the global
    # sort only ever needed to order buckets within a fragment. Scatter
    # each entry to (fragment row, arrival rank) in a (max_frags,
    # frag_cap) grid and sort rows independently: log2(cap)^2 compare
    # passes instead of log2(max_sel)^2 (~3x fewer at MAG shapes), all
    # rows in parallel across sublanes. A fragment whose entry count
    # (duplicates included — e.g. a selected homopolymer k-mer repeated
    # across a low-complexity run) exceeds frag_cap sets seg_overflow;
    # the batch is re-dispatched on the global-sort path, bit-identical.
    if frag_cap > 0:
        in_frag = cfrag < BIG
        slot = jnp.arange(max_sel, dtype=jnp.int32)
        frag_idx = jnp.where(in_frag, cfrag, max_frags)
        start = jnp.full(max_frags, max_sel, dtype=jnp.int32)
        start = start.at[frag_idx].min(slot, mode="drop")
        per_frag = jnp.zeros(max_frags, dtype=jnp.int32)
        per_frag = per_frag.at[frag_idx].add(1, mode="drop")
        seg_overflow = jnp.max(per_frag) > frag_cap
        rank = slot - start[jnp.clip(frag_idx, 0, max_frags - 1)]
        dest = jnp.where(
            in_frag & (rank < frag_cap),
            jnp.clip(frag_idx, 0, max_frags - 1) * frag_cap + rank,
            max_frags * frag_cap,
        )
        grid = jnp.full(max_frags * frag_cap, BIG, dtype=jnp.int32)
        grid = grid.at[dest].set(cbucket, mode="drop")
        grid = jnp.sort(grid.reshape(max_frags, frag_cap), axis=1)
        prev = jnp.concatenate(
            [jnp.full((max_frags, 1), -1, jnp.int32), grid[:, :-1]],
            axis=1,
        )
        first = (grid < BIG) & (grid != prev)
        counts = jnp.sum(first, axis=1, dtype=jnp.int32)
        csum = jnp.cumsum(counts, dtype=jnp.int32)
        row_base = jnp.concatenate([jnp.zeros(1, jnp.int32), csum[:-1]])
        within = jnp.cumsum(first.astype(jnp.int32), axis=1) - 1
        out_pos = jnp.where(
            first, row_base[:, None] + within, max_sel
        )
        flat = jnp.zeros(max_sel, dtype=jnp.int32)
        flat = flat.at[out_pos.reshape(-1)].set(
            grid.reshape(-1), mode="drop"
        )
        n_unique = csum[-1]
        offsets = jnp.concatenate([jnp.zeros(1, jnp.int32), csum])
        overflow = overflow | (n_unique > max_sel)
    else:
        # Global sort: one combined uint32 key when it fits in 31 bits
        # (the padding key 0xFFFFFFFF stays distinct); two-key sort
        # otherwise (multi-Mb genomes).
        bucket_bits = member_bits.bit_length() - 1
        if max_frags * member_bits <= 2**31:
            KEY_PAD = jnp.uint32(0xFFFFFFFF)
            key = jnp.where(
                cfrag < BIG,
                (cfrag.astype(jnp.uint32) << _u32(bucket_bits))
                | cbucket.astype(jnp.uint32),
                KEY_PAD,
            )
            skey = jax.lax.sort(key)
            prev = jnp.concatenate(
                [jnp.array([KEY_PAD], jnp.uint32), skey[:-1]]
            )
            first = (skey != KEY_PAD) & (skey != prev)
            sfrag = (skey >> _u32(bucket_bits)).astype(jnp.int32)
            sbucket = (skey & _u32(member_bits - 1)).astype(jnp.int32)
        else:
            sort_frag = jnp.where(cfrag < BIG, cfrag, BIG)
            sort_bucket = jnp.where(cfrag < BIG, cbucket, BIG)
            sfrag, sbucket = jax.lax.sort(
                (sort_frag, sort_bucket), num_keys=2
            )
            prev_f = jnp.concatenate(
                [jnp.array([-1], jnp.int32), sfrag[:-1]]
            )
            prev_b = jnp.concatenate(
                [jnp.array([-1], jnp.int32), sbucket[:-1]]
            )
            first = (sfrag < BIG) & (
                (sfrag != prev_f) | (sbucket != prev_b)
            )
        seg_overflow = jnp.bool_(False)
        out_pos = _fast_cumsum(first.astype(jnp.int32)) - 1
        n_unique = out_pos[-1] + 1
        flat = jnp.zeros(max_sel, dtype=jnp.int32)
        flat = flat.at[jnp.where(first, out_pos, max_sel)].set(
            sbucket, mode="drop"
        )
        counts = jnp.zeros(max_frags, dtype=jnp.int32)
        counts = counts.at[jnp.where(first, sfrag, max_frags)].add(
            1, mode="drop"
        )
        offsets = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)]
        )
    return (
        pref_words, n_pref, member_words, member_pop,
        flat, offsets, n_unique, overflow, seg_overflow,
    )


def _fit_minor(x, size: int, pad):
    """Slice or pad the minor axis to exactly `size`."""
    n = x.shape[-1]
    if n >= size:
        return x[..., :size]
    return jnp.concatenate(
        [x, jnp.full(x.shape[:-1] + (size - n,), pad, dtype=x.dtype)],
        axis=-1,
    )


def _words_from_sorted(sv, first, bits: int):
    """Packed uint32 indicator words from a bucket-major sorted stream.

    sv: (S,) uint32 sorted values with 0xFFFFFFFF padding at the tail;
    first: unique-value mask. Scatter-free: compact the uniques, OR
    adjacent same-word bit values with 5 doubling passes (a word covers
    32 buckets, so runs are <= 32 long), keep the last entry of each
    word run, and monotone-expand (word, orred-bits) into the
    (bits//32,) word array. Returns ((bits//32,) uint32 words, count).
    """
    from galah_tpu.ops.routing import (
        monotone_compact_tiled as monotone_compact,
        monotone_expand_tiled as monotone_expand,
    )

    PADK = jnp.uint32(0xFFFFFFFF)
    (u,), m = monotone_compact(first, [sv], [PADK], cumsum_fn=_fast_cumsum)
    n_uniq = m
    word = (u >> jnp.uint32(5)).astype(jnp.int32)
    bitv = jnp.where(
        u != PADK, jnp.uint32(1) << (u & jnp.uint32(31)), jnp.uint32(0)
    )
    live = jnp.arange(u.shape[-1], dtype=jnp.int32) < m
    word = jnp.where(live, word, jnp.int32(2**30))
    acc = bitv
    for sh in (1, 2, 4, 8, 16):
        if sh >= u.shape[-1]:
            break
        nb = jnp.concatenate([jnp.zeros(sh, jnp.uint32), acc[:-sh]])
        nw = jnp.concatenate(
            [jnp.full(sh, -1, jnp.int32), word[:-sh]]
        )
        acc = jnp.where(nw == word, acc | nb, acc)
    nxt = jnp.concatenate([word[1:], jnp.full(1, 2**30, jnp.int32)])
    last = live & (nxt != word)
    (wval, wdest), n_words = monotone_compact(
        last, [acc, word], [jnp.uint32(0), 0], cumsum_fn=_fast_cumsum
    )
    out_words = bits // 32
    if wval.shape[-1] > out_words:
        # more stream slots than words exist; live words (<= out_words
        # by construction) sit compacted at the front
        wval = wval[:out_words]
        wdest = wdest[:out_words]
    words = monotone_expand(wval, wdest, n_words, out_words, jnp.uint32(0))
    return words, n_uniq


def _sketch_sort_scan() -> bool:
    """Whether the routed kernel's bitonic sorts compile as fori_loops
    (ops/routing.py::bitonic_sort_scan) instead of unrolled networks —
    bit-identical results. Off unless GALAH_TPU_SKETCH_SORT=scan (the
    routed kernel itself is off by default, see _default_routed)."""
    import os

    return os.environ.get("GALAH_TPU_SKETCH_SORT") == "scan"


def _sketch_one_routed(
    packed, inv_idx, length, bounds, bin2frag, *,
    k: int,
    member_bits: int,
    prefilter_bits: int,
    gthresh: int,
    fthresh: int,
    max_frags: int,
    max_sel: int,
    max_psel: int,
    sort_scan: bool = False,
):
    """Scatter-free formulation of _sketch_one (bit-identical outputs).

    Every scatter and sort (stream compaction, bitmap scatters, dedup
    sort) is replaced with monotone routings and hand-rolled bitonic
    networks (ops/routing.py) that lower to shift+select passes; on
    the GPU this formulation loses to _sketch_one (PERF.md):

    - stream compaction: log2(n) monotone-compact passes;
    - per-fragment dedup: one bitonic sort of the combined
      (frag << bucket_bits | bucket) key (two-key network when it
      exceeds 31 bits), first-occurrence mask, monotone re-compaction;
    - fragment offsets: frag-start positions monotone-expanded into
      the (F,) table + a reverse running-min fill (no scatter-add
      histogram);
    - both bitmaps: bucket-major bitonic sort, unique mask, adjacent
      same-word OR-merge (5 doubling passes), monotone expansion into
      packed words (never materializing uint8 indicators).
    """
    from galah_tpu.ops.routing import (
        bitonic_sort_scan,
        bitonic_sort_tiled,
        monotone_compact_tiled as monotone_compact,
        monotone_expand_tiled as monotone_expand,
    )

    bitonic_sort = bitonic_sort_scan if sort_scan else bitonic_sort_tiled

    P = packed.shape[0] * 4
    n = P - k + 1
    fsel, gsel, mbucket, frag = _hash_front(
        packed, inv_idx, length, bounds, bin2frag,
        k=k, gthresh=gthresh, fthresh=fthresh, member_bits=member_bits,
    )

    BIG = jnp.int32(2**30)
    pay = mbucket | jnp.where(gsel, jnp.int32(member_bits), 0)
    frag_m = jnp.where(frag >= 0, frag, BIG)
    # pad the position axis to P (a power of two) so the compaction's
    # shift passes stay lane-aligned
    fsel = _fit_minor(fsel, P, False)
    frag_m = _fit_minor(frag_m, P, BIG)
    pay = _fit_minor(pay, P, BIG)
    (cfrag, cpay), n_sel = monotone_compact(
        fsel, [frag_m, pay], [BIG, BIG], cumsum_fn=_fast_cumsum
    )
    overflow = n_sel > max_sel
    cfrag = _fit_minor(cfrag, max_sel, BIG)
    cpay = _fit_minor(cpay, max_sel, BIG)

    real = cpay < BIG
    cbucket = jnp.where(real, cpay & jnp.int32(member_bits - 1), BIG)

    # Member bitmap: bucket-major sort over ALL selected hashes.
    PADK = jnp.uint32(0xFFFFFFFF)
    bkey = jnp.where(real, cbucket.astype(jnp.uint32), PADK)
    (sb,) = bitonic_sort([bkey])
    prevb = jnp.concatenate([jnp.array([PADK]), sb[:-1]])
    first_b = (sb != PADK) & (sb != prevb)
    member_words, member_pop = _words_from_sorted(sb, first_b, member_bits)

    # Prefilter bitmap: gsel subset (gsel ⊆ fsel), masked to
    # prefilter_bits — a much smaller stream, own capacity.
    gflag = real & ((cpay & jnp.int32(member_bits)) != 0)
    prefb = jnp.where(
        gflag, (cpay & jnp.int32(prefilter_bits - 1)).astype(jnp.uint32),
        PADK,
    )
    (cpref,), n_pref_stream = monotone_compact(
        gflag, [prefb], [PADK], cumsum_fn=_fast_cumsum
    )
    overflow = overflow | (n_pref_stream > max_psel)
    cpref = _fit_minor(cpref, max_psel, PADK)
    (sp,) = bitonic_sort([cpref])
    prevp = jnp.concatenate([jnp.array([PADK]), sp[:-1]])
    first_p = (sp != PADK) & (sp != prevp)
    pref_words, n_pref = _words_from_sorted(sp, first_p, prefilter_bits)

    # Per-fragment dedup: one sort by (frag, bucket).
    bucket_bits = member_bits.bit_length() - 1
    in_frag = cfrag < BIG
    if max_frags * member_bits <= 2**31:
        key = jnp.where(
            in_frag,
            (cfrag.astype(jnp.uint32) << _u32(bucket_bits))
            | jnp.where(in_frag, cbucket, 0).astype(jnp.uint32),
            PADK,
        )
        (skey,) = bitonic_sort([key])
        prev = jnp.concatenate([jnp.array([PADK]), skey[:-1]])
        first = (skey != PADK) & (skey != prev)
        sfrag = (skey >> _u32(bucket_bits)).astype(jnp.int32)
        sbucket = (skey & _u32(member_bits - 1)).astype(jnp.int32)
    else:
        sort_frag = jnp.where(in_frag, cfrag, BIG)
        sort_bucket = jnp.where(in_frag, cbucket, BIG)
        sfrag, sbucket = bitonic_sort([sort_frag, sort_bucket], n_keys=2)
        prev_f = jnp.concatenate([jnp.array([-1], jnp.int32), sfrag[:-1]])
        prev_b = jnp.concatenate([jnp.array([-1], jnp.int32), sbucket[:-1]])
        first = (sfrag < BIG) & ((sfrag != prev_f) | (sbucket != prev_b))

    (flat, ffrag), n_unique = monotone_compact(
        first, [sbucket, sfrag], [0, max_frags], cumsum_fn=_fast_cumsum
    )

    # Offsets without a histogram: positions where the (compacted,
    # dedup'd) stream enters a new fragment, expanded to the fragment
    # table and back-filled with a reverse running min (empty fragments
    # inherit the next fragment's start; the tail reads n_unique).
    iota_sel = jnp.arange(max_sel, dtype=jnp.int32)
    live_u = iota_sel < n_unique
    prev_ff = jnp.concatenate([jnp.array([-1], jnp.int32), ffrag[:-1]])
    is_start = live_u & (ffrag != prev_ff)
    (startpos, startfrag), n_starts = monotone_compact(
        is_start, [iota_sel, jnp.clip(ffrag, 0, max_frags - 1)],
        [0, max_frags - 1], cumsum_fn=_fast_cumsum,
    )
    fit = min(max_sel, max_frags)
    exp = monotone_expand(
        startpos[:fit] if max_sel > max_frags else startpos,
        startfrag[:fit] if max_sel > max_frags else startfrag,
        jnp.minimum(n_starts, fit),
        max_frags,
        BIG,
    )
    exp = jnp.where(exp == BIG, n_unique, exp)
    starts = jax.lax.cummin(exp[::-1])[::-1]
    offsets = jnp.concatenate([starts, n_unique[None]])

    return (
        pref_words, n_pref, member_words, member_pop,
        flat, offsets, n_unique, overflow, jnp.bool_(False),
    )


@partial(
    jax.jit,
    static_argnames=(
        "k", "member_bits", "prefilter_bits", "gthresh", "fthresh",
        "max_frags", "max_sel", "frag_cap", "routed", "max_psel",
        "sort_scan",
    ),
)
def _sketch_batch_kernel(
    packed, inv_idx, lengths, bounds, bin2frag, *,
    k, member_bits, prefilter_bits, gthresh, fthresh, max_frags, max_sel,
    frag_cap=0, routed=False, max_psel=0, sort_scan=False,
):
    if routed:
        return jax.vmap(
            lambda c, iv, ln, b, m: _sketch_one_routed(
                c, iv, ln, b, m,
                k=k, member_bits=member_bits,
                prefilter_bits=prefilter_bits,
                gthresh=gthresh, fthresh=fthresh,
                max_frags=max_frags, max_sel=max_sel,
                max_psel=max_psel or max_sel,
                sort_scan=sort_scan,
            )
        )(packed, inv_idx, lengths, bounds, bin2frag)
    return jax.vmap(
        lambda c, iv, ln, b, m: _sketch_one(
            c, iv, ln, b, m,
            k=k, member_bits=member_bits, prefilter_bits=prefilter_bits,
            gthresh=gthresh, fthresh=fthresh,
            max_frags=max_frags, max_sel=max_sel, frag_cap=frag_cap,
        )
    )(packed, inv_idx, lengths, bounds, bin2frag)


def _frag_capacity(params: NativeSketchParams) -> int:
    """Row width for the segmented dedup grid: twice the expected
    selected count per fragment (fragment_length / fragment_scale),
    rounded to a lane multiple. Fragments past this (pathological
    low-complexity repeats) trigger the global-sort re-dispatch."""
    mean = max(1, params.fragment_length // max(1, params.fragment_scale))
    return ((2 * mean + 127) // 128) * 128


def _default_frag_cap(params: NativeSketchParams) -> int:
    """Dedup strategy default: the combined-key global sort, everywhere
    (the CPU's comparison sort prefers it ~1.3x over the segmented row
    sorts; the GPU comparison is not measured yet —
    benchmarks/device_sketch_profile.py times both).
    GALAH_TPU_SKETCH_DEDUP=segmented|sort overrides."""
    mode = os.environ.get("GALAH_TPU_SKETCH_DEDUP")
    if mode == "segmented":
        return _frag_capacity(params)
    return 0


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def _default_routed() -> bool:
    """Kernel-formulation default: the XLA sort/scatter kernel on the
    CPU and on the GPU, where the scatter-free routed kernel (bitonic
    networks + monotone routing, ops/routing.py) lost on an H100: 7.0x
    slower at the MAG batch (8 x 3 Mb) and 6.7x at the contig batch
    (4,096 x 5 kb), and 12x longer to compile (PERF.md, "Bring-up on
    the H100"). GALAH_TPU_SKETCH_KERNEL=routed selects the routed
    kernel."""
    return os.environ.get("GALAH_TPU_SKETCH_KERNEL") == "routed"


@dataclass
class _GenomePlan:
    """Host-side prep for one genome: concatenated codes + fragment
    bins in concatenated coordinates."""

    codes: np.ndarray       # (L,) uint8
    bounds: np.ndarray      # (nb,) int32
    bin2frag: np.ndarray    # (nb,) int32
    n_frags: int
    total_len: int


def _plan_genome(seqs: Sequence[bytes], params: NativeSketchParams) -> _GenomePlan:
    parts: List[np.ndarray] = []
    bounds: List[int] = [0]
    bin2frag: List[int] = []
    off = 0
    fid = 0
    total = 0
    for idx, seq in enumerate(seqs):
        if idx > 0:
            parts.append(np.full(1, 255, dtype=np.uint8))
            off += 1
        parts.append(encode_bases(seq))
        total += len(seq)
        cb = _fragment_boundaries(len(seq), params)
        nfrag = max(0, len(cb) - 1)
        for f in range(nfrag):
            start = off + int(cb[f])
            end = off + int(cb[f + 1])
            if start > bounds[-1]:
                bin2frag.append(-1)
                bounds.append(start)
            bin2frag.append(fid)
            bounds.append(end)
            fid += 1
        off += len(seq)
    if off > bounds[-1]:
        bin2frag.append(-1)
        bounds.append(off)
    codes = (
        np.concatenate(parts) if parts else np.empty(0, dtype=np.uint8)
    )
    return _GenomePlan(
        codes=codes,
        bounds=np.asarray(bounds, dtype=np.int32),
        bin2frag=np.asarray(bin2frag, dtype=np.int32),
        n_frags=fid,
        total_len=total,
    )


class DeviceSketchOverflow(Exception):
    """Selected-hash count exceeded the batch's capacity (pathological
    repeat content); the caller should fall back to host sketching."""


def _sel_capacity(n_positions: int, params: NativeSketchParams) -> int:
    """Padded capacity for fragment-selected hashes: mean n/scale plus
    margin (binomial tail is tiny; the margin mostly covers repeat-rich
    sequence where every copy of a selected k-mer counts). 1.5x keeps
    the routed kernel's bitonic sorts one power of two smaller than the
    old 2.0x margin at the common shapes — the sorts are the kernel's
    dominant cost — while overflow (pathological repeat loads > 50%
    above mean) still falls back to the bit-identical host sketcher."""
    mean = n_positions / max(1, params.fragment_scale)
    return _next_pow2(int(1.5 * mean) + 1024)


def _psel_capacity(n_positions: int, params: NativeSketchParams) -> int:
    """Capacity of the routed kernel's genome-level (gsel) stream: a
    2x-mean margin at genome_scale (roomier than _sel_capacity's 1.5x —
    the gsel stream is ~genome_scale/fragment_scale times smaller, so
    its sort cost is negligible and the fatter margin is free)."""
    mean = n_positions / max(1, params.genome_scale)
    return min(
        _next_pow2(int(2.0 * mean) + 1024),
        _sel_capacity(n_positions, params),
    )


def device_sketch_batch(
    names: Sequence[str],
    seq_lists: Sequence[Sequence[bytes]],
    params: NativeSketchParams,
    *,
    return_device: bool = False,
):
    """Sketch a batch of genomes on device, bit-identical to
    sketch_sequences_native.

    names/seq_lists: per genome, its name and contig sequences.
    Returns List[NativeSketch] (host arrays) when return_device is
    False; otherwise (sketches, device_arrays) where device_arrays
    holds the on-device products for zero-copy downstream use:
    {pref_words, n_pref, member_words, member_pop, flat, offsets,
    n_unique} each batched over genomes.

    Raises DeviceSketchOverflow if a genome's selected-hash stream
    exceeds capacity (extreme repeat content) — callers fall back to
    the host path for that batch.
    """
    assert params.k <= 15, "device sketch packs k-mers in 30 bits"
    assert params.member_bits <= 1 << 28, (
        "device sketch packs bucket + gsel flag below the int32 pad"
    )
    assert params.prefilter_bits <= params.member_bits, (
        "device sketch derives prefilter buckets by masking member buckets"
    )
    assert params.genome_threshold <= params.fragment_threshold, (
        "device sketch compacts gsel as a subset of fsel "
        "(genome_scale must be >= fragment_scale)"
    )
    plans, kernel_args, kernel_kw = _prepare_batch(seq_lists, params)
    SEL = kernel_kw["max_sel"]
    if _default_routed():
        out = _sketch_batch_kernel(
            *kernel_args, routed=True,
            max_psel=kernel_kw.pop("max_psel"),
            sort_scan=_sketch_sort_scan(),
            **kernel_kw,
        )
    else:
        kernel_kw.pop("max_psel")
        out = _sketch_batch_kernel(
            *kernel_args, frag_cap=_default_frag_cap(params), **kernel_kw
        )
    if bool(np.any(np.asarray(out[8]))):
        # A fragment's (duplicate-inclusive) entry count blew past the
        # segmented grid's row width — pathological low-complexity
        # repeats. Re-dispatch on the global-sort path (bit-identical).
        logger.info(
            "segmented dedup overflow; re-dispatching on the "
            "global-sort path"
        )
        out = _sketch_batch_kernel(*kernel_args, frag_cap=0, **kernel_kw)
    return _finish_batch(names, plans, out, SEL, params, return_device)


def _prepare_batch(seq_lists, params: NativeSketchParams):
    """Host prep for one device-sketch dispatch: per-genome plans, the
    kernel's device operands and its static arguments (max_psel is
    used by the routed formulation only)."""
    plans = [_plan_genome(s, params) for s in seq_lists]
    G = len(plans)
    max_len = max((p.codes.shape[0] for p in plans), default=1)
    P = _next_pow2(max(max_len, params.k, 4))
    NB = _next_pow2(max(max(p.bounds.shape[0] for p in plans), 2))
    F = _next_pow2(max(max(p.n_frags for p in plans), 1))
    SEL = _sel_capacity(P - params.k + 1, params)

    codes = np.full((G, P), 255, dtype=np.uint8)
    bounds = np.full((G, NB), P, dtype=np.int32)
    bin2frag = np.full((G, NB), -1, dtype=np.int32)
    lengths = np.zeros(G, dtype=np.int32)
    inv_lists: List[np.ndarray] = []
    for i, p in enumerate(plans):
        L = p.codes.shape[0]
        codes[i, :L] = p.codes
        bounds[i, : p.bounds.shape[0]] = p.bounds
        bin2frag[i, : p.bin2frag.shape[0]] = p.bin2frag
        lengths[i] = L
        inv_lists.append(np.nonzero(p.codes >= 4)[0].astype(np.int32))

    # 2-bit pack: 0.25 bytes/base over the wire; non-ACGT positions go
    # as a sparse index list (padding tail is masked by `lengths`).
    c2 = np.where(codes < 4, codes, 0).astype(np.uint8)
    packed = (
        c2[:, 0::4]
        | (c2[:, 1::4] << 2)
        | (c2[:, 2::4] << 4)
        | (c2[:, 3::4] << 6)
    )
    NI = _next_pow2(max(max(v.shape[0] for v in inv_lists), 1))
    inv_idx = np.full((G, NI), P, dtype=np.int32)
    for i, v in enumerate(inv_lists):
        inv_idx[i, : v.shape[0]] = v

    kernel_args = (
        jnp.asarray(packed), jnp.asarray(inv_idx), jnp.asarray(lengths),
        jnp.asarray(bounds), jnp.asarray(bin2frag),
    )
    kernel_kw = dict(
        k=params.k,
        member_bits=params.member_bits,
        prefilter_bits=params.prefilter_bits,
        gthresh=int(params.genome_threshold),
        fthresh=int(params.fragment_threshold),
        max_frags=F,
        max_sel=SEL,
        max_psel=_psel_capacity(P - params.k + 1, params),
    )
    return plans, kernel_args, kernel_kw


def _finish_batch(names, plans, out, SEL, params, return_device):
    """Overflow check, count fetch and host sketch objects for one
    dispatched batch (see device_sketch_batch)."""
    (pref_words, n_pref, member_words, member_pop,
     flat, offsets, n_unique, overflow, _) = out
    if bool(np.any(np.asarray(overflow))):
        raise DeviceSketchOverflow(
            f"selected-hash stream exceeded capacity {SEL}"
        )

    offsets_h = np.asarray(offsets)
    counts = np.asarray(_counts_concat(member_pop, n_pref, n_unique))
    mp_h, npref_h, n_unique_h = counts[0], counts[1], counts[2]
    if _host_copies_mode() == "lazy":
        # Adopted pipelines never read the host copies (screen consumes
        # device-born rows; verify reads the pool/arena): defer the
        # product fetch entirely. Any content access materializes the
        # WHOLE chunk once (the counts above keep len()/popcount free).
        chunk = _LazyChunk(
            member_words, pref_words, flat, counts, params
        )
        _register_lazy_chunk(chunk)

        def _member(i):
            return LazyBuckets(chunk, i, 2, int(mp_h[i]))

        def _pref(i):
            return LazyBuckets(chunk, i, 0, int(npref_h[i]))

        def _flat(i, nu):
            return LazyBuckets(chunk, i, 1, nu)
    else:
        per = _fetch_product_arrays(
            member_words, pref_words, flat, counts, params
        )

        def _member(i):
            return per[i][2]

        def _pref(i):
            return per[i][0]

        def _flat(i, nu):
            return per[i][1]

    sketches: List[NativeSketch] = []
    for i, p in enumerate(plans):
        nf = p.n_frags
        nu = int(n_unique_h[i])
        sketches.append(
            NativeSketch(
                name=names[i],
                total_len=p.total_len,
                prefilter_buckets=_pref(i),
                frag_buckets=_flat(i, nu),
                frag_offsets=offsets_h[i, : nf + 1].astype(np.int64),
                member_buckets=_member(i),
                params=params,
            )
        )
    if return_device:
        dev = {
            "pref_words": pref_words,
            "n_pref": n_pref,
            "member_words": member_words,
            "member_pop": member_pop,
            "flat": flat,
            "offsets": offsets,
            "n_unique": n_unique,
        }
        return sketches, dev
    return sketches


def _batch_genome_cap(P: int, params: NativeSketchParams) -> int:
    """Max genomes/contigs per kernel dispatch so the batch's fixed
    per-genome device buffers (bitmap indicators + packed words, padded
    sequence intermediates, SEL-sized compaction/sort arrays) stay
    inside the device budget. Without this, many-short-contig batches
    sized only by sequence bytes would OOM: at P=8k and default
    member_bits=2^22 the bitmaps alone are ~4.7MB per contig."""
    from galah_tpu.ops.prefilter import _device_resident_budget

    sel = _sel_capacity(P - params.k + 1, params)
    per_genome = (
        # uint8 indicators + packed words for both bitmaps
        (params.member_bits + params.prefilter_bits) * 9 // 8
        # sequence-length intermediates (codes, hash lanes, frag ids,
        # prefix sums; XLA fuses some — this is a deliberate overcount)
        + 40 * P
        # compaction/sort/output arrays over SEL slots
        + 32 * sel
    )
    return max(1, _device_resident_budget() // max(per_genome, 1))



def _run_chunks(n_chunks: int, read_chunk, process_on_device) -> None:
    """Process chunks front to back on the calling thread while a
    reader thread prefetches the next chunk's FASTA (reading rivals
    hashing on production hosts). Exceptions from either side
    propagate to the caller."""
    from concurrent.futures import ThreadPoolExecutor

    if n_chunks == 0:
        return
    with ThreadPoolExecutor(max_workers=1) as reader:
        fut = reader.submit(read_chunk, 0)
        for ci in range(n_chunks):
            data = fut.result()
            if ci + 1 < n_chunks:
                fut = reader.submit(read_chunk, ci + 1)
            process_on_device(ci, data)


def _count_host_fallback(n_units: int) -> None:
    """Metrics counter for units sketched on the host after a
    DeviceSketchOverflow (bit-identical; a capacity rule)."""
    from galah_tpu.utils import metrics

    metrics.current().count("sketch_host_fallback_units", n_units)


def device_sketch_contig_files(
    paths: Sequence[str],
    params: NativeSketchParams,
    *,
    max_batch_bytes: int = 256 << 20,
    sink=None,
) -> List[List[NativeSketch]]:
    """One sketch per contig, per file, in file order — the device
    analog of sketch_contigs_native for --cluster-contigs (reference
    runs `skani triangle -i`, src/skani.rs:379-498; contig names follow
    the tab-split rule via FastaRecord.contig_name).

    Contigs are bucketed by padded length ACROSS the whole corpus so
    one compiled program serves each bucket regardless of how contigs
    spread over files; host memory stays O(batch) (pass 1 records only
    lengths, pass 2 re-reads each touched file per batch, stopping at
    the last wanted record). Batches are capped by both sequence bytes
    and the per-contig fixed device buffers (_batch_genome_cap).
    Overflowing batches fall back to the host sketcher (bit-identical
    either way)."""
    from galah_tpu.io.fasta import read_fasta
    from galah_tpu.sketch.fracminhash import sketch_sequences_native

    # Pass 1 — contig lengths only.
    buckets: dict = {}
    n_contigs: List[int] = []
    for pi, path in enumerate(paths):
        nc = 0
        for rec in read_fasta(path):
            P = _next_pow2(max(len(rec.seq), params.k, 4))
            buckets.setdefault(P, []).append((pi, nc))
            nc += 1
        n_contigs.append(nc)
    out: List[List[Optional[NativeSketch]]] = [
        [None] * nc for nc in n_contigs
    ]

    # Pass 2 — dispatch per bucket chunk; entries within a bucket are
    # in (file, contig) order, so each chunk touches a contiguous run
    # of files and each (chunk, file) pair is read once.
    chunk_descs: List[List[Tuple[int, int]]] = []
    for P, items in sorted(buckets.items()):
        per = max(
            1,
            min(max_batch_bytes // max(P, 1), _batch_genome_cap(P, params)),
        )
        for start in range(0, len(items), per):
            chunk_descs.append(items[start : start + per])

    import threading

    # Forward read cursors: within a length bucket, chunks visit a
    # file's contigs in ascending order, so a persistent per-file
    # iterator turns the old start-from-record-0 re-parse (O(chunks x
    # file) — ~20 full passes over a 100k-contig FASTA) into one
    # sequential pass per bucket run. A request BEHIND the cursor (the
    # next bucket) restarts that file's iterator — correct either way,
    # the cursor is purely a fast path. Each live iterator pins an
    # open file descriptor, so the cache is LRU-bounded (a
    # thousand-file contig corpus must not exhaust ulimit), and a
    # cursor whose read raised is dropped so a retry re-reads the
    # file from scratch instead of resuming a closed generator.
    from collections import OrderedDict

    read_cursors: "OrderedDict" = OrderedDict()
    cursor_lock = threading.Lock()
    MAX_CURSORS = 64

    def read_chunk(ci):
        chunk = chunk_descs[ci]
        wanted: dict = {}
        for pi, cj in chunk:
            wanted.setdefault(pi, set()).add(cj)
        recs: dict = {}
        with cursor_lock:
            for pi, want in wanted.items():
                last = max(want)
                it, nxt = read_cursors.pop(pi, (None, 0))
                if it is None or min(want) < nxt:
                    if it is not None:
                        it.close()
                    it, nxt = iter(read_fasta(paths[pi])), 0
                got = {}
                try:
                    while nxt <= last:
                        rec = next(it)
                        if nxt in want:
                            got[nxt] = (rec.contig_name, rec.seq)
                        nxt += 1
                except BaseException:
                    it.close()  # dead cursor: retries restart the file
                    raise
                read_cursors[pi] = (it, nxt)
                while len(read_cursors) > MAX_CURSORS:
                    _, (old_it, _n) = read_cursors.popitem(last=False)
                    old_it.close()
                recs[pi] = got
        cnames = [recs[pi][cj][0] for pi, cj in chunk]
        clists = [[recs[pi][cj][1]] for pi, cj in chunk]
        return cnames, clists

    def process_on_device(ci, data):
        cnames, clists = data
        chunk = chunk_descs[ci]
        try:
            if sink is not None:
                got_sk, dev = device_sketch_batch(
                    cnames, clists, params, return_device=True
                )
                sink(cnames, got_sk, dev)
            else:
                got_sk = device_sketch_batch(cnames, clists, params)
        except DeviceSketchOverflow:
            logger.warning(
                "device sketch overflow for a %d-contig batch; "
                "falling back to host sketching",
                len(chunk),
            )
            _count_host_fallback(len(chunk))
            got_sk = [
                sketch_sequences_native(n, s, params)
                for n, s in zip(cnames, clists)
            ]
        for (pi, cj), sk in zip(chunk, got_sk):
            out[pi][cj] = sk

    _run_chunks(len(chunk_descs), read_chunk, process_on_device)
    assert all(sk is not None for row in out for sk in row)
    return out  # type: ignore[return-value]


def _words_to_buckets(words: np.ndarray) -> np.ndarray:
    """(W,) uint32 packed words -> sorted int32 bucket indices."""
    bits = np.unpackbits(
        words.view(np.uint8), bitorder="little"
    )
    return np.nonzero(bits)[0].astype(np.int32)


# --- narrow sketch-product transport -------------------------------
# The host copies of a batch's sketch products (member/prefilter word
# bitmaps + the int32 flat stream) can dominate the sketch phase's
# device->host traffic: a 100k x 3kb-contig run fetches ~18KB/contig
# (~1.8GB) while the information content is a few KB of bucket
# indices. When profitable, a post-pass converts the word bitmaps to
# ascending bucket LISTS on device (the host-side _words_to_buckets,
# computed where the data already is) and narrows every list to 2 or 3
# bytes per entry; the whole chunk then fetches as ONE uint8 buffer.
# GALAH_TPU_SKETCH_TRANSPORT=words|lists overrides the default (words
# on CPU where fetches are free; the GPU's choice is measured end to
# end in PERF.md).


def _transport_mode() -> str:
    mode = os.environ.get("GALAH_TPU_SKETCH_TRANSPORT")
    if mode in ("words", "lists"):
        return mode
    from galah_tpu.utils.platform import backend_default

    return backend_default(cpu="words", gpu="lists")


def _batched_fast_cumsum(x: jax.Array) -> jax.Array:
    """Minor-axis inclusive prefix sum for (..., N) int32 via the
    (rows, 8192) hierarchical scan (see ops/pair_table._fast_cumsum)."""
    n = x.shape[-1]
    cols = 8192
    if n <= cols or n % cols:
        return jnp.cumsum(x, axis=-1)
    x3 = x.reshape(*x.shape[:-1], n // cols, cols)
    c = jnp.cumsum(x3, axis=-1)
    offs = jnp.cumsum(c[..., -1], axis=-1)
    offs = jnp.concatenate(
        [jnp.zeros_like(offs[..., :1]), offs[..., :-1]], axis=-1
    )
    return (c + offs[..., None]).reshape(x.shape)


def _bits_to_lists(words: jax.Array, cap: int, row_group: int) -> jax.Array:
    """(G, W) uint32 word bitmaps -> (G, cap) int32 ascending set-bit
    indices (bucket = 32*word + lsb-first bit, matching
    _words_to_buckets); slots past the row's popcount hold 0. Rows are
    processed in groups of `row_group` under lax.map so the unpacked
    (row_group, bits) indicator stays bounded."""
    from galah_tpu.ops.routing import monotone_compact_tiled

    g, w = words.shape
    bits = w * 32
    ng = -(-g // row_group)
    pad = ng * row_group - g
    if pad:
        words = jnp.concatenate(
            [words, jnp.zeros((pad, w), words.dtype)]
        )

    def one(wg):
        shifts = jnp.arange(32, dtype=jnp.uint32)
        ind = (wg[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
        ind = ind.reshape(row_group, bits).astype(jnp.bool_)
        iota = jax.lax.broadcasted_iota(
            jnp.int32, (row_group, bits), 1
        )
        (routed,), _ = monotone_compact_tiled(
            ind, [iota], [0], cumsum_fn=_batched_fast_cumsum
        )
        return jax.lax.slice_in_dim(routed, 0, min(cap, bits), axis=1)

    out = jax.lax.map(one, words.reshape(ng, row_group, w))
    out = out.reshape(ng * row_group, -1)[:g]
    if cap > bits:
        out = jnp.pad(out, ((0, 0), (0, cap - bits)))
    return out


def _entry_bytes(nbits: int) -> int:
    return 2 if nbits <= 16 else (3 if nbits <= 24 else 4)


def _narrow_dev(x: jax.Array, nbits: int) -> jax.Array:
    """(G, N) int32 values < 2^nbits -> (G, per*N) uint8 little-endian
    transport bytes (per = 2/3/4)."""
    g, n = x.shape
    per = _entry_bytes(nbits)
    bs = [((x >> (8 * i)) & 0xFF).astype(jnp.uint8) for i in range(per)]
    return jnp.stack(bs, axis=-1).reshape(g, per * n)


def _decode_narrow(row: np.ndarray, nbits: int, count: int) -> np.ndarray:
    """Invert _narrow_dev for one row slice; returns (count,) int32."""
    per = _entry_bytes(nbits)
    b = row.reshape(-1, per)[:count].astype(np.int32)
    v = b[:, 0]
    for i in range(1, per):
        v = v | (b[:, i] << (8 * i))
    return v.astype(np.int32)


@partial(
    jax.jit,
    static_argnames=(
        "cap", "pcap", "use_m", "use_p", "mrow", "prow",
        "mbits", "pbits", "fbits",
    ),
)
def _sketch_transport_kernel(
    member_words, pref_words, flat, *,
    cap: int, pcap: int, use_m: bool, use_p: bool, mrow: int, prow: int,
    mbits: int, pbits: int, fbits: int,
):
    """One uint8 transport buffer per chunk:
    [member lists | prefilter lists | flat stream], each narrowed to
    its entry width; member/pref appear only when their list form is
    smaller than the word bitmap (use_m/use_p). The prefilter list has
    its OWN pow2 cap (pcap): gsel counts run ~5x below fsel counts
    (genome_scale >= fragment_scale), so sharing the member cap padded
    the sparse pref list past its word-bitmap size and pushed it back
    to the words transport."""
    g = flat.shape[0]
    parts = []
    if use_m:
        parts.append(
            _narrow_dev(_bits_to_lists(member_words, cap, mrow), mbits)
        )
    if use_p:
        parts.append(
            _narrow_dev(_bits_to_lists(pref_words, pcap, prow), pbits)
        )
    fl = jax.lax.slice_in_dim(flat, 0, min(cap, flat.shape[1]), axis=1)
    if cap > flat.shape[1]:
        fl = jnp.pad(fl, ((0, 0), (0, cap - flat.shape[1])))
    parts.append(_narrow_dev(fl, fbits))
    return jnp.concatenate(parts, axis=1)


@jax.jit
def _counts_concat(member_pop, n_pref, n_unique):
    """(3, G) int32 — one small fetch for every per-genome count."""
    return jnp.stack([
        member_pop.astype(jnp.int32),
        n_pref.astype(jnp.int32),
        n_unique.astype(jnp.int32),
    ])


def _fetch_product_arrays(member_words, pref_words, flat, counts, params):
    """Fetch + decode one chunk's sketch products into per-genome
    (prefilter_buckets, frag_buckets, member_buckets) host arrays,
    using the narrow lists transport when smaller (see
    _transport_mode; word-bitmap fetch otherwise, per bitmap)."""
    g = flat.shape[0]
    mp_h, npref_h, n_unique_h = counts[0], counts[1], counts[2]
    mbits_n = int(params.member_bits - 1).bit_length()
    pbits_n = int(params.prefilter_bits - 1).bit_length()
    wm, wp = member_words.shape[1], pref_words.shape[1]
    if _transport_mode() == "lists":
        cap = _next_pow2(max(int(mp_h.max()), int(n_unique_h.max()), 8))
        pcap = _next_pow2(max(int(npref_h.max()), 8))
        use_m = _entry_bytes(mbits_n) * cap < wm * 4
        use_p = _entry_bytes(pbits_n) * pcap < wp * 4
    else:
        cap = pcap = 8
        use_m = use_p = False
    if use_m or use_p:
        buf = np.asarray(_sketch_transport_kernel(
            member_words, pref_words, flat,
            cap=cap, pcap=pcap, use_m=use_m, use_p=use_p,
            mrow=max(1, min(g, (1 << 26) // (wm * 32))),
            prow=max(1, min(g, (1 << 26) // (wp * 32))),
            mbits=mbits_n, pbits=pbits_n, fbits=mbits_n,
        ))
        off_p = _entry_bytes(mbits_n) * cap if use_m else 0
        off_f = off_p + (_entry_bytes(pbits_n) * pcap if use_p else 0)
        flat_h = None
    else:
        off_p = off_f = 0
        buf = None
        flat_h = np.asarray(flat)
    member_words_h = None if use_m else np.asarray(member_words)
    pref_words_h = None if use_p else np.asarray(pref_words)

    out = []
    for i in range(g):
        if use_p:
            pb = _decode_narrow(buf[i, off_p:off_f], pbits_n,
                                int(npref_h[i]))
        else:
            pb = _words_to_buckets(pref_words_h[i])
        nu = int(n_unique_h[i])
        if buf is not None:
            fb = _decode_narrow(buf[i, off_f:], mbits_n, nu)
        else:
            fb = flat_h[i, :nu].copy()
        if use_m:
            mb = _decode_narrow(buf[i, :off_p], mbits_n, int(mp_h[i]))
        else:
            mb = _words_to_buckets(member_words_h[i])
        out.append((pb, fb, mb))
    return out


# --- lazy host copies ------------------------------------------------
# In the adopted device-resident pipeline nothing reads a sketch's
# host arrays: the screen consumes device-born prefilter rows and the
# verify stage reads the bitmap pool / stream arena. Lazy mode defers
# each chunk's product fetch until some consumer actually touches
# array CONTENT (store persistence, multi-process exchange, host
# fallbacks); lengths/popcounts stay free via the eager counts fetch.
# Pinned device products are bounded: past LAZY_PIN_SHARE of the device
# memory limit the oldest pending chunk is materialized and released.
# The registry holds chunks weakly (oldest first): a chunk whose
# sketches are all gone releases its device buffers with them, so a
# finished run leaves nothing pinned on the device.

LAZY_PIN_SHARE = 1 / 8
import itertools as _itertools
import threading as _threading
import weakref as _weakref

_LAZY_PENDING: "_weakref.WeakValueDictionary" = _weakref.WeakValueDictionary()
_LAZY_SEQ = _itertools.count()

_LAZY_LOCK = _threading.Lock()


def _host_copies_mode() -> str:
    """eager on the CPU; on the GPU the end-to-end A/B in PERF.md
    decides. GALAH_TPU_SKETCH_HOST_COPIES=eager|lazy overrides."""
    mode = os.environ.get("GALAH_TPU_SKETCH_HOST_COPIES")
    if mode in ("eager", "lazy"):
        return mode
    from galah_tpu.utils.platform import backend_default

    return backend_default(cpu="eager", gpu="lazy")


def _lazy_pin_budget() -> int:
    from galah_tpu.utils.platform import device_memory_limit

    return int(device_memory_limit() * LAZY_PIN_SHARE)


class _LazyChunk:
    """Deferred host materialization of one sketch chunk's products."""

    def __init__(self, member_words, pref_words, flat, counts, params):
        self._dev = (member_words, pref_words, flat)
        self._counts = counts
        self._params = params
        self._per = None
        self._lock = _threading.Lock()
        self._seq = next(_LAZY_SEQ)
        self.nbytes = sum(
            int(np.prod(a.shape)) * a.dtype.itemsize for a in self._dev
        )

    def get(self):
        with self._lock:
            if self._per is None:
                self._per = _fetch_product_arrays(
                    *self._dev, self._counts, self._params
                )
                self._dev = None  # release device buffers
                with _LAZY_LOCK:
                    _LAZY_PENDING.pop(self._seq, None)
            return self._per


def _register_lazy_chunk(chunk: "_LazyChunk") -> None:
    # Registered from the device worker thread, drained from whichever
    # thread materializes first — guard the registry (the chunk's own
    # lock serializes its fetch; get() self-removes).
    with _LAZY_LOCK:
        _LAZY_PENDING[chunk._seq] = chunk
    while True:
        with _LAZY_LOCK:
            pending = list(_LAZY_PENDING.values())
            over = (
                sum(c.nbytes for c in pending) > _lazy_pin_budget()
                and len(pending) > 1
            )
            oldest = pending[0] if over else None
            del pending
        if oldest is None or oldest is chunk:
            return
        oldest.get()  # materialize + release the oldest


class LazyBuckets(np.lib.mixins.NDArrayOperatorsMixin):
    """Duck-typed int32 bucket array whose CONTENT materializes its
    whole chunk on first access; len()/shape are free (eager counts).
    Supports the codebase's uses: len(), np.asarray/__array__ (feeds
    np.concatenate, fancy indexing, buffer assignment, np.savez),
    every ufunc/operator (NDArrayOperatorsMixin + __array_ufunc__),
    astype, indexing, iteration, and pickling (materializes)."""

    dtype = np.dtype(np.int32)

    def __init__(self, chunk: _LazyChunk, row: int, field: int, n: int):
        self._chunk = chunk
        self._row = row
        self._field = field
        self._n = n
        self._arr = None

    def _mat(self) -> np.ndarray:
        if self._arr is None:
            self._arr = self._chunk.get()[self._row][self._field]
            self._chunk = None
        return self._arr

    def __len__(self) -> int:
        return self._n

    @property
    def shape(self):
        return (self._n,)

    def __array__(self, dtype=None, copy=None):
        a = self._mat()
        return a.astype(dtype) if dtype is not None else a

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        inputs = tuple(
            x._mat() if isinstance(x, LazyBuckets) else x for x in inputs
        )
        return getattr(ufunc, method)(*inputs, **kwargs)

    def astype(self, dtype, **kw):
        return self._mat().astype(dtype, **kw)

    def __getitem__(self, idx):
        return self._mat()[idx]

    def __iter__(self):
        return iter(self._mat())

    def __reduce__(self):
        return (np.asarray, (self._mat(),))


def device_sketch_files(
    paths: Sequence[str],
    params: NativeSketchParams,
    *,
    max_batch_bytes: int = 32 << 20,
    sink=None,
) -> List[NativeSketch]:
    """Sketch whole genome files on device.

    Reads sequences on the host (C++ reader when available), groups
    genomes into power-of-two length buckets so each bucket reuses one
    compiled program, and dispatches batches capped at max_batch_bytes
    of padded sequence. Genomes whose repeat content overflows the
    selected-hash capacity fall back to the host sketcher — results are
    bit-identical either way, so mixing paths is safe.

    The default on the GPU (engines/native.py::_use_device_sketch;
    GALAH_TPU_DEVICE_SKETCH=0 turns it off).
    """
    from galah_tpu.io.fasta import read_fasta_sequences

    out: List[Optional[NativeSketch]] = [None] * len(paths)

    # Pass 1 — bucket by padded concatenated length (contigs +
    # separators), reading one genome at a time and discarding it:
    # host memory stays O(batch), not O(corpus) (a 100k-genome corpus
    # would otherwise hold every uncompressed sequence at once).
    buckets = {}
    for i, p in enumerate(paths):
        seqs = read_fasta_sequences(p)
        total = sum(len(s) for s in seqs) + max(0, len(seqs) - 1)
        P = _next_pow2(max(total, params.k))
        buckets.setdefault(P, []).append(i)
        del seqs

    # Pass 2 — re-read per dispatched batch, prefetching the next
    # batch's FASTA on a reader thread while the device computes the
    # current one (read time rivals hash time on production hosts).
    # Chunks target ~32MB of padded sequence.
    chunks: List[List[int]] = []
    for P, idxs in sorted(buckets.items()):
        per = max(
            1,
            min(max_batch_bytes // max(P, 1), _batch_genome_cap(P, params)),
        )
        for start in range(0, len(idxs), per):
            chunks.append(idxs[start : start + per])

    def read_chunk(ci):
        return [read_fasta_sequences(paths[i]) for i in chunks[ci]]

    def process_on_device(ci, lists):
        chunk = chunks[ci]
        names = [paths[i] for i in chunk]
        try:
            if sink is not None:
                sketches, dev = device_sketch_batch(
                    names, lists, params, return_device=True
                )
                # Hand the on-device products (bitmaps, streams,
                # offsets) to the caller BEFORE any host use so the
                # downstream pipeline never re-uploads them.
                sink(names, sketches, dev)
            else:
                sketches = device_sketch_batch(names, lists, params)
        except DeviceSketchOverflow:
            logger.warning(
                "device sketch overflow for a %d-genome batch; "
                "falling back to host sketching",
                len(chunk),
            )
            _count_host_fallback(len(chunk))
            from galah_tpu.sketch.fracminhash import (
                sketch_sequences_native,
            )

            sketches = [
                sketch_sequences_native(n, s, params)
                for n, s in zip(names, lists)
            ]
        for i, sk in zip(chunk, sketches):
            out[i] = sk

    _run_chunks(len(chunks), read_chunk, process_on_device)
    assert all(sk is not None for sk in out)
    return out  # type: ignore[return-value]
