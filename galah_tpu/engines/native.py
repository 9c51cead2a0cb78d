"""The native accelerator engine: preclusterer + clusterer.

This replaces the reference's external skani and fastANI backends
(src/skani.rs, src/fastani.rs). One engine context owns the sketch
store and device caches; the preclusterer and clusterer views share it
so genomes are sketched exactly once per run (the reference re-reads
FASTA files for every subprocess pair, src/skani.rs:718-788).

Pipeline for `distances()` (triangle mode):
1. sketch every genome (host, parallel; C++ fast path when available);
2. indicator-matmul screen over all pairs on the device
   (galah_tpu.ops.prefilter) with a conservative containment cutoff;
3. fragment-containment verify of surviving pairs, batched
   one-query-many-refs (galah_tpu.ops.fragment_ani);
4. pairs whose verified ANI >= threshold and AF passes are returned in
   the sparse cache — the same contract as the reference's
   `skani triangle --sparse --min-af` (src/skani.rs:144-225).

The clusterer view exposes batched pair ANI with skani-compatible
return semantics (0.0 when the AF filter fails, matching `skani dist`'s
empty output treated as 0.0, src/skani.rs:758-787) or fastANI-
compatible (None on AF failure, src/fastani.rs:56-68).
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from galah_tpu import defaults
from galah_tpu.cluster.cache import SortedPairDistanceCache
from galah_tpu.engines.base import ClusterDistanceFinder, PreclusterDistanceFinder
from galah_tpu.ops.fragment_ani import FragmentAniConfig, FragmentAniEngine
from galah_tpu.ops.prefilter import screen_rectangle, screen_triangle
from galah_tpu.sketch.fracminhash import (
    NativeSketch,
    NativeSketchParams,
    sketch_file_native,
    small_genome_params,
)
from galah_tpu.utils import metrics

logger = logging.getLogger(__name__)


class _DictStore:
    """In-memory sketch store (default mode)."""

    def __init__(self) -> None:
        self._d: Dict[str, NativeSketch] = {}

    def put(self, key: str, sketch: NativeSketch) -> None:
        self._d[key] = sketch

    def get(self, key: str):
        return self._d.get(key)

    def __contains__(self, key: str) -> bool:
        return key in self._d


class _LazySketchList:
    """List-like view over a sketch store: items load on access, so the
    screen/verify stages never hold every sketch in RAM at once."""

    def __init__(self, store, keys: List[str]) -> None:
        self._store = store
        self._keys = keys

    def __len__(self) -> int:
        return len(self._keys)

    def __getitem__(self, i: int) -> NativeSketch:
        return self._store.get(self._keys[i])

    def __iter__(self):
        for k in self._keys:
            yield self._store.get(k)


def _shrink_bits(
    params: NativeSketchParams, max_genome_length: int
) -> NativeSketchParams:
    """Shrink bitmap widths when the dataset's genomes are small, never
    growing past the defaults. Cuts device residency and host<->device
    transfer. The screen bitmap targets ~6% load (x16): collisions are
    corrected for and the screen cutoff is conservative. The verify
    (member) bitmap targets ~0.4% load (x256): per-fragment identity
    estimates feed a >=95%-ANI decision where +-0.01 matters — at x16
    load a 95.0-borderline contig pair (reference
    tests/data/contigs/contigs_rep_bug.fna) flipped clusters with the
    codegen of the compiled kernel."""
    import dataclasses

    def pick(
        target_hashes: int, default_bits: int, floor_bits: int, mult: int
    ) -> int:
        bits = 1 << max(int(target_hashes * mult - 1).bit_length(), floor_bits)
        return min(bits, default_bits)

    member = pick(
        max_genome_length // params.fragment_scale + 1,
        params.member_bits, 17, 256,
    )
    pref = pick(
        max_genome_length // params.genome_scale + 1,
        params.prefilter_bits, 13, 16,
    )
    return dataclasses.replace(params, member_bits=member, prefilter_bits=pref)


class _PrefRowCache:
    """Device-resident packed prefilter rows from device sketching.

    Holds references to device-sketch batches' (G, W) pref_words arrays
    (keyed by unit name) so the screen's resident matrix can be
    assembled device-to-device instead of re-uploading host-packed
    rows. FIFO-bounded by bytes: evicted names fall back to the host
    row (always available)."""

    def __init__(self, budget_bytes: int) -> None:
        from collections import deque

        self._budget = budget_bytes
        self._map: Dict[str, Tuple] = {}
        self._batches: "deque" = deque()
        self._bytes = 0

    def adopt(self, names: Sequence[str], pref_words) -> None:
        nb = int(np.prod(pref_words.shape)) * 4
        if nb > self._budget:
            return
        while self._bytes + nb > self._budget and self._batches:
            old_names, old_arr, old_nb = self._batches.popleft()
            for i, nm in enumerate(old_names):
                # Identity compare: tuple equality over a jax array
                # would call elementwise __eq__ and raise on truthiness
                # (or broadcast-error across batch shapes).
                hit = self._map.get(nm)
                if hit is not None and hit[0] is old_arr and hit[1] == i:
                    del self._map[nm]
            self._bytes -= old_nb
        self._batches.append((list(names), pref_words, nb))
        self._bytes += nb
        for i, nm in enumerate(names):
            self._map[nm] = (pref_words, i)

    def get(self, name: str):
        return self._map.get(name)

    def __len__(self) -> int:
        return len(self._map)


def _chain_sinks(base, extra):
    """Compose the device-sketch adoption sink with an extra per-batch
    callback (the pipeline overlap's screen feed); base runs first so
    verify caches are adopted before any screen tile can need them."""
    if extra is None:
        return base
    if base is None:
        return extra

    def chained(names, sketches, dev):
        base(names, sketches, dev)
        extra(names, sketches, dev)

    return chained


class NativeContext:
    """Shared state for the native engine: sketch params, sketch store,
    and the device-side fragment-ANI engine."""

    def __init__(
        self,
        small_genomes: bool = False,
        fragment_length: Optional[int] = None,
        threads: int = 4,
        low_memory: bool = False,
        params: Optional[NativeSketchParams] = None,
        max_genome_length: Optional[int] = None,
        sketch_directory: Optional[str] = None,
    ) -> None:
        """sketch_directory: persistent cross-run sketch cache
        (--sketch-directory): sketches land at content-stable paths
        keyed by unit, parameters and source-file signature, so a
        re-run (or a crash resumed via --sweep-checkpoint /
        --input-distance-cache) reuses them instead of re-sketching —
        the sketch-phase leg of SURVEY §5's first-class persistable
        artifacts (reference analog: skani's reusable sketch DB,
        src/skani.rs:265-290)."""
        if params is not None:
            self.params = params
        elif small_genomes:
            # None means "flag not given": the preset's denser 1000bp
            # default applies; an explicit value (even 3000, the global
            # default) is always honored.
            self.params = small_genome_params(fragment_length=fragment_length)
        else:
            self.params = NativeSketchParams(
                fragment_length=fragment_length
                if fragment_length is not None
                else defaults.DEFAULT_FRAGMENT_LENGTH
            )
            if max_genome_length:
                self.params = _shrink_bits(self.params, max_genome_length)
        # Set once the first sketch exists: bitmap widths are frozen
        # from then on (_widen_for_low_af refuses to change them).
        self._sketched_any = False
        self.threads = max(1, threads)
        self.low_memory = low_memory
        self.sketch_directory = sketch_directory
        if sketch_directory:
            # Persistent cross-run store; in --low-memory it doubles
            # as the spill target (bounded working set), otherwise
            # everything stays resident and the disk copy is the
            # reusable artifact.
            from galah_tpu.sketch.store import PersistentSketchStore

            self._store = PersistentSketchStore(
                sketch_directory, self.params,
                max_resident=64 if low_memory else (1 << 31),
            )
        elif low_memory:
            # Disk-backed sketch store with an LRU working set — the
            # low-memory analog of skani sketch-then-search
            # (src/skani.rs:229-377).
            import tempfile

            from galah_tpu.sketch.store import DiskSketchStore

            self._spill_dir = tempfile.TemporaryDirectory(
                prefix="galah-tpu-sketches-"
            )
            self._store = DiskSketchStore(
                self._spill_dir.name, self.params, max_resident=64
            )
        else:
            self._store = _DictStore()
        self._contig_store: Dict[str, List[NativeSketch]] = {}
        # Device-born packed prefilter rows for the screen (filled by
        # the device-sketch sink; ~512MB FIFO budget, host fallback).
        self._pref_cache = _PrefRowCache(
            int(os.environ.get("GALAH_TPU_PREF_CACHE_BYTES", 512 << 20))
        )
        self.frag_engine = FragmentAniEngine(
            FragmentAniConfig(
                k=self.params.k,
                member_bits=self.params.member_bits,
                min_fragment_hashes=self.params.min_fragment_hashes,
            )
        )

    def _widen_for_low_af(
        self, min_af: float, screen_ani_pct: Optional[float]
    ) -> None:
        """Widen the prefilter bitmap when the requested AF puts the
        exact screen cutoff near the collision-noise floor.

        Corrected-containment noise between unrelated sketches has
        std ~ 1/sqrt(B) (independent of sketch size), so the bitmap is
        sized to keep the cutoff >= 4 sigma — for EVERY requested AF,
        not only tiny ones: at --precluster-ani 85 even the default
        bitmap leaves an AF-0.05 cutoff at ~1.1 sigma (a borderline
        pair dropped ~13% of the time). If the width needed exceeds
        2^26 bits (8MB packed per genome) the flag is refused with a
        clear error instead of ever silently losing pairs the
        reference would keep (src/skani.rs:144-159)."""
        import dataclasses
        import math as _math

        if min_af <= 0:
            return
        ani = screen_ani_pct or defaults.MIN_SUPPORTED_PRECLUSTER_ANI
        cutoff = _screen_min_containment(ani, min_af, self.params.k)
        need = (4.0 / cutoff) ** 2
        cap = 1 << 26
        if need > cap:
            raise ValueError(
                f"Error: --min-aligned-fraction {min_af:g} at ANI "
                f"{ani:g}% needs a {need / 8 / 1e6:.0f}MB prefilter "
                "sketch per genome to screen reliably. Raise "
                "--min-aligned-fraction, or lower it to 0 to disable "
                "aligned-fraction screening entirely (every pair is "
                "then verified)."
            )
        bits = 1 << _math.ceil(_math.log2(need))
        if bits > self.params.prefilter_bits:
            if self._sketched_any:
                raise RuntimeError(
                    "internal: prefilter bitmap widening requested after "
                    "sketches were already computed at the old width — "
                    "construct the NativePreclusterer before any sketching"
                )
            logger.info(
                "Widening prefilter bitmap to %d bits for "
                "--min-aligned-fraction %.3g",
                bits,
                min_af,
            )
            self.params = dataclasses.replace(
                self.params, prefilter_bits=bits
            )
            # The disk sketch stores fingerprint filenames with the
            # params object; a stale snapshot here would let a
            # --sketch-directory run reuse sketches built at a
            # DIFFERENT width across runs (wrong containments or
            # out-of-range bucket indices).
            if hasattr(self._store, "set_params"):
                self._store.set_params(self.params)

    def key_for(self, sketch: NativeSketch) -> str:
        # Keyed by unit name (path or contig name) so device-side caches
        # survive sketch reloads in low-memory mode.
        return sketch.name

    def sketch(self, path: str) -> NativeSketch:
        sk = self._store.get(path)
        if sk is None:
            self._sketched_any = True
            sk = sketch_file_native(path, self.params)
            self._store.put(path, sk)
        return sk

    def sketch_many(
        self, paths: Sequence[str], extra_sink=None
    ) -> List[NativeSketch]:
        """extra_sink(names, sketches, dev): additional per-batch
        device-sketch callback (the sketch->screen pipeline overlap
        feeds the incremental screen through it). Only invoked on the
        device-sketch path; host-sketched units never reach it and the
        caller back-fills them."""
        missing = [p for p in dict.fromkeys(paths) if p not in self._store]
        if missing:
            logger.info("Sketching %d genomes ..", len(missing))
            self._sketched_any = True
            sketched_here = len(missing)
            with metrics.current().phase("sketch"):
                import jax

                from galah_tpu.parallel.mp import governed_flag

                nproc = jax.process_count()
                if (
                    nproc > 1
                    and len(missing) > 1
                    and governed_flag("GALAH_TPU_MP_SKETCH")
                ):
                    # Partition sketching across processes and exchange
                    # the results: sketching is the O(n) phase and was
                    # the only one every host repeated in full. Sketch
                    # bytes are ~50x smaller than the FASTA they distill,
                    # so shipping them over DCN beats re-reading and
                    # re-hashing the sequence on every host.
                    from galah_tpu.parallel.mp import exchange_sketches

                    mine = missing[jax.process_index()::nproc]
                    sketched_here = len(mine)
                    bases_here = 0
                    if mine:
                        bases_here = self._sketch_local(mine)
                    logger.info(
                        "Sketched %d/%d genomes locally; exchanging "
                        "across %d processes",
                        len(mine), len(missing), nproc,
                    )
                    exchange_sketches(
                        missing, self._store.get, self._store.put,
                        expect_params=self.params,
                    )
                else:
                    bases_here = self._sketch_local(
                        missing, extra_sink=extra_sink
                    )
            # Per-host truth: with the MP partition each host only
            # sketched its share (throughput math stays honest; the
            # bases counter likewise sums only locally-produced
            # sketches — re-fetching them from the store would reload
            # full .npz files in --low-memory mode just to read a
            # length).
            metrics.current().count("genomes_sketched", sketched_here)
            metrics.current().count("sketch_bases", bases_here)
            logger.info("Finished sketching genomes")
        if self.low_memory:
            return _LazySketchList(self._store, list(paths))
        return [self._store.get(p) for p in paths]

    def _device_sink(self):
        """Per-batch adoption callback for device sketching: hands the
        on-device sketch products straight to the verify caches (bitmap
        pool + stream arena) so the pipeline never re-uploads what the
        device just computed. GALAH_TPU_RESIDENT=0 disables adoption
        (host mirrors then feed every stage, as before)."""
        if os.environ.get("GALAH_TPU_RESIDENT", "1") == "0":
            return None

        def sink(names, sketches, dev):
            self.frag_engine.adopt_batch(names, sketches, dev)
            self._pref_cache.adopt(names, dev["pref_words"])

        return sink

    def pref_matrix_builder(self, sketches: Sequence[NativeSketch],
                            sizes_f: np.ndarray):
        """matrix_builder for the resident packed screen: assembles the
        (n_pad, W) matrix on device from device-born pref rows, with
        host-packed uploads only for rows the cache lost. Returns None
        (host assembly) when nothing is device-resident."""
        if os.environ.get("GALAH_TPU_RESIDENT", "1") == "0":
            return None
        keys = [self.key_for(s) for s in sketches]
        if not any(self._pref_cache.get(k) is not None for k in keys):
            return None
        bits = self.params.prefilter_bits
        w = bits // 32

        def build(n_pad: int):
            import jax
            import jax.numpy as jnp

            from galah_tpu.ops.fragment_ani import (
                _pool_adopt,
                _pool_fill_dense,
            )
            from galah_tpu.ops.prefilter import pack_indicator

            x = jnp.zeros((n_pad, w), jnp.uint32)
            by_batch: Dict[int, List[Tuple[int, int]]] = {}
            batch_arr: Dict[int, object] = {}
            missing: List[int] = []
            for i, key in enumerate(keys):
                hit = self._pref_cache.get(key)
                if hit is None:
                    missing.append(i)
                else:
                    arr, row = hit
                    by_batch.setdefault(id(arr), []).append((i, row))
                    batch_arr[id(arr)] = arr
            for bid, items in by_batch.items():
                step = 8192
                for lo in range(0, len(items), step):
                    chunk = items[lo : lo + step]
                    bpad = max(8, 1 << (len(chunk) - 1).bit_length())
                    # padding -> duplicate of the first entry (set is
                    # idempotent for identical rows)
                    dst = np.full(bpad, chunk[0][0], np.int32)
                    src = np.full(bpad, chunk[0][1], np.int32)
                    for b, (i, row) in enumerate(chunk):
                        dst[b] = i
                        src[b] = row
                    x = _pool_adopt(
                        x, batch_arr[bid], jnp.asarray(src),
                        jnp.asarray(dst),
                    )
            step = max(8, (64 << 20) // (w * 4))
            for lo in range(0, len(missing), step):
                chunk = missing[lo : lo + step]
                bpad = max(8, 1 << (len(chunk) - 1).bit_length())
                block = np.zeros((bpad, w), np.uint32)
                dst = np.zeros(bpad, np.int32)
                for b, i in enumerate(chunk):
                    block[b] = pack_indicator(
                        sketches[i].prefilter_buckets, bits
                    )
                    dst[b] = i
                # pow2-pad with duplicates of the first row (identical
                # content at a duplicate index: order-independent)
                block[len(chunk):] = block[0]
                dst[len(chunk):] = dst[0]
                x = _pool_fill_dense(
                    x, jax.device_put(block), jax.device_put(dst)
                )
            s_all = np.zeros(n_pad, dtype=np.float32)
            s_all[: len(keys)] = sizes_f
            logger.info(
                "Resident screen matrix: %d device-born rows, %d "
                "host-uploaded", len(keys) - len(missing), len(missing),
            )
            return x, jnp.asarray(s_all)

        return build

    def _sketch_local(
        self, missing: Sequence[str], extra_sink=None
    ) -> int:
        """Sketch `missing` into the store; returns total bases
        sketched (for the band-immune work counters)."""
        bases = 0
        if _use_device_sketch():
            # Accelerator sketching (ops/device_sketch.py): bit-identical
            # to the host path; on by default behind fast links (probe
            # above), forced by GALAH_TPU_DEVICE_SKETCH=1/0.
            from galah_tpu.ops.device_sketch import device_sketch_files

            sink = _chain_sinks(self._device_sink(), extra_sink)
            for p, sk in zip(
                missing,
                device_sketch_files(missing, self.params, sink=sink),
            ):
                self._store.put(p, sk)
                bases += sk.total_len
        elif self.threads > 1 and len(missing) > 1:
            with ThreadPoolExecutor(max_workers=self.threads) as ex:
                for p, sk in zip(
                    missing,
                    ex.map(
                        lambda p: sketch_file_native(p, self.params),
                        missing,
                    ),
                ):
                    self._store.put(p, sk)
                    bases += sk.total_len
        else:
            for p in missing:
                sk = sketch_file_native(p, self.params)
                self._store.put(p, sk)
                bases += sk.total_len
        return bases

    def sketch_contigs(
        self, paths: Sequence[str], extra_sink=None
    ) -> List[NativeSketch]:
        """One sketch per contig, across files, in file order (the unit
        order the reference's contig mode uses,
        src/cluster_argument_parsing.rs:595-629). extra_sink: see
        sketch_many — feeds the sketch->screen overlap pipeline."""
        from galah_tpu.sketch.fracminhash import sketch_contigs_native

        out: List[NativeSketch] = []
        missing = [p for p in paths if p not in self._contig_store]
        if missing and self.sketch_directory:
            # Persistent contig bundles: one file per input FASTA
            # (content-stable name), loaded whole on a hit.
            from galah_tpu.sketch.store import load_contig_sketches

            still = []
            for p in missing:
                bp = self._contig_bundle_path(p)
                if os.path.exists(bp):
                    try:
                        self._contig_store[p] = load_contig_sketches(bp)
                        continue
                    except Exception as e:
                        logger.warning(
                            "ignoring unreadable contig sketch bundle "
                            "%s: %r", bp, e,
                        )
                still.append(p)
            if len(still) < len(missing):
                logger.info(
                    "Reused contig sketches for %d/%d files from %s",
                    len(missing) - len(still), len(missing),
                    self.sketch_directory,
                )
            missing = still
        if missing:
            self._sketched_any = True
            with metrics.current().phase("sketch"):
                if _use_device_sketch():
                    from galah_tpu.ops.device_sketch import (
                        device_sketch_contig_files,
                    )

                    sink = _chain_sinks(self._device_sink(), extra_sink)
                    for path, sks in zip(
                        missing,
                        device_sketch_contig_files(
                            missing, self.params, sink=sink,
                        ),
                    ):
                        self._contig_store[path] = sks
                else:
                    for path in missing:
                        self._contig_store[path] = sketch_contigs_native(
                            path, self.params, threads=self.threads
                        )
        if missing and self.sketch_directory:
            from galah_tpu.sketch.store import save_contig_sketches

            for p in missing:
                save_contig_sketches(
                    self._contig_bundle_path(p), self._contig_store[p]
                )
        for path in paths:
            out.extend(self._contig_store[path])
        n_contigs = sum(len(self._contig_store[p]) for p in missing)
        if n_contigs:
            metrics.current().count("contigs_sketched", n_contigs)
        return out

    def _contig_bundle_path(self, path: str) -> str:
        from galah_tpu.sketch.store import _file_sig, _stable_sketch_name

        name = _stable_sketch_name(
            "contigs:" + path, self.params, _file_sig(path)
        )
        return os.path.join(self.sketch_directory, name)


def _use_device_sketch() -> bool:
    """Whether the sketch stage runs on the accelerator.

    GALAH_TPU_DEVICE_SKETCH=1/0 forces it. On the GPU it is on by
    default: device-born sketches feed the screen matrix and verify
    caches with no further upload, so the device path moves 0.25
    bytes/base in total where host sketching moves ~0.75 bytes/base of
    sketch products. On an H100 the two tie end to end on 3 Mb MAGs,
    and the host sketcher was faster on 5 kb contigs (PERF.md). The CPU
    backend keeps host sketching: the 'device' would be the same host,
    and the C++ sketcher is faster than XLA:CPU."""
    env = os.environ.get("GALAH_TPU_DEVICE_SKETCH")
    if env is not None:
        return env == "1"
    from galah_tpu.utils.platform import backend_default

    return backend_default(cpu=False, gpu=True)


class _LazyIndicatorRows:
    """Indicator rows materialized on access (they're 8x larger than the
    underlying bucket lists, so never hold them all)."""

    def __init__(self, sketches) -> None:
        self._sketches = sketches

    def __len__(self) -> int:
        return len(self._sketches)

    def __getitem__(self, i: int) -> np.ndarray:
        return self._sketches[i].prefilter_indicator()


class _LazyPackedRows:
    """Packed uint32 bitmap rows materialized on access."""

    def __init__(self, sketches, bits: int) -> None:
        from galah_tpu.ops.prefilter import pack_indicator

        self._sketches = sketches
        self._bits = bits
        self._pack = pack_indicator
        # Width hint: lets the screens size their buffers without
        # touching row 0 (which would materialize a lazy sketch chunk
        # just to read its length).
        self.row_width = bits // 32

    def __len__(self) -> int:
        return len(self._sketches)

    def __getitem__(self, i: int) -> np.ndarray:
        return self._pack(self._sketches[i].prefilter_buckets, self._bits)


def _screen_backend() -> str:
    """'packed' (GPU default: packed upload + on-device unpack + matrix
    product) or 'indicator' (uint8 indicator upload + product; CPU
    default — no transfer cost, no unpack work). Env: GALAH_TPU_SCREEN."""
    env = os.environ.get("GALAH_TPU_SCREEN")
    if env:
        if env not in ("packed", "indicator"):
            raise ValueError(
                f"GALAH_TPU_SCREEN={env!r}: expected packed or indicator"
            )
        return env
    from galah_tpu.utils.platform import backend_default

    return backend_default(cpu="indicator", gpu="packed")


def calibrated_ani_threshold(
    threshold_pct: float, semantics: str, k: int
) -> float:
    """Map a user-facing ANI threshold to the native estimator's scale.

    "window": identity — thresholds compare against the estimator's own
    event-inclusive ANI. "skani-calibrated": the estimator reads LOWER
    than gap-excluded (skani) ANI by p_indel*(k+len-1)/k per unit
    divergence (theory-pinned measurement: tests/
    test_estimator_stress.py::test_indel_bias_matches_theory), so the
    threshold shifts down by that bias at the documented typical indel
    load — a pair whose gap-excluded ANI is exactly `threshold_pct`
    then sits exactly at the shifted cut. Monotone in threshold_pct, so
    cluster orderings never change; only where the knife falls does.
    Reference semantics being reproduced: src/skani.rs:718-788."""
    if semantics == "window":
        return threshold_pct
    if semantics != "skani-calibrated":
        raise ValueError(f"unknown --ani-semantics {semantics!r}")
    c = (
        defaults.CALIBRATION_INDEL_EVENTS_PER_SUB
        * (k + defaults.CALIBRATION_MEAN_INDEL_LEN - 1.0)
        / k
    )
    return threshold_pct - c * (100.0 - threshold_pct)


def _screen_min_containment(
    ani_threshold_pct: float, min_af: float, k: int
) -> float:
    """Exact screen cutoff from the requested AF — no floor. The
    reference passes --min-af through to skani verbatim
    (src/skani.rs:144-159); when the user asks for a very low AF the
    context widens the prefilter bitmap instead
    (NativeContext._widen_for_low_af) so the cutoff stays above
    collision noise (std ~ 1/sqrt(B)) rather than silently dropping
    pairs. min_af <= 0 disables screen pruning entirely (every pair is
    verified)."""
    if min_af <= 0:
        return 0.0
    return defaults.NATIVE_SCREEN_MARGIN * min_af * (ani_threshold_pct / 100.0) ** k


def _emit_verified(res, idx_by_key_pair, threshold_pct, min_af, cache):
    """Insert bidirectional verify results into the sparse cache — the
    ONE implementation of the AF/ANI filter, the duplicate-path
    "emit every index pair per key pair" rule, and the float32
    rounding, shared by the batch and overlapped verify paths (their
    bit-identical guarantee rides on this being a single function)."""
    for kp, (ani, af_f, af_r) in res.items():
        for i, j in idx_by_key_pair[kp]:
            if max(af_f, af_r) >= min_af and ani >= threshold_pct:
                cache.insert((i, j), float(np.float32(ani)))


class _VerifyFeeder:
    """Incremental verify: screen tiles' drained pairs flush into the
    fragment-ANI engine in chunks WHILE the sweep (and the sketch feed)
    continues — the screen->verify leg of the pipeline overlap. Flush
    numerics are per-pair, so chunking never changes a result (same
    guarantee the grouped/pair-table split already makes); the final
    cache equals the one-batch _verify_pairs cache exactly.

    chunk_pairs trades flush frequency against dispatch count:
    each flush groups its own pairs by source genome, so very small
    chunks would re-touch a stream per chunk. GALAH_TPU_VERIFY_FLUSH
    overrides (0 disables mid-sweep flushing: everything verifies in
    finish())."""

    def __init__(self, owner, sketch_for, threshold_pct: float,
                 min_af: float) -> None:
        env = os.environ.get("GALAH_TPU_VERIFY_FLUSH")
        self.chunk_pairs = int(env) if env else 50_000
        self.owner = owner
        self.sketch_for = sketch_for
        self.threshold_pct = threshold_pct
        self.min_af = min_af
        self.cache = SortedPairDistanceCache()
        self.total = 0
        self.verify_seconds = 0.0
        self._buf: List[np.ndarray] = []
        self._buffered = 0

    def feed(self, pairs: np.ndarray, anis=None) -> None:
        if len(pairs) == 0:
            return
        self._buf.append(pairs)
        self._buffered += len(pairs)
        if self.chunk_pairs and self._buffered >= self.chunk_pairs:
            self._flush()

    def _flush(self) -> None:
        import time as _time

        if not self._buf:
            return
        pairs = np.concatenate(self._buf)
        self._buf, self._buffered = [], 0
        t0 = _time.perf_counter()
        ctx = self.owner.ctx
        sketches_by_key: Dict[str, NativeSketch] = {}
        key_pairs: List[Tuple[str, str]] = []
        idx_by_key_pair: Dict[Tuple[str, str], List[Tuple[int, int]]] = {}
        for i, j in pairs:
            i, j = int(i), int(j)
            si, sj = self.sketch_for(i), self.sketch_for(j)
            ki, kj = ctx.key_for(si), ctx.key_for(sj)
            sketches_by_key.setdefault(ki, si)
            sketches_by_key.setdefault(kj, sj)
            key_pairs.append((ki, kj))
            idx_by_key_pair.setdefault((ki, kj), []).append((i, j))
        res = ctx.frag_engine.bidirectional(key_pairs, sketches_by_key)
        _emit_verified(
            res, idx_by_key_pair, self.threshold_pct, self.min_af,
            self.cache,
        )
        self.total += len(pairs)
        self.verify_seconds += _time.perf_counter() - t0

    def finish(self) -> SortedPairDistanceCache:
        self._flush()
        m = metrics.current()
        m.phases["verify"] = (
            m.phases.get("verify", 0.0) + self.verify_seconds
        )
        if self.total:
            m.rate(
                "verify_pairs_per_s", self.total, self.verify_seconds
            )
        logger.info(
            "Verified %d candidate pairs (overlapped); %d passed "
            "ANI>=%.4g with AF>=%.3g",
            self.total, len(self.cache), self.threshold_pct, self.min_af,
        )
        return self.cache


class _VerifyMixin:
    """Shared verify stage: candidate pairs -> verified sparse cache."""

    def _report_indel_load(self, cache, sketch_for) -> None:
        """Calibration honesty (VERDICT r4 #8): estimate the corpus's
        apparent indel load from a sample of verified pairs and report
        it in the metrics/log, so users of --ani-semantics
        skani-calibrated can see when the fixed default load
        (defaults.CALIBRATION_*) is off for THEIR corpus. Advisory
        only; GALAH_TPU_INDEL_ESTIMATE=0 disables."""
        if os.environ.get("GALAH_TPU_INDEL_ESTIMATE", "1") == "0":
            return
        if len(cache) == 0:
            return
        try:
            from galah_tpu.ops.indel_estimate import estimate_indel_load

            keys = [p for p, _ in cache.items()]
            # Sample pairs from a COMPACT index window: in lazy
            # host-copy mode touching a sketch's content materializes
            # its whole device-sketch chunk over the link, so a spread
            # sample would fetch every chunk (~13s measured on the
            # bench e2e). Pick the densest 128-index window first and
            # only widen if it carries too few pairs.
            from collections import Counter

            span = 128
            blocks = Counter(
                min(i, j) // span
                for i, j in keys
                if max(i, j) - min(i, j) < span
            )
            sample = []
            if blocks:
                best = blocks.most_common(1)[0][0]
                sample = [
                    (i, j) for i, j in keys
                    if min(i, j) // span == best
                    and max(i, j) - min(i, j) < span
                ][:24]
            if len(sample) < 8:
                sample = keys[:24]
            res = estimate_indel_load(
                sample, sketch_for, self.ctx.params, max_pairs=24
            )
        except Exception as e:  # advisory: never fail the run
            logger.debug("indel-load estimate failed: %r", e)
            return
        if res is None:
            return
        m = metrics.current()
        m.count(
            "apparent_indel_events_per_sub",
            res["apparent_indel_events_per_sub"],
        )
        m.count("indel_estimate_pairs_used", res["pairs_used"])
        apparent = res["apparent_indel_events_per_sub"]
        default = res["calibration_default"]
        logger.info(
            "Apparent corpus indel load: %.3f indel events per "
            "substitution (skani-calibrated assumes %.3f; mark ratio "
            "%.1f over %d pair-directions / %d fragments). A large "
            "mismatch means the calibrated threshold shift is off for "
            "this corpus.",
            apparent, default, res["mark_ratio"],
            int(res["pairs_used"]), int(res["fragments_used"]),
        )

    def _verify_pairs(
        self,
        sketches: Sequence[NativeSketch],
        pairs: np.ndarray,
        threshold_pct: float,
        min_af: float,
    ) -> SortedPairDistanceCache:
        ctx = self.ctx
        cache = SortedPairDistanceCache()
        total = len(pairs)
        import time as _time

        _t0 = _time.perf_counter()
        # One global bidirectional batch (default): both directions
        # grouped by source genome so every fragment stream/bitmap hits
        # the device exactly once. In low-memory mode the batch is
        # chunked so at most ~the disk store's LRU working set of
        # sketches is pinned in host RAM at a time (a single global
        # dict of every candidate endpoint would defeat --low-memory
        # exactly on the large corpora it exists for).
        keys = (
            sketches._keys if isinstance(sketches, _LazySketchList) else None
        )
        chunk_keys = 64 if ctx.low_memory else None

        def flush(key_pairs, sketches_by_key, idx_by_key_pair):
            res = ctx.frag_engine.bidirectional(key_pairs, sketches_by_key)
            _emit_verified(
                res, idx_by_key_pair, threshold_pct, min_af, cache
            )

        sketches_by_key: Dict[str, NativeSketch] = {}
        key_pairs: List[Tuple[str, str]] = []
        idx_by_key_pair: Dict[Tuple[str, str], List[Tuple[int, int]]] = {}
        for i, j in pairs:
            i, j = int(i), int(j)
            ki = keys[i] if keys else ctx.key_for(sketches[i])
            kj = keys[j] if keys else ctx.key_for(sketches[j])
            if ki not in sketches_by_key:
                sketches_by_key[ki] = sketches[i]
            if kj not in sketches_by_key:
                sketches_by_key[kj] = sketches[j]
            key_pairs.append((ki, kj))
            idx_by_key_pair.setdefault((ki, kj), []).append((i, j))
            if chunk_keys and len(sketches_by_key) >= chunk_keys:
                flush(key_pairs, sketches_by_key, idx_by_key_pair)
                sketches_by_key, key_pairs, idx_by_key_pair = {}, [], {}
        if key_pairs:
            flush(key_pairs, sketches_by_key, idx_by_key_pair)
        _dt = _time.perf_counter() - _t0
        m = metrics.current()
        m.phases["verify"] = m.phases.get("verify", 0.0) + _dt
        if total:
            m.rate("verify_pairs_per_s", total, _dt)
        logger.info(
            "Verified %d candidate pairs; %d passed ANI>=%.4g with AF>=%.3g",
            total,
            len(cache),
            threshold_pct,
            min_af,
        )
        return cache


class NativePreclusterer(PreclusterDistanceFinder, _VerifyMixin):
    supports_contigs = True

    def __init__(
        self,
        threshold: float,
        min_aligned_threshold: float,
        ctx: NativeContext,
        ani_semantics: str = defaults.DEFAULT_ANI_SEMANTICS,
        sweep_checkpoint: Optional[str] = None,
    ) -> None:
        """threshold: percent (e.g. 95.0); min_aligned_threshold:
        fraction (e.g. 0.15), as in the reference's SkaniPreclusterer
        (src/skani.rs:12-18). ani_semantics "skani-calibrated" shifts
        the threshold by the documented indel bias so the cut matches
        gap-excluded ANI (the 85% accuracy guard applies to the
        user-facing value, before calibration). sweep_checkpoint: path
        of the mid-sweep tile log (ops/sweep_checkpoint.py) — drained
        screen tiles persist incrementally and a killed sweep resumes
        from them, byte-identical."""
        if threshold < defaults.MIN_SUPPORTED_PRECLUSTER_ANI:
            raise ValueError(
                "Error: the native engine produces inaccurate results with ANI "
                f"less than 85%. Provided: {threshold:g}"
            )
        self.threshold = calibrated_ani_threshold(
            threshold, ani_semantics, ctx.params.k
        )
        self.min_aligned_threshold = min_aligned_threshold
        self.ctx = ctx
        self.sweep_checkpoint = sweep_checkpoint
        # The preclusterer owns the prefilter screen, so ITS
        # construction — not the shared context's — sizes the bitmap
        # for (or refuses) the requested AF: a NativeClusterer-only run
        # never evaluates the screen cutoff and must not be refused.
        # Runs before any sketching (bitmap width shapes the sketches).
        ctx._widen_for_low_af(min_aligned_threshold, threshold)

    # -- triangle mode --
    def distances(self, genome_fasta_paths: Sequence[str]) -> SortedPairDistanceCache:
        if self._pipeline_enabled(len(genome_fasta_paths)):
            return self._distances_pipelined(genome_fasta_paths)
        sketches = self.ctx.sketch_many(genome_fasta_paths)
        return self._screen_and_verify(sketches)

    def _pipeline_enabled(self, n_paths: int) -> bool:
        """Whether the sketch->screen overlap pipeline applies: the
        single-device resident packed screen fed by device sketching
        (the single-GPU production path). Sharded multi-device sweeps,
        low-memory streaming, host sketching, and non-resident corpora
        keep the sequential phases. GALAH_TPU_PIPELINE=0 disables;
        =1 forces (testing on the CPU multi-device conftest)."""
        env = os.environ.get("GALAH_TPU_PIPELINE")
        if env == "0":
            return False
        if n_paths < 2:
            return False
        ctx = self.ctx
        if ctx.low_memory or not _use_device_sketch():
            return False
        if os.environ.get("GALAH_TPU_RESIDENT", "1") == "0":
            return False
        if _screen_backend() != "packed":
            return False
        import jax

        if env != "1" and (
            jax.device_count() > 1 or jax.process_count() > 1
        ):
            return False
        from galah_tpu.ops.prefilter import _device_resident_budget

        w = ctx.params.prefilter_bits // 32
        return n_paths * w * 4 <= _device_resident_budget()

    def _distances_pipelined(
        self, paths: Sequence[str]
    ) -> SortedPairDistanceCache:
        """Overlapped sketch->screen over whole genomes (units keyed by
        path)."""
        idxs_by_key: Dict[str, List[int]] = {}
        for i, p in enumerate(paths):
            idxs_by_key.setdefault(p, []).append(i)
        return self._run_pipelined(
            len(paths), idxs_by_key,
            lambda feed: self.ctx.sketch_many(paths, extra_sink=feed),
            unit_names=list(paths),
        )

    def _distances_contigs_pipelined(
        self, paths: Sequence[str], contig_names: Sequence[str]
    ) -> SortedPairDistanceCache:
        """Overlapped sketch->screen over per-contig units (keyed by
        contig name — duplicates are rejected upstream by the CLI's
        contig-name extraction, matching the reference's dup check,
        src/cluster_argument_parsing.rs:616-621)."""
        idxs_by_key: Dict[str, List[int]] = {}
        for i, nm in enumerate(contig_names):
            idxs_by_key.setdefault(nm, []).append(i)

        def sketch(feed):
            sketches = self.ctx.sketch_contigs(paths, extra_sink=feed)
            if [s.name for s in sketches] != list(contig_names):
                raise ValueError(
                    "Contig names passed to distances_contigs do not "
                    "match file contents"
                )
            return sketches

        return self._run_pipelined(
            len(contig_names), idxs_by_key, sketch,
            unit_names=list(contig_names),
        )

    def _run_pipelined(
        self, n: int, idxs_by_key: Dict[str, List[int]], sketch_call,
        unit_names: Optional[List[str]] = None,
    ) -> SortedPairDistanceCache:
        """Overlapped sketch->screen core: the device-sketch sink feeds
        each batch's device-born prefilter rows straight into an
        IncrementalPackedScreen, so screen tiles dispatch while later
        units are still being read/uploaded/sketched — the e2e wall
        approaches max(phase) + tail instead of sum(phases) (the
        reference's in-process handoff, src/skani.rs:270-304, without
        its per-pair subprocess cost). Results are bit-identical to the
        sequential path (tests/test_pipeline_overlap.py)."""
        import time as _time

        from galah_tpu.ops.prefilter import pack_indicator
        from galah_tpu.ops.prefilter import IncrementalPackedScreen

        ctx = self.ctx
        k = ctx.params.k
        bits = ctx.params.prefilter_bits
        min_cont = _screen_min_containment(
            self.threshold, self.min_aligned_threshold, k
        )
        logger.info(
            "Pipelined sketch+screen+verify over %d units (overlapped)", n
        )
        scr = IncrementalPackedScreen(
            n, k, min_cont, bits,
            checkpoint_path=self.sweep_checkpoint, unit_names=unit_names,
        )
        # Screen->verify leg: drained tile pairs flush into the verify
        # engine mid-sweep. Sketch objects for any drained pair's
        # endpoints are guaranteed present in sk_by_idx — a tile only
        # dispatches once both row blocks were fed, and every feed
        # path records its sketches first.
        sk_by_idx: Dict[int, NativeSketch] = {}
        feeder = _VerifyFeeder(
            self, sk_by_idx.__getitem__, self.threshold,
            self.min_aligned_threshold,
        )
        scr.on_pairs = feeder.feed

        def screen_feed(names, sks, dev):
            idxs: List[int] = []
            src_rows: List[int] = []
            sizes: List[float] = []
            for r, (nm, sk) in enumerate(zip(names, sks)):
                for i in idxs_by_key.get(nm, ()):
                    idxs.append(i)
                    src_rows.append(r)
                    sizes.append(float(sk.n_prefilter))
                    sk_by_idx[i] = sk
            if idxs:
                scr.add_device_rows(idxs, dev["pref_words"], src_rows, sizes)

        _t0 = _time.perf_counter()
        sketches = sketch_call(screen_feed)
        _t_sketch_done = _time.perf_counter()
        # Back-fill rows the sink never saw: host/shadow-sketched
        # units, overflow fallbacks, units already in the store.
        for i in range(n):
            if i not in sk_by_idx:
                sk_by_idx[i] = sketches[i]
        late = scr.missing_rows()
        if late:
            scr.add_host_rows(
                late,
                [
                    pack_indicator(sketches[i].prefilter_buckets, bits)
                    for i in late
                ],
                [float(sketches[i].n_prefilter) for i in late],
            )
        res = scr.finish()
        _dt_tail = _time.perf_counter() - _t_sketch_done
        m = metrics.current()
        # Phase accounting under overlap: "screen" records only the
        # post-sketch TAIL (the overlapped portion rides inside the
        # sketch wall — that is the win being measured). The feeder
        # likewise accumulates only its own flush time under "verify".
        m.phases["screen"] = m.phases.get("screen", 0.0) + _dt_tail
        # Flag for metrics readers: phase timers OVERLAP in this mode
        # (screen dispatches and verify flushes ride inside the sketch
        # wall), so phases_s sums exceeding wall_clock_s is the
        # overlap working, not double-billed time.
        m.counters["phases_overlapped"] = 1.0
        m.rate(
            "screen_pairs_per_s", n * (n - 1) / 2,
            _time.perf_counter() - _t0,
        )
        if scr.rows_at_first_dispatch is not None:
            m.count(
                "screen_rows_at_first_dispatch",
                int(scr.rows_at_first_dispatch),
            )
            logger.info(
                "Pipelined screen: first tile dispatched after %d/%d "
                "rows; %d rows back-filled post-sketch; screen tail %.2fs",
                scr.rows_at_first_dispatch, n, len(late), _dt_tail,
            )
        logger.info("Screen produced %d candidate pairs", len(res.pairs))
        cache = feeder.finish()
        self._report_indel_load(cache, sk_by_idx.__getitem__)
        return cache

    # -- contig mode --
    def distances_contigs(
        self, genome_fasta_paths: Sequence[str], contig_names: Sequence[str]
    ) -> SortedPairDistanceCache:
        if self._pipeline_enabled(len(contig_names)):
            return self._distances_contigs_pipelined(
                genome_fasta_paths, contig_names
            )
        sketches = self.ctx.sketch_contigs(genome_fasta_paths)
        if [s.name for s in sketches] != list(contig_names):
            raise ValueError(
                "Contig names passed to distances_contigs do not match file contents"
            )
        return self._screen_and_verify(sketches)

    # -- reference-genome (rectangular) mode --
    def distances_with_references(
        self, genome_fasta_paths: Sequence[str], reference_genomes: Sequence[str]
    ) -> SortedPairDistanceCache:
        """Cross-group comparisons only (src/skani.rs:502-687): members
        of `genome_fasta_paths` that are references are compared against
        nothing within their own group."""
        sketches = self.ctx.sketch_many(genome_fasta_paths)
        self._warn_checkpoint_unsupported("reference-genome rectangle")
        ref_set = set(reference_genomes)
        ref_idx = [i for i, p in enumerate(genome_fasta_paths) if p in ref_set]
        query_idx = [i for i, p in enumerate(genome_fasta_paths) if p not in ref_set]
        if not ref_idx or not query_idx:
            return SortedPairDistanceCache()
        min_cont = _screen_min_containment(
            self.threshold, self.min_aligned_threshold, self.ctx.params.k
        )
        import jax as _jax
        import os as _os

        explicit_backend = _os.environ.get("GALAH_TPU_SCREEN")
        if (
            explicit_backend is None
            and _jax.device_count() > 1
            and not self.ctx.low_memory
        ):
            # Mesh-sharded query-block x ref-block tile sweep (SURVEY
            # P9): the rectangle scales with devices/hosts exactly like
            # the triangle — only sparse results leave a device.
            from galah_tpu.ops.prefilter import pack_indicator
            from galah_tpu.parallel.distance import (
                sharded_screen_rectangle_packed,
            )

            bits = self.ctx.params.prefilter_bits
            logger.info(
                "Reference-mode screening on %d devices "
                "(sharded rectangle sweep)", _jax.device_count(),
            )
            res = sharded_screen_rectangle_packed(
                [pack_indicator(sketches[i].prefilter_buckets, bits)
                 for i in query_idx],
                np.asarray([sketches[i].n_prefilter for i in query_idx]),
                [pack_indicator(sketches[i].prefilter_buckets, bits)
                 for i in ref_idx],
                np.asarray([sketches[i].n_prefilter for i in ref_idx]),
                self.ctx.params.k,
                min_cont,
                bits,
            )
        elif _screen_backend() == "indicator":
            res = screen_rectangle(
                [sketches[i].prefilter_indicator() for i in query_idx],
                np.asarray([sketches[i].n_prefilter for i in query_idx]),
                [sketches[i].prefilter_indicator() for i in ref_idx],
                np.asarray([sketches[i].n_prefilter for i in ref_idx]),
                self.ctx.params.k,
                min_cont,
            )
        else:
            from galah_tpu.ops.prefilter import pack_indicator
            from galah_tpu.ops.prefilter import screen_rectangle_packed

            bits = self.ctx.params.prefilter_bits
            res = screen_rectangle_packed(
                [pack_indicator(sketches[i].prefilter_buckets, bits) for i in query_idx],
                np.asarray([sketches[i].n_prefilter for i in query_idx]),
                [pack_indicator(sketches[i].prefilter_buckets, bits) for i in ref_idx],
                np.asarray([sketches[i].n_prefilter for i in ref_idx]),
                self.ctx.params.k,
                min_cont,
                bits,
                cache_blocks=not self.ctx.low_memory,
            )
        if len(res.pairs) == 0:
            return SortedPairDistanceCache()
        remapped = np.stack(
            [
                np.asarray(query_idx, dtype=np.int64)[res.pairs[:, 0]],
                np.asarray(ref_idx, dtype=np.int64)[res.pairs[:, 1]],
            ],
            axis=1,
        )
        cache = self._verify_pairs(
            sketches, remapped, self.threshold, self.min_aligned_threshold
        )
        self._report_indel_load(cache, lambda i: sketches[i])
        return cache

    def method_name(self) -> str:
        return "native"

    def _warn_checkpoint_unsupported(self, path_name: str) -> None:
        if getattr(self, "sweep_checkpoint", None):
            logger.warning(
                "--sweep-checkpoint only applies to the single-device "
                "resident packed screen; the %s path will NOT "
                "checkpoint mid-sweep (the between-phase caches, "
                "--output-distance-cache and the sketch store, still "
                "apply)", path_name,
            )

    def _screen_and_verify(
        self, sketches: Sequence[NativeSketch]
    ) -> SortedPairDistanceCache:
        import jax

        k = self.ctx.params.k
        n = len(sketches)
        logger.info("Screening %d sketches all-vs-all ..", n)
        min_cont = _screen_min_containment(
            self.threshold, self.min_aligned_threshold, k
        )
        import os as _os
        import time as _time

        _t0 = _time.perf_counter()
        explicit_backend = _os.environ.get("GALAH_TPU_SCREEN")
        if (
            explicit_backend is None
            and jax.device_count() > 1
            and self.ctx.low_memory
        ):
            # SURVEY P8: the distributed case IS the low-memory case.
            # The row-sharded sweep pins only n/n_dev rows per device,
            # and rows materialize lazily from the disk sketch store
            # (the role of skani's sketch-then-stream search,
            # src/skani.rs:229-377) — the host never assembles the full
            # packed matrix and only sparse hits return.
            from galah_tpu.parallel.distance import (
                sharded_screen_triangle_rowsharded,
            )

            self._warn_checkpoint_unsupported("row-sharded low-memory")
            bits = self.ctx.params.prefilter_bits
            logger.info(
                "Screening on %d devices (row-sharded sweep fed from "
                "the low-memory sketch store)",
                jax.device_count(),
            )
            res = sharded_screen_triangle_rowsharded(
                _LazyPackedRows(sketches, bits),
                np.asarray([s.n_prefilter for s in sketches]),
                k,
                min_cont,
                bits,
            )
        elif (
            explicit_backend is None
            and jax.device_count() > 1
        ):
            # Mesh-sharded tiled sweep: the packed matrix is resident on
            # every device and the tile list is sharded — only sparse
            # above-cutoff results leave a device (no n^2 anywhere).
            from galah_tpu.parallel.distance import (
                sharded_screen_triangle_packed,
            )

            bits = self.ctx.params.prefilter_bits
            logger.info(
                "Screening on %d devices (sharded tile sweep)",
                jax.device_count(),
            )
            res = sharded_screen_triangle_packed(
                _LazyPackedRows(sketches, bits),
                np.asarray([s.n_prefilter for s in sketches]),
                k,
                min_cont,
                bits,
                checkpoint_path=getattr(self, "sweep_checkpoint", None),
                unit_names=[s.name for s in sketches],
            )
        elif _screen_backend() == "indicator":
            self._warn_checkpoint_unsupported("indicator")
            res = screen_triangle(
                _LazyIndicatorRows(sketches),
                np.asarray([s.n_prefilter for s in sketches]),
                k,
                min_cont,
                cache_blocks=not self.ctx.low_memory,
            )
        else:
            # Default: packed uint32 upload, on-device unpack, the
            # matmul (32x less host->device transfer than indicators).
            # Device-born sketch rows assemble the resident matrix
            # device-to-device (pref_matrix_builder) — zero re-upload.
            from galah_tpu.ops.prefilter import screen_triangle_packed

            bits = self.ctx.params.prefilter_bits
            sizes_arr = np.asarray([s.n_prefilter for s in sketches])
            res = screen_triangle_packed(
                _LazyPackedRows(sketches, bits),
                sizes_arr,
                k,
                min_cont,
                bits,
                cache_blocks=not self.ctx.low_memory,
                matrix_builder=(
                    None
                    if self.ctx.low_memory
                    else self.ctx.pref_matrix_builder(
                        sketches, sizes_arr.astype(np.float32)
                    )
                ),
                checkpoint_path=getattr(self, "sweep_checkpoint", None),
                unit_names=[s.name for s in sketches],
            )
        _dt = _time.perf_counter() - _t0
        m = metrics.current()
        m.phases["screen"] = m.phases.get("screen", 0.0) + _dt
        m.rate("screen_pairs_per_s", n * (n - 1) / 2, _dt)
        logger.info("Screen produced %d candidate pairs", len(res.pairs))
        if len(res.pairs) == 0:
            return SortedPairDistanceCache()
        cache = self._verify_pairs(
            sketches, res.pairs, self.threshold, self.min_aligned_threshold
        )
        self._report_indel_load(cache, lambda i: sketches[i])
        return cache


class NativeClusterer(ClusterDistanceFinder):
    def __init__(
        self,
        threshold: float,
        min_aligned_threshold: float,
        ctx: NativeContext,
        af_fail_result: Optional[float] = 0.0,
        ani_semantics: str = defaults.DEFAULT_ANI_SEMANTICS,
    ) -> None:
        """af_fail_result: value returned when the AF filter fails —
        0.0 for skani-compatible semantics (src/skani.rs:758-787), None
        for fastANI-compatible (src/fastani.rs:56-68). ani_semantics:
        see calibrated_ani_threshold."""
        self.threshold = calibrated_ani_threshold(
            threshold, ani_semantics, ctx.params.k
        )
        self.min_aligned_threshold = min_aligned_threshold
        self.ctx = ctx
        self.af_fail_result = af_fail_result

    def initialise(self) -> None:
        assert self.threshold > 1.0, "ANI threshold must be a percentage"

    def method_name(self) -> str:
        return "native"

    def get_ani_threshold(self) -> float:
        return self.threshold

    def calculate_ani(self, fasta1: str, fasta2: str) -> Optional[float]:
        return self.calculate_ani_batch([(fasta1, fasta2)])[0]

    def calculate_ani_batch(
        self, pairs: Sequence[Tuple[str, str]]
    ) -> List[Optional[float]]:
        """Pairs are (ref, query) paths; batches are grouped by shared
        query — the greedy core's many-to-one access pattern."""
        if not pairs:
            return []
        ctx = self.ctx
        sketches_by_key = {}
        key_pairs = []
        for ref, query in pairs:
            rs, qs = ctx.sketch(ref), ctx.sketch(query)
            kr, kq = ctx.key_for(rs), ctx.key_for(qs)
            sketches_by_key[kr] = rs
            sketches_by_key[kq] = qs
            key_pairs.append((kq, kr))
        res = ctx.frag_engine.bidirectional(key_pairs, sketches_by_key)
        out: List[Optional[float]] = []
        for kp in key_pairs:
            ani, af_f, af_r = res[kp]
            if max(af_f, af_r) >= self.min_aligned_threshold:
                out.append(float(np.float32(ani)))
            else:
                out.append(self.af_fail_result)
        return out
