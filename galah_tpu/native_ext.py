"""ctypes bindings for the C++ fastaio library.

The library is built from native/fastaio.cpp at first use (`make -C
native`, into a temporary name renamed into place, so concurrent
first users never load a half-written file). It is optional: every
entry point has a numpy fallback with identical semantics (tests
assert parity), used when the build fails. Set GALAH_TPU_NO_NATIVE=1 to
force the numpy path.
"""

from __future__ import annotations

import ctypes
import logging
import os
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)

_LIB = None
_TRIED = False


NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)
LIB_NAME = "libfastaio.so"


def _build_library() -> Optional[str]:
    """Build native/libfastaio.so from the committed sources; returns
    its path, or None when the build fails (no compiler, no zlib)."""
    import subprocess
    import threading

    target = os.path.join(NATIVE_DIR, LIB_NAME)
    tmp = f"{LIB_NAME}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        proc = subprocess.run(
            ["make", "-C", NATIVE_DIR, "--no-print-directory",
             f"OUT={tmp}"],
            capture_output=True, text=True,
        )
    except OSError as e:
        logger.warning("cannot build the native library: %s", e)
        return None
    if proc.returncode != 0:
        logger.warning(
            "native library build failed; using the numpy fallback:\n%s",
            proc.stderr[-2000:],
        )
        return None
    os.replace(os.path.join(NATIVE_DIR, tmp), target)
    return target


def _find_library() -> Optional[str]:
    path = os.path.join(NATIVE_DIR, LIB_NAME)
    if os.path.exists(path):
        return path
    if os.path.exists(os.path.join(NATIVE_DIR, "fastaio.cpp")):
        return _build_library()
    return None


def get_lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("GALAH_TPU_NO_NATIVE"):
        return None
    path = _find_library()
    if path is None:
        logger.debug("native fastaio library not found; using numpy fallback")
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        logger.warning("failed to load %s: %s", path, e)
        return None

    try:
        _bind_signatures(lib)
    except AttributeError as e:
        # A stale library missing newer symbols must degrade to the
        # numpy fallback, not break available().
        logger.warning("stale native library %s (%s); rebuild with "
                       "`make -C native`. Using numpy fallback.", path, e)
        return None
    _LIB = lib
    logger.debug("loaded native fastaio from %s", path)
    return _LIB


def _bind_signatures(lib) -> None:
    lib.gt_open.restype = ctypes.c_void_p
    lib.gt_open.argtypes = [ctypes.c_char_p]
    lib.gt_error.restype = ctypes.c_char_p
    lib.gt_error.argtypes = [ctypes.c_void_p]
    lib.gt_close.argtypes = [ctypes.c_void_p]
    lib.gt_num_records.restype = ctypes.c_int64
    lib.gt_num_records.argtypes = [ctypes.c_void_p]
    lib.gt_record_name.restype = ctypes.c_char_p
    lib.gt_record_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.gt_record_seq_len.restype = ctypes.c_int64
    lib.gt_record_seq_len.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.gt_record_seq_copy.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
    ]
    lib.gt_genome_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)
    ]
    lib.gt_native_sketch.restype = ctypes.c_int64
    lib.gt_native_sketch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
    ]
    lib.gt_sketch_sizes.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    ]
    lib.gt_sketch_copy.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.gt_sketch_bulk_sizes.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)
    ]
    lib.gt_sketch_bulk_copy.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.gt_mash_sketch.restype = ctypes.c_int64
    lib.gt_mash_sketch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32,
    ]
    lib.gt_mash_copy.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
    lib.gt_murmur3_x64_128_low.restype = ctypes.c_uint64
    lib.gt_murmur3_x64_128_low.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32,
    ]


def available() -> bool:
    return get_lib() is not None


class NativeFasta:
    """RAII wrapper over a parsed FASTA handle."""

    def __init__(self, path: str) -> None:
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native fastaio library not available")
        self.lib = lib
        self.handle = lib.gt_open(path.encode())
        err = lib.gt_error(self.handle)
        if err:
            msg = err.decode()
            lib.gt_close(self.handle)
            self.handle = None
            raise IOError(msg)

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.gt_close(self.handle)
            self.handle = None

    def num_records(self) -> int:
        return self.lib.gt_num_records(self.handle)

    def name(self, i: int) -> str:
        return self.lib.gt_record_name(self.handle, i).decode(
            "utf-8", errors="replace"
        )

    def seq(self, i: int) -> bytes:
        n = self.lib.gt_record_seq_len(self.handle, i)
        buf = ctypes.create_string_buffer(n)
        self.lib.gt_record_seq_copy(self.handle, i, buf)
        return buf.raw

    def genome_stats(self):
        out = (ctypes.c_int64 * 3)()
        self.lib.gt_genome_stats(self.handle, out)
        return int(out[0]), int(out[1]), int(out[2])

    def native_sketch(self, mode: int, params, threads: int = 1) -> List[dict]:
        """mode 0: whole genome; mode 1: per contig (sketched in
        parallel across `threads` host threads). Returns raw sketch
        arrays per unit."""
        n = self.lib.gt_native_sketch(
            self.handle,
            mode,
            params.k,
            int(params.genome_threshold),
            int(params.fragment_threshold),
            params.fragment_length,
            params.min_fragment_length,
            params.member_bits - 1,
            params.prefilter_bits - 1,
            max(1, int(threads)),
        )
        if n < 0:
            raise ValueError(
                "native sketcher requires member_bits and prefilter_bits "
                "<= 2**31 (int31 bucket storage)"
            )
        # Bulk transfer: two ctypes calls total, then zero-copy numpy
        # views per sketch (200k per-sketch round trips cost ~12s on a
        # 100k-contig file; this path costs ~0.3s).
        totals = (ctypes.c_int64 * 4)()
        self.lib.gt_sketch_bulk_sizes(self.handle, totals)
        meta = np.empty((n, 5), dtype=np.int64)
        pref_all = np.empty(int(totals[0]), dtype=np.int32)
        member_all = np.empty(int(totals[1]), dtype=np.int32)
        fragb_all = np.empty(int(totals[2]), dtype=np.int32)
        frago_all = np.empty(int(totals[3]), dtype=np.int64)
        self.lib.gt_sketch_bulk_copy(
            self.handle,
            meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            pref_all.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            member_all.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            fragb_all.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            frago_all.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        ends = np.cumsum(meta[:, 1:], axis=0)
        starts = ends - meta[:, 1:]
        out = []
        for i in range(n):
            out.append(
                dict(
                    total_len=int(meta[i, 0]),
                    prefilter_buckets=pref_all[starts[i, 0]:ends[i, 0]],
                    member_buckets=member_all[starts[i, 1]:ends[i, 1]],
                    frag_buckets=fragb_all[starts[i, 2]:ends[i, 2]],
                    frag_offsets=frago_all[starts[i, 3]:ends[i, 3]],
                )
            )
        return out

    def mash_hashes(self, k: int, sketch_size: int, seed: int = 0) -> np.ndarray:
        n = self.lib.gt_mash_sketch(self.handle, k, sketch_size, seed)
        out = np.empty(n, dtype=np.uint64)
        self.lib.gt_mash_copy(
            self.handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
        )
        return out
