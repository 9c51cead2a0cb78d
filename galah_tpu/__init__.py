"""galah_tpu — an accelerator-native genome dereplication engine.

A from-scratch reimplementation of the capabilities of galah
(https://github.com/wwood/galah) that runs on an NVIDIA GPU: k-mer
sketching, all-vs-all sketch comparison and high-precision ANI run as
JAX/XLA kernels; the greedy quality-ordered clustering runs on host
over the sparse above-threshold pair list.

Public API mirrors the reference's five plugin interfaces
(reference: src/lib.rs:29-76) as Python ABCs in galah_tpu.engines.
"""

__version__ = "0.2.2"


def _tune_numpy_allocator() -> None:
    """Disable numpy's MADV_HUGEPAGE on kernels where it forces
    synchronous THP compaction on every fresh 2MB fault.

    numpy madvises MADV_HUGEPAGE for allocations beyond ~4MB. With
    /sys/kernel/mm/transparent_hugepage/defrag set to [always] or
    [madvise], each first touch of such a region can enter direct
    compaction; on some virtualized hosts this costs ~100ms+ PER 2MB
    PAGE (measured here: 11s to first-touch a 100MB array vs 0.05s
    without the madvise — a 200x tax on every large buffer). Huge pages
    buy TLB hits worth a few percent; they never buy back a 200x fault
    stall, so turn the madvise off when faults would compact
    synchronously. GALAH_TPU_HUGEPAGES=1 forces it back on.
    """
    import os

    if os.environ.get("GALAH_TPU_HUGEPAGES") == "1":
        return
    try:
        with open("/sys/kernel/mm/transparent_hugepage/defrag") as f:
            defrag = f.read()
        if "[always]" not in defrag and "[madvise]" not in defrag:
            return  # defer modes compact asynchronously; keep hugepages
        try:
            from numpy._core.multiarray import _set_madvise_hugepage
        except ImportError:  # numpy < 2
            from numpy.core.multiarray import _set_madvise_hugepage
        _set_madvise_hugepage(False)
    except Exception:
        pass  # non-Linux or numpy internals moved; leave defaults


_tune_numpy_allocator()

from galah_tpu import defaults  # noqa: F401,E402

__all__ = ["defaults", "__version__"]
