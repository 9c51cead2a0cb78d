"""Device mesh construction.

The reference's only parallelism is a rayon thread pool
(src/cluster_argument_parsing.rs:557-561); the device equivalent is a
jax.sharding.Mesh over the available devices. One logical axis "rows"
shards genomes (data parallel); an optional second axis "buckets"
shards the sketch indicator width (tensor parallel analog), with
intersection counts psum-reduced across it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed for multi-process runs. Pass the
    coordinator address (e.g. localhost:<port>), process count and
    process id explicitly. Call once per process before any other
    JAX operation; `make_mesh()` then sees every host's devices."""
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def make_mesh(
    devices: Optional[Sequence] = None,
    bucket_axis: int = 1,
) -> Mesh:
    """1D ("rows") or 2D ("rows", "buckets") mesh over devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if bucket_axis > 1:
        if n % bucket_axis != 0:
            raise ValueError(f"{n} devices not divisible by bucket_axis={bucket_axis}")
        arr = np.asarray(devices).reshape(n // bucket_axis, bucket_axis)
        return Mesh(arr, ("rows", "buckets"))
    return Mesh(np.asarray(devices), ("rows",))


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0) -> Tuple[np.ndarray, int]:
    n = x.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x, n
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(x, pad_width), n
