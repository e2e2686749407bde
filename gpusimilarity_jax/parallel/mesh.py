"""Device mesh construction and memory accounting.

Replaces the reference's GPU enumeration / greedy placement layer
(``get_gpu_count`` / ``get_next_gpu`` / ``get_gpu_free_memory``,
``fingerprintdb_cuda.cu:33-68,401-413``). Here there is no per-device
placement loop: the fingerprint matrix is laid out once with a
``NamedSharding`` over a 1-D mesh and XLA moves the shards.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

SHARD_AXIS = "shards"


def device_count() -> int:
    return len(jax.devices())


def make_mesh(devices: Optional[Sequence[jax.Device]] = None, axis: str = SHARD_AXIS) -> Mesh:
    """1-D mesh over all local devices (library rows are sharded across it)."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def available_device_memory(devices: Optional[Sequence[jax.Device]] = None) -> Optional[int]:
    """Total free device memory in bytes, or None if the platform can't say.

    The analog of ``get_available_gpu_memory`` (``fingerprintdb_cuda.cu:
    401-413``), used to pick an automatic fold factor. GPU runtimes report
    ``bytes_limit``/``bytes_in_use`` via ``memory_stats`` (``bytes_limit``
    is the preallocated pool, ``XLA_PYTHON_CLIENT_MEM_FRACTION`` of the
    card); CPU returns None
    (no meaningful cap) and callers fall back to fold factor 1.
    """
    if devices is None:
        devices = jax.devices()
    total = 0
    n_remote = 0
    for d in devices:
        if d.process_index != jax.process_index():
            # memory_stats raises on non-addressable remote devices; their
            # HBM matches a local device's, so extrapolate below instead of
            # silently disabling the auto-fold in multi-host jobs
            n_remote += 1
            continue
        try:
            stats = d.memory_stats()
        except Exception:
            return None
        if not stats or "bytes_limit" not in stats:
            return None
        total += stats["bytes_limit"] - stats.get("bytes_in_use", 0)
    n_local = len(devices) - n_remote
    if n_local == 0:
        return None
    if n_remote:
        total += (total // n_local) * n_remote
    return total


def auto_fold_factor(
    db_bytes: int,
    devices: Optional[Sequence[jax.Device]] = None,
    reserve_fraction: float = 0.25,
) -> int:
    """Smallest fold factor that fits ``db_bytes`` into free device memory.

    Mirrors the reference's global fold decision (``gpusim.cpp:119-143``):
    ``ceil(total_db_bytes / usable_memory)``, where a fraction of memory is
    reserved for scores/indices/workspace (the reference reserves an
    index-array allowance).
    """
    free = available_device_memory(devices)
    if free is None or db_bytes == 0:
        return 1
    usable = int(free * (1.0 - reserve_fraction))
    if usable <= 0:
        raise MemoryError("no usable device memory for fingerprint data")
    return max(1, -(-db_bytes // usable))
