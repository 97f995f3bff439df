"""Multi-host (multi-process) scale-out.

The reference is single-process/single-GPU; this module adds the
multi-host path: each host runs the same program, JAX's distributed
runtime wires the hosts together, and global arrays are assembled from
per-host local shards.

Typical use (one process per host):

    from multimodal_3d_image_segmentation.parallel import multihost
    multihost.initialize("host0:1234", num_processes=2, process_id=0)
    mesh = make_mesh(n_data=jax.device_count())
    batch = multihost.global_batch(mesh, local_x)   # per-host data loading

Design: hosts load disjoint sample subsets (shard the data lists by
``jax.process_index()``), build process-local arrays, and lift them into
jit-visible global arrays with ``jax.make_array_from_process_local_data``.
Collectives are inserted by XLA from the sharding annotations (NCCL on
GPUs).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import DATA_AXIS

__all__ = ["initialize", "is_multihost", "process_count", "process_index",
           "shard_list_for_process", "global_batch"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize the JAX distributed runtime (no-op if single process).

    Pass coordinator_address='host:port', num_processes and process_id
    (a cluster manager JAX recognizes may supply them instead).
    """
    if num_processes is not None and num_processes <= 1:
        return
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError as e:
        # 'distributed.initialize should only be called once' is benign;
        # anything else (and any ValueError from a missing coordinator
        # address etc.) must propagate — swallowing it would silently run
        # N independent single-host processes with no gradient sync
        if "only be called once" not in str(e):
            raise


def is_multihost() -> bool:
    return jax.process_count() > 1


def process_count() -> int:
    return jax.process_count()


def process_index() -> int:
    return jax.process_index()


def shard_list_for_process(items: Sequence, process: Optional[int] = None,
                           n_processes: Optional[int] = None):
    """Deterministically shard a sample list across hosts (round-robin, so
    epoch sizes stay balanced within one sample)."""
    p = jax.process_index() if process is None else process
    n = jax.process_count() if n_processes is None else n_processes
    return list(items)[p::n]


def global_batch(mesh: Mesh, local_array: np.ndarray,
                 spec: Optional[P] = None) -> jax.Array:
    """Lift a process-local numpy batch into a global jit-visible array
    sharded over the mesh's data axis."""
    if spec is None:
        spec = P(DATA_AXIS)
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(sharding, local_array)
