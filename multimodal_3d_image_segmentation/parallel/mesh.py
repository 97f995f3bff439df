"""Device mesh + sharding utilities.

The reference is strictly single-GPU (``experiments/run.py:39``); this
module adds the parallelism of the rebuild:

  * ``data`` axis — batch data-parallelism (gradients psum'd by XLA).
  * ``spatial`` axis — sharding of one volume's spatial extent across
    devices, for single-volume latency and volumes larger than one
    device's memory. The pruned spectral transforms contract the sharded
    spatial axis with a dense DFT matrix, so XLA's SPMD partitioner lowers
    them to matmul + reduce-scatter/all-reduce automatically — a
    distributed 3D spectral transform with no hand-written collectives.
    Convolutions over the sharded axis get halo exchanges from SPMD.

The mesh is a plain reshape of ``jax.devices()``: the cards of one host
reach each other at the same rate, so no axis order is preferred.

Everything is expressed with ``jax.sharding`` (Mesh/NamedSharding/
PartitionSpec) + jit; no hand-rolled NCCL-style code.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "batch_sharding", "volume_sharding",
           "replicated", "DATA_AXIS", "SPATIAL_AXIS"]

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Create a 2D (data, spatial) mesh.

    Args:
        n_data: size of the data axis; defaults to n_devices // n_spatial.
        n_spatial: size of the spatial (volume-sharding) axis.
        devices: devices to use (default: all local devices).
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        assert len(devices) % n_spatial == 0
        n_data = len(devices) // n_spatial
    assert n_data * n_spatial <= len(devices), (
        f"requested {n_data}x{n_spatial} mesh but only "
        f"{len(devices)} devices")
    grid = np.array(devices[: n_data * n_spatial]).reshape(
        n_data, n_spatial)
    return Mesh(grid, (DATA_AXIS, SPATIAL_AXIS))


def batch_sharding(mesh: Mesh, shape, spatial_axis: Optional[int] = None
                   ) -> NamedSharding:
    """Sharding for a channel-first batch (B, C, *spatial): batch over
    ``data``; optionally one spatial axis over ``spatial``.

    ``shape`` may be the array shape (divisibility-aware: axes that do not
    divide evenly stay replicated, e.g. batch 1 with a data axis) or, for
    backward compatibility, an int ndim (assumes divisibility).

    ``spatial_axis`` indexes into the spatial dims (0 = D). Default: the
    first spatial axis whose extent divides the mesh's spatial size
    (preferring H — a large, power-of-two-friendly extent in BraTS).
    """
    if isinstance(shape, int):
        ndim = shape
        shape = None
    else:
        shape = tuple(shape)
        ndim = len(shape)

    spec = [None] * ndim
    n_data = mesh.shape[DATA_AXIS]
    if n_data > 1 and (shape is None or shape[0] % n_data == 0):
        spec[0] = DATA_AXIS

    n_sp = mesh.shape[SPATIAL_AXIS]
    if n_sp > 1:
        candidates = ([spatial_axis] if spatial_axis is not None
                      else ([1, 0, 2] if ndim >= 5 else [0, 1]))
        for cand in candidates:
            if 2 + cand >= ndim:
                continue
            if shape is None or shape[2 + cand] % n_sp == 0:
                spec[2 + cand] = SPATIAL_AXIS
                break
    return NamedSharding(mesh, P(*spec))


def volume_sharding(mesh: Mesh, ndim_or_shape, spatial_axis: int = 1
                    ) -> NamedSharding:
    """Sharding for single-volume inference: all devices along one spatial
    axis (both mesh axes flattened onto it when batch == 1).

    Like ``batch_sharding``, divisibility-aware when given a shape tuple:
    if the chosen spatial extent does not divide the device count, the
    volume stays replicated (graceful, matching the training path) rather
    than raising mid-test-loop. An int ``ndim`` assumes divisibility."""
    if isinstance(ndim_or_shape, int):
        ndim, shape = ndim_or_shape, None
    else:
        shape = tuple(ndim_or_shape)
        ndim = len(shape)
    n_total = mesh.shape[DATA_AXIS] * mesh.shape[SPATIAL_AXIS]
    spec = [None] * ndim
    if (shape is not None and n_total > 1
            and shape[2 + spatial_axis] % n_total != 0):
        return NamedSharding(mesh, P())  # replicate: extent not divisible
    if mesh.shape[DATA_AXIS] > 1 and mesh.shape[SPATIAL_AXIS] > 1:
        spec[2 + spatial_axis] = (DATA_AXIS, SPATIAL_AXIS)
    elif mesh.shape[SPATIAL_AXIS] > 1:
        spec[2 + spatial_axis] = SPATIAL_AXIS
    elif mesh.shape[DATA_AXIS] > 1:
        spec[2 + spatial_axis] = DATA_AXIS
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
