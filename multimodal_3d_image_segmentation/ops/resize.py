"""Spatial resampling with exact PyTorch semantics.

The reference uses ``torch.nn.functional.interpolate`` with
mode='bilinear'/'trilinear' (align_corners=False) for output upsampling
(``nets/hnosegxs.py:174-176``) and mode='nearest' for deep-supervision
upsampling (``nets/architectures.py:638-653``).

Linear interpolation is separable with exactly two taps per output sample.
Each axis is evaluated as ONE dense matmul against the (n_in, n_out)
two-tap interpolation matrix, which reads the input once and writes the
output once (a gather form would materialize the lo- and hi-neighbor
copies of the upsampled tensor per axis). Whether the matmul or a gather
form is faster on the GPU is not measured yet. Accumulating the zero taps
adds exactly 0.0 in fp, and the matmuls run at HIGHEST precision with
fp32 weights, so results match the two-tap gather form
(``lo + (hi-lo)*w``) to within rounding (parity tests bound the gap at
<=3e-4 against PyTorch fp32). Index semantics are exact:

  * linear, align_corners=False: src = (dst + 0.5) * in/out - 0.5, clamped.
  * nearest: src = floor(dst * in / out).
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["resize_linear", "resize_nearest"]


@functools.lru_cache(maxsize=None)
def _linear_taps_np(n_in: int, n_out: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lo_idx, hi_idx, hi_weight) per output sample, half-pixel centers."""
    dst = np.arange(n_out)
    src = (dst + 0.5) * (n_in / n_out) - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    w_hi = (src - lo).astype(np.float32)
    return lo, hi, w_hi


@functools.lru_cache(maxsize=None)
def _linear_matrix_np(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_in, n_out) two-tap interpolation matrix.

    At a clamped endpoint ``hi == lo`` and ``w_hi == 0`` exactly (the
    source coordinate was clipped onto the grid point), so the summed
    row weight is exactly 1.0 with no cancellation."""
    lo, hi, w_hi = _linear_taps_np(n_in, n_out)
    m = np.zeros((n_in, n_out), np.float32)
    cols = np.arange(n_out)
    np.add.at(m, (lo, cols), 1.0 - w_hi)
    np.add.at(m, (hi, cols), w_hi)
    return m


def _axis_matmul(x: jax.Array, mat_np: np.ndarray, ax: int) -> jax.Array:
    """Contract axis ``ax`` of ``x`` with ``mat_np`` (n_in, n_out), output
    axis in place. fp32 weights + HIGHEST precision keep the two-tap
    sum fp32-exact; bf16 inputs gain fp32 accumulation over the gather
    form."""
    letters = "abcdefghij"[:x.ndim]
    sub = f"{letters},{letters[ax]}z->{letters[:ax]}z{letters[ax + 1:]}"
    mat = jnp.asarray(mat_np)
    y = jnp.einsum(sub, x.astype(jnp.float32), mat,
                   precision=jax.lax.Precision.HIGHEST)
    return y.astype(x.dtype)


def resize_linear(x: jax.Array, sizes: Sequence[int],
                  channel_first: bool = False) -> jax.Array:
    """Bi/tri-linear resize of the spatial axes of (B, *spatial, C), or of
    (B, C, *spatial) with ``channel_first=True``."""
    axes = range(2, x.ndim) if channel_first else range(1, x.ndim - 1)
    for ax, n_out in zip(axes, sizes):
        n_in = x.shape[ax]
        n_out = int(n_out)
        if n_in == n_out:
            continue
        x = _axis_matmul(x, _linear_matrix_np(n_in, n_out), ax)
    return x


def resize_nearest(x: jax.Array, sizes: Sequence[int],
                   channel_first: bool = False) -> jax.Array:
    """Nearest-neighbor resize (floor indexing, PyTorch 'nearest')."""
    axes = range(2, x.ndim) if channel_first else range(1, x.ndim - 1)
    for ax, n_out in zip(axes, sizes):
        n_in = x.shape[ax]
        if n_in == n_out:
            continue
        idx = np.floor(np.arange(n_out) * (n_in / n_out)).astype(np.int64)
        idx = np.minimum(idx, n_in - 1)
        x = jnp.take(x, idx, axis=ax)
    return x
