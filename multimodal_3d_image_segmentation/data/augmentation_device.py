"""On-device (jitted) random affine augmentation.

Device-side alternative to the host-side :class:`.augmentation.ImageTransform`
for input pipelines that are host-CPU bound: the same rotation / shift /
zoom / flip model evaluated inside the jitted train step. Semantics match
the host version exactly for a *given* transform matrix (same (x, y, z)
matrix conventions, center offset at size/2 + 0.5, ITK half-up rounding and
[-0.5, n-0.5) inside test — verified by tests); the random draws use
``jax.random`` and are therefore equivalent in distribution, not bit-equal
to the numpy stream.

Random flips are folded into the affine matrix (a reflection about the
center), so the whole augmentation is one gather.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["affine_nn_device", "make_device_augment"]


def affine_nn_device(x: jax.Array, matrix: jax.Array, offset: jax.Array,
                     cval: float = 0.0) -> jax.Array:
    """Nearest-neighbor affine resample of a channel-first (C, *spatial)
    array: out[i] = x[round(matrix @ i + offset)] in zyx index coordinates,
    ITK conventions (round half up; [-0.5, n-0.5) is inside)."""
    nd = x.ndim - 1
    spatial = x.shape[1:]
    grid = jnp.stack(jnp.meshgrid(
        *[jnp.arange(s, dtype=jnp.float32) for s in spatial],
        indexing="ij")).reshape(nd, -1)
    src = matrix.astype(jnp.float32) @ grid + offset[:, None].astype(
        jnp.float32)
    si = jnp.floor(src + 0.5).astype(jnp.int32)
    inside = jnp.ones(si.shape[1], dtype=bool)
    flat = jnp.zeros(si.shape[1], dtype=jnp.int32)
    for d in range(nd):
        inside &= (si[d] >= 0) & (si[d] < spatial[d])
        flat = flat * spatial[d] + jnp.clip(si[d], 0, spatial[d] - 1)
    vals = jnp.take(x.reshape(x.shape[0], -1), flat, axis=1)
    vals = jnp.where(inside[None, :], vals,
                     jnp.asarray(cval, x.dtype))
    return vals.reshape(x.shape)


def _center_offset_zyx(matrix_zyx, spatial):
    """Fold the size/2 + 0.5 center offset (host `transform_matrix_offset_
    center` semantics) into (A, t) for index coordinates."""
    center = jnp.asarray([s / 2.0 + 0.5 for s in spatial], jnp.float32)
    t = center - matrix_zyx @ center
    return matrix_zyx, t


def make_device_augment(rotation_range=None, shift_range=None,
                        zoom_range=None, flip=None, cval: float = 0.0,
                        augmentation_probability: float = 1.0):
    """Build ``augment(key, x, y) -> (x, y)`` for channel-first 3D batches
    (B, C, D, H, W) / (B, 1, D, H, W), jit-compatible.

    Args mirror :class:`.augmentation.ImageTransform` except ``seed``:
    randomness enters through the ``key`` argument (the train step derives
    it per step from the configured [augmentation] seed).
    """

    def sample_matrix(key, spatial):
        """Random (x, y, z) matrix composed like the host version, then
        permuted to zyx index coordinates with flips folded in."""
        keys = jax.random.split(key, 8)
        m = jnp.eye(3, dtype=jnp.float32)

        if rotation_range is not None:
            rots = jnp.asarray(rotation_range, jnp.float32) * jnp.pi / 180.0
            theta = jax.random.uniform(keys[0], (3,), minval=-1.0,
                                       maxval=1.0) * rots
            # reversed to (x, y, z) order, composed as in the host version
            t0, t1, t2 = theta[2], theta[1], theta[0]
            cd, sd = jnp.cos(t0), jnp.sin(t0)
            ch, sh = jnp.cos(t1), jnp.sin(t1)
            cw, sw = jnp.cos(t2), jnp.sin(t2)
            rot = jnp.array(
                [[ch * cw, -cd * sw + sd * sh * cw,
                  sd * sw + cd * sh * cw],
                 [ch * sw, cd * cw + sd * sh * sw,
                  -sd * cw + cd * sh * sw],
                 [-sh, sd * ch, cd * ch]])
            m = rot

        t_xyz = jnp.zeros(3, jnp.float32)
        if shift_range is not None:
            sizes_zyx = jnp.asarray(spatial, jnp.float32)
            sr = jnp.asarray(shift_range, jnp.float32)
            sh = jax.random.uniform(keys[1], (3,), minval=-1.0,
                                    maxval=1.0) * sr * sizes_zyx
            t_xyz = sh[::-1]  # (x, y, z)

        if zoom_range is not None:
            z = jax.random.uniform(keys[2], (), minval=zoom_range[0],
                                   maxval=zoom_range[1])
            m = z * m
            t_xyz = z * t_xyz

        # permute (x, y, z) -> (z, y, x) index coordinates
        perm = jnp.asarray([2, 1, 0])
        a_zyx = m[jnp.ix_(perm, perm)]
        t_zyx = t_xyz[::-1]

        # center offset first (size/2 + 0.5, host semantics) ...
        a_c, t_center = _center_offset_zyx(a_zyx, spatial)
        t_c = t_center + t_zyx

        # ... then fold random output-array flips (host applies them after
        # the resample): out'[i] = out[n-1-i] = in[A_c (S i + f) + t_c]
        # with S = diag(+-1), f = n-1 on flipped axes.
        if flip is not None:
            do = (jax.random.uniform(keys[3], (3,)) < 0.5) & \
                jnp.asarray([bool(f) for f in flip])
            sign = jnp.where(do, -1.0, 1.0)
            n1 = jnp.asarray([s - 1.0 for s in spatial], jnp.float32)
            f = jnp.where(do, n1, 0.0)
            t_c = t_c + a_c @ f
            a_c = a_c * sign[None, :]
        return a_c, t_c

    def augment_one(key, x, y):
        spatial = x.shape[1:]
        k_gate, k_mat = jax.random.split(key)
        a, t = sample_matrix(k_mat, spatial)
        gate = jax.random.uniform(k_gate, ()) < augmentation_probability
        ident = (jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32))
        a = jnp.where(gate, a, ident[0])
        t = jnp.where(gate, t, ident[1])
        x2 = affine_nn_device(x, a, t, cval)
        y2 = affine_nn_device(y, a, t, cval)
        return x2, y2

    def augment(key, x, y):
        """x (B, C, *sp), y (B, 1, *sp)."""
        keys = jax.random.split(key, x.shape[0])
        return jax.vmap(augment_one)(keys, x, y)

    return augment
