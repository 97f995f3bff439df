"""Hartley-domain multi-head attention (HartleyMHA, MICCAI 2023).

Re-design of the reference ``HartleyMultiHeadAttention``
(``nets/hartley_mha.py:18-524``): self/cross attention computed on the
packed corner spectrum of the Hartley transform. Spectral projections and
the attention contractions are plain einsums; the forward/inverse
transforms use the pruned matmul chains of :mod:`.spectral`.

Behavioral contract preserved:
  * per-head spectral 1x1 projections on the kept modes (``freq_conv``);
  * optional patch *grouping* in frequency space: prod(patch) neighboring
    frequency pixels fold into channels before attention
    (``nets/hartley_mha.py:421-524``), with the same (c, pd, ph, pw)
    channel packing order;
  * attention activation is configurable and defaults to SELU — not
    softmax (``nets/hartley_mha.py:196-199``);
  * 1, 2 or 3 inputs give self / shared-kv / full cross attention.

Layout: channels-last (B, *spatial, C).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from .. import nn
from . import initializers as inits
from .activations import get_activation
from .spectral import _prec, dht_crop, dht_pad_inverse, normalize_modes

__all__ = ["HartleyMultiHeadAttention"]


def _grouping(x: jax.Array, patch: Sequence[int]) -> jax.Array:
    """(B, *sp, Z, C) -> (B, *sp/patch, Z, C*prod(patch)).

    Channel packing order matches reference ``grouping3d``
    (``nets/hartley_mha.py:473-498``): c slowest, then patch indices in
    axis order.
    """
    nd = len(patch)
    b = x.shape[0]
    sp = x.shape[1:1 + nd]
    z, c = x.shape[-2], x.shape[-1]
    nums = []
    shape = [b]
    for s, p in zip(sp, patch):
        assert s % p == 0, f"spatial size {s} not divisible by patch {p}"
        nums.append(s // p)
        shape += [s // p, p]
    shape += [z, c]
    x = x.reshape(shape)
    # (b, n0, p0, n1, p1, ..., z, c) -> (b, n0, n1, ..., z, c, p0, p1, ...)
    perm = ([0] + [1 + 2 * i for i in range(nd)] + [1 + 2 * nd, 2 + 2 * nd]
            + [2 + 2 * i for i in range(nd)])
    x = x.transpose(perm)
    return x.reshape([b] + nums + [z, c * int(np.prod(patch))])


def _ungrouping(x: jax.Array, num_channels: int,
                patch: Sequence[int]) -> jax.Array:
    """Inverse of `_grouping`."""
    nd = len(patch)
    b = x.shape[0]
    nums = x.shape[1:1 + nd]
    z = x.shape[-2]
    shape = [b] + list(nums) + [z, num_channels] + list(patch)
    x = x.reshape(shape)
    # (b, n0.., z, c, p0..) -> (b, n0, p0, n1, p1, .., z, c)
    perm = [0]
    for i in range(nd):
        perm += [1 + i, 3 + nd + i]
    perm += [1 + nd, 2 + nd]
    x = x.transpose(perm)
    out_sp = [n * p for n, p in zip(nums, patch)]
    return x.reshape([b] + out_sp + [z, num_channels])


class HartleyMultiHeadAttention(nn.Module):
    """Multi-head attention in the Hartley frequency domain.

    Args mirror the reference (``nets/hartley_mha.py:49-128``); ``num_modes``
    must satisfy 2*m <= spatial size and be divisible by ``patch_size``.
    """
    in_channels: int
    key_dim: int
    num_heads: int
    num_modes: Union[int, Sequence[int]]
    patch_size: Optional[Union[int, Sequence[int]]] = None
    attention_activation: Optional[Union[str, Callable]] = "selu"
    value_dim: Optional[int] = None
    key_in_channels: Optional[int] = None
    value_in_channels: Optional[int] = None
    use_bias: bool = False
    use_transform: bool = True
    snn_init: bool = False
    precision: Optional[jax.lax.Precision] = None

    @nn.compact
    def __call__(self, inputs):
        if not isinstance(inputs, (tuple, list)):
            q_in = k_in = v_in = inputs
        elif len(inputs) == 2:
            q_in, k_in = inputs[0], inputs[1]
            v_in = k_in
        elif len(inputs) == 3:
            q_in, k_in, v_in = inputs
        else:
            raise ValueError("Invalid inputs.")

        nd = q_in.ndim - 2
        modes = normalize_modes(self.num_modes, nd)
        patch = None
        if self.patch_size is not None:
            patch = normalize_modes(self.patch_size, nd)

        value_dim = self.value_dim or self.key_dim
        key_in_channels = self.key_in_channels or self.in_channels
        value_in_channels = self.value_in_channels or key_in_channels

        def proj_param(name, out_dim, in_dim):
            # torch fan-in of a (heads, out, in) tensor is
            # size(1) * prod(size(2:)) = out_dim * in_dim (the reference
            # kaiming_uniform_'s these 3-D tensors directly,
            # ``nets/hartley_mha.py:92-98,126``)
            fan_in = out_dim * in_dim
            init = (inits.kaiming_normal_linear(fan_in) if self.snn_init
                    else inits.kaiming_uniform_a5(fan_in))
            return self.param(name, init, (self.num_heads, out_dim, in_dim))

        w_query = proj_param("weight_query", self.key_dim, self.in_channels)
        w_key = proj_param("weight_key", self.key_dim, key_in_channels)
        w_value = proj_param("weight_value", value_dim, value_in_channels)
        fan_out = value_dim * self.num_heads
        out_init = (inits.kaiming_normal_linear(fan_out) if self.snn_init
                    else inits.kaiming_uniform_a5(fan_out))
        w_out = self.param("weight_out", out_init, (value_dim, fan_out))

        biases = {}
        if self.use_bias:
            b_init = (inits.snn_bias() if self.snn_init
                      else inits.zeros_init())
            biases["query"] = self.param("bias_query", b_init,
                                         (self.num_heads, self.key_dim))
            biases["key"] = self.param("bias_key", b_init,
                                       (self.num_heads, self.key_dim))
            biases["value"] = self.param("bias_value", b_init,
                                         (self.num_heads, value_dim))
            biases["out"] = self.param("bias_out", b_init, (value_dim,))

        # 'mixed' mode: spectra ride fp32 (dht_crop promotes), weights cast
        # to the island dtype, only the volume-scale inverse drops back
        from .spectral import _isl
        prec = (self.precision if self.precision is not None
                else _prec(_isl(q_in.dtype)))

        if self.use_transform:
            sizes = q_in.shape[1:-1]
            assert all(s >= 2 * m for s, m in zip(sizes, modes)), (
                f"spatial sizes {sizes} must be >= 2 * modes {modes}")
            query = dht_crop(q_in, modes)
            key = query if k_in is q_in else dht_crop(k_in, modes)
            value = key if v_in is k_in else dht_crop(v_in, modes)
        else:
            sizes = None
            query, key, value = q_in, k_in, v_in

        # Per-head spectral projections: (B, *sp, I) -> (B, *sp, Z, O)
        def freq_conv(w, x):
            return jnp.einsum("...i,zoi->...zo", x, w.astype(x.dtype),
                              precision=prec)

        query = freq_conv(w_query, query)
        key = freq_conv(w_key, key)
        value = freq_conv(w_value, value)

        if self.use_bias:
            query = query + biases["query"].astype(query.dtype)
            key = key + biases["key"].astype(key.dtype)
            value = value + biases["value"].astype(value.dtype)

        if patch is not None:
            query = _grouping(query, patch)
            key = _grouping(key, patch)
            value = _grouping(value, patch)

        sp_freq = query.shape[1:-2]
        z = self.num_heads

        def flat(x):
            return x.reshape(x.shape[0], int(np.prod(x.shape[1:-2])),
                             x.shape[-2], x.shape[-1])

        q, k, v = flat(query), flat(key), flat(value)

        att = jnp.einsum("bqzc,bkzc->bzqk", q, k, precision=prec)
        att = att / math.sqrt(k.shape[-1])
        act = get_activation(self.attention_activation)
        if act is not None:
            att = act(att)

        out = jnp.einsum("bzqk,bkzc->bqzc", att, v, precision=prec)
        out = out.reshape((out.shape[0],) + sp_freq
                          + (z, out.shape[-1]))

        if patch is not None:
            out = _ungrouping(out, value_dim, patch)

        # Merge heads (z slowest) and apply the output projection.
        out = out.reshape(out.shape[:-2] + (z * value_dim,))
        out = jnp.einsum("...i,oi->...o", out, w_out.astype(out.dtype),
                         precision=prec)
        if self.use_bias:
            out = out + biases["out"].astype(out.dtype)

        if self.use_transform:
            out = dht_pad_inverse(out, sizes).astype(q_in.dtype)
        return out
