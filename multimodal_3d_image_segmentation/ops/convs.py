"""Convolution building blocks (channels-last, torch-parity semantics).

Covers the reference's ``ConvNormAct``/``ConvTransposeNormAct``
(``nets/nets_utils.py:136-211``) with identical shape arithmetic:
  * stride 1 -> 'same' padding;
  * stride s with kernel k -> symmetric padding k//2 per side
    (so k=2, s=2 maps size n -> n//2 + 1);
  * transposed conv: stride 2, padding k//2, output_padding 1
    (k=3 doubles the size exactly).

All convs run through ``lax.conv_general_dilated`` in NDHWC/NHWC layout
and use the reference's initializer scheme (default torch or SNN — see
:mod:`.initializers`).
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .. import nn
from . import initializers as inits
from .activations import get_activation, is_selu
from .spectral import _prec, channel_mix

__all__ = ["Conv", "ConvTranspose", "ConvNormAct", "ConvTransposeNormAct",
           "ConcatConvNormAct", "_SplitKernelConv1x1"]


def _tuple(v, nd: int) -> Tuple[int, ...]:
    if np.isscalar(v):
        return (int(v),) * nd
    assert len(v) == nd
    return tuple(int(t) for t in v)


def _dim_numbers(nd: int):
    sp = "DHW"[-nd:] if nd <= 3 else None
    assert sp is not None, "only 1-3 spatial dims supported"
    return (f"N{sp}C", f"{sp}IO", f"N{sp}C")


class Conv(nn.Module):
    """Plain convolution with torch-parity padding and init.

    Matches ``torch.nn.ConvNd(k, s, padding='same' if s==1 else k//2)`` as
    used throughout the reference models.
    """
    features: int
    kernel_size: Union[int, Sequence[int]] = 1
    strides: Union[int, Sequence[int]] = 1
    use_bias: bool = True
    snn_init: bool = False

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        nd = x.ndim - 2
        k = _tuple(self.kernel_size, nd)
        s = _tuple(self.strides, nd)
        in_features = x.shape[-1]
        fan_in = in_features * int(np.prod(k))

        w_init = (inits.kaiming_normal_linear(fan_in) if self.snn_init
                  else inits.kaiming_uniform_a5(fan_in))
        kernel = self.param("kernel", w_init, k + (in_features, self.features))

        if all(kk == 1 for kk in k) and all(st == 1 for st in s):
            # 1x1 convs as channel-mixing einsums
            mat = kernel.reshape(in_features, self.features)
            y = channel_mix(x, mat)
        else:
            if all(st == 1 for st in s):
                padding = "SAME"
            else:
                padding = [(kk // 2, kk // 2) for kk in k]
            # _prec honors the fp32 precision contract (HIGHEST unless the
            # serving config opts down)
            y = jax.lax.conv_general_dilated(
                x, kernel.astype(x.dtype),
                window_strides=s, padding=padding,
                dimension_numbers=_dim_numbers(nd),
                precision=_prec(x.dtype))

        if self.use_bias:
            b_init = (inits.snn_bias() if self.snn_init
                      else inits.torch_conv_bias(fan_in))
            bias = self.param("bias", b_init, (self.features,))
            y = y + bias.astype(y.dtype)
        return y


class ConvTranspose(nn.Module):
    """Transposed convolution with torch semantics: stride 2,
    padding = k//2, output_padding = 1 (reference
    ``nets/nets_utils.py:190-203``). k=3 doubles spatial size; k=2 gives
    2n - 1.
    """
    features: int
    kernel_size: Union[int, Sequence[int]] = 2
    use_bias: bool = True
    snn_init: bool = False

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        nd = x.ndim - 2
        k = _tuple(self.kernel_size, nd)
        stride = 2
        output_padding = 1
        in_features = x.shape[-1]
        # torch fan-in convention for ConvTranspose weights (in, out, *k):
        # fan_in = out_channels * prod(k)
        fan_in = self.features * int(np.prod(k))

        w_init = (inits.kaiming_normal_linear(fan_in) if self.snn_init
                  else inits.kaiming_uniform_a5(fan_in))
        kernel = self.param("kernel", w_init, k + (in_features, self.features))

        # Transposed conv == conv over the (stride-1)-dilated input with the
        # spatially flipped kernel and padding (k-1-p, k-1-p+output_padding).
        flipped = jnp.flip(kernel, axis=tuple(range(nd)))
        padding = [(kk - 1 - kk // 2, kk - 1 - kk // 2 + output_padding)
                   for kk in k]
        y = jax.lax.conv_general_dilated(
            x, flipped.astype(x.dtype),
            window_strides=(1,) * nd, padding=padding,
            lhs_dilation=(stride,) * nd,
            dimension_numbers=_dim_numbers(nd),
            precision=_prec(x.dtype))

        if self.use_bias:
            b_init = (inits.snn_bias() if self.snn_init
                      else inits.torch_conv_bias(fan_in))
            bias = self.param("bias", b_init, (self.features,))
            y = y + bias.astype(y.dtype)
        return y


class _SplitKernelConv1x1(nn.Module):
    """1x1 conv over a *virtual* concatenation of inputs.

    Holds one kernel of shape (1,..,1, sum(C_i), features) — identical
    parameters to a Conv applied to ``concatenate(inputs, -1)`` — but
    computes ``sum_i x_i @ K_i`` so the concatenated tensor is never
    materialized in device memory (the concats in the reference blocks are the
    widest tensors in the network).

    ``upsample_to``: when set, inputs may be at coarser resolutions; each
    part is nearest-upsampled to this spatial size AFTER its projection.
    Nearest resize is a voxel gather, so it commutes exactly with the
    per-voxel einsum — identical values to upsample-then-project, but the
    wide coarse tensors are projected to ``features`` channels first (the
    deep-supervision legs go from O(sum C_i) full-resolution traffic to
    O(features)).
    """
    features: int
    use_bias: bool = True
    snn_init: bool = False
    upsample_to: Union[Tuple[int, ...], None] = None

    @nn.compact
    def __call__(self, inputs) -> jax.Array:
        if not isinstance(inputs, (tuple, list)):
            inputs = (inputs,)
        nd = inputs[0].ndim - 2
        cins = [x.shape[-1] for x in inputs]
        fan_in = sum(cins)
        w_init = (inits.kaiming_normal_linear(fan_in) if self.snn_init
                  else inits.kaiming_uniform_a5(fan_in))
        kernel = self.param("kernel", w_init,
                            (1,) * nd + (fan_in, self.features))
        mat = kernel.reshape(fan_in, self.features)

        y = None
        off = 0
        for x, c in zip(inputs, cins):
            part = channel_mix(x, mat[off:off + c])
            if (self.upsample_to is not None
                    and part.shape[1:-1] != tuple(self.upsample_to)):
                from .resize import resize_nearest
                part = resize_nearest(part, self.upsample_to)
            y = part if y is None else y + part
            off += c

        if self.use_bias:
            b_init = (inits.snn_bias() if self.snn_init
                      else inits.torch_conv_bias(fan_in))
            bias = self.param("bias", b_init, (self.features,))
            y = y + bias.astype(y.dtype)
        return y


class ConcatConvNormAct(nn.Module):
    """ConvNormAct(kernel=1) over a virtual concat of inputs — numerically
    identical to ``ConvNormAct(...)(concatenate(inputs, -1))`` with the same
    parameter tree, without materializing the concat. ``upsample_to``
    additionally lets inputs arrive at coarser resolutions (deep-supervision
    legs): parts are projected first, then nearest-upsampled — exact."""
    features: int
    use_bias: bool = True
    activation: Union[str, None] = "selu"
    use_snn: bool = True
    upsample_to: Union[Tuple[int, ...], None] = None

    @nn.compact
    def __call__(self, inputs) -> jax.Array:
        if self.use_snn and not is_selu(self.activation):
            raise RuntimeError(
                "Self-normalizing neural network (SNN) must be used with SELU.")
        snn_init = self.use_snn and is_selu(self.activation)
        x = _SplitKernelConv1x1(self.features, use_bias=self.use_bias,
                                snn_init=snn_init,
                                upsample_to=self.upsample_to,
                                name="conv")(inputs)
        if not self.use_snn:
            x = nn.GroupNorm(num_groups=1, epsilon=1e-5, name="norm")(x)
        act = get_activation(self.activation)
        if act is not None:
            x = act(x)
        return x


class ConvNormAct(nn.Module):
    """Convolution + optional GroupNorm(1) + activation (reference
    ``nets/nets_utils.py:136-174``). With ``use_snn`` (the default) no
    normalization is applied and the activation must be SELU.
    """
    features: int
    kernel_size: Union[int, Sequence[int]] = 1
    strides: Union[int, Sequence[int]] = 1
    use_bias: bool = True
    activation: Union[str, None] = "selu"
    use_snn: bool = True

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        if self.use_snn and not is_selu(self.activation):
            raise RuntimeError(
                "Self-normalizing neural network (SNN) must be used with SELU.")
        snn_init = self.use_snn and is_selu(self.activation)
        x = Conv(self.features, self.kernel_size, self.strides,
                 use_bias=self.use_bias, snn_init=snn_init, name="conv")(x)
        if not self.use_snn:
            x = nn.GroupNorm(num_groups=1, epsilon=1e-5, name="norm")(x)
        act = get_activation(self.activation)
        if act is not None:
            x = act(x)
        return x


class ConvTransposeNormAct(nn.Module):
    """Transposed convolution + optional GroupNorm(1) + activation
    (reference ``nets/nets_utils.py:177-211``). Normalization is skipped
    for SELU (self-normalizing)."""
    features: int
    kernel_size: Union[int, Sequence[int]] = 2
    use_bias: bool = True
    activation: Union[str, None] = "selu"

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        snn = is_selu(self.activation)
        x = ConvTranspose(self.features, self.kernel_size,
                          use_bias=self.use_bias, snn_init=snn,
                          name="conv")(x)
        if not snn:
            x = nn.GroupNorm(num_groups=1, epsilon=1e-5, name="norm")(x)
        act = get_activation(self.activation)
        if act is not None:
            x = act(x)
        return x
