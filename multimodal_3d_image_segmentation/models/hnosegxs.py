"""HNOSeg-XS: extremely small Hartley neural operator for segmentation
(IEEE-TMI 2025). Re-design of the reference ``nets/hnosegxs.py:20-494``.

Architecture (per reference): optional learnable 2x downsampling -> 1x1 conv
-> a tower of HNO-XS blocks with U-Net-style skips across blocks (first half
encode, second half decode, median excluded) -> optional deep-supervision
concat -> trilinear upsample -> 1x1 conv -> softmax.

Each HNO-XS block performs ONE forward Hartley transform cropped to the kept
modes, runs n_XS frequency-resident channel-mixing convolutions with
identity skips and SELU entirely on the packed spectrum, and ONE inverse
transform — the source of its speed. The transform pair is the pruned
matmul chain of :mod:`..ops.spectral`, and the frequency-resident chain is a
dense (o, i) einsum stack on the packed spectrum (~1.5 MB for the flagship
config at 240x240x155).

Reference config (``experiments/config_files/config_hnoseg_xs.ini:46-51``):
filters=24, num_transform_blocks=[3]*8, num_modes=(10,14,14) -> 28,248
parameters, asserted in tests.
"""
from __future__ import annotations

from typing import Callable, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from .. import nn
from ..ops.activations import get_activation, is_selu
from ..ops.convs import (ConcatConvNormAct, Conv, ConvNormAct,
                         _SplitKernelConv1x1)
from ..ops.operators import HartleyOperator
from ..ops.padcrop import spatial_padcrop
from ..ops.resize import resize_linear
from ..ops.spectral import clip_modes, dht_crop, dht_pad_inverse, \
    normalize_modes

__all__ = ["HNOSegXS", "HNOXSBlock"]


class _FreqResidentConv(nn.Module):
    """One frequency-domain convolution with identity skip + activation
    (reference ``nets/hnosegxs.py:282-329``). Operates on the packed
    spectrum; with shared weights this is a 1x1 channel-mixing conv."""
    in_channels: int
    out_channels: int
    num_modes: Union[int, Sequence[int]]
    weights_type: str = "shared"
    activation: Union[str, Callable, None] = "selu"
    use_conv_branch: bool = False
    snn_init: bool = False

    @nn.compact
    def __call__(self, x):
        x1 = HartleyOperator(
            self.in_channels, self.out_channels, self.num_modes,
            use_bias=False, weights_type=self.weights_type,
            use_transform=False, snn_init=self.snn_init, name="op")(x)
        if self.use_conv_branch:
            x2 = Conv(self.out_channels, 1, use_bias=False,
                      snn_init=self.snn_init, name="conv_branch")(x)
            x1 = x1 + x2
        x1 = x1 + x  # identity skip
        if not is_selu(self.activation):
            x1 = nn.GroupNorm(num_groups=1, epsilon=1e-5,
                              name="normalization")(x1)
        act = get_activation(self.activation)
        if act is not None:  # This activation is crucial
            x1 = act(x1)
        return x1


class HNOXSBlock(nn.Module):
    """HNO-XS block: transform-crop -> n_XS frequency-resident convolutions
    -> pad-inverse -> activation -> block skip (concat+conv or add)
    (reference ``nets/hnosegxs.py:185-279``)."""
    num_convs: int
    in_channels: int
    out_channels: int
    num_modes: Union[int, Sequence[int]]
    weights_type: str = "shared"
    activation: Union[str, Callable, None] = "selu"
    use_conv_branch: bool = False
    use_block_concat: bool = True
    snn_init: bool = False

    @nn.compact
    def __call__(self, x, skip=None):
        """``skip`` is the U-Net skip tensor; it is concatenated (virtually)
        with x before the mapping conv, never materialized."""
        if self.in_channels != self.out_channels:
            inputs = (x,) if skip is None else (x, skip)
            x = ConcatConvNormAct(self.out_channels, use_bias=True,
                                  activation=self.activation,
                                  use_snn=is_selu(self.activation),
                                  name="mapping_conv")(inputs)
        else:
            assert skip is None

        tmp = x
        nd = x.ndim - 2
        sizes = x.shape[1:-1]
        modes = clip_modes(normalize_modes(self.num_modes, nd), sizes)

        # TransformCrop: one forward DHT restricted to the kept modes.
        y = dht_crop(x, modes)
        for i in range(self.num_convs):
            y = _FreqResidentConv(
                self.out_channels, self.out_channels, self.num_modes,
                weights_type=self.weights_type,
                activation=self.activation,
                use_conv_branch=self.use_conv_branch,
                snn_init=self.snn_init, name=f"conv_blocks_{i}")(y)
        # PadInverse: one inverse DHT back to the block grid ('mixed'
        # mode: back to the activation dtype, spectra stayed fp32).
        x = dht_pad_inverse(y, sizes).astype(tmp.dtype)

        if not is_selu(self.activation):
            x = nn.GroupNorm(num_groups=1, epsilon=1e-5,
                             name="normalization")(x)
        act = get_activation(self.activation)
        if act is not None:
            x = act(x)

        # Block skip AFTER normalization/activation (reference
        # ``nets/hnosegxs.py:270-277``: intensity range of pad_inverse).
        if self.use_block_concat:
            x = ConcatConvNormAct(self.out_channels, use_bias=True,
                                  activation=self.activation,
                                  use_snn=is_selu(self.activation),
                                  name="conv_concat")((x, tmp))
        else:
            x = x + tmp
        return x


class HNOSegXS(nn.Module):
    """HNOSeg-XS architecture (reference ``nets/hnosegxs.py:20-182``).

    Public contract matches the reference: input (B, C, *spatial)
    channel-first, output softmax probabilities (B, out_channels, *spatial).
    """
    in_channels: int
    out_channels: int
    filters: int
    num_transform_blocks: Union[int, Sequence[int]]
    num_modes: Union[int, Sequence[int]]
    weights_type: str = "shared"
    use_resize: bool = True
    use_deep_supervision: bool = False
    use_unet_skip: bool = True
    use_block_concat: bool = True
    activation: Union[str, Callable, None] = "selu"
    output_activation: Union[str, Callable, None] = "softmax"
    ndim: int = 5
    channel_first_io: bool = True
    compute_dtype: str = "float32"
    use_remat: bool = False

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        assert self.ndim in (4, 5)
        snn = is_selu(self.activation)
        in_dtype = x.dtype
        if self.channel_first_io:
            nd = x.ndim
            x = x.transpose((0,) + tuple(range(2, nd)) + (1,))
        x = x.astype(self.compute_dtype)
        image_size = x.shape[1:-1]

        ntb = self.num_transform_blocks
        if np.isscalar(ntb):
            ntb = [int(ntb)]
        num_blocks = len(ntb)

        ds_tensors = []
        encode_tensors = {}

        if self.use_resize:
            x = ConvNormAct(self.filters, kernel_size=2, strides=2,
                            use_bias=True, activation=self.activation,
                            use_snn=snn, name="conv_in")(x)

        x = ConvNormAct(self.filters, use_bias=True,
                        activation=self.activation, use_snn=snn,
                        name="conv1")(x)
        if self.use_deep_supervision:
            ds_tensors.append(x)

        # Rematerialization trades FLOPs for activation memory when
        # training at full resolution (jax.checkpoint per block).
        block_cls = nn.remat(HNOXSBlock) if self.use_remat else HNOXSBlock

        cur_in = self.filters
        for i, num_convs in enumerate(ntb):
            # Decoding: always exclude i == num_blocks // 2 (median /
            # self-input block), reference ``nets/hnosegxs.py:116-128``.
            skip = None
            if self.use_unet_skip and i > num_blocks // 2:
                skip = encode_tensors[num_blocks - 1 - i]
                cur_in = cur_in + skip.shape[-1]

            x = block_cls(num_convs, cur_in, self.filters, self.num_modes,
                           weights_type=self.weights_type,
                           activation=self.activation,
                           use_block_concat=self.use_block_concat,
                           snn_init=snn, name=f"layers_{i}")(x, skip)
            cur_in = self.filters

            if self.use_deep_supervision:
                ds_tensors.append(x)
            if self.use_unet_skip and i < num_blocks // 2:
                encode_tensors[i] = x

        # conv_out is a 1x1 (pointwise, linear, no bias) conv and the
        # resize is linear and per-channel, so they commute exactly; apply
        # conv_out on the (virtual) deep-supervision concat at the block
        # grid BEFORE upsampling so the resize moves out_channels instead
        # of the full feature stack. Numerically identical to the
        # reference order (``nets/hnosegxs.py:171-178``).
        x = _SplitKernelConv1x1(self.out_channels, use_bias=False,
                                snn_init=snn, name="conv_out")(
            tuple(ds_tensors) if ds_tensors else x)

        # Go channel-first while the tensor is still small (out_channels
        # wide): the channel-first output then needs no final transpose.
        nd = x.ndim
        x = x.transpose((0, nd - 1) + tuple(range(1, nd - 1)))
        if self.use_resize:
            x = resize_linear(x, image_size, channel_first=True)
        x = spatial_padcrop(x, image_size, channel_first=True)
        x = x.astype(in_dtype)

        if self.output_activation == "softmax":
            x = jax.nn.softmax(x, axis=1)
        else:
            act = get_activation(self.output_activation)
            if act is not None:
                x = act(x)

        if not self.channel_first_io:
            x = x.transpose((0,) + tuple(range(2, nd)) + (1,))
        return x
