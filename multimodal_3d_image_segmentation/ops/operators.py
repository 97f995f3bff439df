"""Frequency-domain neural operator layers (Hartley & Fourier).

Re-designs of the reference's ``HartleyOperator``
(``nets/hartley_operator.py:17-299``) and ``FourierOperator``
(``nets/fourier_operator.py:15-223``) on top of the pruned packed-corner
transforms: the FFT + 8-way corner slicing + zero-pad concat of the
reference collapses into matmul chains that never leave the kept modes.

Behavioral contract preserved exactly:
  * shared weights  -> per-frequency channel mixing with one (o, i) matrix
    (a 1x1 conv in frequency space);
  * individual weights -> Hartley convolution theorem
    h = (W (X + X^-) + W^- (X - X^-)) / 2 with X^-[k] = X[N-k]
    (``nets/hartley_operator.py:302-333``), including the documented
    reverse-after-crop quirk for ``use_transform=False``
    (``nets/hartley_operator.py:280``);
  * SELU applied in the frequency domain before the inverse transform
    (``nets/hartley_operator.py:265-267``) — crucial for accuracy. The
    pruned path exploits selu(0) == 0 so the implicit zero padding is
    invariant; the (rarely used) frequency-domain bias is handled by an
    exact closed-form origin correction instead of materializing the full
    spectrum;
  * Fourier keeps complex weights as separate real/imag parameters and the
    rfft half-spectrum mode layout (``nets/fourier_operator.py:67-76``).

Layout: channels-last (B, *spatial, C).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from .. import nn
from . import initializers as inits
from . import spectral
from .spectral import (_prec, clip_modes, dht_crop, dht_pad_inverse,
                       extended_reverse, extended_to_packed, normalize_modes,
                       packed_reverse, rfft_crop, rfft_pad_inverse,
                       spatial_axes)

__all__ = ["HartleyOperator", "FourierOperator"]

_EINSUM_SHARED = "...i,oi->...o"


def _einsum_individual(nd: int) -> str:
    sp = "dhw"[-nd:]
    return f"b{sp}i,oi{sp}->b{sp}o"


def _hartley_conv(eq, w, w_rev, x, x_rev, precision):
    """Hartley convolution theorem in the frequency domain
    (reference ``nets/hartley_operator.py:302-317``)."""
    h1 = jnp.einsum(eq, x + x_rev, w, precision=precision)
    h2 = jnp.einsum(eq, x - x_rev, w_rev, precision=precision)
    return (h1 + h2) * 0.5


def _check_weights_type(weights_type):
    if weights_type not in ("individual", "shared"):
        raise ValueError("weights_type must be one of {'individual', 'shared'}")


class HartleyOperator(nn.Module):
    """Hartley-domain spectral convolution.

    Args:
        in_channels / out_channels: channel counts.
        num_modes: kept modes per spatial axis (int or per-axis sequence).
            Must satisfy 2*m <= spatial size (clipped at trace time for
            shared weights, asserted for individual).
        use_bias: add a learned frequency-domain bias (default False).
        weights_type: 'shared' (one (o,i) matrix for all modes) or
            'individual' (per-mode kernels + Hartley convolution theorem).
        use_transform: if False, inputs are already a packed frequency
            spectrum (the HNOSeg-XS fast path).
        snn_init: use the self-normalizing init scheme.
    """
    in_channels: int
    out_channels: int
    num_modes: Optional[Union[int, Sequence[int]]] = None
    use_bias: bool = False
    weights_type: str = "shared"
    use_transform: bool = True
    snn_init: bool = False
    precision: Optional[jax.lax.Precision] = None

    def _params(self, nd: int):
        _check_weights_type(self.weights_type)
        if self.weights_type == "shared":
            w_shape = (self.out_channels, self.in_channels)
        else:
            assert self.num_modes is not None
            modes = normalize_modes(self.num_modes, nd)
            w_shape = ((self.out_channels, self.in_channels)
                       + tuple(2 * m for m in modes))
        fan_in = int(np.prod(w_shape[1:]))
        w_init = (inits.kaiming_normal_linear(fan_in) if self.snn_init
                  else inits.kaiming_uniform_a5(fan_in))
        weight = self.param("weight", w_init, w_shape)
        bias = None
        if self.use_bias:
            b_init = inits.snn_bias() if self.snn_init else inits.zeros_init()
            bias = self.param("bias", b_init, (self.out_channels,))
        return weight, bias

    def _precision(self, dtype):
        return self.precision if self.precision is not None else _prec(dtype)

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        nd = x.ndim - 2
        weight, bias = self._params(nd)
        # 'mixed' mode: the weight stays fp32 and the whole op runs as an
        # fp32 island (the spectra are mode-scale tensors); only the
        # volume-scale inverse output is cast back to the input dtype.
        weight = weight.astype(spectral._isl(x.dtype))
        axes = spatial_axes(x.ndim)

        if self.use_transform:
            return self._call_transform(x, weight, bias, nd, axes)
        return self._call_notransform(x, weight, bias, nd, axes)

    def _call_transform(self, x, weight, bias, nd, axes):
        sizes = x.shape[1:-1]
        modes = normalize_modes(self.num_modes, nd)
        if self.weights_type == "shared":
            modes = clip_modes(modes, sizes)
        else:
            assert all(s >= 2 * m for s, m in zip(sizes, modes)), (
                f"spatial sizes {sizes} must be >= 2 * modes {modes}")

        if self.weights_type == "shared":
            xp = dht_crop(x, modes)
            y = jnp.einsum(_EINSUM_SHARED, xp, weight,
                           precision=self._precision(xp.dtype))
        else:
            # Extended kept set (2m+1 per axis) makes the true frequency
            # reversal k -> N-k an exact permutation (parity with
            # reverse-then-crop of the full spectrum).
            ext = dht_crop(x, modes, extended=True)
            xp = extended_to_packed(ext, axes)
            xr = extended_to_packed(extended_reverse(ext, axes), axes)
            w_axes = tuple(range(2, 2 + nd))
            w_rev = packed_reverse(weight, w_axes)
            y = _hartley_conv(_einsum_individual(nd), weight, w_rev, xp, xr,
                              self._precision(xp.dtype))

        if bias is not None:
            y = y + bias.astype(y.dtype)
            # Reference applies SELU to the *full* zero-padded spectrum with
            # the bias broadcast everywhere. selu(bias) is a constant c over
            # the zero region; IDHT(c * ones) is c * prod(sizes) at the
            # origin, so correct in closed form (see module docstring).
            c = jax.nn.selu(bias.astype(y.dtype))
            y = jax.nn.selu(y) - c
            out = dht_pad_inverse(y, sizes)
            origin = (slice(None),) + (0,) * nd + (slice(None),)
            out = out.at[origin].add(c * float(np.prod(sizes)))
            return out.astype(x.dtype)

        # This activation is crucial: nonlinearity in the frequency domain
        # (reference ``nets/hartley_operator.py:265-267``). selu(0) == 0, so
        # the implicit zero padding is untouched.
        y = jax.nn.selu(y)
        return dht_pad_inverse(y, sizes).astype(x.dtype)

    def _call_notransform(self, x, weight, bias, nd, axes):
        p = self._precision(spectral._isl(x.dtype))
        if self.weights_type == "shared":
            y = jnp.einsum(_EINSUM_SHARED, x, weight, precision=p)
        else:
            # NOTE: reverse after cropping differs from the true reversal at
            # the highest negative frequency per axis — reproduced for
            # parity (reference ``nets/hartley_operator.py:280``).
            x_rev = packed_reverse(x, axes)
            w_axes = tuple(range(2, 2 + nd))
            w_rev = packed_reverse(weight, w_axes)
            y = _hartley_conv(_einsum_individual(nd), weight, w_rev, x, x_rev,
                              p)
        if bias is not None:
            y = y + bias.astype(y.dtype)
        return y


class FourierOperator(nn.Module):
    """Fourier-domain spectral convolution (FNO-style).

    Complex weights stored as separate real/imag parameters (reference
    ``nets/fourier_operator.py:73-76``). The last spatial axis keeps only
    the non-negative modes (rfft half spectrum).

    With ``use_transform=False`` the input and output are (real, imag)
    tuples of the packed spectrum.
    """
    in_channels: int
    out_channels: int
    num_modes: Optional[Union[int, Sequence[int]]] = None
    use_bias: bool = False
    weights_type: str = "shared"
    use_transform: bool = True
    snn_init: bool = False
    precision: Optional[jax.lax.Precision] = None

    def _params(self, nd: int):
        _check_weights_type(self.weights_type)
        if self.weights_type == "shared":
            w_shape = (self.out_channels, self.in_channels)
        else:
            assert self.num_modes is not None
            modes = normalize_modes(self.num_modes, nd)
            w_shape = ((self.out_channels, self.in_channels)
                       + tuple(2 * m for m in modes[:-1]) + (modes[-1],))
        fan_in = int(np.prod(w_shape[1:]))
        w_init = (inits.kaiming_normal_linear(fan_in) if self.snn_init
                  else inits.kaiming_uniform_a5(fan_in))
        wr = self.param("weight_real", w_init, w_shape)
        wi = self.param("weight_imag", w_init, w_shape)
        bias = None
        if self.use_bias:
            b_init = inits.snn_bias() if self.snn_init else inits.zeros_init()
            bias = self.param("bias", b_init, (self.out_channels,))
        return wr, wi, bias

    def _mix(self, re, im, wr, wi, nd):
        """(wr + i wi) (re + i im), channel contraction."""
        if self.weights_type == "shared":
            eq = _EINSUM_SHARED
        else:
            eq = _einsum_individual(nd)
        p = (self.precision if self.precision is not None
             else _prec(jnp.result_type(re, wr)))
        yre = (jnp.einsum(eq, re, wr, precision=p)
               - jnp.einsum(eq, im, wi, precision=p))
        yim = (jnp.einsum(eq, re, wi, precision=p)
               + jnp.einsum(eq, im, wr, precision=p))
        return yre, yim

    @nn.compact
    def __call__(self, x):
        if self.use_transform:
            nd = x.ndim - 2
        else:
            nd = x[0].ndim - 2
        wr, wi, bias = self._params(nd)

        if not self.use_transform:
            re, im = x
            wr = wr.astype(spectral._isl(re.dtype))
            wi = wi.astype(spectral._isl(re.dtype))
            yre, yim = self._mix(re, im, wr, wi, nd)
            if bias is not None:
                # torch complex + real adds to the real part only
                yre = yre + bias.astype(yre.dtype)
            return yre, yim

        sizes = x.shape[1:-1]
        modes = normalize_modes(self.num_modes, nd)
        if self.weights_type == "shared":
            modes = clip_modes(modes, sizes)
        else:
            assert all(s >= 2 * m for s, m in zip(sizes, modes)), (
                f"spatial sizes {sizes} must be >= 2 * modes {modes}")

        wr = wr.astype(spectral._isl(x.dtype))
        wi = wi.astype(spectral._isl(x.dtype))
        re, im = rfft_crop(x, modes)
        yre, yim = self._mix(re, im, wr, wi, nd)
        out = rfft_pad_inverse(yre, yim, sizes).astype(x.dtype)

        if bias is not None:
            # Reference adds the (real) bias to the spectrum after padding
            # the non-last axes to full size but before irfftn
            # (``nets/fourier_operator.py:193-209``). By linearity the
            # correction is bias * prod(non-last sizes) * Dirichlet(j) along
            # the last axis at the origin of the other axes.
            n_last, m_last = sizes[-1], modes[-1]
            j = np.arange(n_last)
            f = np.ones(n_last)
            for k in range(1, m_last):
                f = f + 2.0 * np.cos(2.0 * np.pi * k * j / n_last)
            scale = float(np.prod(sizes[:-1]))
            corr = (np.asarray(f, out.dtype)[:, None]
                    * bias.astype(out.dtype)[None, :] * scale)
            origin = (slice(None),) + (0,) * (nd - 1) + (slice(None),) * 2
            out = out.at[origin].add(corr)
        return out
