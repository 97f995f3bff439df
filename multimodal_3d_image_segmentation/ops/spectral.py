"""Pruned ("packed-corner") spectral transforms as matmul chains.

This is the spectral core of the framework. The reference pipeline
(IBM/multimodal-3d-image-segmentation) computes a full FFT, crops a small
block of low/high frequency "corners", mixes channels there, zero-pads the
corners back and runs a full inverse FFT (see reference
``nets/hnosegxs.py:332-494`` TransformCrop/PadInverse and
``nets/hartley_operator.py:109-271``). Because the kept mode counts are tiny
(e.g. (10, 14, 14)) compared to the volume (e.g. 240x240x155), the
crop-after-FFT wastes almost all FFT work, and the corner slicing/concat
materializes 8 temporaries.

Here the *pruned* discrete transform is evaluated directly: for each axis,
contracting with a (n, 2m) cas/DFT matrix yields exactly the packed corner
layout ``[0..m-1, n-m..n-1]`` the reference produces by crop+concat. Each
axis is one dense matmul; after the first axis the working set shrinks by
~n/2m, so the whole forward transform is a chain of tall-skinny matmuls. The inverse transform
(zero-pad + full inverse FFT in the reference) is the transposed chain: the
zero blocks are never materialized.

Conventions match the reference exactly (``nets/dht.py:29-36``):
  * forward DHT uses 1/N normalization; inverse uses none. This makes
    frequency magnitudes resolution-invariant — the keystone of zero-shot
    super-resolution.
  * DHT(x) = Re(FFT(x)) - Im(FFT(x)) (the cas transform).
  * the real-FFT variant keeps only non-negative frequencies on the last
    axis (reference ``nets/fourier_operator.py:69-72``).

A full-grid FFT-based path (`dht_full`, cuFFT on the GPU) computes the same
spectrum the way the reference does; it serves cross-validation and the
spectral-core comparison in ``tools/bench_spectral.py``.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "clip_modes",
    "normalize_modes",
    "dht_full",
    "set_fp32_transform_precision",
    "dht_crop",
    "dht_pad_inverse",
    "rfft_crop",
    "rfft_pad_inverse",
    "packed_reverse",
    "extended_reverse",
    "extended_reverse_perm",
    "extended_to_packed",
    "spatial_axes",
    "channel_mix",
]

# Precision for the fp32 matmuls (spectral chains, channel mixes, convs).
# The DFT contraction sums O(n) terms of O(1) magnitude with heavy
# cancellation, so the default is full fp32. Which dot algorithm XLA's GPU
# backend runs for each setting is recorded in PERF.md (read from the
# optimized HLO on the card).
PRECISION = jax.lax.Precision.HIGHEST

_FP32_PRECISION_MODES = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}


def set_fp32_transform_precision(mode: str) -> None:
    """Set the precision used for fp32 einsums and convs framework-wide.

    ``highest`` (the default) asks for fp32-exact products; ``high`` and
    ``default`` let the backend trade mantissa bits for speed (on the GPU
    a tensor-core algorithm, see PERF.md). Must be called before the first
    trace of a jitted function to take effect (precision is baked in at
    trace time; cached executables do not retrace).
    """
    global PRECISION
    if mode not in _FP32_PRECISION_MODES:
        raise ValueError(
            f"transform precision must be one of "
            f"{sorted(_FP32_PRECISION_MODES)}, got {mode!r}")
    PRECISION = _FP32_PRECISION_MODES[mode]


def _prec(dtype):
    """With bf16 activations (mixed-precision mode) use native bf16
    multiplies with fp32 accumulation; fp32 activations get PRECISION."""
    if dtype == jnp.bfloat16:
        return jax.lax.Precision.DEFAULT
    return PRECISION


# 'mixed' serving mode: activations stay bfloat16 (storage + elementwise
# traffic at bf16 rates) but every WEIGHT/TRANSFORM-MATRIX contraction runs
# as an fp32 island — matrices and learned weights kept fp32, bf16 operands
# promoted into the dot (the convert fuses into the operand read),
# PRECISION-class accumulation, outputs cast back to bf16 at volume scale.
# The only bf16 rounding left is activation *storage* between ops; the
# systematic matrix/weight rounding that plain-bf16 serving pays on every
# cancellation-heavy spectral contraction is eliminated. Quality-gated by
# the trained-network Dice protocol (tools/bench_precision.py).
BF16_EXACT = False


def set_bf16_exact(enabled: bool) -> None:
    """Enable/disable the 'mixed' (bf16 storage, fp32-exact weights)
    serving mode. Like ``set_fp32_transform_precision``, must be set
    before the first trace; cached executables do not retrace."""
    global BF16_EXACT
    BF16_EXACT = bool(enabled)


def _isl(dtype):
    """Island dtype: the dtype weight/matrix contractions run at for
    ``dtype`` activations (fp32 when the 'mixed' mode is active)."""
    if BF16_EXACT and dtype == jnp.bfloat16:
        return jnp.float32
    return dtype


def spatial_axes(ndim: int) -> Tuple[int, ...]:
    """Spatial axes for channels-last layout (B, *spatial, C)."""
    return tuple(range(1, ndim - 1))


def normalize_modes(num_modes, n_spatial: int) -> Tuple[int, ...]:
    """Broadcast a scalar mode count to all spatial dims (reference
    ``nets/hartley_operator.py:63-69`` semantics)."""
    if np.isscalar(num_modes):
        return (int(num_modes),) * n_spatial
    assert len(num_modes) == n_spatial
    return tuple(int(m) for m in num_modes)


def clip_modes(modes: Sequence[int], sizes: Sequence[int]) -> Tuple[int, ...]:
    """Clip modes to half the spatial size (reference
    ``nets/hartley_operator.py:172-178``). Runs at trace time."""
    return tuple(min(int(m), int(s) // 2) for m, s in zip(modes, sizes))


def _kept_freqs(n: int, m: int, extended: bool = False) -> np.ndarray:
    """Kept frequencies in packed-corner order: [0..m-1] then [n-m..n-1].

    ``extended`` additionally keeps frequency ``m`` (between the corners),
    which makes true frequency reversal k -> (n - k) mod n a permutation of
    the kept set (needed for exact Hartley-convolution parity, see
    `extended_reverse_perm`).
    """
    if extended:
        assert n >= 2 * m + 1
        return np.concatenate([np.arange(m + 1), np.arange(n - m, n)])
    assert n >= 2 * m
    return np.concatenate([np.arange(m), np.arange(n - m, n)])


@functools.lru_cache(maxsize=None)
def _dft_mats_np(n: int, m: int, forward: bool, extended: bool,
                 sign: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) matrices for the pruned DFT along one axis.

    forward: shape (n, K) with 1/n scaling (reference forward norm).
    inverse: shape (K, n) with no scaling.
    ``sign`` is the sign of the exponent angle (e^{sign * i * theta}).
    The matrices are built in float64 for accuracy at large n.
    """
    ks = _kept_freqs(n, m, extended)
    j = np.arange(n)
    theta = 2.0 * np.pi * np.outer(j, ks) / n  # (n, K)
    if forward:
        c = np.cos(theta) / n
        s = np.sin(sign * theta) / n
    else:
        c = np.cos(theta).T
        s = np.sin(sign * theta).T
    return c, s


_LETTERS = "abcdefghijklmnop"


def _cas_chain(x, stages):
    """Run a pruned separable e^{i theta}-factor transform on a real tensor,
    carrying the complex pair as one extra tensor axis of size 2 (inserted
    at position 1) so every stage is a single dot_general.

    ``stages``: ordered (orig_axis, kind, matrix); axes refer to the
    comp-free layout. kinds:
      'first'  real -> complex (inserts the comp axis),
      'mid'    complex -> complex,
      'fold'   complex -> real (removes the comp axis; the final Re - Im
               or Hermitian combination is folded into the matrix so no
               separate subtraction pass touches the big output),
      'single' real -> real (one-axis transform, fold pre-applied).
    """
    # The comp axis is carried at position 1, so transformed axes must be
    # >= 1 (axis 0 with a 'first' stage would silently sum over the kept
    # modes — the einsum reduces any label appearing only on the matrix)
    assert all(st[0] >= 1 for st in stages), (
        "transform axes must be >= 1 (axis 0 is the leading/batch axis)")
    # If the first stage is already complex->*, the caller passed x with
    # the comp axis pre-inserted at position 1 (e.g. rfft inverse).
    has_comp = stages[0][1] in ("mid", "fold") if stages else False
    for orig_axis, kind, mat in stages:
        ax = orig_axis + (1 if has_comp else 0)
        subs = _LETTERS[:x.ndim]
        a = subs[ax]
        if kind == "first":
            out = subs[0] + "Q" + subs[1:].replace(a, "K")
            eq = f"{subs},{a}KQ->{out}"
            has_comp = True
        elif kind == "single":
            eq = f"{subs},{a}K->{subs.replace(a, 'K')}"
        else:
            q = subs[1]  # comp axis label
            if kind == "mid":
                out = subs.replace(a, "K").replace(q, "P")
                eq = f"{subs},{a}{q}KP->{out}"
            else:  # fold
                out = subs.replace(a, "K").replace(q, "")
                eq = f"{subs},{a}{q}K->{out}"
                has_comp = False
        # matrices may ride a wider dtype than x ('mixed' mode: fp32
        # matrices on bf16 activations) — precision follows the promoted
        # dtype so the island actually accumulates at PRECISION
        x = jnp.einsum(eq, x, mat, precision=_prec(jnp.result_type(x, mat)))
    return x


def _stage_matrix(c, s, kind, dtype, final_weights=None):
    """Build the stage matrix from (C, S) = (cos, sin-with-sign) parts.

    first:  M[a, k, q]    = (C, S)
    mid:    M[a, q, k, p] : q=0 -> (C, S); q=1 -> (-S, C)
            ((re + i im)(C + iS) -> re' = reC - imS ; im' = imC + reS)
    fold:   M[a, q, k]    : q=0 -> C - S ; q=1 -> -(C + S)
            (result = re' - im' of the final factor)
    single: M[a, k]       = C - S
    fold with final_weights (w0, w1): q=0 -> w0; q=1 -> w1 (e.g. the
    Hermitian rfft completion).
    """
    if kind == "fold" and final_weights is not None:
        # numpy constants: embedded at lowering with no device readback
        return np.asarray(np.stack(final_weights, axis=1), dtype)
    c = np.asarray(c)
    s = np.asarray(s)
    if kind == "first":
        m = np.stack([c, s], axis=-1)
    elif kind == "mid":
        m = np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], axis=1)
    elif kind == "fold":
        m = np.stack([c - s, -(c + s)], axis=1)
    elif kind == "single":
        m = c - s
    else:
        raise ValueError(kind)
    return np.asarray(m, dtype)


def _axis_order(pairs, forward):
    """Process axes so intermediates stay small: for the forward transform
    contract the axis with the largest reduction first; for the inverse
    expand the axis with the largest expansion last.

    Both orders sort descending on n_in/n_out: forward pairs carry
    (n, 2m) so that is reduction-first; inverse pairs carry (2m, n) so
    the largest expansion (smallest ratio) lands last. (``forward`` kept
    for call-site readability; a previous ascending inverse sort
    expanded the largest axis FIRST — ~38% extra contraction FLOPs at
    flagship inverse shapes.)"""
    del forward
    return sorted(pairs, key=lambda t: t[1] / max(t[2], 1), reverse=True)


def _kinds(n_stages: int):
    if n_stages == 1:
        return ["single"]
    return ["first"] + ["mid"] * (n_stages - 2) + ["fold"]


def dht_crop(x: jax.Array, modes: Sequence[int],
             axes: Optional[Sequence[int]] = None,
             extended: bool = False) -> jax.Array:
    """Forward DHT (1/N norm) evaluated only at the packed corner modes.

    Equivalent to the reference's ``dhtn`` followed by TransformCrop's
    8-corner crop+concat (``nets/hnosegxs.py:378-410``), in one matmul chain
    per axis; the final Re - Im is folded into the last stage's matrix.

    Args:
        x: real tensor; ``axes`` defaults to all but first/last
            (channels-last convention).
        modes: kept modes per transformed axis (already clipped).
        extended: keep 2m+1 rows per axis (see `_kept_freqs`).

    Returns:
        Real packed spectrum with transformed axes of size 2m (or 2m+1).
    """
    if axes is None:
        axes = spatial_axes(x.ndim)
    dt = _isl(x.dtype)
    mdict = dict(zip(axes, modes))
    # 'extended' may be per-axis; an axis with n == 2m cannot (and need
    # not) be extended: its packed spectrum IS the full spectrum, so the
    # flip+roll reversal is already exact there.
    if isinstance(extended, bool):
        extended = [extended] * len(axes)
    edict = {ax: bool(e) and x.shape[ax] > 2 * m
             for ax, m, e in zip(axes, modes, extended)}
    pairs = [(ax, x.shape[ax], 2 * m) for ax, m in zip(axes, modes)]
    order = _axis_order(pairs, forward=True)
    stages = []
    kinds = _kinds(len(order))
    for (ax, n, _), kind in zip(order, kinds):
        c, s = _dft_mats_np(int(n), int(mdict[ax]), True, edict[ax], -1)
        stages.append((ax, kind, _stage_matrix(c, s, kind, dt)))
    return _cas_chain(x, stages)


def dht_pad_inverse(y: jax.Array, sizes: Sequence[int],
                    axes: Optional[Sequence[int]] = None) -> jax.Array:
    """Inverse DHT (no norm) from a packed corner spectrum to the full grid.

    Equivalent to the reference's PadInverse (zero-pad corners to full size,
    then inverse ``dhtn``, ``nets/hnosegxs.py:413-494``): the zero blocks are
    never materialized. Modes are inferred as (packed size)//2, matching
    ``nets/hnosegxs.py:459-462``.
    """
    if axes is None:
        axes = spatial_axes(y.ndim)
    dt = _isl(y.dtype)
    modes = {ax: y.shape[ax] // 2 for ax in axes}
    ndict = dict(zip(axes, sizes))
    for ax, n in zip(axes, sizes):
        assert n >= 2 * modes[ax], (
            f"target size {n} < 2*modes {2 * modes[ax]} on axis {ax}")
    pairs = [(ax, 2 * modes[ax], n) for ax, n in zip(axes, sizes)]
    order = _axis_order(pairs, forward=False)
    stages = []
    kinds = _kinds(len(order))
    for (ax, _, _), kind in zip(order, kinds):
        c, s = _dft_mats_np(int(ndict[ax]), int(modes[ax]), False, False, -1)
        stages.append((ax, kind, _stage_matrix(c, s, kind, dt)))
    return _cas_chain(y, stages)


def rfft_crop(x: jax.Array, modes: Sequence[int],
              axes: Optional[Sequence[int]] = None
              ) -> Tuple[jax.Array, jax.Array]:
    """Forward real FFT (1/N norm) at the packed kept modes.

    All axes but the last keep packed corners [0..m-1, n-m..n-1]; the last
    transformed axis keeps only [0..m-1] (the rfft half spectrum), matching
    the reference FourierOperator's mode layout
    (``nets/fourier_operator.py:168-191``).

    Returns the (real, imag) pair of the cropped spectrum.
    """
    if axes is None:
        axes = spatial_axes(x.ndim)
    dt = _isl(x.dtype)
    last = axes[-1]
    pairs = []
    for ax, m in zip(axes, modes):
        n = x.shape[ax]
        if ax == last:
            ks = np.arange(m)
            theta = 2.0 * np.pi * np.outer(np.arange(n), ks) / n
            c = np.cos(theta) / n
            s = np.sin(-theta) / n
            pairs.append((ax, n, m, c, s))
        else:
            c, s = _dft_mats_np(int(n), int(m), True, False, -1)
            pairs.append((ax, n, 2 * m, c, s))
    order = sorted(pairs, key=lambda t: t[1] / max(t[2], 1), reverse=True)
    stages = []
    for i, (ax, _, _, c, s) in enumerate(order):
        kind = "first" if i == 0 else "mid"
        stages.append((ax, kind, _stage_matrix(c, s, kind, dt)))
    out = _cas_chain(x, stages)  # comp axis at position 1
    return out[:, 0], out[:, 1]


def rfft_pad_inverse(re: jax.Array, im: jax.Array, sizes: Sequence[int],
                     axes: Optional[Sequence[int]] = None) -> jax.Array:
    """Inverse real FFT (norm='forward' -> unscaled) from packed modes.

    Equivalent to zero-padding the kept modes into the rfftn half-spectrum
    and calling irfftn (reference ``nets/fourier_operator.py:193-211``). The
    non-last axes are inverted with e^{+i theta} chains; the last (Hermitian)
    axis doubles the k>0 columns.
    """
    if axes is None:
        axes = spatial_axes(re.ndim)
    dt = _isl(re.dtype)
    last = axes[-1]

    x = jnp.stack([re, im], axis=1)  # comp axis at position 1

    pairs = []
    for ax, n in zip(axes, sizes):
        if ax == last:
            continue
        m = re.shape[ax] // 2
        assert n >= 2 * m
        c, s = _dft_mats_np(int(n), int(m), False, False, +1)
        pairs.append((ax, 2 * m, n, c, s))
    # descending (2m)/n: largest expansion last, keeping intermediates
    # small (same fix as _axis_order)
    order = sorted(pairs, key=lambda t: t[1] / max(t[2], 1), reverse=True)
    stages = [(ax, "mid", _stage_matrix(c, s, "mid", dt))
              for ax, _, _, c, s in order]

    # Hermitian last axis (must run after the others): folded stage with
    # x_j = sum_k w_k * Re(Z_k e^{+i theta}), w_0 = 1, w_{k>0} = 2.
    n = [sz for ax, sz in zip(axes, sizes) if ax == last][0]
    m = re.shape[last]
    assert n >= 2 * m
    ks = np.arange(m)
    w = np.where(ks == 0, 1.0, 2.0)
    theta = 2.0 * np.pi * np.outer(ks, np.arange(n)) / n
    a = w[:, None] * np.cos(theta)
    b = w[:, None] * np.sin(theta)
    stages.append((last, "fold",
                   _stage_matrix(None, None, "fold", dt,
                                 final_weights=(a, -b))))
    return _cas_chain(x, stages)


def dht_full(x: jax.Array, axes: Optional[Sequence[int]] = None,
             is_inverse: bool = False) -> jax.Array:
    """Full-grid DHT via FFT: H(x) = Re(FFT(x)) - Im(FFT(x)).

    Normalization matches reference ``nets/dht.py:29-36``: forward applies
    1/N, inverse applies none. Used for cross-validation and full-spectrum
    configurations; production paths use the pruned matmul transforms.
    """
    if axes is None:
        axes = spatial_axes(x.ndim)
    f = jnp.fft.fftn(x, axes=tuple(axes))
    if not is_inverse:
        norm = np.prod([x.shape[a] for a in axes]).astype(np.float64)
        f = f / norm
    return (f.real - f.imag).astype(x.dtype)


def packed_reverse(x: jax.Array, axes: Sequence[int]) -> jax.Array:
    """Reference ``get_reverse`` (flip then roll by 1) applied to a packed
    spectrum (``nets/hartley_operator.py:320-333``).

    On a *full-length* spectrum this is exactly X[k] -> X[(N-k) mod N]. On a
    cropped/packed spectrum it differs from true reversal at the single
    highest negative frequency per axis — a quirk the reference documents
    (``nets/hartley_operator.py:280``) and which we reproduce bit-for-bit
    for the ``use_transform=False`` individual-weights path.
    """
    for ax in axes:
        x = jnp.roll(jnp.flip(x, ax), 1, ax)
    return x


def extended_reverse_perm(m: int) -> np.ndarray:
    """Permutation implementing true reversal k -> (n-k) mod n on the
    extended kept set [0..m, n-m..n-1] (length 2m+1).

    Positions: p in [0, m] hold k=p; p in [m+1, 2m] hold k = n-(2m+1)+p.
    Reversal: k=0 -> 0; k=p (1<=p<=m) -> n-p at position 2m+1-p;
    k=n-q (1<=q<=m) -> q at position q.
    """
    perm = np.empty(2 * m + 1, dtype=np.int64)
    perm[0] = 0
    perm[1:] = np.arange(2 * m, 0, -1)  # both halves: p -> 2m+1-p
    return perm


def extended_to_packed(x: jax.Array, axes: Sequence[int]) -> jax.Array:
    """Drop the extra k=m row per axis: extended (2m+1) -> packed (2m).

    Even-sized axes are already packed (the n == 2m case) and pass through.
    """
    for ax in axes:
        if x.shape[ax] % 2 == 0:
            continue
        m = (x.shape[ax] - 1) // 2
        idx = np.concatenate([np.arange(m), np.arange(m + 1, 2 * m + 1)])
        x = jnp.take(x, idx, axis=ax)
    return x


def extended_reverse(x: jax.Array, axes: Sequence[int]) -> jax.Array:
    """True frequency reversal on an extended spectrum. Odd-sized axes
    (2m+1) use the exact permutation; even-sized axes hold the full
    spectrum (n == 2m) where flip+roll IS the exact reversal."""
    for ax in axes:
        if x.shape[ax] % 2 == 0:
            x = jnp.roll(jnp.flip(x, ax), 1, ax)
        else:
            m = (x.shape[ax] - 1) // 2
            x = jnp.take(x, extended_reverse_perm(m), axis=ax)
    return x


def channel_mix(x: jax.Array, mat: jax.Array) -> jax.Array:
    """1x1 channel mix ``einsum('...i,io->...o', x, mat)`` at the
    framework precision. In 'mixed' mode the weight stays fp32 and the
    bf16 operand is promoted into the dot; the result is cast back to the
    activation dtype (the cast fuses into the dot's epilogue)."""
    dt = _isl(x.dtype)
    return jnp.einsum("...i,io->...o", x, mat.astype(dt),
                      precision=_prec(dt)).astype(x.dtype)
