"""Unit tests for the pruned spectral core against numpy FFT oracles.

Oracle definitions are derived independently from the published math:
DHT(x) = Re(FFT(x)) - Im(FFT(x)), forward 1/N normalization, inverse none;
packed corner layout = [0..m-1] ++ [n-m..n-1] per transformed axis.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest

from multimodal_3d_image_segmentation.ops import spectral, dhtn


def np_dht(x, axes, inverse=False):
    f = np.fft.fftn(x, axes=axes)
    if not inverse:
        f = f / np.prod([x.shape[a] for a in axes])
    return (f.real - f.imag).astype(np.float32)


def np_crop_packed(f, axes, modes, extended=False):
    for ax, m in zip(axes, modes):
        n = f.shape[ax]
        if extended:
            idx = np.concatenate([np.arange(m + 1), np.arange(n - m, n)])
        else:
            idx = np.concatenate([np.arange(m), np.arange(n - m, n)])
        f = np.take(f, idx, axis=ax)
    return f


def np_pad_packed(y, axes, sizes):
    """Zero-pad a packed corner spectrum back to full size."""
    out = y
    for ax, n in zip(axes, sizes):
        m = out.shape[ax] // 2
        shape = list(out.shape)
        shape[ax] = n - 2 * m
        low = np.take(out, np.arange(m), axis=ax)
        high = np.take(out, np.arange(m, 2 * m), axis=ax)
        out = np.concatenate([low, np.zeros(shape, out.dtype), high], axis=ax)
    return out


@pytest.mark.parametrize("shape,axes", [
    ((2, 12, 10, 3), (1, 2)),
    ((1, 8, 9, 7, 4), (1, 2, 3)),
    ((2, 3, 16, 15), (2, 3)),
])
def test_dht_full_matches_numpy(shape, axes):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    got = np.asarray(dhtn(jnp.asarray(x), dim=axes))
    want = np_dht(x, axes)
    np.testing.assert_allclose(got, want, atol=1e-5)

    got_inv = np.asarray(dhtn(jnp.asarray(x), dim=axes, is_inverse=True))
    want_inv = np_dht(x, axes, inverse=True)
    np.testing.assert_allclose(got_inv, want_inv, atol=1e-4)


def test_dht_roundtrip_identity():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 10, 12, 9, 2)).astype(np.float32)
    h = dhtn(jnp.asarray(x), dim=(1, 2, 3))
    back = dhtn(h, dim=(1, 2, 3), is_inverse=True)
    np.testing.assert_allclose(np.asarray(back), x, atol=1e-5)


@pytest.mark.parametrize("shape,modes", [
    ((1, 12, 10, 8, 3), (3, 4, 2)),
    ((2, 9, 11, 7, 2), (4, 5, 3)),   # odd sizes
    ((1, 8, 8, 2), (4, 4)),          # modes == n//2 exactly
])
def test_dht_crop_matches_fft_crop(shape, modes):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    axes = tuple(range(1, x.ndim - 1))
    got = np.asarray(spectral.dht_crop(jnp.asarray(x), modes))
    want = np_crop_packed(np_dht(x, axes), axes, modes)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("shape,modes", [
    ((1, 13, 10, 9, 3), (3, 4, 2)),
])
def test_dht_crop_extended(shape, modes):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    axes = tuple(range(1, x.ndim - 1))
    got = np.asarray(spectral.dht_crop(jnp.asarray(x), modes, extended=True))
    want = np_crop_packed(np_dht(x, axes), axes, modes, extended=True)
    np.testing.assert_allclose(got, want, atol=1e-5)

    # extended -> packed drops the k=m row
    packed = np.asarray(spectral.extended_to_packed(jnp.asarray(got), axes))
    want_packed = np_crop_packed(np_dht(x, axes), axes, modes)
    np.testing.assert_allclose(packed, want_packed, atol=1e-5)


@pytest.mark.parametrize("sizes,modes", [
    ((12, 10, 8), (3, 4, 2)),
    ((9, 11, 7), (4, 5, 3)),
    ((8, 8), (4, 4)),
])
def test_dht_pad_inverse_matches_pad_then_fft(sizes, modes):
    rng = np.random.default_rng(4)
    packed_shape = (1,) + tuple(2 * m for m in modes) + (3,)
    y = rng.standard_normal(packed_shape).astype(np.float32)
    axes = tuple(range(1, len(sizes) + 1))
    got = np.asarray(spectral.dht_pad_inverse(jnp.asarray(y), sizes))
    padded = np_pad_packed(y, axes, sizes)
    want = np_dht(padded, axes, inverse=True)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_crop_then_pad_inverse_is_lowpass_projection():
    """transform->crop->pad->inverse twice equals doing it once (idempotent
    spectral projection), the invariant behind the reference's architecture."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 16, 14, 12, 2)).astype(np.float32)
    modes = (4, 3, 5)

    def proj(v):
        return spectral.dht_pad_inverse(
            spectral.dht_crop(jnp.asarray(v), modes), v.shape[1:-1])

    once = np.asarray(proj(x))
    twice = np.asarray(proj(once))
    np.testing.assert_allclose(twice, once, atol=1e-4)


@pytest.mark.parametrize("shape,modes", [
    ((1, 12, 10, 8, 3), (3, 4, 2)),
    ((2, 9, 11, 3), (4, 5)),
])
def test_rfft_crop_matches_numpy(shape, modes):
    rng = np.random.default_rng(6)
    x = rng.standard_normal(shape).astype(np.float32)
    axes = tuple(range(1, x.ndim - 1))
    f = np.fft.rfftn(x, axes=axes) / np.prod([x.shape[a] for a in axes])
    # crop: packed corners on all but last; [:m] on last
    want = np_crop_packed(f, axes[:-1], modes[:-1])
    want = np.take(want, np.arange(modes[-1]), axis=axes[-1])
    re, im = spectral.rfft_crop(jnp.asarray(x), modes)
    np.testing.assert_allclose(np.asarray(re), want.real, atol=1e-5)
    np.testing.assert_allclose(np.asarray(im), want.imag, atol=1e-5)


@pytest.mark.parametrize("sizes,modes", [
    ((12, 10, 8), (3, 4, 2)),
    ((9, 11, 7), (4, 5, 3)),
])
def test_rfft_pad_inverse_matches_numpy(sizes, modes):
    rng = np.random.default_rng(7)
    shape = (1,) + tuple(2 * m for m in modes[:-1]) + (modes[-1], 2)
    zr = rng.standard_normal(shape).astype(np.float32)
    zi = rng.standard_normal(shape).astype(np.float32)
    axes = tuple(range(1, len(sizes) + 1))

    # numpy oracle: embed into the rfftn half-spectrum, irfftn norm='forward'
    z = zr + 1j * zi
    half = list(sizes)
    half[-1] = sizes[-1] // 2 + 1
    full = np.zeros((1,) + tuple(half) + (2,), np.complex128)
    sl = [slice(None)] * full.ndim
    # scatter packed corners on non-last axes
    padded = np_pad_packed(z, axes[:-1], sizes[:-1])
    sl[axes[-1]] = slice(0, modes[-1])
    full[tuple(sl)] = padded
    want = np.fft.irfftn(full, s=sizes, axes=axes, norm="forward")

    got = spectral.rfft_pad_inverse(jnp.asarray(zr), jnp.asarray(zi), sizes)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-4)


def test_extended_reverse_matches_full_reverse():
    """True reversal on the extended kept set == reverse full spectrum then
    crop (the reference's use_transform=True individual-weights semantics)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 12, 11, 2)).astype(np.float32)
    axes = (1, 2)
    modes = (3, 4)
    h = np_dht(x, axes)

    def full_reverse(a, ax_list):
        for ax in ax_list:
            a = np.roll(np.flip(a, ax), 1, ax)
        return a

    want = np_crop_packed(full_reverse(h, axes), axes, modes)
    ext = spectral.dht_crop(jnp.asarray(x), modes, extended=True)
    got = np.asarray(spectral.extended_to_packed(
        spectral.extended_reverse(ext, axes), axes))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_packed_reverse_is_flip_roll():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 6, 8, 3)).astype(np.float32)
    got = np.asarray(spectral.packed_reverse(jnp.asarray(x), (1, 2)))
    want = x
    for ax in (1, 2):
        want = np.roll(np.flip(want, ax), 1, ax)
    np.testing.assert_allclose(got, want)


def test_mode_clipping():
    assert spectral.clip_modes((10, 14, 14), (20, 20, 16)) == (10, 10, 8)
    assert spectral.normalize_modes(5, 3) == (5, 5, 5)


def test_channel_mix_matches_einsum():
    """The 1x1 channel mix is the plain einsum at the framework precision,
    in every mode; bf16 activations keep their dtype, and 'mixed' mode runs
    the dot with the fp32 weight and casts back."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((5, 64, 24)).astype(np.float32)
    m = rng.standard_normal((24, 16)).astype(np.float32)
    xj, mj = jnp.asarray(x), jnp.asarray(m)
    want = np.einsum("dni,io->dno", x.astype(np.float64), m)
    for mode in ("highest", "high"):
        spectral.set_fp32_transform_precision(mode)
        try:
            got = spectral.channel_mix(xj, mj)
            assert got.dtype == jnp.float32
            np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                                       atol=1e-4)
        finally:
            spectral.set_fp32_transform_precision("highest")
    xb = xj.astype(jnp.bfloat16)
    got = spectral.channel_mix(xb, mj)
    assert got.dtype == jnp.bfloat16
    spectral.set_bf16_exact(True)
    try:
        got_mixed = spectral.channel_mix(xb, mj)
    finally:
        spectral.set_bf16_exact(False)
    assert got_mixed.dtype == jnp.bfloat16
    want_b = np.einsum("dni,io->dno", np.asarray(xb, np.float64), m)
    np.testing.assert_allclose(np.asarray(got_mixed, np.float64), want_b,
                               rtol=1e-2, atol=5e-2)


def _bench_spectral():
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "bench_spectral.py")
    spec = importlib.util.spec_from_file_location("bench_spectral", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("grid, modes", [
    ((9, 11, 11, 8), (3, 4, 4)),
    ((12, 10, 14, 4), (4, 5, 3)),
    ((7, 16, 9, 2), (2, 8, 4)),
], ids=["odd", "even-full", "mixed"])
def test_fft_form_matches_pruned_chains(grid, modes):
    """The reference's spectral core (full FFT + corner crop, zero-pad +
    inverse FFT), as tools/bench_spectral.py times it, computes what the
    pruned matmul chains compute."""
    bench = _bench_spectral()
    x = jnp.asarray(np.random.default_rng(5).standard_normal((1,) + grid),
                    jnp.float32)
    crop = spectral.dht_crop(x, modes)
    np.testing.assert_allclose(np.asarray(bench.fft_crop(x, modes)),
                               np.asarray(crop), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(bench.fft_pad_inverse(crop, grid[:3])),
        np.asarray(spectral.dht_pad_inverse(crop, grid[:3])), atol=1e-4)
