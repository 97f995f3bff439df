"""Parity tests for conv/transposed-conv/resize/padcrop building blocks
against PyTorch semantics."""
import numpy as np
import jax.numpy as jnp
import pytest

from multimodal_3d_image_segmentation.ops.convs import Conv, ConvTranspose
from multimodal_3d_image_segmentation.ops.resize import (resize_linear,
                                                             resize_nearest)
from multimodal_3d_image_segmentation.ops.padcrop import spatial_padcrop
from tests.reference_oracle import (to_torch_channel_first,
                                    from_torch_channel_first)

torch = pytest.importorskip("torch")


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("k,s,shape", [
    (1, 1, (2, 7, 9, 8, 3)),
    (3, 1, (1, 8, 7, 9, 2)),
    (2, 2, (1, 9, 8, 7, 2)),   # learnable downsample: n -> n//2 + 1
    (3, 2, (1, 10, 9, 11, 2)),  # VNet downsampling
])
def test_conv_matches_torch(k, s, shape):
    cin, cout = shape[-1], 4
    x = _rand(shape, 1)
    padding = "same" if s == 1 else k // 2
    ref = torch.nn.Conv3d(cin, cout, k, s, padding)
    with torch.no_grad():
        want = from_torch_channel_first(ref(to_torch_channel_first(x, torch)))

    mod = Conv(cout, k, s, use_bias=True)
    # torch conv weight (O, I, *k) -> flax kernel (*k, I, O)
    w = ref.weight.detach().numpy().transpose(2, 3, 4, 1, 0)
    params = {"kernel": jnp.asarray(w), "bias": jnp.asarray(
        ref.bias.detach().numpy())}
    got = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("k,shape", [
    (2, (1, 5, 6, 7, 3)),
    (3, (1, 6, 5, 4, 2)),
])
def test_conv_transpose_matches_torch(k, shape):
    cin, cout = shape[-1], 4
    x = _rand(shape, 2)
    ref = torch.nn.ConvTranspose3d(cin, cout, k, 2, k // 2, output_padding=1)
    with torch.no_grad():
        want = from_torch_channel_first(ref(to_torch_channel_first(x, torch)))

    mod = ConvTranspose(cout, k, use_bias=True)
    # torch transposed-conv weight (I, O, *k) -> our kernel (*k, I, O)
    w = ref.weight.detach().numpy().transpose(2, 3, 4, 0, 1)
    params = {"kernel": jnp.asarray(w), "bias": jnp.asarray(
        ref.bias.detach().numpy())}
    got = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("in_shape,out_size", [
    ((1, 5, 6, 7, 2), (10, 12, 14)),
    ((1, 6, 7, 2), (13, 9)),           # 2D up+down mix
    ((2, 8, 8, 8, 3), (5, 11, 8)),
])
def test_resize_linear_matches_torch_interpolate(in_shape, out_size):
    x = _rand(in_shape, 3)
    mode = "trilinear" if len(out_size) == 3 else "bilinear"
    want = from_torch_channel_first(torch.nn.functional.interpolate(
        to_torch_channel_first(x, torch), size=out_size, mode=mode))
    got = np.asarray(resize_linear(jnp.asarray(x), out_size))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("in_shape,out_size", [
    ((1, 5, 6, 7, 2), (10, 12, 14)),
    ((2, 9, 4, 3), (5, 9)),
])
def test_resize_nearest_matches_torch_interpolate(in_shape, out_size):
    x = _rand(in_shape, 4)
    want = from_torch_channel_first(torch.nn.functional.interpolate(
        to_torch_channel_first(x, torch), size=out_size, mode="nearest"))
    got = np.asarray(resize_nearest(jnp.asarray(x), out_size))
    np.testing.assert_allclose(got, want, atol=0)


def test_spatial_padcrop_matches_reference_semantics():
    """Odd differences put the extra element on the high side, both for
    padding and cropping (reference ``nets/nets_utils.py:60-99``)."""
    x = _rand((1, 5, 8, 6, 2), 5)
    y = np.asarray(spatial_padcrop(jnp.asarray(x), (8, 5, 6)))
    assert y.shape == (1, 8, 5, 6, 2)
    # pad 5->8: d=3 -> lo 1, hi 2
    np.testing.assert_allclose(y[:, 1:6, :, :, :][:, :, :, :, :],
                               x[:, :, 1:6][..., :, :], atol=0)
    # crop 8->5: d=3 -> lo 1, hi 2 (keep rows 1..5)
    np.testing.assert_allclose(y[:, 1:6], x[:, :, 1:6], atol=0)

    # identity
    z = spatial_padcrop(jnp.asarray(x), (5, 8, 6))
    np.testing.assert_allclose(np.asarray(z), x)


def test_resize_channel_first_matches_channels_last():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1, 7, 9, 6, 3)).astype(np.float32)
    x_cf = np.transpose(x, (0, 4, 1, 2, 3))
    out_cl = np.asarray(resize_linear(jnp.asarray(x), (14, 13, 11)))
    out_cf = np.asarray(resize_linear(jnp.asarray(x_cf), (14, 13, 11),
                                      channel_first=True))
    np.testing.assert_allclose(np.transpose(out_cf, (0, 2, 3, 4, 1)),
                               out_cl, atol=1e-6)

    n_cl = np.asarray(resize_nearest(jnp.asarray(x), (3, 5, 12)))
    n_cf = np.asarray(resize_nearest(jnp.asarray(x_cf), (3, 5, 12),
                                     channel_first=True))
    np.testing.assert_array_equal(np.transpose(n_cf, (0, 2, 3, 4, 1)), n_cl)
