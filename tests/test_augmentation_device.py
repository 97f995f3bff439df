"""On-device augmentation: exact agreement with the host resampler for a
given matrix, and distributional/semantic checks for the random pipeline."""
import numpy as np
import jax
import jax.numpy as jnp

from multimodal_3d_image_segmentation.data.augmentation import (
    ImageTransform, apply_transform, transform_matrix_offset_center)
from multimodal_3d_image_segmentation.data.augmentation_device import (
    affine_nn_device, make_device_augment)


def test_affine_nn_device_matches_host_resampler():
    rng = np.random.default_rng(0)
    x = rng.random((2, 12, 14, 10)).astype(np.float32)
    m_xyz = np.eye(4)
    m_xyz[:3, :3] = [[0.95, 0.05, 0.0], [-0.04, 1.02, 0.03],
                     [0.0, -0.02, 0.98]]
    m_xyz[:3, 3] = [1.3, -0.8, 0.4]

    want = apply_transform(x, m_xyz, cval=-1.0)

    # host machinery -> explicit (A, t) in zyx coords for the device version
    img_size_xyz = x.shape[1:][::-1]
    m = transform_matrix_offset_center(m_xyz, img_size_xyz)
    a_xyz, t_xyz = m[:3, :3], m[:3, 3]
    perm = np.array([2, 1, 0])
    a = jnp.asarray(a_xyz[np.ix_(perm, perm)], jnp.float32)
    t = jnp.asarray(t_xyz[perm], jnp.float32)

    got = np.asarray(affine_nn_device(jnp.asarray(x), a, t, cval=-1.0))
    mismatch = (got != want).mean()
    assert mismatch < 1e-3, mismatch  # boundary rounding ties only


def test_device_augment_identity_when_gated_off():
    aug = make_device_augment(shift_range=[.3, .3, .3],
                              augmentation_probability=0.0)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.random((2, 2, 8, 8, 6)).astype(np.float32))
    y = jnp.asarray(rng.integers(0, 3, (2, 1, 8, 8, 6)).astype(np.float32))
    x2, y2 = jax.jit(aug)(jax.random.PRNGKey(0), x, y)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x))
    np.testing.assert_allclose(np.asarray(y2), np.asarray(y))


def test_device_augment_labels_integral_and_jointly_transformed():
    aug = make_device_augment(rotation_range=[20, 10, 5],
                              shift_range=[.1, .1, .1],
                              zoom_range=[0.85, 1.15], flip=[1, 1, 1],
                              augmentation_probability=1.0)
    rng = np.random.default_rng(2)
    seg = rng.integers(0, 4, (2, 1, 12, 12, 10)).astype(np.float32)
    x = jnp.asarray(seg.repeat(2, axis=1))  # channels == labels
    y = jnp.asarray(seg)
    x2, y2 = jax.jit(aug)(jax.random.PRNGKey(3), x, y)
    assert set(np.unique(np.asarray(y2))).issubset({0., 1., 2., 3.})
    # x and y got the SAME transform: channel 0 of x == y wherever inside
    np.testing.assert_allclose(np.asarray(x2)[:, :1], np.asarray(y2))


def test_device_flip_fold_matches_host_flip():
    """Pure flip (no other transform) must equal the host's array flip."""
    aug = make_device_augment(flip=[1, 0, 0], augmentation_probability=1.0)
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.random((1, 1, 9, 7, 6)).astype(np.float32))
    y = x[:, :1]
    flipped = []
    for s in range(40):
        x2, _ = jax.jit(aug)(jax.random.PRNGKey(s), x, y)
        x2 = np.asarray(x2)
        if np.allclose(x2, np.asarray(x)):
            continue
        np.testing.assert_allclose(x2, np.asarray(x)[:, :, ::-1], atol=1e-6)
        flipped.append(s)
    assert flipped, "flip never triggered in 40 draws"
