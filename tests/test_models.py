"""Model construction, parameter-count goldens, and shape tests.

The 28,248 parameter count for the flagship HNOSeg-XS config is the
reference's install smoke test (reference ``README.md:57-63``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_3d_image_segmentation import models


def n_params(params):
    return sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(params))


def test_hnosegxs_flagship_param_count():
    model = models.HNOSegXS(
        in_channels=4, out_channels=4, filters=24,
        num_transform_blocks=[3] * 8, num_modes=(10, 14, 14))
    x = jnp.zeros((1, 4, 32, 32, 32))
    params = model.init(jax.random.PRNGKey(0), x)["params"]
    assert n_params(params) == 28248


def test_hnosegxs_forward_shapes_and_softmax():
    model = models.HNOSegXS(4, 3, 8, [2, 2, 2], (3, 3, 3))
    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        (1, 4, 24, 20, 16)).astype(np.float32))
    params = model.init(jax.random.PRNGKey(0), x)
    y = model.apply(params, x)
    assert y.shape == (1, 3, 24, 20, 16)
    np.testing.assert_allclose(np.asarray(y.sum(axis=1)), 1.0, atol=1e-5)


def test_hnosegxs_zero_shot_super_resolution():
    """Same params run at a different (larger) resolution — the headline
    capability (reference ``README.md:83-87``)."""
    model = models.HNOSegXS(2, 3, 8, [2, 2], (3, 4, 4),
                            use_deep_supervision=True)
    x_small = jnp.zeros((1, 2, 16, 16, 12))
    params = model.init(jax.random.PRNGKey(1), x_small)
    x_big = jnp.asarray(np.random.default_rng(1).standard_normal(
        (1, 2, 32, 32, 24)).astype(np.float32))
    y = model.apply(params, x_big)
    assert y.shape == (1, 3, 32, 32, 24)


@pytest.mark.parametrize("transform_type", ["Fourier", "Hartley"])
def test_neural_operator_seg_forward(transform_type):
    model = models.NeuralOperatorSeg(
        in_channels=2, out_channels=3, filters=6, num_transform_blocks=3,
        num_modes=(3, 3, 3), transform_type=transform_type,
        use_deep_supervision=True)
    x = jnp.asarray(np.random.default_rng(2).standard_normal(
        (1, 2, 16, 16, 12)).astype(np.float32))
    params = model.init(jax.random.PRNGKey(2), x)
    y = model.apply(params, x)
    assert y.shape == (1, 3, 16, 16, 12)
    np.testing.assert_allclose(np.asarray(y.sum(axis=1)), 1.0, atol=1e-5)


def test_hartley_mha_seg_forward():
    model = models.HartleyMHASeg(
        in_channels=2, out_channels=3, filters=8, num_transform_blocks=2,
        num_heads=2, num_modes=(4, 4, 4), patch_size=2)
    x = jnp.asarray(np.random.default_rng(3).standard_normal(
        (1, 2, 16, 16, 16)).astype(np.float32))
    params = model.init(jax.random.PRNGKey(3), x)
    y = model.apply(params, x)
    assert y.shape == (1, 3, 16, 16, 16)


def test_vnetds_forward():
    model = models.VNetDS(
        in_channels=2, out_channels=3, base_num_filters=4,
        num_blocks=[1, 2, 3], right_leg_indexes=[0, 1, 2])
    x = jnp.asarray(np.random.default_rng(4).standard_normal(
        (1, 2, 24, 24, 16)).astype(np.float32))
    params = model.init(jax.random.PRNGKey(4), x)
    y = model.apply(params, x)
    assert y.shape == (1, 3, 24, 24, 16)
    np.testing.assert_allclose(np.asarray(y.sum(axis=1)), 1.0, atol=1e-5)


def test_vnetds_snn_selu():
    model = models.VNetDS(
        in_channels=1, out_channels=2, base_num_filters=4,
        num_blocks=[1, 1], activation="selu", use_snn=True)
    x = jnp.zeros((1, 1, 16, 16, 16))
    params = model.init(jax.random.PRNGKey(5), x)
    y = model.apply(params, x)
    assert y.shape == (1, 2, 16, 16, 16)


def test_models_2d():
    """2D vs 3D is a config outcome, not a code path choice."""
    model = models.HNOSegXS(3, 2, 8, [2, 2], (4, 4), ndim=4)
    x = jnp.asarray(np.random.default_rng(5).standard_normal(
        (2, 3, 24, 20)).astype(np.float32))
    params = model.init(jax.random.PRNGKey(6), x)
    y = model.apply(params, x)
    assert y.shape == (2, 2, 24, 20)


@pytest.mark.slow
def test_hnosegxs_remat_matches():
    """use_remat trades memory for FLOPs without changing values/grads."""
    from multimodal_3d_image_segmentation import losses
    kw = dict(in_channels=2, out_channels=3, filters=8,
              num_transform_blocks=[2, 2], num_modes=(3, 4, 4))
    m0 = models.HNOSegXS(**kw)
    m1 = models.HNOSegXS(**kw, use_remat=True)
    x = jnp.asarray(np.random.default_rng(7).standard_normal(
        (1, 2, 16, 16, 12)).astype(np.float32))
    y = jnp.asarray((np.random.default_rng(8).integers(
        0, 3, (1, 16, 16, 12))))
    y1h = jax.nn.one_hot(y, 3, axis=1)
    params = m0.init(jax.random.PRNGKey(0), x)["params"]

    def loss(m):
        return lambda p: losses.pcc_loss(m.apply({"params": p}, x), y1h)

    l0, g0 = jax.value_and_grad(loss(m0))(params)
    l1, g1 = jax.value_and_grad(loss(m1))(params)
    np.testing.assert_allclose(float(l0), float(l1), atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(g0),
                    jax.tree_util.tree_leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
