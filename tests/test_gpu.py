"""Tests that need the GPU. They skip elsewhere; ``python chip_smoke.py``
runs them on the card, in its own process, after its other phases."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (run on the card by chip_smoke.py)")
    return dev


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_pruned_transform_pair_gpu_matches_cpu(gpu, precision):
    """dht_crop -> dht_pad_inverse at the flagship block grid
    (1, 78, 121, 121, 24), modes (10, 14, 14), on the card against the
    CPU at fp32 'highest'. 'high' runs TF32 tensor-core products on the
    GPU (10-bit mantissa), hence its looser bound."""
    from multimodal_3d_image_segmentation.ops import spectral
    x = np.random.default_rng(0).standard_normal(
        (1, 78, 121, 121, 24)).astype(np.float32)
    modes = (10, 14, 14)

    def pair(v):
        return spectral.dht_pad_inverse(spectral.dht_crop(v, modes),
                                        x.shape[1:4])

    cpu = jax.devices("cpu")[0]
    try:
        want = np.asarray(jax.jit(pair)(jax.device_put(x, cpu)))
        spectral.set_fp32_transform_precision(precision)
        got = np.asarray(jax.jit(pair)(jax.device_put(x, gpu)))
    finally:
        spectral.set_fp32_transform_precision("highest")
    rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert rel <= (1e-5 if precision == "highest" else 2e-3), rel


@pytest.mark.gpu
def test_small_forward_gpu_matches_cpu(gpu):
    from multimodal_3d_image_segmentation import models
    model = models.HNOSegXS(4, 4, 8, [2, 2, 2], (3, 4, 4))
    x = np.random.default_rng(1).standard_normal(
        (1, 4, 20, 24, 24)).astype(np.float32)
    params = model.init(jax.random.PRNGKey(0), x)["params"]
    f = jax.jit(lambda p, v: model.apply({"params": p}, v))
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        yg = np.asarray(f(jax.device_put(params, gpu),
                          jax.device_put(x, gpu)))
        yc = np.asarray(f(jax.device_put(params, cpu),
                          jax.device_put(x, cpu)))
    np.testing.assert_allclose(yg, yc, atol=1e-5)
