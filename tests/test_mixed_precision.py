"""'mixed' serving mode: bf16 activation storage + fp32 weight/matrix
islands (``ops/spectral.set_bf16_exact``).

The mode eliminates the systematic matrix/weight rounding that plain-bf16
serving pays on every cancellation-heavy spectral contraction, leaving
only activation-storage rounding. These tests pin:
  * the flag routes (outputs differ from plain bf16, dtype stays bf16);
  * transform numerics collapse to input-rounding class (matrix rounding
    gone) while plain bf16 is measurably worse;
  * whole-model error vs the fp32-HIGHEST oracle does not regress vs
    plain bf16;
  * the runtime maps ``[model] compute_dtype = mixed``.

Quality at the reference's 0.1% Dice bar is adjudicated on trained
networks on the GPU (tools/bench_precision.py) — not here.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multimodal_3d_image_segmentation import models
from multimodal_3d_image_segmentation.ops import spectral


@pytest.fixture(autouse=True)
def _restore_flags():
    yield
    spectral.set_bf16_exact(False)
    spectral.set_fp32_transform_precision("highest")


def _smooth_volume(shape, c=3, seed=0):
    """Low-frequency multi-channel volume: DHT coefficients of a smooth
    signal are dominated by cancellation, making matrix rounding visible."""
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.linspace(0, 2 * np.pi, s) for s in shape],
                        indexing="ij")
    chans = []
    for i in range(c):
        f = np.zeros(shape)
        for _ in range(4):
            k = rng.integers(1, 4, 3)
            f = f + rng.standard_normal() * np.cos(
                k[0] * grids[0] + k[1] * grids[1] + k[2] * grids[2])
        chans.append(f)
    return np.stack(chans, -1)[None].astype(np.float32)


def test_transform_island_collapses_matrix_rounding():
    x64 = _smooth_volume((24, 24, 20)).astype(np.float64)
    modes = (6, 6, 6)

    def roundtrip(x):
        y = spectral.dht_crop(x, modes)
        return spectral.dht_pad_inverse(y, x.shape[1:-1])

    want = np.asarray(roundtrip(jnp.asarray(x64)), np.float64)

    xb = jnp.asarray(x64.astype(np.float32)).astype(jnp.bfloat16)
    spectral.set_bf16_exact(False)
    err_bf16 = float(np.max(np.abs(
        np.asarray(roundtrip(xb), np.float64) - want)))
    spectral.set_bf16_exact(True)
    out_mixed = roundtrip(xb)
    err_mixed = float(np.max(np.abs(
        np.asarray(out_mixed, np.float64) - want)))

    # input rounding alone bounds the island: |DHT rt| amplification of
    # the 2^-9 bf16 input noise stays ~1e-2 at this scale, while plain
    # bf16 adds per-stage matrix rounding on top
    scale = float(np.max(np.abs(want)))
    assert err_mixed < err_bf16, (err_mixed, err_bf16)
    assert err_mixed < 8e-3 * scale, (err_mixed, scale)
    # spectra ride fp32 inside the island; the caller keeps bf16 in this
    # test's roundtrip only at the input
    assert out_mixed.dtype == jnp.float32


@pytest.mark.parametrize("family", ["fnoseg", "xs"])
def test_model_mixed_routes_and_does_not_regress(family):
    if family == "fnoseg":
        build = lambda **kw: models.NeuralOperatorSeg(  # noqa: E731
            3, 4, 8, 4, (4, 5, 5), "Fourier", **kw)
    else:
        build = lambda **kw: models.HNOSegXS(  # noqa: E731
            3, 4, 8, [2] * 4, (4, 5, 5), **kw)
    x = jnp.asarray(_smooth_volume((32, 32, 26))
                    .transpose(0, 4, 1, 2, 3))          # channel-first

    def run(dtype, mixed):
        spectral.set_bf16_exact(mixed)
        spectral.set_fp32_transform_precision("highest")
        m = build(compute_dtype=dtype)
        p = m.init(jax.random.PRNGKey(0), jnp.zeros_like(x))["params"]
        return np.asarray(m.apply({"params": p}, x), np.float32)

    ref = run("float32", False)
    bf = run("bfloat16", False)
    mx = run("bfloat16", True)

    assert np.any(mx != bf), "mixed mode did not change the computation"
    d_bf = float(np.abs(bf - ref).mean())
    d_mx = float(np.abs(mx - ref).mean())
    # islands must not make things worse; they usually help (the margin
    # is loose because activation-storage rounding dominates both)
    assert d_mx <= d_bf * 1.1, (d_mx, d_bf)


def test_run_config_maps_mixed(tmp_path):
    from multimodal_3d_image_segmentation.runtime.run import _build_model

    class _Data:
        def get_num_x_modalities(self):
            return 3

    cfg = {"model": {"model_name": "HNOSegXS", "out_channels": 4,
                     "filters": 8, "num_transform_blocks": [2, 2],
                     "num_modes": [4, 5, 5],
                     "compute_dtype": "mixed"}}
    model = _build_model(cfg, _Data(), lambda: (32, 32, 26))
    assert model.compute_dtype == "bfloat16"
    assert spectral.BF16_EXACT
