"""End-to-end golden parity: full models vs the PyTorch reference with
imported weights (the checkpoint-migration contract)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multimodal_3d_image_segmentation import models
from multimodal_3d_image_segmentation.utils import (
    import_reference_state_dict)
from tests.reference_oracle import (get_reference_nets, to_torch_channel_first,
                                    from_torch_channel_first)


def _run_parity(ref_model, our_model, x, torch, atol):
    """x is channels-last; both models consume channel-first."""
    ref_model.eval()
    with torch.no_grad():
        want = ref_model(to_torch_channel_first(x, torch))
    want = want.detach().numpy()

    x_cf = jnp.asarray(np.transpose(
        x, (0, x.ndim - 1) + tuple(range(1, x.ndim - 1))))
    params = our_model.init(jax.random.PRNGKey(0), jnp.zeros_like(x_cf))
    sd = {k: v.detach().numpy() for k, v in ref_model.state_dict().items()}
    imported = import_reference_state_dict(our_model, params["params"], sd)
    got = np.asarray(our_model.apply({"params": imported}, x_cf))
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got, want, atol=atol)


def _rand(shape, seed):
    # channels-LAST here; helpers transpose as needed
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_hnosegxs_full_model_parity():
    nets, torch = get_reference_nets()
    ref = nets.HNOSegXS(3, 4, 8, [2, 2, 2, 2], (3, 4, 4),
                        use_deep_supervision=True)
    ours = models.HNOSegXS(3, 4, 8, [2, 2, 2, 2], (3, 4, 4),
                           use_deep_supervision=True)
    x = _rand((1, 20, 18, 16, 3), 1)
    _run_parity(ref, ours, x, torch, atol=2e-4)


@pytest.mark.parametrize("transform_type", ["Fourier", "Hartley"])
@pytest.mark.parametrize("weights_type", ["shared", "individual"])
def test_neural_operator_seg_full_model_parity(transform_type, weights_type):
    nets, torch = get_reference_nets()
    kw = dict(in_channels=2, out_channels=3, filters=6,
              num_transform_blocks=2, num_modes=(3, 4, 4),
              transform_type=transform_type, weights_type=weights_type,
              use_deep_supervision=True)
    ref = nets.NeuralOperatorSeg(**kw)
    ours = models.NeuralOperatorSeg(**kw)
    x = _rand((1, 18, 16, 16, 2), 2)
    _run_parity(ref, ours, x, torch, atol=3e-4)


def test_hartley_mha_seg_full_model_parity():
    nets, torch = get_reference_nets()
    kw = dict(in_channels=2, out_channels=3, filters=8,
              num_transform_blocks=2, num_heads=2, num_modes=(4, 4, 4),
              patch_size=2, use_deep_supervision=True)
    ref = nets.HartleyMHASeg(**kw)
    ours = models.HartleyMHASeg(**kw)
    x = _rand((1, 16, 16, 16, 2), 3)
    _run_parity(ref, ours, x, torch, atol=3e-4)


@pytest.mark.parametrize("use_snn,activation", [(False, "elu"),
                                                (True, "selu")])
def test_vnetds_full_model_parity(use_snn, activation):
    nets, torch = get_reference_nets()
    kw = dict(in_channels=2, out_channels=3, base_num_filters=4,
              num_blocks=[1, 2, 2], right_leg_indexes=[0, 1, 2],
              activation=activation, use_snn=use_snn)
    ref = nets.VNetDS(**kw)
    ours = models.VNetDS(**kw)
    x = _rand((1, 20, 18, 16, 2), 4)
    _run_parity(ref, ours, x, torch, atol=5e-4)


def test_vnetds_no_residual_no_ds_parity():
    nets, torch = get_reference_nets()
    kw = dict(in_channels=1, out_channels=2, base_num_filters=4,
              num_blocks=[1, 1], use_residual=False, use_resize=False)
    ref = nets.VNetDS(**kw)
    ours = models.VNetDS(**kw)
    x = _rand((1, 16, 16, 12, 1), 5)
    _run_parity(ref, ours, x, torch, atol=5e-4)


def test_hnosegxs_variant_parity():
    """Add-skip (no concat), no resize, no unet skip."""
    nets, torch = get_reference_nets()
    kw = dict(in_channels=2, out_channels=3, filters=8,
              num_transform_blocks=[2, 2], num_modes=(3, 4, 4),
              use_resize=False, use_unet_skip=False, use_block_concat=False)
    ref = nets.HNOSegXS(**kw)
    ours = models.HNOSegXS(**kw)
    x = _rand((1, 16, 16, 12, 2), 11)
    _run_parity(ref, ours, x, torch, atol=2e-4)


def test_hnosegxs_individual_weights_parity():
    nets, torch = get_reference_nets()
    kw = dict(in_channels=2, out_channels=3, filters=6,
              num_transform_blocks=[2, 2], num_modes=(3, 4, 4),
              weights_type="individual")
    ref = nets.HNOSegXS(**kw)
    ours = models.HNOSegXS(**kw)
    x = _rand((1, 20, 18, 16, 2), 12)
    _run_parity(ref, ours, x, torch, atol=2e-4)


def test_neural_operator_seg_no_block_skip_parity():
    nets, torch = get_reference_nets()
    kw = dict(in_channels=2, out_channels=3, filters=6,
              num_transform_blocks=2, num_modes=(3, 4, 4),
              transform_type="Fourier", use_block_skip=False,
              use_bias_conv_branch=True)
    ref = nets.NeuralOperatorSeg(**kw)
    ours = models.NeuralOperatorSeg(**kw)
    x = _rand((1, 18, 16, 16, 2), 13)
    _run_parity(ref, ours, x, torch, atol=3e-4)


def test_hnosegxs_2d_parity():
    nets, torch = get_reference_nets()
    kw = dict(in_channels=3, out_channels=2, filters=8,
              num_transform_blocks=[2, 2], num_modes=(4, 4), ndim=4)
    ref = nets.HNOSegXS(**kw)
    ours = models.HNOSegXS(**kw)
    x = _rand((2, 20, 18, 3), 14)
    _run_parity(ref, ours, x, torch, atol=2e-4)


def test_export_reference_state_dict_roundtrip():
    """Our params -> reference state dict -> torch reference model produces
    identical outputs (weights trained here usable in the reference)."""
    nets, torch = get_reference_nets()
    from multimodal_3d_image_segmentation.utils import (
        export_reference_state_dict)

    kw = dict(in_channels=2, out_channels=3, filters=8,
              num_transform_blocks=[2, 2], num_modes=(3, 4, 4))
    ours = models.HNOSegXS(**kw)
    x_cl = _rand((1, 16, 16, 12, 2), 30)
    x_cf = jnp.asarray(np.transpose(x_cl, (0, 4, 1, 2, 3)))
    params = ours.init(jax.random.PRNGKey(7), x_cf)["params"]
    got = np.asarray(ours.apply({"params": params}, x_cf))

    sd = export_reference_state_dict(ours, params)
    ref = nets.HNOSegXS(**kw)
    # no reshape: load_state_dict shape-checks strictly, so the exporter
    # must emit the reference's exact (broadcast) bias shapes itself
    ref.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in sd.items()})
    ref.eval()
    with torch.no_grad():
        want = ref(to_torch_channel_first(x_cl, torch)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)

    # structural roundtrip
    back = import_reference_state_dict(ours, params, sd)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
