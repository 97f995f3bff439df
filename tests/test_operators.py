"""Golden parity tests: JAX operators vs the upstream PyTorch reference
with identical weights (skipped when the reference checkout is absent)."""
import numpy as np
import jax.numpy as jnp
import pytest

from multimodal_3d_image_segmentation.ops.operators import (
    FourierOperator, HartleyOperator)
from tests.reference_oracle import (get_reference_nets, to_torch_channel_first,
                                    from_torch_channel_first)

ATOL = 2e-4


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("weights_type", ["shared", "individual"])
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("shape,modes", [
    ((1, 12, 10, 8, 3), (3, 4, 2)),       # 3D
    ((2, 13, 11, 3), (4, 5)),             # 2D, odd sizes
])
def test_hartley_operator_transform_parity(weights_type, use_bias, shape,
                                           modes):
    nets, torch = get_reference_nets()
    cin, cout = shape[-1], 5
    x = _rand(shape, 1)

    ref = nets.hartley_operator.HartleyOperator(
        cin, cout, modes, use_bias=use_bias, weights_type=weights_type,
        use_transform=True, ndim=len(shape))
    with torch.no_grad():
        want = from_torch_channel_first(ref(to_torch_channel_first(x, torch)))

    mod = HartleyOperator(cin, cout, modes, use_bias=use_bias,
                          weights_type=weights_type, use_transform=True)
    params = {"weight": jnp.asarray(ref.weight.detach().numpy())}
    if use_bias:
        # make the bias non-trivial, then sync both implementations
        with torch.no_grad():
            ref.bias.uniform_(-0.5, 0.5)
            want = from_torch_channel_first(
                ref(to_torch_channel_first(x, torch)))
        params["bias"] = jnp.asarray(
            ref.bias.detach().numpy().reshape(-1))
    got = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("weights_type", ["shared", "individual"])
@pytest.mark.parametrize("packed_shape,modes", [
    ((1, 6, 8, 4, 3), (3, 4, 2)),
    ((2, 8, 10, 3), (4, 5)),
])
def test_hartley_operator_notransform_parity(weights_type, packed_shape,
                                             modes):
    nets, torch = get_reference_nets()
    cin, cout = packed_shape[-1], 4
    x = _rand(packed_shape, 2)

    ref = nets.hartley_operator.HartleyOperator(
        cin, cout, modes, use_bias=False, weights_type=weights_type,
        use_transform=False, ndim=len(packed_shape))
    with torch.no_grad():
        want = from_torch_channel_first(ref(to_torch_channel_first(x, torch)))

    mod = HartleyOperator(cin, cout, modes, weights_type=weights_type,
                          use_transform=False)
    params = {"weight": jnp.asarray(ref.weight.detach().numpy())}
    got = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("weights_type", ["shared", "individual"])
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("shape,modes", [
    ((1, 12, 10, 8, 3), (3, 4, 2)),
    ((2, 13, 11, 3), (4, 5)),
])
def test_fourier_operator_transform_parity(weights_type, use_bias, shape,
                                           modes):
    nets, torch = get_reference_nets()
    cin, cout = shape[-1], 5
    x = _rand(shape, 3)

    ref = nets.fourier_operator.FourierOperator(
        cin, cout, modes, use_bias=use_bias, weights_type=weights_type,
        use_transform=True, ndim=len(shape))
    if use_bias:
        with torch.no_grad():
            ref.bias.uniform_(-0.5, 0.5)
    with torch.no_grad():
        want = from_torch_channel_first(ref(to_torch_channel_first(x, torch)))

    mod = FourierOperator(cin, cout, modes, use_bias=use_bias,
                          weights_type=weights_type, use_transform=True)
    params = {
        "weight_real": jnp.asarray(ref.weight_real.detach().numpy()),
        "weight_imag": jnp.asarray(ref.weight_imag.detach().numpy()),
    }
    if use_bias:
        params["bias"] = jnp.asarray(ref.bias.detach().numpy().reshape(-1))
    got = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_fourier_operator_notransform_parity():
    nets, torch = get_reference_nets()
    cin, cout, modes = 3, 4, (3, 4, 2)
    packed = (1, 6, 8, 2, cin)
    re, im = _rand(packed, 4), _rand(packed, 5)

    ref = nets.fourier_operator.FourierOperator(
        cin, cout, modes, weights_type="shared", use_transform=False, ndim=5)
    xt = torch.complex(to_torch_channel_first(re, torch),
                       to_torch_channel_first(im, torch))
    with torch.no_grad():
        out = ref(xt)
    want_re = from_torch_channel_first(out.real)
    want_im = from_torch_channel_first(out.imag)

    mod = FourierOperator(cin, cout, modes, weights_type="shared",
                          use_transform=False)
    params = {
        "weight_real": jnp.asarray(ref.weight_real.detach().numpy()),
        "weight_imag": jnp.asarray(ref.weight_imag.detach().numpy()),
    }
    got_re, got_im = mod.apply({"params": params},
                               (jnp.asarray(re), jnp.asarray(im)))
    np.testing.assert_allclose(np.asarray(got_re), want_re, atol=ATOL)
    np.testing.assert_allclose(np.asarray(got_im), want_im, atol=ATOL)


def test_hartley_operator_mode_clipping_matches_reference():
    """Shared weights clip modes to size//2 at call time — the zero-shot SR
    mechanism (reference ``nets/hartley_operator.py:172-178``)."""
    nets, torch = get_reference_nets()
    cin, cout, modes = 2, 3, (10, 14, 14)
    shape = (1, 8, 9, 7, cin)  # all sizes < 2*modes
    x = _rand(shape, 6)

    ref = nets.hartley_operator.HartleyOperator(
        cin, cout, modes, weights_type="shared", ndim=5)
    with torch.no_grad():
        want = from_torch_channel_first(ref(to_torch_channel_first(x, torch)))

    mod = HartleyOperator(cin, cout, modes, weights_type="shared")
    params = {"weight": jnp.asarray(ref.weight.detach().numpy())}
    got = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_hartley_operator_individual_tight_size_parity():
    """individual weights with spatial size == 2*modes exactly (the
    reference's minimum legal size)."""
    nets, torch = get_reference_nets()
    cin, cout, modes = 2, 3, (3, 4, 2)
    shape = (1, 6, 11, 4, cin)  # axes 0 and 2 tight (s == 2m), axis 1 loose
    x = _rand(shape, 20)

    ref = nets.hartley_operator.HartleyOperator(
        cin, cout, modes, weights_type="individual", use_transform=True,
        ndim=5)
    with torch.no_grad():
        want = from_torch_channel_first(ref(to_torch_channel_first(x, torch)))

    mod = HartleyOperator(cin, cout, modes, weights_type="individual",
                          use_transform=True)
    params = {"weight": jnp.asarray(ref.weight.detach().numpy())}
    got = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_export_operator_bias_shapes_load_into_reference():
    """export_reference_state_dict emits the reference's broadcast bias
    shapes — torch load_state_dict shape-checks strictly, so a flat (O,)
    operator bias would be rejected (``nets/hartley_operator.py:79``)."""
    nets, torch = get_reference_nets()
    import jax
    from multimodal_3d_image_segmentation.utils import (
        export_reference_state_dict)

    cin, cout, modes = 3, 5, (3, 4, 2)
    mod = HartleyOperator(cin, cout, modes, use_bias=True,
                          use_transform=True)
    x = _rand((1, 12, 10, 8, cin), 2)
    params = mod.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    sd = export_reference_state_dict(mod, params)
    assert sd["bias"].shape == (1, cout, 1, 1, 1)

    ref = nets.hartley_operator.HartleyOperator(
        cin, cout, modes, use_bias=True, use_transform=True, ndim=5)
    ref.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in sd.items()})
    with torch.no_grad():
        want = from_torch_channel_first(ref(to_torch_channel_first(x, torch)))
    got = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=ATOL)
