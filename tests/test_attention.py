"""Golden parity tests for HartleyMultiHeadAttention vs the reference."""
import numpy as np
import jax.numpy as jnp
import pytest

from multimodal_3d_image_segmentation.ops.attention import (
    HartleyMultiHeadAttention)
from tests.reference_oracle import (get_reference_nets, to_torch_channel_first,
                                    from_torch_channel_first)

ATOL = 3e-4


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _params_from_ref(ref, use_bias=False):
    p = {
        "weight_query": jnp.asarray(ref.weight_query.detach().numpy()),
        "weight_key": jnp.asarray(ref.weight_key.detach().numpy()),
        "weight_value": jnp.asarray(ref.weight_value.detach().numpy()),
        "weight_out": jnp.asarray(ref.weight_out.detach().numpy()),
    }
    if use_bias:
        for name in ["bias_query", "bias_key", "bias_value"]:
            t = getattr(ref, name).detach().numpy()
            p[name] = jnp.asarray(t.reshape(t.shape[1], t.shape[2]))
        p["bias_out"] = jnp.asarray(
            ref.bias_out.detach().numpy().reshape(-1))
    return p


@pytest.mark.parametrize("patch,shape,modes", [
    (None, (1, 12, 10, 8, 3), (3, 4, 2)),
    ((1, 2, 2), (1, 12, 10, 8, 3), (3, 4, 2)),
    (2, (1, 13, 11, 9, 2), (4, 4, 4)),
    (None, (2, 12, 10, 3), (3, 4)),     # 2D
    (2, (1, 13, 11, 2), (4, 4)),        # 2D patched
])
def test_hartley_mha_self_attention_parity(patch, shape, modes):
    nets, torch = get_reference_nets()
    cin, key_dim, heads = shape[-1], 4, 2
    x = _rand(shape, 1)

    ref = nets.hartley_mha.HartleyMultiHeadAttention(
        cin, key_dim, heads, modes, patch_size=patch, ndim=len(shape))
    with torch.no_grad():
        want = from_torch_channel_first(ref(to_torch_channel_first(x, torch)))

    mod = HartleyMultiHeadAttention(cin, key_dim, heads, modes,
                                    patch_size=patch)
    got = np.asarray(mod.apply({"params": _params_from_ref(ref)},
                               jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_hartley_mha_cross_attention_and_bias_parity():
    nets, torch = get_reference_nets()
    cin, key_dim, heads, modes = 3, 4, 2, (3, 4, 2)
    q = _rand((1, 12, 10, 8, cin), 2)
    kv = _rand((1, 12, 10, 8, cin), 3)
    v = _rand((1, 12, 10, 8, cin), 4)

    ref = nets.hartley_mha.HartleyMultiHeadAttention(
        cin, key_dim, heads, modes, use_bias=True, ndim=5)
    with torch.no_grad():
        for b in [ref.bias_query, ref.bias_key, ref.bias_value, ref.bias_out]:
            b.uniform_(-0.5, 0.5)
        want2 = from_torch_channel_first(ref(
            [to_torch_channel_first(q, torch),
             to_torch_channel_first(kv, torch)]))
        want3 = from_torch_channel_first(ref(
            [to_torch_channel_first(q, torch),
             to_torch_channel_first(kv, torch),
             to_torch_channel_first(v, torch)]))

    mod = HartleyMultiHeadAttention(cin, key_dim, heads, modes, use_bias=True)
    params = _params_from_ref(ref, use_bias=True)
    got2 = np.asarray(mod.apply({"params": params},
                                (jnp.asarray(q), jnp.asarray(kv))))
    got3 = np.asarray(mod.apply(
        {"params": params},
        (jnp.asarray(q), jnp.asarray(kv), jnp.asarray(v))))
    np.testing.assert_allclose(got2, want2, atol=ATOL)
    np.testing.assert_allclose(got3, want3, atol=ATOL)


def test_hartley_mha_notransform_parity():
    nets, torch = get_reference_nets()
    cin, key_dim, heads, modes = 3, 4, 2, (3, 4, 2)
    packed = (1, 6, 8, 4, cin)
    x = _rand(packed, 5)

    ref = nets.hartley_mha.HartleyMultiHeadAttention(
        cin, key_dim, heads, modes, use_transform=False, ndim=5)
    with torch.no_grad():
        want = from_torch_channel_first(ref(to_torch_channel_first(x, torch)))

    mod = HartleyMultiHeadAttention(cin, key_dim, heads, modes,
                                    use_transform=False)
    got = np.asarray(mod.apply({"params": _params_from_ref(ref)},
                               jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=ATOL)
