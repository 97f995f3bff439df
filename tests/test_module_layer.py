"""The in-repo module layer (``nn.py``) against recorded goldens.

Goldens (``tests/fixtures/module_layer/``, see ``module_goldens.py``) hold
parameter paths and shapes of every shipped config, forward outputs and
one-step loss + gradients at small shapes, and per-family parameter
counts. Parameters are filled from their paths, so a renamed or reshaped
parameter fails here before it can break a checkpoint.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import module_goldens as mg
from multimodal_3d_image_segmentation import losses, models, nn
from multimodal_3d_image_segmentation.utils.labels import to_categorical


def _load_json(name):
    with open(os.path.join(mg.FIXTURES, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def forward_goldens():
    return dict(np.load(os.path.join(mg.FIXTURES, "forward.npz")))


@pytest.fixture(scope="module")
def grad_goldens():
    return dict(np.load(os.path.join(mg.FIXTURES, "grads.npz")))


def _shapes(model, shape):
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros(shape, jnp.float32)))["params"]


def _flat(tree):
    return {mg.path_str(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _build(model_name, kw):
    return getattr(models, model_name)(**kw)


@pytest.mark.parametrize("config", sorted(mg.CONFIGS))
def test_param_tree_matches_golden(config):
    model_name, kw, shape = mg.config_model(config)
    got = {p: list(leaf.shape)
           for p, leaf in _flat(_shapes(_build(model_name, kw), shape)).items()}
    assert got == _load_json("param_trees.json")[config]


@pytest.mark.parametrize("case", sorted(mg.FORWARD_CASES))
def test_forward_matches_golden(case, forward_goldens):
    model_name, kw, shape = mg.FORWARD_CASES[case]
    model = _build(model_name, kw)
    params = mg.fill_params(_shapes(model, shape))
    y = jax.jit(lambda p, v: model.apply({"params": p}, v))(
        params, mg.make_input(shape))
    want = forward_goldens[case]
    assert y.shape == want.shape and y.dtype == want.dtype
    # the golden must not be a flat softmax: it has to discriminate
    assert float(np.std(want)) > 1e-3
    tol = 2e-2 if kw.get("compute_dtype") == "bfloat16" else 2e-5
    np.testing.assert_allclose(np.asarray(y), want, atol=tol, rtol=0)


@pytest.mark.parametrize("family", sorted(mg.GRAD_CASES))
def test_loss_and_grad_match_golden(family, grad_goldens):
    model_name, kw, shape = mg.FORWARD_CASES[mg.GRAD_CASES[family]]
    model = _build(model_name, kw)
    params = mg.fill_params(_shapes(model, shape))
    x = mg.make_input(shape)
    y1h = to_categorical(mg.make_labels(shape, kw["out_channels"]),
                         kw["out_channels"])

    def loss_fn(p):
        return losses.pcc_loss(model.apply({"params": p}, x), y1h)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    np.testing.assert_allclose(float(loss),
                               grad_goldens[f"{family}::loss"], rtol=1e-5)
    flat = _flat(grads)
    want = {k.split("::", 1)[1]: v for k, v in grad_goldens.items()
            if k.startswith(f"{family}::") and not k.endswith("::loss")}
    assert sorted(flat) == sorted(want)
    for path, g in flat.items():
        scale = float(np.max(np.abs(want[path]))) + 1e-12
        np.testing.assert_allclose(np.asarray(g), want[path],
                                   atol=1e-4 * scale, rtol=0, err_msg=path)


@pytest.mark.parametrize("family", sorted(mg.FAMILIES))
def test_summary_param_count(family):
    model_name, kw, shape = mg.config_model(mg.FAMILIES[family])
    text, rows = nn.tabulate(_build(model_name, kw),
                             jnp.zeros(shape, jnp.float32))
    want = _load_json("param_counts.json")[family]
    assert f"Total parameters: {want:,}" in text
    assert rows[0][0] == () and rows[0][3] == want
    if family == "HNOSegXS":
        assert want == 28248  # the reference's install smoke test


@pytest.mark.parametrize("use_deep_supervision", [False, True])
def test_remat_matches_plain(use_deep_supervision):
    kw = dict(in_channels=2, out_channels=3, filters=6,
              num_transform_blocks=[2, 2, 2], num_modes=(3, 3, 3),
              use_deep_supervision=use_deep_supervision)
    plain = models.HNOSegXS(**kw)
    remat = models.HNOSegXS(**kw, use_remat=True)
    shape = (1, 2, 12, 12, 10)
    params = plain.init(jax.random.PRNGKey(0), jnp.zeros(shape))["params"]
    assert (jax.tree_util.tree_structure(params) == jax.tree_util.
            tree_structure(remat.init(jax.random.PRNGKey(0),
                                      jnp.zeros(shape))["params"]))
    x = mg.make_input(shape)
    y1h = to_categorical(mg.make_labels(shape, 3), 3)

    def loss(model):
        return jax.jit(jax.value_and_grad(lambda p: losses.pcc_loss(
            model.apply({"params": p}, x), y1h)))(params)

    (l0, g0), (l1, g1) = loss(plain), loss(remat)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(g0),
                    jax.tree_util.tree_leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


class _Norm(nn.Module):
    @nn.compact
    def __call__(self, x):
        return nn.GroupNorm(num_groups=1, epsilon=1e-5, name="gn")(x)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_group_norm_formula(ndim, dtype):
    shape = (2,) + (5, 6, 4)[:ndim] + (6,)
    x = jnp.asarray(mg.make_input(shape) * 3 + 1, dtype)
    model = _Norm()
    params = model.init(jax.random.PRNGKey(0), x)["params"]
    assert {k: v.shape for k, v in params["gn"].items()} == {
        "scale": (6,), "bias": (6,)}
    rng = np.random.default_rng(3)
    params = {"gn": {"scale": jnp.asarray(rng.uniform(0.5, 2, 6),
                                          jnp.float32),
                     "bias": jnp.asarray(rng.uniform(-1, 1, 6),
                                         jnp.float32)}}
    y = model.apply({"params": params}, x)
    # statistics in float32 promote the output to float32
    assert y.dtype == jnp.float32
    xf = np.asarray(x, np.float64)
    axes = tuple(range(1, xf.ndim))
    mean = xf.mean(axes, keepdims=True)
    var = xf.var(axes, keepdims=True)
    want = ((xf - mean) / np.sqrt(var + 1e-5)
            * np.asarray(params["gn"]["scale"]) + np.asarray(
                params["gn"]["bias"]))
    np.testing.assert_allclose(np.asarray(y), want, atol=2e-4, rtol=2e-4)


class _Dup(nn.Module):
    @nn.compact
    def __call__(self, x):
        x = _Norm(name="a")(x)
        return _Norm(name="a")(x)


class _Leaf(nn.Module):
    def weight(self):
        return self.param("w", lambda k, s, d: jnp.ones(s, d), (2,))


def test_duplicate_submodule_name_raises():
    with pytest.raises(ValueError, match="duplicate submodule name 'a'"):
        _Dup().init(jax.random.PRNGKey(0), jnp.ones((1, 3, 2)))


def test_missing_param_raises():
    model = _Norm()
    x = jnp.ones((1, 3, 2))
    params = model.init(jax.random.PRNGKey(0), x)["params"]
    del params["gn"]["bias"]
    with pytest.raises(KeyError, match="gn/bias"):
        model.apply({"params": params}, x)


def test_param_outside_compact_raises():
    with pytest.raises(RuntimeError, match="outside a compact method"):
        _Leaf().weight()
