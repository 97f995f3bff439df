"""Runtime unit tests: schedules vs torch, optimizers, checkpoints,
config parsing."""
import os
from io import StringIO

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multimodal_3d_image_segmentation import losses, models
from multimodal_3d_image_segmentation.runtime import (
    build_optimizer, build_schedule, create_train_state, make_train_step)
from multimodal_3d_image_segmentation.runtime.checkpoint import (
    load_checkpoint, load_params, save_checkpoint, save_params)
from multimodal_3d_image_segmentation.runtime.config import (get_config,
                                                                 save_config)
from multimodal_3d_image_segmentation.utils.labels import (remap_labels,
                                                               to_categorical)


def test_cosine_warm_restarts_matches_torch():
    torch = pytest.importorskip("torch")
    base_lr, eta_min, t0 = 5e-3, 1e-3, 17
    sched = build_schedule(
        {"scheduler_name": "CosineAnnealingWarmRestarts", "T_0": t0,
         "eta_min": eta_min}, base_lr, steps_per_epoch=1, num_epochs=1)

    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.Adamax([p], lr=base_lr)
    ref = torch.optim.lr_scheduler.CosineAnnealingWarmRestarts(
        opt, T_0=t0, eta_min=eta_min)
    for step in range(3 * t0):
        np.testing.assert_allclose(float(sched(step)), ref.get_last_lr()[0],
                                   rtol=1e-6)
        ref.step()


def test_schedule_default_t0_is_full_run():
    sched = build_schedule(
        {"scheduler_name": "CosineAnnealingWarmRestarts", "eta_min": 0.1},
        1.0, steps_per_epoch=7, num_epochs=10)
    # single ramp over 70 steps: monotone decreasing
    vals = [float(sched(s)) for s in range(70)]
    assert vals[0] == pytest.approx(1.0)
    assert all(a >= b for a, b in zip(vals, vals[1:]))
    assert vals[-1] > 0.1  # never quite reaches eta_min before restart


def test_optimizer_registry():
    for name in ["Adamax", "Adam", "AdamW", "SGD", "RMSprop"]:
        tx = build_optimizer({"optimizer_name": name, "lr": 1e-3})
        params = {"w": jnp.ones((3,))}
        state = tx.init(params)
        grads = {"w": jnp.ones((3,))}
        updates, _ = tx.update(grads, state, params)
        assert jnp.all(jnp.isfinite(updates["w"]))
    with pytest.raises(ValueError):
        build_optimizer({"optimizer_name": "Nope"})


def test_checkpoint_roundtrip(tmp_path):
    model = models.HNOSegXS(2, 3, 8, [2], (3, 3, 3))
    x = jnp.zeros((1, 2, 12, 12, 8))
    params = model.init(jax.random.PRNGKey(0), x)["params"]
    tx = build_optimizer({"optimizer_name": "Adamax", "lr": 1e-3})
    state = create_train_state(model, params, tx)

    step = make_train_step(losses.pcc_loss, num_labels=3, donate=False)
    y = jnp.zeros((1, 1, 12, 12, 8), jnp.int32)
    state, _ = step(state, jnp.ones_like(x), y)

    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, state, epoch=5, min_loss=0.25, best_epoch=3)

    fresh = create_train_state(model, params, tx)
    restored, epoch, min_loss, best_epoch = load_checkpoint(path, fresh)
    assert (epoch, min_loss, best_epoch) == (5, 0.25, 3)
    assert int(restored.step) == int(state.step)
    for a, b in zip(jax.tree_util.tree_leaves(restored.params),
                    jax.tree_util.tree_leaves(state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(restored.opt_state),
                    jax.tree_util.tree_leaves(state.opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # resumed training step must be identical to continuing the original
    s1, l1 = step(state, jnp.ones_like(x), y)
    s2, l2 = step(restored, jnp.ones_like(x), y)
    np.testing.assert_allclose(float(l1), float(l2))

    # weights-only export
    wpath = str(tmp_path / "model.npz")
    save_params(wpath, state.params)
    p2 = load_params(wpath, params)
    for a, b in zip(jax.tree_util.tree_leaves(p2),
                    jax.tree_util.tree_leaves(state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_config_dialect_matches_reference_files():
    """Our parser reads the shipped configs (same dialect as reference)."""
    cfg = get_config("configs/config_hnoseg_xs.ini")
    assert cfg["model"]["model_name"] == "HNOSegXS"
    assert cfg["model"]["num_modes"] == (10, 14, 14)
    assert cfg["model"]["num_transform_blocks"] == [3] * 8
    assert cfg["optimizer"]["lr"] == 5e-3
    assert cfg["statistics"]["region_labels"][1] == [1, 2, 3]
    # interpolation resolved
    assert cfg["input_lists"]["data_lists_train_paths"][0].endswith(
        "t1c_train-0.6.txt")


def test_save_config_snapshot(tmp_path):
    cfg = get_config("configs/config_hnoseg_xs.ini")
    save_config(cfg, str(tmp_path))
    assert os.path.exists(tmp_path / "config_hnoseg_xs.ini")
    reparsed = get_config(str(tmp_path / "config_hnoseg_xs.ini"))
    assert reparsed["model"]["num_modes"] == (10, 14, 14)


def test_to_categorical_and_remap():
    y = jnp.asarray(np.array([[[[0, 1], [2, 1]]]]))  # (1, 1, 2, 2)
    oh = to_categorical(y, 3)
    assert oh.shape == (1, 3, 2, 2)
    np.testing.assert_allclose(np.asarray(oh.sum(axis=1)), 1.0)
    np.testing.assert_allclose(np.asarray(oh[0, 2, 1, 0]), 1.0)

    remapped = remap_labels(y, {1: 4, 4: 1})
    assert int(remapped[0, 0, 0, 1]) == 4
    # numpy path
    out = remap_labels(np.asarray(y), {2: 9})
    assert out[0, 0, 1, 0] == 9


def test_profiling_utilities():
    from multimodal_3d_image_segmentation.utils.profiling import (
        Timer, device_memory_stats, time_calls)
    import jax.numpy as jnp

    t = Timer(skip_first=1)
    for _ in range(3):
        with t.measure():
            pass
    assert len(t.times) == 2 and t.mean >= 0 and t.median >= 0

    stats = device_memory_stats()
    assert "bytes_in_use_mib" in stats

    calls = []

    def fn(v):
        calls.append(1)
        return v * 2.0 + 1.0

    times = time_calls(fn, jnp.ones((64, 64)), iters=3, warmup=2)
    # warm-up calls run but are not reported
    assert len(calls) == 5 and len(times) == 3
    assert all(np.isfinite(t) and t >= 0 for t in times)


def test_async_checkpointer_ordering(tmp_path):
    from multimodal_3d_image_segmentation.runtime.checkpoint import (
        AsyncCheckpointer, load_params)
    ckpt = AsyncCheckpointer()
    path = str(tmp_path / "p.npz")
    template = {"w": jnp.zeros((4,))}
    # rapid successive saves: the last one must win
    for i in range(5):
        ckpt.save_params(path, {"w": jnp.full((4,), float(i))})
    ckpt.wait()
    out = load_params(path, template)
    np.testing.assert_allclose(np.asarray(out["w"]), 4.0)


@pytest.mark.parametrize("cfg_file", [
    "configs/config_hnoseg_xs.ini", "configs/config_fnoseg.ini",
    "configs/config_hnoseg.ini", "configs/config_fno.ini",
    pytest.param("configs/config_vnet-ds.ini", marks=pytest.mark.slow),
    "configs/config_hartleymha.ini",
])
def test_all_shipped_configs_build_models(cfg_file):
    """Every shipped config parses and constructs its model (with data-
    derived args injected the way run.py does)."""
    from multimodal_3d_image_segmentation.runtime.run import _build_model

    cfg = get_config(cfg_file)

    class FakeInput:
        def get_num_x_modalities(self):
            return 4

    model = _build_model(cfg, FakeInput(), lambda: (120, 120, 78))
    # large enough for the individual-weights / MHA mode asserts after the
    # stride-2 resize (the real configs run at 120x120x78)
    x = jnp.zeros((1, 4, 48, 48, 48), jnp.float32)
    params = model.init(jax.random.PRNGKey(0), x)["params"]
    y = model.apply({"params": params}, x)
    assert y.shape == (1, 4, 48, 48, 48)


def test_flagship_config_ships_benchmarked_settings():
    """The flagship config ships the benchmarked settings: the plain XLA
    path (no kernel switch) at fp32 transform_precision 'highest' (the
    TF32 'high' option is not quality-gated)."""
    for path in ("configs/config_hnoseg_xs.ini",
                 "configs/config_inference_hnoseg_xs.ini"):
        cfg = get_config(path)
        assert "use_pallas" not in cfg["model"]
        assert cfg["model"]["transform_precision"] == "highest"


def test_transform_precision_knob():
    import jax as _jax
    from multimodal_3d_image_segmentation.ops import spectral
    from multimodal_3d_image_segmentation.runtime.run import _build_model

    orig = spectral.PRECISION
    try:
        spectral.set_fp32_transform_precision("high")
        assert spectral._prec(jnp.float32) == _jax.lax.Precision.HIGH
        # bf16 activations are unaffected by the knob
        assert spectral._prec(jnp.bfloat16) == _jax.lax.Precision.DEFAULT
        with pytest.raises(ValueError):
            spectral.set_fp32_transform_precision("fast")

        # run.py plumbs [model] transform_precision and pops it before
        # constructing the model
        cfg = {"model": {"model_name": "HNOSegXS", "out_channels": 4,
                         "filters": 8, "num_transform_blocks": [1],
                         "num_modes": 4,
                         "transform_precision": "highest"}}

        class FakeInput:
            def get_num_x_modalities(self):
                return 4

        _build_model(cfg, FakeInput(), lambda: (16, 16, 16))
        assert spectral.PRECISION == _jax.lax.Precision.HIGHEST
    finally:
        spectral.PRECISION = orig


def test_save_model_graph(tmp_path):
    """model_graph.pdf artifact (reference train_test.py:117-122 analog)."""
    from multimodal_3d_image_segmentation.runtime.train_test import (
        save_model_graph)
    model = models.HNOSegXS(in_channels=4, out_channels=4, filters=8,
                            num_transform_blocks=[1, 1], num_modes=(3, 3, 3))
    out = tmp_path / "model_graph.pdf"
    save_model_graph(model, (1, 4, 16, 16, 16), str(out))
    assert out.stat().st_size > 1000


def test_loss_log_roundtrip(tmp_path):
    from multimodal_3d_image_segmentation.runtime.train_test import (
        get_losses_from_file, plot_losses)
    log = tmp_path / "stdout.txt"
    log.write_text("".join(
        f"Epoch: {i}\ntrain_loss: {1.0 / (i + 1)}\nvalid_loss: {1.5 / (i + 1)}\n"
        for i in range(4)))
    train, valid = get_losses_from_file(str(log))
    assert train == [1.0, 0.5, 1.0 / 3, 0.25]
    assert valid == [1.5, 0.75, 0.5, 0.375]
    pdf = tmp_path / "plot_loss.pdf"
    plot_losses(4, 1, [train, valid], ["r", "b--"], ["Train", "Valid"],
                str(pdf))
    assert pdf.stat().st_size > 500

    log.write_text("train_loss: 1.0\n")  # unbalanced -> hard error
    with pytest.raises(ValueError):
        get_losses_from_file(str(log))


def test_2d_config_builds_and_runs():
    """Shipped 2D (ndim=4) config constructs and applies its model."""
    from multimodal_3d_image_segmentation.runtime.run import _build_model

    cfg = get_config("configs/config_fnoseg_2d.ini")

    class FakeInput:
        def get_num_x_modalities(self):
            return 1

    model = _build_model(cfg, FakeInput(), lambda: (256, 256))
    assert model.ndim == 4
    x = jnp.zeros((2, 1, 64, 64), jnp.float32)
    params = model.init(jax.random.PRNGKey(0), x)["params"]
    y = model.apply({"params": params}, x)
    assert y.shape == (2, 4, 64, 64)


def _small_state():
    model = models.HNOSegXS(2, 3, 4, [1, 1], (3, 3, 3))
    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        (1, 2, 8, 8, 8)).astype(np.float32))
    y = jnp.asarray(np.random.default_rng(1).integers(
        0, 3, (1, 1, 8, 8, 8)).astype(np.int32))
    params = model.init(jax.random.PRNGKey(0), x)["params"]
    tx = build_optimizer({"optimizer_name": "Adamax", "lr": 1e-2})
    return model, params, tx, x, y


def test_train_state_matches_manual_optax_update():
    """TrainState.apply_gradients == one hand-written optax update."""
    import optax
    model, params, tx, x, y = _small_state()
    state = create_train_state(model, params, tx)
    grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.5), params)
    new = state.apply_gradients(grads=grads)
    updates, opt_state = tx.update(grads, tx.init(params), params)
    want = optax.apply_updates(params, updates)
    assert int(new.step) == 1
    for a, b in zip(jax.tree_util.tree_leaves(new.params),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(new.opt_state),
                    jax.tree_util.tree_leaves(opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_npz_params_keyed_by_parameter_path(tmp_path):
    model, params, tx, x, y = _small_state()
    path = str(tmp_path / "model.npz")
    save_params(path, params)
    with np.load(path) as z:
        keys = set(z.files)
        np.testing.assert_array_equal(
            z["layers_0/conv_blocks_0/op/weight"],
            np.asarray(params["layers_0"]["conv_blocks_0"]["op"]["weight"]))
    assert "conv_in/conv/kernel" in keys and "conv_out/kernel" in keys
    back = load_params(path, params)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))


def test_npz_full_state_and_metadata(tmp_path):
    model, params, tx, x, y = _small_state()
    step = make_train_step(losses.pcc_loss, num_labels=3, donate=False)
    state, _ = step(create_train_state(model, params, tx), x, y)
    path = str(tmp_path / "checkpoint.npz")
    save_checkpoint(path, state, epoch=7, min_loss=0.125, best_epoch=None)
    with np.load(path) as z:
        assert int(z["meta/epoch"]) == 7 and int(z["step"]) == 1
        assert any(k.startswith("opt_state/") for k in z.files)
    restored, epoch, min_loss, best = load_checkpoint(
        path, create_train_state(model, params, tx))
    assert (epoch, min_loss, best) == (7, 0.125, None)
    assert int(restored.step) == 1


def test_npz_resume_continues_identically(tmp_path):
    """Two more steps after a save/load equal two more steps without."""
    model, params, tx, x, y = _small_state()
    step = make_train_step(losses.pcc_loss, num_labels=3, donate=False)
    state, _ = step(create_train_state(model, params, tx), x, y)
    path = str(tmp_path / "checkpoint.npz")
    save_checkpoint(path, state, epoch=0, min_loss=1.0, best_epoch=0)
    resumed, *_ = load_checkpoint(path, create_train_state(model, params, tx))
    for _ in range(2):
        state, la = step(state, x, y)
        resumed, lb = step(resumed, x, y)
        assert float(la) == float(lb)
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(resumed)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_npz_wrong_template_raises(tmp_path):
    model, params, tx, x, y = _small_state()
    path = str(tmp_path / "model.npz")
    save_params(path, params)
    other = models.HNOSegXS(2, 3, 6, [1, 1], (3, 3, 3)).init(
        jax.random.PRNGKey(0), x)["params"]
    with pytest.raises(ValueError, match="shape"):
        load_params(path, other)
    deeper = models.HNOSegXS(2, 3, 4, [1, 1, 1], (3, 3, 3)).init(
        jax.random.PRNGKey(0), x)["params"]
    with pytest.raises(KeyError, match="layers_2"):
        load_params(path, deeper)


@pytest.mark.parametrize("case", ["dice", "surface"])
def test_regional_tsv_matches_golden(tmp_path, case):
    """results_regional.csv is byte-identical to the golden recorded from
    the earlier pandas writer (NaN cells empty, inf spelled out, %.6f)."""
    from multimodal_3d_image_segmentation.data.nifti import write_image
    from multimodal_3d_image_segmentation.metrics import statistics_regional
    surf = case == "surface"
    rng = np.random.default_rng(7)
    y_true, y_pred, lst = [], [], []
    for i in range(3):
        t = rng.integers(0, 3, size=(10, 12, 8)).astype(np.uint8)
        p = t.copy()
        flip = rng.random(t.shape) < 0.2
        p[flip] = rng.integers(0, 3, size=int(flip.sum()))
        if i == 2:  # no 'core' label: NaN dice
            t[t == 2] = 1
            p[p == 2] = 1
        y_true.append(t)
        y_pred.append(p)
        fn = tmp_path / f"case{i:03d}" / "seg.nii.gz"
        fn.parent.mkdir()
        write_image(t, str(fn))
        lst.append(str(fn))
    out = tmp_path / "out"
    out.mkdir()
    statistics_regional(y_true, y_pred, lst, str(out),
                        ["background", "lesion", "core"],
                        [[0], [1, 2], [2]], is_print=False,
                        use_surface_dice=surf, use_hd95=surf, nproc=None)
    golden = os.path.join(os.path.dirname(__file__), "fixtures",
                          "module_layer", f"results_regional_{case}.tsv")
    with open(golden) as f:
        want = f.read()
    assert (out / "results_regional.csv").read_text() == want
