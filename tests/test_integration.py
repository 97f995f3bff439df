"""End-to-end integration: synthetic NIfTI volumes through
config -> train -> test -> statistics, plus resume and zero-shot SR."""
import os
from io import StringIO

import numpy as np
import pytest

from multimodal_3d_image_segmentation.data.nifti import (read_image,
                                                             write_image)
from multimodal_3d_image_segmentation.runtime.config import get_config
from multimodal_3d_image_segmentation.runtime.run import run

SHAPE = (12, 14, 10)  # (z, y, x)


def _make_dataset(root, n=4, shape=SHAPE, seed=0):
    """Synthetic 2-modality dataset: blobs with labels 0/1/2."""
    rng = np.random.default_rng(seed)
    lists = {"m0": [], "m1": [], "seg": []}
    for i in range(n):
        pdir = root / f"case{i}"
        os.makedirs(pdir, exist_ok=True)
        zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape],
                                 indexing="ij")
        c = [s // 2 + rng.integers(-2, 3) for s in shape]
        r2 = ((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2)
        seg = np.zeros(shape, np.uint8)
        seg[r2 < 16] = 1
        seg[r2 < 4] = 2
        segf = seg.astype(np.float32)
        m0 = segf * 10 + rng.standard_normal(shape) + 20
        m1 = segf * -5 + rng.standard_normal(shape) + 40
        for name, arr in [("m0", m0.astype(np.float32)),
                          ("m1", m1.astype(np.float32)), ("seg", seg)]:
            fn = str(pdir / f"case{i}-{name}.nii.gz")
            write_image(arr, fn, spacing=(1.0, 1.0, 1.0))
            lists[name].append(fn)
    return lists


def _write_lists(tmp_path, lists, split):
    paths = []
    for name in ["m0", "m1", "seg"]:
        fn = str(tmp_path / f"{name}_{split}.txt")
        with open(fn, "w") as f:
            f.writelines([ln + "\n" for ln in lists[name]])
        paths.append(fn)
    return paths


def _config(tmp_path, output_dir, train_paths, valid_paths, test_paths,
            num_epochs=2, is_train=True, is_test=True, is_statistics=True,
            is_continue=False, extra=""):
    cfg = f"""
[main]
output_dir = '{output_dir}'
is_train = {is_train}
is_test = {is_test}
is_statistics = {is_statistics}
is_continue = {is_continue}
visible_devices = '0'

[input_lists]
data_dir = ''
data_lists_train_paths = {train_paths!r}
data_lists_valid_paths = {valid_paths!r}
data_lists_test_paths = {test_paths!r}

[input_args]
idx_x_modalities = [0, 1]
idx_y_modalities = [2]
batch_size = 1
num_workers = 0
use_data_normalization = True

[augmentation]
rotation_range = [10, 0, 0]
shift_range = [0.1, 0.1, 0.1]
zoom_range = [0.9, 1.1]
augmentation_probability = 0.5

[model]
model_name = 'HNOSegXS'
out_channels = 3
filters = 8
num_transform_blocks = [2, 2]
num_modes = (3, 3, 3)

[optimizer]
optimizer_name = 'Adamax'
lr = 5e-3

[scheduler]
scheduler_name = 'CosineAnnealingWarmRestarts'
eta_min = 1e-3

[loss]
loss_name = 'PCCLoss'

[train]
num_epochs = {num_epochs}
selection_epoch_portion = 0.5
is_print = False

[test]
output_folder = 'test'

[statistics]
use_surface_dice = True
use_hd95 = True
region_names = ['background', 'lesion', 'core']
region_labels = [
    [0],
    [1, 2],
    [2],
    ]
{extra}
"""
    sio = StringIO(cfg)
    return get_config(sio, source=str(tmp_path / "config.ini"))


@pytest.mark.slow
def test_full_pipeline(tmp_path):
    data_root = tmp_path / "data"
    os.makedirs(data_root)
    lists = _make_dataset(data_root, n=4)
    train = _write_lists(tmp_path, {k: v[:2] for k, v in lists.items()},
                         "train")
    valid = _write_lists(tmp_path, {k: v[2:3] for k, v in lists.items()},
                         "valid")
    test = _write_lists(tmp_path, {k: v[3:] for k, v in lists.items()},
                        "test")
    out = str(tmp_path / "exp")

    cfg = _config(tmp_path, out, train, valid, test, num_epochs=2)
    run(cfg)

    # artifacts
    assert os.path.exists(os.path.join(out, "config.ini"))
    assert os.path.exists(os.path.join(out, "stdout.txt"))
    assert os.path.exists(os.path.join(out, "model/model.npz"))
    assert os.path.exists(os.path.join(out, "model/checkpoint.npz"))
    assert os.path.exists(os.path.join(out, "plot_loss.pdf"))
    assert os.path.exists(os.path.join(out, "model_summary.txt"))
    assert os.path.exists(os.path.join(out, "test/images/case3_pred.nii.gz"))
    assert os.path.exists(os.path.join(out, "test/images/case3_true.nii.gz"))
    assert os.path.exists(os.path.join(out,
                                       "test/prediction_time_memory.txt"))
    assert os.path.exists(os.path.join(out, "test/results_regional.csv"))
    assert os.path.exists(os.path.join(out,
                                       "test/average_results_regional.txt"))

    pred = read_image(os.path.join(out, "test/images/case3_pred.nii.gz"))
    assert pred.array.shape == SHAPE
    assert set(np.unique(pred.array)).issubset({0, 1, 2})

    # stdout.txt holds the loss history
    log = open(os.path.join(out, "stdout.txt")).read()
    assert log.count("train_loss:") == 2
    assert log.count("valid_loss:") == 2


def test_refuses_overwrite_and_resume(tmp_path):
    data_root = tmp_path / "data"
    os.makedirs(data_root)
    lists = _make_dataset(data_root, n=3)
    train = _write_lists(tmp_path, {k: v[:2] for k, v in lists.items()},
                         "train")
    valid = _write_lists(tmp_path, {k: v[2:] for k, v in lists.items()},
                         "valid")
    out = str(tmp_path / "exp")

    cfg = _config(tmp_path, out, train, valid, valid, num_epochs=2,
                  is_test=False, is_statistics=False)
    run(cfg)

    # refuse to overwrite without is_continue (reference run.py:75-77)
    cfg2 = _config(tmp_path, out, train, valid, valid, num_epochs=2,
                   is_test=False, is_statistics=False)
    with pytest.raises(RuntimeError, match="already exists"):
        run(cfg2)

    # resume: more epochs, continues from checkpoint
    cfg3 = _config(tmp_path, out, train, valid, valid, num_epochs=4,
                   is_test=False, is_statistics=False, is_continue=True)
    run(cfg3)
    log = open(os.path.join(out, "stdout.txt")).read()
    assert "Epoch: 3" in log


@pytest.mark.slow
def test_zero_shot_super_resolution_pipeline(tmp_path):
    """Train at low resolution, test at double resolution with the same
    weights (reference README.md:83-87 semantics via test-only config)."""
    lo_root = tmp_path / "lo"
    hi_root = tmp_path / "hi"
    os.makedirs(lo_root), os.makedirs(hi_root)
    lo = _make_dataset(lo_root, n=3, shape=(10, 12, 8))
    hi = _make_dataset(hi_root, n=2, shape=(20, 24, 16), seed=7)

    train = _write_lists(tmp_path, {k: v[:2] for k, v in lo.items()}, "tr")
    valid = _write_lists(tmp_path, {k: v[2:] for k, v in lo.items()}, "va")
    hi_test = _write_lists(tmp_path, hi, "hite")
    out = str(tmp_path / "exp_sr")

    cfg = _config(tmp_path, out, train, valid, hi_test, num_epochs=1,
                  is_test=False, is_statistics=False)
    run(cfg)

    # test-only at the higher resolution: same weights, new shapes
    cfg2 = _config(tmp_path, out, train, valid, hi_test, is_train=False,
                   is_test=True, is_statistics=False)
    run(cfg2)
    pred = read_image(os.path.join(out, "test/images/case0_pred.nii.gz"))
    assert pred.array.shape == (20, 24, 16)


def test_inference_cli(tmp_path):
    """Dedicated inference entry point (TF-tree parity: zero-shot SR CLI)."""
    from multimodal_3d_image_segmentation.runtime.inference import (
        run_inference)

    data_root = tmp_path / "data"
    os.makedirs(data_root)
    lists = _make_dataset(data_root, n=3)
    train = _write_lists(tmp_path, {k: v[:2] for k, v in lists.items()}, "tr")
    valid = _write_lists(tmp_path, {k: v[2:] for k, v in lists.items()}, "va")
    out = str(tmp_path / "exp")

    cfg = _config(tmp_path, out, train, valid, valid, num_epochs=1,
                  is_test=False, is_statistics=False)
    run(cfg)

    # double-resolution inference via the dedicated CLI
    hi_root = tmp_path / "hi"
    os.makedirs(hi_root)
    hi = _make_dataset(hi_root, n=2, shape=(24, 28, 20), seed=9)
    hi_test = _write_lists(tmp_path, hi, "hite")
    cfg2 = _config(tmp_path, out, train, valid, hi_test, is_train=False,
                   is_test=True, is_statistics=False)
    run_inference(cfg2)
    # [test] output_folder in the shared test config is 'test'
    pred = read_image(os.path.join(out, "test/images/case0_pred.nii.gz"))
    assert pred.array.shape == (24, 28, 20)


@pytest.mark.slow
def test_2d_pipeline(tmp_path):
    """2D images end to end: ndim inferred from data (reference run.py:84)."""
    rng = np.random.default_rng(3)
    shape = (20, 18)
    lists = {"m0": [], "seg": []}
    root = tmp_path / "data2d"
    for i in range(3):
        pdir = root / f"case{i}"
        os.makedirs(pdir, exist_ok=True)
        yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
        c = [s // 2 + rng.integers(-2, 3) for s in shape]
        seg = (((yy - c[0]) ** 2 + (xx - c[1]) ** 2) < 25).astype(np.uint8)
        m0 = seg * 5.0 + rng.standard_normal(shape).astype(np.float32) + 10
        for name, arr in [("m0", m0.astype(np.float32)), ("seg", seg)]:
            fn = str(pdir / f"case{i}-{name}.nii.gz")
            write_image(arr, fn)
            lists[name].append(fn)
    paths = []
    for name in ["m0", "seg"]:
        fn = str(tmp_path / f"{name}_2d.txt")
        with open(fn, "w") as f:
            f.writelines([ln + "\n" for ln in lists[name]])
        paths.append(fn)

    cfg = f"""
[main]
output_dir = '{tmp_path / "exp2d"}'
is_train = True
is_test = True
is_statistics = False
visible_devices = '0'

[input_lists]
data_dir = ''
data_lists_train_paths = {paths!r}
data_lists_valid_paths = {paths!r}
data_lists_test_paths = {paths!r}

[input_args]
idx_x_modalities = [0]
idx_y_modalities = [1]
batch_size = 1
num_workers = 0
use_data_normalization = True

[model]
model_name = 'HNOSegXS'
out_channels = 2
filters = 8
num_transform_blocks = [2, 2]
num_modes = (3, 3)

[optimizer]
optimizer_name = 'Adamax'
lr = 5e-3

[loss]
loss_name = 'PCCLoss'

[train]
num_epochs = 1
selection_epoch_portion = 0.5
is_print = False

[test]
output_folder = 'test'
"""
    config = get_config(StringIO(cfg), source=str(tmp_path / "c2d.ini"))
    run(config)
    pred = read_image(os.path.join(str(tmp_path / "exp2d"),
                                   "test/images/case0_pred.nii.gz"))
    assert pred.array.shape == shape


@pytest.mark.parametrize("model_section", [
    """[model]
model_name = 'NeuralOperatorSeg'
out_channels = 3
filters = 6
num_transform_blocks = 2
num_modes = (3, 3, 3)
transform_type = 'Fourier'
""",
    """[model]
model_name = 'NeuralOperatorSeg'
out_channels = 3
filters = 6
num_transform_blocks = 2
num_modes = (3, 3, 3)
transform_type = 'Hartley'
""",
    """[model]
model_name = 'VNetDS'
out_channels = 3
base_num_filters = 4
num_blocks = [1, 2]
right_leg_indexes = [0, 1]
""",
    """[model]
model_name = 'HartleyMHASeg'
out_channels = 3
filters = 8
num_transform_blocks = 2
num_heads = 2
num_modes = (2, 2, 2)
patch_size = 2
""",
], ids=["fnoseg", "hnoseg", "vnetds", "hartleymha"])
@pytest.mark.slow
def test_pipeline_other_model_families(tmp_path, model_section):
    """Every model family runs through the config-driven pipeline."""
    data_root = tmp_path / "data"
    os.makedirs(data_root)
    lists = _make_dataset(data_root, n=3, shape=(16, 16, 12))
    train = _write_lists(tmp_path, {k: v[:2] for k, v in lists.items()}, "tr")
    valid = _write_lists(tmp_path, {k: v[2:] for k, v in lists.items()}, "va")
    out = str(tmp_path / "exp")

    cfg = _config(tmp_path, out, train, valid, valid, num_epochs=1,
                  is_statistics=False)
    # swap the [model] section
    raw = cfg["config"].getvalue()
    import re as _re
    raw = _re.sub(r"\[model\][^\[]*", model_section + "\n", raw)
    cfg2 = get_config(StringIO(raw), source=str(tmp_path / "c.ini"))
    run(cfg2)
    pred = read_image(os.path.join(out, "test/images/case2_pred.nii.gz"))
    assert pred.array.shape == (16, 16, 12)


@pytest.mark.slow
def test_pipeline_with_parallel_mesh(tmp_path):
    """[parallel] config section: training+testing over a (data, spatial)
    mesh on the virtual 8-device backend."""
    data_root = tmp_path / "data"
    os.makedirs(data_root)
    lists = _make_dataset(data_root, n=4, shape=(16, 16, 12))
    train = _write_lists(tmp_path, {k: v[:2] for k, v in lists.items()}, "tr")
    valid = _write_lists(tmp_path, {k: v[2:3] for k, v in lists.items()},
                         "va")
    test = _write_lists(tmp_path, {k: v[3:] for k, v in lists.items()}, "te")
    out = str(tmp_path / "exp_mesh")

    extra = """
[parallel]
n_data = 2
n_spatial = 2
"""
    cfg = _config(tmp_path, out, train, valid, test, num_epochs=1,
                  is_statistics=False, extra=extra)
    run(cfg)
    pred = read_image(os.path.join(out, "test/images/case3_pred.nii.gz"))
    assert pred.array.shape == (16, 16, 12)


@pytest.mark.slow
def test_pipeline_with_device_augmentation(tmp_path):
    """[augmentation] device = True: augmentation inside the jitted step."""
    data_root = tmp_path / "data"
    os.makedirs(data_root)
    lists = _make_dataset(data_root, n=3)
    train = _write_lists(tmp_path, {k: v[:2] for k, v in lists.items()}, "tr")
    valid = _write_lists(tmp_path, {k: v[2:] for k, v in lists.items()}, "va")
    out = str(tmp_path / "exp_devaug")

    cfg = _config(tmp_path, out, train, valid, valid, num_epochs=2,
                  is_statistics=False)
    raw = cfg["config"].getvalue().replace(
        "[augmentation]", "[augmentation]\ndevice = True")
    cfg2 = get_config(StringIO(raw), source=str(tmp_path / "c.ini"))
    run(cfg2)
    log = open(os.path.join(out, "stdout.txt")).read()
    assert log.count("train_loss:") == 2


@pytest.mark.slow
def test_cli_entrypoints_as_subprocesses(tmp_path):
    """The real CLI entries (`python -m ...runtime.run config.ini` and the
    partitioning CLI) work from a clean subprocess — the exact user
    calling convention (reference `python experiments/run.py config`)."""
    import subprocess
    import sys as _sys
    import textwrap

    from multimodal_3d_image_segmentation.data.nifti import write_image

    # tiny synthetic dataset, BraTS'23 folder layout
    rng = np.random.default_rng(0)
    data = tmp_path / "data"
    lists = {"m0": [], "seg": []}
    for i in range(3):
        pdir = data / f"case{i:03d}"
        pdir.mkdir(parents=True)
        seg = (rng.random((10, 12, 8)) > 0.6).astype(np.uint8)
        m0 = seg * 3.0 + rng.standard_normal((10, 12, 8)).astype(np.float32)
        for name, arr in [("m0", m0.astype(np.float32)), ("seg", seg)]:
            fn = str(pdir / f"case{i:03d}-{name}.nii.gz")
            write_image(arr, fn)
            lists[name].append(fn)
    for name in lists:
        for split, sl in [("train", slice(0, 2)), ("valid", slice(2, 3)),
                          ("test", slice(2, 3))]:
            (tmp_path / f"{name}_{split}.txt").write_text(
                "".join(p + "\n" for p in lists[name][sl]))

    cfg = tmp_path / "config.ini"
    cfg.write_text(textwrap.dedent(f"""
        [main]
        output_dir = '{tmp_path}/exp'
        is_train = True
        is_test = True
        is_statistics = False

        [input_lists]
        data_dir = ''
        data_lists_train_paths = ['{tmp_path}/m0_train.txt', '{tmp_path}/seg_train.txt']
        data_lists_valid_paths = ['{tmp_path}/m0_valid.txt', '{tmp_path}/seg_valid.txt']
        data_lists_test_paths = ['{tmp_path}/m0_test.txt', '{tmp_path}/seg_test.txt']

        [input_args]
        idx_x_modalities = [0]
        idx_y_modalities = [1]
        batch_size = 1
        num_workers = 0

        [model]
        model_name = 'HNOSegXS'
        out_channels = 2
        filters = 4
        num_transform_blocks = [1]
        num_modes = (2, 3, 2)

        [optimizer]
        optimizer_name = 'Adamax'
        lr = 5e-3

        [loss]
        loss_name = 'PCCLoss'

        [train]
        num_epochs = 1
        is_print = False

        [test]
        output_folder = 'test'
    """))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=1",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [_sys.executable, "-m",
         "multimodal_3d_image_segmentation.runtime.run", str(cfg)],
        # generous: this 1-core host serializes the whole suite
        capture_output=True, text=True, timeout=1800, env=env,
        cwd=os.path.join(os.path.dirname(__file__), ".."))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert os.path.isfile(str(tmp_path / "exp/model/model.npz"))
    assert os.path.isfile(
        str(tmp_path / "exp/test/images/case002_pred.nii.gz"))

    # partitioning CLI as a subprocess
    pcfg = tmp_path / "part.ini"
    pcfg.write_text(textwrap.dedent(f"""
        [partitioning]
        base_paths = ['{data}']
        train_fraction = 0.6
        valid_fraction = 0.2
        test_fraction = 0.2
        modalities = ['m0', 'seg']
        ext = 'nii.gz'
        remove_str = ''
        seed = 1

        [io]
        output_dir = '{tmp_path}/splits'
    """))
    proc2 = subprocess.run(
        [_sys.executable, "-m",
         "multimodal_3d_image_segmentation.data.partitioning",
         str(pcfg)],
        capture_output=True, text=True, timeout=900, env=env,
        cwd=os.path.join(os.path.dirname(__file__), ".."))
    assert proc2.returncode == 0, proc2.stdout + proc2.stderr
    assert os.path.isfile(str(tmp_path / "splits/m0_train-0.6.txt"))
