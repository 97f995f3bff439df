"""Worked 2D example: ACDC-style synthetic slices -> train -> test -> stats.

Exercises the framework's 2D (ndim=4) path end to end: 2D NIfTI images,
scalar in-plane rotation augmentation, 2-tuple num_modes, 2D model apply,
2D metrics. Companion of ``synthetic_example.py`` (3D) and
``configs/config_fnoseg_2d.ini``.

Usage:
    python examples/synthetic_example_2d.py [work_dir]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from multimodal_3d_image_segmentation.data.nifti import write_image
from multimodal_3d_image_segmentation.runtime.config import get_config
from multimodal_3d_image_segmentation.runtime.run import run

SHAPE = (48, 40)  # (y, x) slice
N_CASES = 10


def make_dataset(root):
    """Synthetic cardiac-like slices: ring (myocardium) around a disc
    (cavity) on a noisy background."""
    rng = np.random.default_rng(0)
    lists = {"cine": [], "seg": []}
    for i in range(N_CASES):
        pdir = os.path.join(root, f"case{i:03d}")
        os.makedirs(pdir, exist_ok=True)
        yy, xx = np.meshgrid(*[np.arange(s) for s in SHAPE], indexing="ij")
        c = [s // 2 + rng.integers(-4, 5) for s in SHAPE]
        r2 = (yy - c[0]) ** 2 + (xx - c[1]) ** 2
        seg = np.zeros(SHAPE, np.uint8)
        seg[r2 < 144] = 1          # myocardium ring
        seg[r2 < 49] = 2           # cavity
        segf = seg.astype(np.float32)
        cine = (segf * 6 + rng.standard_normal(SHAPE).astype(np.float32)
                + 40)
        for name, arr in [("cine", cine.astype(np.float32)), ("seg", seg)]:
            fn = os.path.join(pdir, f"case{i:03d}-{name}.nii.gz")
            write_image(arr, fn)
            lists[name].append(fn)
    return lists


def write_lists(work, lists):
    splits = {"train": slice(0, 6), "valid": slice(6, 8),
              "test": slice(8, 10)}
    paths = {}
    for split, sl in splits.items():
        paths[split] = []
        for name in ["cine", "seg"]:
            fn = os.path.join(work, f"{name}_{split}.txt")
            with open(fn, "w") as f:
                f.writelines([ln + "\n" for ln in lists[name][sl]])
            paths[split].append(fn)
    return paths


CONFIG = """
[main]
output_dir = '{work}/experiment'
is_train = True
is_test = True
is_statistics = True
visible_devices = '0'

[input_lists]
data_dir = ''
data_lists_train_paths = {train!r}
data_lists_valid_paths = {valid!r}
data_lists_test_paths = {test!r}

[input_args]
idx_x_modalities = [0]
idx_y_modalities = [1]
batch_size = 1
num_workers = 2
use_data_normalization = True

[augmentation]
rotation_range = 25
shift_range = [0.1, 0.1]
zoom_range = [0.9, 1.1]
augmentation_probability = 0.8

[model]
model_name = 'NeuralOperatorSeg'
out_channels = 3
filters = 12
num_transform_blocks = 6
num_modes = (6, 6)
transform_type = 'Fourier'

[optimizer]
optimizer_name = 'Adamax'
lr = 5e-3

[scheduler]
scheduler_name = 'CosineAnnealingWarmRestarts'
eta_min = 1e-3

[loss]
loss_name = 'PCCLoss'

[train]
num_epochs = 25
selection_epoch_portion = 0.5
is_plot_model = True
is_print = True

[test]
output_folder = 'test'

[statistics]
use_surface_dice = True
use_hd95 = True
region_names = ['background', 'myocardium', 'cavity']
region_labels = [
\t[0],
\t[1],
\t[2],
\t]
"""


def main():
    work = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                           else "./synthetic_example_2d")
    os.makedirs(work, exist_ok=True)
    print(f"Generating synthetic 2D dataset under {work} ...")
    lists = make_dataset(os.path.join(work, "data"))
    paths = write_lists(work, lists)

    cfg_path = os.path.join(work, "config_example_2d.ini")
    with open(cfg_path, "w") as f:
        f.write(CONFIG.format(work=work, **paths))

    print(f"Running the 2D pipeline from {cfg_path} ...")
    run(get_config(cfg_path))
    print(f"\nDone. Artifacts under {work}/experiment/")


if __name__ == "__main__":
    main()
