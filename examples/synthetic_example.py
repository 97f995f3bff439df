"""Worked example: synthetic dataset -> train -> test -> statistics.

Analog of the reference TF tree's ``BraTS2019_example.zip`` scaffold
(``tensorflow/readme.md:63``): generates a small synthetic multimodal
dataset in the BraTS'23 folder layout, writes split lists and a config,
then runs the full pipeline.

Usage:
    python examples/synthetic_example.py [work_dir] [--cpu]

``--cpu`` forces the CPU backend — lets the example run while another
JAX process holds the GPU (a JAX process reserves most of the card's
memory when it starts).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    sys.argv.remove("--cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")

import numpy as np

from multimodal_3d_image_segmentation.data.nifti import write_image
from multimodal_3d_image_segmentation.runtime.config import get_config
from multimodal_3d_image_segmentation.runtime.run import run

SHAPE = (32, 36, 28)  # (z, y, x)
N_CASES = 8


def make_dataset(root):
    rng = np.random.default_rng(0)
    lists = {"m0": [], "m1": [], "seg": []}
    for i in range(N_CASES):
        pdir = os.path.join(root, f"case{i:03d}")
        os.makedirs(pdir, exist_ok=True)
        zz, yy, xx = np.meshgrid(*[np.arange(s) for s in SHAPE],
                                 indexing="ij")
        c = [s // 2 + rng.integers(-4, 5) for s in SHAPE]
        r2 = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
        seg = np.zeros(SHAPE, np.uint8)
        seg[r2 < 64] = 1
        seg[r2 < 16] = 2
        segf = seg.astype(np.float32)
        m0 = segf * 8 + rng.standard_normal(SHAPE).astype(np.float32) + 30
        m1 = segf * -4 + rng.standard_normal(SHAPE).astype(np.float32) + 50
        for name, arr in [("m0", m0.astype(np.float32)),
                          ("m1", m1.astype(np.float32)), ("seg", seg)]:
            fn = os.path.join(pdir, f"case{i:03d}-{name}.nii.gz")
            write_image(arr, fn)
            lists[name].append(fn)
    return lists


def write_lists(work, lists):
    splits = {"train": slice(0, 5), "valid": slice(5, 6), "test": slice(6, 8)}
    paths = {}
    for split, sl in splits.items():
        paths[split] = []
        for name in ["m0", "m1", "seg"]:
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
idx_x_modalities = [0, 1]
idx_y_modalities = [2]
batch_size = 1
num_workers = 2
use_data_normalization = True

[augmentation]
rotation_range = [20, 0, 0]
shift_range = [0.1, 0.1, 0.1]
zoom_range = [0.9, 1.1]
augmentation_probability = 0.8

[model]
model_name = 'HNOSegXS'
out_channels = 3
filters = 16
num_transform_blocks = [2, 2, 2, 2]
num_modes = (5, 6, 5)

[optimizer]
optimizer_name = 'Adamax'
lr = 5e-3

[scheduler]
scheduler_name = 'CosineAnnealingWarmRestarts'
eta_min = 1e-3

[loss]
loss_name = 'PCCLoss'

[train]
num_epochs = 20
selection_epoch_portion = 0.5
is_plot_model = True
is_print = True

[test]
output_folder = 'test'

[statistics]
use_surface_dice = True
use_hd95 = True
region_names = ['background', 'lesion', 'core']
region_labels = [
\t[0],
\t[1, 2],
\t[2],
\t]
"""


def main():
    work = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                           else "./synthetic_example")
    os.makedirs(work, exist_ok=True)
    print(f"Generating synthetic dataset under {work} ...")
    lists = make_dataset(os.path.join(work, "data"))
    paths = write_lists(work, lists)

    cfg_path = os.path.join(work, "config_example.ini")
    with open(cfg_path, "w") as f:
        f.write(CONFIG.format(work=work, **paths))

    print(f"Running the pipeline from {cfg_path} ...")
    run(get_config(cfg_path))
    print(f"\nDone. Artifacts under {work}/experiment/")


if __name__ == "__main__":
    main()
