"""Experiment CLI: ``python -m multimodal_3d_image_segmentation.runtime.run config.ini``

Re-design of reference ``experiments/run.py:29-197``. The config dialect,
section schema ([main]/[input_lists]/[input_args]/[augmentation]/[model]/
[optimizer]/[scheduler]/[loss]/[train]/[test]/[statistics]) and output
artifacts are unchanged, so reference config files run after editing only
the path entries. The [model] section doubles as kwargs for
``getattr(models, model_name)`` — the de-facto plugin system.

New (optional) section [parallel]:
    n_data    — data-parallel mesh axis size
    n_spatial — spatial (volume-sharding) mesh axis size
Absent, the run uses a single device. ``visible_devices`` selects the
starting device index.
"""
from __future__ import annotations

import copy
import os
import sys
from functools import partial

import jax
import jax.numpy as jnp

from .. import models
from ..data.dataset import InputData
from ..data.nifti import read_image, read_img
from ..data.normalization import normalize_modalities
from ..losses import get_loss
from ..metrics import statistics_regional
from ..parallel.mesh import make_mesh
from ..utils.profiling import setup_compilation_cache
from .checkpoint import load_params
from .config import get_config, save_config
from .optim import build_optimizer, build_schedule
from .train_test import testing, training

__all__ = ["run", "get_data_lists", "main"]


def get_data_lists(data_lists_paths, data_dir=None):
    """Read per-modality filename list files
    (reference ``experiments/utils.py:210-231``)."""
    if data_lists_paths is None:
        return None
    data_dir = data_dir or ""
    data_lists = []
    for dl_path in data_lists_paths:
        dl_path = os.path.expanduser(dl_path)
        with open(dl_path) as f:
            a_list = f.read().splitlines()
        data_lists.append([os.path.join(data_dir, fname) for fname in a_list])
    return data_lists


def _build_model(config_args, input_data, image_size_getter):
    model_args = copy.deepcopy(config_args["model"])
    model_args["in_channels"] = input_data.get_num_x_modalities()
    model_args["ndim"] = len(image_size_getter()) + 2
    model_args.pop("device", None)  # placement is sharding-driven
    # Framework-wide fp32 matmul precision knob (not a model kwarg): see
    # ops/spectral.set_fp32_transform_precision.
    tp = model_args.pop("transform_precision", None)
    if tp is not None:
        from ..ops.spectral import set_fp32_transform_precision
        set_fp32_transform_precision(tp)
    # 'mixed' serving: bf16 activations + fp32 weight/matrix islands
    # (ops/spectral.set_bf16_exact) — bf16 traffic, fp32-exact weights.
    if model_args.get("compute_dtype") == "mixed":
        model_args["compute_dtype"] = "bfloat16"
        from ..ops.spectral import set_bf16_exact
        set_bf16_exact(True)
    model_name = model_args.pop("model_name")
    if isinstance(model_args.get("num_modes"), list):
        model_args["num_modes"] = tuple(model_args["num_modes"])
    return getattr(models, model_name)(**model_args)


def run(config_args):
    """Run an experiment: train and/or test and/or statistics."""
    output_dir = os.path.expanduser(config_args["main"]["output_dir"])

    # Honor visible_devices as the default device index for single-device
    # runs (the reference's torch.cuda.set_device, ``run.py:39``). Meshes
    # override this.
    vis = config_args["main"].get("visible_devices")
    if vis is not None and "parallel" not in config_args:
        try:
            idx = int(str(vis).strip())
        except (ValueError, TypeError):
            print(f"Warning: visible_devices={vis!r} is not an integer "
                  "device index; ignored.")
        else:
            if 0 <= idx < len(jax.devices()):
                jax.config.update("jax_default_device", jax.devices()[idx])
            else:
                print(f"Warning: visible_devices={idx} out of range for "
                      f"{len(jax.devices())} device(s); ignored.")

    # Input data
    input_lists = copy.deepcopy(config_args["input_lists"])
    data_dir = input_lists.get("data_dir")  # None = lists hold full paths
    data_dir = os.path.expanduser(data_dir) if data_dir else data_dir
    data_lists_train = get_data_lists(
        input_lists.get("data_lists_train_paths"), data_dir)
    data_lists_valid = get_data_lists(
        input_lists.get("data_lists_valid_paths"), data_dir)
    data_lists_test = get_data_lists(
        input_lists.get("data_lists_test_paths"), data_dir)

    input_args = copy.deepcopy(config_args["input_args"])
    if input_args.pop("use_data_normalization", True):
        mask_val = input_args.pop("mask_val", 0)
        clip_val = input_args.pop("clip_val", None)
        x_processing = partial(normalize_modalities, mask_val=mask_val,
                               clip_val=clip_val)
    else:
        x_processing = None

    input_data = None
    transform_args = config_args.get("augmentation")
    augment_fn = None
    if transform_args and transform_args.get("device", False):
        # on-device augmentation: runs inside the jitted train step; the
        # host pipeline then skips the per-sample resample entirely
        from ..data.augmentation_device import make_device_augment
        dev_args = {k: v for k, v in transform_args.items() if k != "device"}
        # the [augmentation] seed keys the per-step PRNG stream inside the
        # jitted train step (decoupled from the weight-init seed)
        augment_seed = dev_args.pop("seed", None)
        augment_fn = make_device_augment(**dev_args)
        transform_args = None
    else:
        augment_seed = None
    if config_args["main"]["is_train"] or config_args["main"]["is_test"]:
        input_data = InputData(reader=read_img,
                               data_lists_train=data_lists_train,
                               data_lists_valid=data_lists_valid,
                               data_lists_test=data_lists_test,
                               x_processing=x_processing,
                               transform_kwargs=transform_args,
                               **input_args)

    # Optional mesh
    mesh = None
    if "parallel" in config_args:
        par = config_args["parallel"]
        mesh = make_mesh(n_data=par.get("n_data"),
                         n_spatial=par.get("n_spatial", 1))

    # Train or read model
    model = None
    params = None
    if config_args["main"]["is_train"]:
        if os.path.exists(output_dir) and not config_args["main"].get(
                "is_continue", False):
            raise RuntimeError(f"output_dir already exists! \n{output_dir}")

        os.makedirs(output_dir, exist_ok=True)
        save_config(config_args, output_dir)

        model = _build_model(config_args, input_data,
                             input_data.get_train_image_size)

        train_args = copy.deepcopy(config_args["train"])
        num_epochs = train_args.get("num_epochs", 100)

        optimizer_args = copy.deepcopy(config_args["optimizer"])
        base_lr = optimizer_args.get("lr", 1e-3)
        schedule = build_schedule(
            config_args.get("scheduler"), base_lr,
            input_data.get_train_num_batches(), num_epochs)
        tx = build_optimizer(optimizer_args, schedule)

        loss_args = copy.deepcopy(config_args["loss"])
        loss_name = loss_args.pop("loss_name")
        loss_fn = get_loss(loss_name, **loss_args)

        if train_args.pop("use_autocast", None):
            print("Warning: [train] use_autocast is ignored; use "
                  "[model] compute_dtype = 'bfloat16' for mixed precision.")
        params = training(model=model, input_data=input_data,
                          output_dir=output_dir, loss_fn=loss_fn, tx=tx,
                          mesh=mesh, augment_fn=augment_fn,
                          augment_seed=augment_seed, **train_args)

    elif config_args["main"]["is_test"]:
        model = _build_model(config_args, input_data,
                             input_data.get_test_image_size)
        template = model.init(
            jax.random.PRNGKey(0),
            jnp.zeros((1, model.in_channels)
                      + tuple(input_data.get_test_image_size()),
                      jnp.float32))["params"]
        params = load_params(os.path.join(output_dir, "model/model.npz"),
                             template)

    if (not config_args["main"]["is_test"]
            and not config_args["main"]["is_statistics"]):
        return

    # Testing
    test_args = copy.deepcopy(config_args.get("test", {}))
    test_dir = os.path.join(output_dir, test_args.pop("output_folder",
                                                      "test"))
    if "is_print" not in test_args and "train" in config_args:
        is_print = config_args["train"].get("is_print", True)
    else:
        is_print = test_args.get("is_print", True)
    test_args.pop("is_print", None)
    if test_args.pop("use_autocast", None):
        print("Warning: [test] use_autocast is ignored; use "
              "[model] compute_dtype = 'bfloat16' for mixed precision.")

    if config_args["main"]["is_test"]:
        testing(model=model, params=params, input_data=input_data,
                output_dir=test_dir, is_print=is_print, mesh=mesh,
                **test_args)

    if config_args["main"]["is_statistics"]:
        idx_y_modalities = input_args.get("idx_y_modalities")
        if idx_y_modalities:
            if is_print:
                print("\nComputing statistics")
            idx_y = idx_y_modalities[0]
            y_list_test = data_lists_test[idx_y]

            ids = [fn.split("/")[-2] for fn in y_list_test]
            fn_true = [os.path.join(str(test_dir), "images",
                                    f"{i}_true.nii.gz") for i in ids]
            fn_pred = [os.path.join(str(test_dir), "images",
                                    f"{i}_pred.nii.gz") for i in ids]
            from ..data.nifti import read_images
            y_true = [im.array for im in read_images(fn_true)]
            y_pred = [im.array for im in read_images(fn_pred)]
            assert len(y_true) == len(y_pred)
            if is_print:
                print(f"There are {len(y_true)} samples loaded.")

            use_surface_dice = True
            use_hd95 = True
            region_names = region_labels = None
            if "statistics" in config_args:
                stats = config_args["statistics"]
                use_surface_dice = stats.get("use_surface_dice", True)
                use_hd95 = stats.get("use_hd95", True)
                region_names = stats.get("region_names", None)
                region_labels = stats.get("region_labels", None)

            nproc = config_args["input_args"].get("num_workers")
            if is_print:
                print("-------- Regional result statistics --------")
            statistics_regional(y_true, y_pred, y_list_test, test_dir,
                                region_names, region_labels, is_print,
                                use_surface_dice=use_surface_dice,
                                use_hd95=use_hd95, nproc=nproc)
        else:
            print("Statistics cannot be computed without valid "
                  "idx_y_modalities (ground truths).")


def main():
    setup_compilation_cache()
    config_args = get_config(sys.argv[1])
    run(config_args)


if __name__ == "__main__":
    main()
