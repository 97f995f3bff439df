"""Dedicated inference CLI (zero-shot super-resolution).

Analog of the reference TF tree's ``tensorflow/experiments/inference.py:32-
173``: load a trained model and run inference on a test set whose
resolution may differ from the training resolution. The TF version has to
rebuild the model at the new size and copy weights (``inference.py:73-80``);
here the models are shape-polymorphic — the same params jit-specialize to
the new shapes (one extra compile, cached afterwards).

Usage: ``python -m multimodal_3d_image_segmentation.runtime.inference
config.ini`` with the same config dialect; only [main] is_test is honored
(training keys are ignored).
"""
from __future__ import annotations

import copy
import os
import sys
from functools import partial

import jax
import jax.numpy as jnp

from ..data.dataset import InputData
from ..data.nifti import read_img
from ..data.normalization import normalize_modalities
from ..parallel.mesh import make_mesh
from ..utils.profiling import setup_compilation_cache
from .checkpoint import load_params
from .config import get_config
from .run import _build_model, get_data_lists
from .train_test import testing

__all__ = ["run_inference", "main"]


def run_inference(config_args):
    output_dir = os.path.expanduser(config_args["main"]["output_dir"])

    input_lists = copy.deepcopy(config_args["input_lists"])
    data_dir = input_lists.get("data_dir")  # None = lists hold full paths
    data_dir = os.path.expanduser(data_dir) if data_dir else data_dir
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

    input_data = InputData(reader=read_img,
                           data_lists_test=data_lists_test,
                           x_processing=x_processing, **input_args)

    mesh = None
    if "parallel" in config_args:
        par = config_args["parallel"]
        mesh = make_mesh(n_data=par.get("n_data"),
                         n_spatial=par.get("n_spatial", 1))

    model = _build_model(config_args, input_data,
                         input_data.get_test_image_size)
    template = model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, model.in_channels)
                  + tuple(input_data.get_test_image_size()),
                  jnp.float32))["params"]
    params = load_params(os.path.join(output_dir, "model/model.npz"),
                         template)

    test_args = copy.deepcopy(config_args.get("test", {}))
    test_dir = os.path.join(output_dir,
                            test_args.pop("output_folder", "inference"))
    if test_args.pop("use_autocast", None):
        # same contract as runtime/run.py: reference configs may carry it
        print("Warning: [test] use_autocast is ignored; use "
              "[model] compute_dtype = 'bfloat16' for mixed precision.")
    testing(model=model, params=params, input_data=input_data,
            output_dir=test_dir, mesh=mesh, **test_args)


def main():
    setup_compilation_cache()
    run_inference(get_config(sys.argv[1]))


if __name__ == "__main__":
    main()
