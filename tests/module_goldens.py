"""Shared case table and deterministic inputs for the module-layer goldens.

The goldens under ``tests/fixtures/module_layer/`` were recorded once from
an independent implementation of the same models (the Flax-based module
tree these models were first written in), on the CPU, with parameters
filled by :func:`fill_params` from each parameter's path. The tests in
``test_module_layer.py`` rebuild the same models with the in-repo module
layer, fill the same parameters and compare, so any drift in parameter
paths, shapes, initial wiring or forward math shows up as a mismatch.
"""
from __future__ import annotations

import os
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "module_layer")

# Keys of a [model] section that are runtime knobs, not model fields.
_NOT_MODEL_KWARGS = ("model_name", "transform_precision")

# (config file, number of input modalities, init spatial shape). The init
# shape only has to be large enough for every config's kept modes.
CONFIGS = {
    "fno": ("configs/config_fno.ini", 4, (48, 56, 56)),
    "fnoseg": ("configs/config_fnoseg.ini", 4, (48, 56, 56)),
    "fnoseg_2d": ("configs/config_fnoseg_2d.ini", 1, (64, 64)),
    "hartleymha": ("configs/config_hartleymha.ini", 4, (48, 56, 56)),
    "hnoseg": ("configs/config_hnoseg.ini", 4, (48, 56, 56)),
    "hnoseg_xs": ("configs/config_hnoseg_xs.ini", 4, (48, 56, 56)),
    "vnet_ds": ("configs/config_vnet-ds.ini", 4, (48, 56, 56)),
    # examples/synthetic_example.py's [model] section
    "example": (None, 2, (32, 36, 28)),
}

EXAMPLE_MODEL = dict(model_name="HNOSegXS", out_channels=3, filters=16,
                     num_transform_blocks=[2, 2, 2, 2], num_modes=(5, 6, 5))

# Family of each config, and the config whose full width gives the
# family's parameter count.
FAMILIES = {
    "HNOSegXS": "hnoseg_xs",
    "FNOSeg": "fnoseg",
    "HNOSeg": "hnoseg",
    "HartleyMHASeg": "hartleymha",
    "VNetDS": "vnet_ds",
}


def config_model(name):
    """(model_name, kwargs) of a config's [model] section, as
    ``runtime.run._build_model`` would pass them (minus ``ndim``)."""
    path, n_in, spatial = CONFIGS[name]
    if path is None:
        section = dict(EXAMPLE_MODEL)
    else:
        from multimodal_3d_image_segmentation.runtime.config import \
            get_config
        section = dict(get_config(os.path.join(ROOT, path))["model"])
    model_name = section["model_name"]
    kw = {k: v for k, v in section.items() if k not in _NOT_MODEL_KWARGS}
    if isinstance(kw.get("num_modes"), list):
        kw["num_modes"] = tuple(kw["num_modes"])
    kw["in_channels"] = n_in
    kw["ndim"] = len(spatial) + 2
    return model_name, kw, (1, n_in) + tuple(spatial)


# Forward goldens: (model_name, kwargs, input shape). The configs are cut
# in width and depth so the fixtures stay small; the extra cases cover
# the branches the configs do not take.
_SMALL_3D = (1, 2, 16, 16, 12)
FORWARD_CASES = {
    "fno": ("NeuralOperatorSeg", dict(
        in_channels=2, out_channels=3, filters=6, num_transform_blocks=2,
        num_modes=(2, 3, 3), transform_type="Fourier",
        weights_type="individual", use_bias_conv_branch=True,
        use_block_skip=False), _SMALL_3D),
    "fnoseg": ("NeuralOperatorSeg", dict(
        in_channels=2, out_channels=3, filters=6, num_transform_blocks=2,
        num_modes=(3, 3, 3), transform_type="Fourier"), _SMALL_3D),
    "fnoseg_2d": ("NeuralOperatorSeg", dict(
        in_channels=1, out_channels=3, filters=6, num_transform_blocks=2,
        num_modes=(4, 4), transform_type="Fourier", ndim=4),
        (2, 1, 20, 16)),
    "hartleymha": ("HartleyMHASeg", dict(
        in_channels=2, out_channels=3, filters=8, num_transform_blocks=2,
        num_heads=2, num_modes=(2, 2, 2), patch_size=2), _SMALL_3D),
    "hnoseg": ("NeuralOperatorSeg", dict(
        in_channels=2, out_channels=3, filters=6, num_transform_blocks=2,
        num_modes=(3, 3, 3), transform_type="Hartley"), _SMALL_3D),
    "hnoseg_xs": ("HNOSegXS", dict(
        in_channels=2, out_channels=3, filters=8,
        num_transform_blocks=[3, 3, 3], num_modes=(3, 4, 4)), _SMALL_3D),
    "vnet_ds": ("VNetDS", dict(
        in_channels=2, out_channels=3, base_num_filters=4,
        num_blocks=[1, 2, 2], right_leg_indexes=[0, 1, 2]), _SMALL_3D),
    "example": ("HNOSegXS", dict(
        in_channels=2, out_channels=3, filters=8,
        num_transform_blocks=[2, 2, 2, 2], num_modes=(3, 4, 3)),
        _SMALL_3D),
    "hartley_no_resize": ("NeuralOperatorSeg", dict(
        in_channels=2, out_channels=3, filters=6, num_transform_blocks=2,
        num_modes=(3, 3, 3), transform_type="Hartley", use_resize=False),
        (1, 2, 12, 12, 8)),
    "fourier_no_resize": ("NeuralOperatorSeg", dict(
        in_channels=2, out_channels=3, filters=6, num_transform_blocks=2,
        num_modes=(3, 3, 3), transform_type="Fourier", use_resize=False),
        (1, 2, 12, 12, 8)),
    "hartley_deep_supervision": ("NeuralOperatorSeg", dict(
        in_channels=2, out_channels=3, filters=6, num_transform_blocks=3,
        num_modes=(3, 3, 3), transform_type="Hartley",
        use_deep_supervision=True), _SMALL_3D),
    "mha_no_patch_no_resize": ("HartleyMHASeg", dict(
        in_channels=2, out_channels=3, filters=8, num_transform_blocks=2,
        num_heads=2, num_modes=(3, 3, 3), patch_size=None,
        use_resize=False, use_deep_supervision=False), (1, 2, 12, 12, 8)),
    "hnoseg_xs_bf16": ("HNOSegXS", dict(
        in_channels=2, out_channels=3, filters=8,
        num_transform_blocks=[2, 2, 2], num_modes=(3, 4, 4),
        use_deep_supervision=True, compute_dtype="bfloat16"), _SMALL_3D),
    "vnet_ds_bf16": ("VNetDS", dict(
        in_channels=2, out_channels=3, base_num_filters=4,
        num_blocks=[1, 1], right_leg_indexes=[0, 1],
        compute_dtype="bfloat16"), _SMALL_3D),
}

# One-step loss + gradient goldens, one per family.
GRAD_CASES = {
    "HNOSegXS": "hnoseg_xs",
    "FNOSeg": "fnoseg",
    "HNOSeg": "hnoseg",
    "HartleyMHASeg": "hartleymha",
    "VNetDS": "vnet_ds",
}


def path_str(path):
    """'a/b/c' from a ``jax.tree_util`` key path of dict keys."""
    return "/".join(str(getattr(k, "key", k)) for k in path)


def fill_params(shapes):
    """Deterministic parameters for a tree of shapes (leaves with
    ``.shape``): each leaf is drawn from a generator seeded by the CRC32 of
    its path, so values depend on the path and shape only."""
    import jax

    def fill(path, leaf):
        p = path_str(path)
        shape = tuple(leaf.shape)
        rng = np.random.default_rng(zlib.crc32(p.encode()))
        u = rng.uniform(-1.0, 1.0, shape)
        if len(shape) >= 2:
            fan = max(1, int(np.prod(shape)) // max(shape))
            v = u / np.sqrt(fan)
        elif p.endswith("scale"):
            v = 1.0 + 0.1 * u
        else:
            v = 0.1 * u
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def make_input(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def make_labels(shape, n_classes, seed=1):
    lab_shape = (shape[0], 1) + tuple(shape[2:])
    return np.random.default_rng(seed).integers(
        0, n_classes, size=lab_shape).astype(np.int32)
