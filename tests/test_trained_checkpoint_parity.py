"""Trained-checkpoint end-to-end parity vs the PyTorch reference.

Closes the strongest stand-in this environment allows for real-data
accuracy parity (real BraTS volumes are unavailable): the reference model
is TRAINED in-process on synthetic blob volumes with the reference's own
loss/optimizer (``nets/custom_losses.py::PCCLoss`` + ``torch.optim.Adamax``,
the recipe of ``experiments/config_files/config_hnoseg_xs.ini:53-66``),
exported exactly like the reference exports its best model
(``torch.save(state_dict) -> model.pt`` reloaded with ``weights_only=True``,
``experiments/run.py:124-133``), imported via
``utils.import_reference_state_dict``, and BOTH stacks then produce
predictions on held-out volumes at a HIGHER resolution (the reference's
zero-shot-SR protocol, ``README.md:83-87``) that flow through this repo's
full ``testing()`` + ``statistics_regional`` disk pipeline.

The reference's own IO/metrics dependencies (SimpleITK, surface-distance)
are not installable offline, so its predictions are written and scored by
THIS repo's pipeline too — the same code scores both stacks, so the
comparison isolates the model stacks (trained torch forward vs
imported-weights JAX forward) while exercising our test+statistics path
end to end. Asserted: per-sample per-region Dice parity <= 0.1% (the
reference README's quality bar) and voxel argmax agreement >= 99.99%.
"""
import os
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pandas as pd
import pytest

from multimodal_3d_image_segmentation import models
from multimodal_3d_image_segmentation.data.dataset import InputData
from multimodal_3d_image_segmentation.data.nifti import (read_img,
                                                             write_image)
from multimodal_3d_image_segmentation.data.normalization import (
    normalize_modalities)
from multimodal_3d_image_segmentation.metrics import statistics_regional
from multimodal_3d_image_segmentation.runtime import train_test
from multimodal_3d_image_segmentation.utils import (
    import_reference_state_dict)
from tests.reference_oracle import get_reference_nets

TRAIN_SHAPE = (16, 16, 12)
EVAL_SHAPE = (48, 48, 32)   # zero-shot higher-res eval: regions are
                            # thousands of voxels, so one boundary-voxel
                            # flip moves Dice by ~3e-4 << the 1e-3 bar
N_TRAIN, N_EVAL, STEPS = 3, 3, 120

REGION_NAMES = ["background", "lesion", "core"]
REGION_LABELS = [[0], [1, 2], [2]]

FAMILIES = {
    # flagship + one tower family
    "hnoseg_xs": ("HNOSegXS",
                  dict(in_channels=2, out_channels=3, filters=8,
                       num_transform_blocks=[2, 2], num_modes=(3, 4, 4),
                       use_deep_supervision=True)),
    "fnoseg": ("NeuralOperatorSeg",
               dict(in_channels=2, out_channels=3, filters=6,
                    num_transform_blocks=2, num_modes=(3, 4, 4),
                    transform_type="Fourier", weights_type="shared",
                    use_deep_supervision=True)),
}


def _blob_case(rng, shape):
    """2-modality blob volume, geometry in normalized coordinates so the
    train- and eval-resolution draws rasterize the same structures."""
    zz, yy, xx = np.meshgrid(*[np.linspace(0, 1, s) for s in shape],
                             indexing="ij")
    seg = np.zeros(shape, np.uint8)
    for _ in range(2):
        c = rng.uniform(0.28, 0.72, 3)
        r = rng.uniform(0.2, 0.3)
        d2 = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
        seg[d2 < r ** 2] = 1
        seg[d2 < (0.7 * r) ** 2] = 2
    m0 = seg * 10.0 + rng.standard_normal(shape) + 20.0
    m1 = (seg == 2) * 8.0 - seg * 3.0 + rng.standard_normal(shape) + 40.0
    return m0.astype(np.float32), m1.astype(np.float32), seg


def _norm(x):
    return normalize_modalities(x, mask_val=0)


def _train_reference(nets, torch, model_kw, model_name):
    """Train the reference torch model on synthetic volumes with the
    reference recipe; returns the state dict round-tripped through
    ``model.pt`` with ``weights_only=True`` (run.py:124-133 semantics)."""
    torch.manual_seed(0)
    model = getattr(nets, model_name)(**model_kw)
    model.train()
    opt = torch.optim.Adamax(model.parameters(), lr=5e-3)

    rng = np.random.default_rng(1)
    cases = [_blob_case(rng, TRAIN_SHAPE) for _ in range(N_TRAIN)]
    xs = [torch.from_numpy(_norm(np.stack([m0, m1]))[None])
          for m0, m1, _ in cases]
    y1hs = [torch.nn.functional.one_hot(
        torch.from_numpy(seg[None].astype(np.int64)), 3)
        .permute(0, 4, 1, 2, 3).float() for _, _, seg in cases]

    from nets.custom_losses import PCCLoss  # reference loss
    loss_fn = PCCLoss()
    first = last = None
    for i in range(STEPS):
        j = i % N_TRAIN
        opt.zero_grad()
        loss = loss_fn(model(xs[j]), y1hs[j])
        loss.backward()
        opt.step()
        last = float(loss)
        if first is None:
            first = last
    assert last < first, "reference training did not reduce the loss"
    return model, first, last


def _roundtrip_model_pt(torch, model, tmp_path):
    pt = str(tmp_path / "model.pt")
    torch.save(model.state_dict(), pt)
    return torch.load(pt, weights_only=True)


def _write_eval_dataset(root):
    rng = np.random.default_rng(99)  # held-out geometry
    lists = [[], [], []]
    for i in range(N_EVAL):
        pdir = root / f"case{i}"
        os.makedirs(pdir, exist_ok=True)
        m0, m1, seg = _blob_case(rng, EVAL_SHAPE)
        for k, (name, arr) in enumerate([("m0", m0), ("m1", m1),
                                         ("seg", seg)]):
            fn = str(pdir / f"case{i}-{name}.nii.gz")
            write_image(arr, fn, spacing=(1.0, 1.0, 1.0))
            lists[k].append(fn)
    return lists


def _read_dice_csv(out_dir):
    df = pd.read_csv(os.path.join(out_dir, "results_regional.csv"),
                     sep="\t")
    df = df[df["ID"] != "End"]
    cols = [f"dice {n}" for n in REGION_NAMES]
    return df[cols].to_numpy(dtype=np.float64)


@pytest.mark.slow
@pytest.mark.parametrize("family", list(FAMILIES))
def test_trained_checkpoint_end_to_end_parity(tmp_path, family):
    nets, torch = get_reference_nets()
    model_name, kw = FAMILIES[family]

    # 1. train the reference + export/reload model.pt
    ref_model, loss0, loss1 = _train_reference(nets, torch, kw, model_name)
    sd = _roundtrip_model_pt(torch, ref_model, tmp_path)
    sd_np = {k: v.numpy() for k, v in sd.items()}

    # 2. import the trained checkpoint into this framework
    our_model = getattr(models, model_name)(**kw)
    template = our_model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, kw["in_channels"]) + EVAL_SHAPE))["params"]
    params = import_reference_state_dict(our_model, template, sd_np)

    # 3. full testing() pass (disk pipeline) with the imported weights
    data_root = tmp_path / "data"
    os.makedirs(data_root)
    lists = _write_eval_dataset(data_root)
    input_data = InputData(reader=read_img, data_lists_test=lists,
                           idx_x_modalities=[0, 1], idx_y_modalities=[2],
                           x_processing=_norm, batch_size=1, num_workers=0)
    out_jax = str(tmp_path / "jax_test")
    train_test.testing(our_model, params, input_data, out_jax,
                       is_print=False)

    # 4. the reference stack's predictions on the same held-out volumes
    # (same normalization path), written through the same disk pipeline
    ref_model.eval()
    out_ref = str(tmp_path / "ref_test")
    flow_ds = input_data._get_flow(lists).dataset
    agree = []
    for i in range(N_EVAL):
        x, y = flow_ds[i]
        with torch.no_grad():
            probs = ref_model(torch.from_numpy(x[None]))
        pred_ref = probs.argmax(1).numpy()[0].astype(np.uint8)
        train_test.save_output(y[0], lists, i, os.path.join(out_ref, "images"),
                    None, "_true")
        train_test.save_output(pred_ref, lists, i, os.path.join(out_ref, "images"),
                    None, "_pred")
        pred_jax = read_img(os.path.join(
            out_jax, "images", f"case{i}_pred.nii.gz"))
        agree.append(float(np.mean(pred_jax == pred_ref)))

    # every class actually learned (a dead class cannot support parity)
    preds_jax = [read_img(os.path.join(out_jax, "images",
                                       f"case{i}_pred.nii.gz"))
                 for i in range(N_EVAL)]
    assert set(np.unique(np.stack(preds_jax))) == {0, 1, 2}, (
        f"not all classes predicted (train loss {loss0:.4f}->{loss1:.4f})")

    # 5. both stacks' statistics through statistics_regional
    dices = {}
    for out_dir in (out_jax, out_ref):
        ids = [fn.split("/")[-2] for fn in lists[2]]
        y_true = [read_img(os.path.join(out_dir, "images",
                                        f"{i}_true.nii.gz")) for i in ids]
        y_pred = [read_img(os.path.join(out_dir, "images",
                                        f"{i}_pred.nii.gz")) for i in ids]
        statistics_regional(y_true, y_pred, lists[2], out_dir,
                            REGION_NAMES, REGION_LABELS, is_print=False,
                            use_surface_dice=False, use_hd95=False)
        dices[out_dir] = _read_dice_csv(out_dir)

    # 6. the parity assertions: Dice within the reference README's 0.1%
    # bar per sample per region; voxel-level argmax agreement
    delta = np.abs(dices[out_jax] - dices[out_ref])
    assert np.all(np.isfinite(dices[out_jax]))
    assert float(np.nanmax(delta)) <= 1e-3, (
        f"per-region Dice parity broken: max delta {delta.max():.2e}\n"
        f"jax:\n{dices[out_jax]}\nref:\n{dices[out_ref]}")
    assert min(agree) >= 0.9999, f"argmax agreement {min(agree):.6f}"
