"""Serving-precision quality on a TRAINED network (needs a GPU).

Quality the way the reference frames it (Dice, zero-shot
super-resolution — reference README.md:10, Fig. 2):

  1. train a family on synthetic blob volumes at 120x120x78 (fp32,
     'highest') to convergence;
  2. evaluate the SAME trained params on held-out volumes at 240x240x155
     (zero-shot SR) under each serving mode:
       - fp32 / 'highest'  (the exactness oracle)
       - fp32 / 'high' and 'default' (tensor-core fp32 products, see
         PERF.md for the algorithm XLA picks)
       - bfloat16, and 'mixed' (bf16 storage + fp32 weight islands)
  3. report per-class Dice deltas vs the oracle, argmax agreement and the
     per-volume time of each mode (host clock, compile excluded).

Usage: ``python tools/bench_precision.py [--families a,b] [--out FILE]``.
The Dice bar is |delta| <= 0.001 (0.1%, BASELINE.md).
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_3d_image_segmentation import losses, models
from multimodal_3d_image_segmentation.ops import spectral
from multimodal_3d_image_segmentation.runtime import (
    build_optimizer, build_schedule, create_train_state, make_train_step)

TRAIN_SHAPE = (120, 120, 78)
EVAL_SHAPE = (240, 240, 155)
N_TRAIN = 6
N_EVAL = 3
STEPS = 400

MODEL_FAMILIES = {
    # zero-shot SR via use_resize=False + mode truncation (XS resizes)
    "hnoseg_xs": lambda **kw: models.HNOSegXS(
        4, 4, 24, [3] * 8, (10, 14, 14), **kw),
    "fnoseg": lambda **kw: models.NeuralOperatorSeg(
        4, 4, 24, 24, (10, 14, 14), "Fourier", **kw),
    "hnoseg": lambda **kw: models.NeuralOperatorSeg(
        4, 4, 24, 24, (10, 14, 14), "Hartley", **kw),
    "hartleymha": lambda **kw: models.HartleyMHASeg(
        4, 4, 24, 16, 4, (8, 12, 12), 2, **kw),
    "vnet_ds": lambda **kw: models.VNetDS(
        4, 4, 24, [1, 2, 3, 3, 3],
        right_leg_indexes=[0, 1, 2, 3, 4], **kw),
}


def blob_volume(rng, shape):
    """Multi-blob volume with 3 foreground classes; geometry defined in
    normalized coordinates so low- and high-res draws are consistent.

    Shells are wide enough to survive 120^3 rasterization and every
    foreground class has its own intensity key, so a converged network
    has nonzero Dice on ALL classes (a class it never learns would make
    its precision delta trivially zero).
    """
    zz, yy, xx = np.meshgrid(*[np.linspace(0, 1, s) for s in shape],
                             indexing="ij")
    seg = np.zeros(shape, np.int32)
    for _ in range(3):
        c = rng.uniform(0.22, 0.78, 3)
        r = rng.uniform(0.12, 0.22)
        d2 = ((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2)
        seg[d2 < r ** 2] = 1
        seg[d2 < (0.72 * r) ** 2] = 2
        seg[d2 < (0.45 * r) ** 2] = 3
    x = np.stack([seg * 2.0 + rng.standard_normal(shape) * 0.5,
                  -seg + rng.standard_normal(shape) * 0.5,
                  (seg == 2) * 3.0 + rng.standard_normal(shape) * 0.5,
                  (seg == 3) * 3.0 + rng.standard_normal(shape) * 0.5]
                 ).astype(np.float32)
    return x, seg


def make_dataset(seed, n, shape):
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for _ in range(n):
        x, s = blob_volume(rng, shape)
        xs.append(x)
        ys.append(s)
    return np.stack(xs), np.stack(ys)


def train(family="hnoseg_xs", params_seed=0):
    spectral.set_fp32_transform_precision("highest")
    model = MODEL_FAMILIES[family]()
    xs, ys = make_dataset(1, N_TRAIN, TRAIN_SHAPE)
    fracs = [float(np.mean(ys == c)) for c in range(4)]
    print("train class fractions:",
          " ".join(f"{f:.4f}" for f in fracs), flush=True)
    assert all(f > 1e-4 for f in fracs), "a class rasterized away"
    schedule = build_schedule(
        {"scheduler_name": "CosineAnnealingWarmRestarts", "eta_min": 1e-3},
        5e-3, N_TRAIN, STEPS // N_TRAIN)
    tx = build_optimizer({"optimizer_name": "Adamax", "lr": 5e-3}, schedule)
    params = model.init(jax.random.PRNGKey(params_seed),
                        jnp.zeros((1, 4) + TRAIN_SHAPE))["params"]
    state = create_train_state(model, params, tx)
    step = make_train_step(losses.pcc_loss, num_labels=4, donate=False)
    losses_hist = []
    for i in range(STEPS):
        j = i % N_TRAIN
        state, loss = step(state, jnp.asarray(xs[j:j + 1]),
                           jnp.asarray(ys[j:j + 1, None]))
        if i % 50 == 0 or i == STEPS - 1:
            losses_hist.append(round(float(loss), 5))
            print(f"step {i:4d} loss {float(loss):.5f}", flush=True)
    return state.params, losses_hist


def dice_per_class(pred, true, n_classes=4):
    out = []
    for lab in range(1, n_classes):
        inter = np.count_nonzero((pred == lab) & (true == lab))
        denom = (np.count_nonzero(pred == lab)
                 + np.count_nonzero(true == lab))
        out.append(2 * inter / denom if denom else float("nan"))
    return out


def evaluate(params, mode, family="hnoseg_xs"):
    """mode: ('highest'|'high'|'default', compute_dtype)"""
    from multimodal_3d_image_segmentation.utils.profiling import time_calls
    prec, dtype = mode
    spectral.set_fp32_transform_precision(prec)
    # 'mixed': bf16 activations + fp32 weight/matrix islands
    spectral.set_bf16_exact(dtype == "mixed")
    if dtype == "mixed":
        dtype = "bfloat16"
    model = MODEL_FAMILIES[family](compute_dtype=dtype)

    # fresh closure per mode: precision is baked at trace time
    def fwd(p, v):
        return jnp.argmax(model.apply({"params": p}, v), axis=1)

    step = jax.jit(fwd)
    xs, ys = make_dataset(99, N_EVAL, EVAL_SHAPE)   # held-out geometry
    dices, preds = [], []
    for i in range(N_EVAL):
        pred = np.asarray(step(params, jnp.asarray(xs[i:i + 1])))[0]
        preds.append(pred)
        dices.append(dice_per_class(pred, ys[i]))
    sec = float(np.median(time_calls(step, params, jnp.asarray(xs[:1]),
                                     iters=5)))
    return np.asarray(dices), preds, sec


def main():
    import subprocess
    from multimodal_3d_image_segmentation.utils.profiling import (
        setup_compilation_cache)
    setup_compilation_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write results as JSON")
    ap.add_argument("--families", default="hnoseg_xs",
                    help="comma list of " + ",".join(MODEL_FAMILIES))
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)

    modes = {
        "fp32_highest": ("highest", "float32"),
        "fp32_high": ("high", "float32"),
        "fp32_default": ("default", "float32"),
        "bf16": ("high", "bfloat16"),
        # bf16 activation storage + fp32 weight/matrix islands
        # (ops/spectral.set_bf16_exact)
        "mixed": ("high", "mixed"),
    }
    results = {"train_shape": list(TRAIN_SHAPE),
               "eval_shape": list(EVAL_SHAPE),
               "steps": STEPS, "device_kind": dev.device_kind,
               "card": card}
    for family in args.families.split(","):
        params, hist = train(family)
        fam_res = {"train_loss_history": hist}
        ref_dice, ref_preds = None, None
        for name, mode in modes.items():
            dices, preds, sec = evaluate(params, mode, family)
            mean_d = np.nanmean(dices, axis=0)
            rec = {"per_class_dice_mean":
                   [round(float(v), 5) for v in mean_d],
                   "ms_per_volume": sec * 1e3}
            if name == "fp32_highest":   # deltas ONLY vs the true oracle
                ref_dice, ref_preds = mean_d, preds
                # a ~0-Dice class makes its delta trivially zero — flag
                # it so the claim cannot silently rest on a dead class
                rec["all_classes_learned"] = bool(np.all(mean_d > 0.2))
            elif ref_dice is not None:
                rec["dice_delta_vs_highest"] = [
                    round(float(v - r), 5)
                    for v, r in zip(mean_d, ref_dice)]
                agree = np.mean([np.mean(p == q)
                                 for p, q in zip(preds, ref_preds)])
                rec["argmax_agreement_vs_highest"] = round(float(agree), 6)
            fam_res[name] = rec
            print(family, name, rec, flush=True)
        results[family] = fam_res
        if args.out:  # incremental: survive a later-family crash
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
