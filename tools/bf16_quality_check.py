"""bf16-vs-fp32 training quality comparison on synthetic data (needs a GPU).

Trains the same model/config/data with fp32 and bf16 activations and
compares loss trajectories, foreground Dice and the steady train-step
time — evidence for whether ``compute_dtype='bfloat16'`` is quality-safe
for this model family. Usage: ``python tools/bf16_quality_check.py
[--out FILE]``.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_3d_image_segmentation import losses, models
from multimodal_3d_image_segmentation.runtime import (  # noqa: E402
    build_optimizer, build_schedule, create_train_state, make_train_step)
from multimodal_3d_image_segmentation.utils.profiling import (  # noqa: E402
    time_calls)


def blob_batch(rng, batch=2, shape=(32, 32, 24), n_classes=4):
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    xs, ys = [], []
    for _ in range(batch):
        c = [s // 2 + rng.integers(-5, 6) for s in shape]
        r2 = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
        seg = np.zeros(shape, np.int32)
        seg[r2 < 100] = 1
        seg[r2 < 36] = 2
        seg[r2 < 9] = 3
        x = np.stack([seg * 2.0 + rng.standard_normal(shape) * 0.5,
                      -seg + rng.standard_normal(shape) * 0.5,
                      (seg == 2) * 3.0 + rng.standard_normal(shape) * 0.5,
                      rng.standard_normal(shape) * 0.5])
        xs.append(x.astype(np.float32))
        ys.append(seg[None])
    return jnp.asarray(np.stack(xs)), jnp.asarray(np.stack(ys))


def run(compute_dtype, steps=150):
    model = models.HNOSegXS(4, 4, 16, [2] * 4, (5, 6, 5),
                            compute_dtype=compute_dtype)
    rng = np.random.default_rng(0)
    x, y = blob_batch(rng)
    schedule = build_schedule(
        {"scheduler_name": "CosineAnnealingWarmRestarts", "eta_min": 1e-3},
        5e-3, 1, steps)
    tx = build_optimizer({"optimizer_name": "Adamax", "lr": 5e-3}, schedule)
    params = model.init(jax.random.PRNGKey(0), x)["params"]
    state = create_train_state(model, params, tx)
    step = make_train_step(losses.pcc_loss, num_labels=4, donate=False)
    step_s = float(np.median(time_calls(step, state, x, y, iters=10)))
    hist = []
    for i in range(steps):
        state, loss = step(state, x, y)
        if i % 25 == 0 or i == steps - 1:
            hist.append(float(loss))
    pred = np.asarray(jnp.argmax(
        model.apply({"params": state.params}, x), axis=1))
    true = np.asarray(y)[:, 0]
    dices = []
    for lab in range(1, 4):
        inter = np.count_nonzero((pred == lab) & (true == lab))
        denom = (np.count_nonzero(pred == lab)
                 + np.count_nonzero(true == lab))
        dices.append(2 * inter / denom if denom else float("nan"))
    return hist, dices, step_s


def main():
    import argparse
    import json
    import subprocess
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write results as JSON")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    results = {"device_kind": dev.device_kind, "card": card}
    for dt in ["float32", "bfloat16"]:
        hist, dices, step_s = run(dt)
        results[dt] = {"loss_history": [round(float(v), 5) for v in hist],
                       "per_class_dice": [round(float(d), 4)
                                          for d in dices],
                       "ms_per_step": step_s * 1e3}
        print(f"{dt:9s} loss: " + " ".join(f"{v:.4f}" for v in hist)
              + "  | per-class Dice: "
              + " ".join(f"{d:.3f}" for d in dices)
              + f"  | {step_s * 1e3:.3f} ms/step", flush=True)
    f32 = results["float32"]["per_class_dice"]
    b16 = results["bfloat16"]["per_class_dice"]
    results["dice_delta_bf16_minus_fp32"] = [
        round(b - a, 4) for a, b in zip(f32, b16)]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
