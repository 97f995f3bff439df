"""Benchmark: HNOSeg-XS full-resolution BraTS'23 inference throughput.

Protocol mirrors the reference (``experiments/train_test.py:384-426``):
per-volume time on 240x240x155 volumes (array layout (z, y, x) =
(155, 240, 240), as the data loader reads them), compile excluded. The
model is built from ``configs/config_hnoseg_xs.ini``. Each call is timed
on the host clock around ``block_until_ready``; the median is reported.
Baseline: the published V100 number for HNOSeg-XS inference is
< 0.24 s/volume (reference ``README.md:10``, Fig. 1 ~0.20 s).

Prints the device and the card's power limit, then ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
with value = volumes/sec/GPU and vs_baseline = speedup over the 0.24 s
V100 reference. Needs a GPU.
"""
import json
import os
import subprocess
import sys

import numpy as np

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

BASELINE_SECONDS_PER_VOLUME = 0.24  # V100, reference README.md:10
SHAPE = (1, 4, 155, 240, 240)       # BraTS'23 full resolution
ITERS = 20


def main():
    from multimodal_3d_image_segmentation import models
    from multimodal_3d_image_segmentation.ops import spectral
    from multimodal_3d_image_segmentation.runtime.config import get_config
    from multimodal_3d_image_segmentation.utils.profiling import (
        setup_compilation_cache, time_calls)

    setup_compilation_cache()
    dev = jax.devices()[0]
    print(f"device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())}")
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")

    kw = dict(get_config(os.path.join(
        REPO, "configs", "config_hnoseg_xs.ini"))["model"])
    kw.pop("model_name")
    spectral.set_fp32_transform_precision(kw.pop("transform_precision"))
    kw["num_modes"] = tuple(kw["num_modes"])
    model = models.HNOSegXS(in_channels=SHAPE[1], **kw)

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(SHAPE).astype(np.float32))
    params = model.init(jax.random.PRNGKey(0), jnp.zeros_like(x))["params"]
    fwd = jax.jit(lambda p, v: model.apply({"params": p}, v))
    sec_per_volume = float(np.median(time_calls(fwd, params, x,
                                                iters=ITERS, warmup=2)))
    print(json.dumps({
        "metric": "hnoseg_xs_brats23_240x240x155_inference_volumes_per_sec",
        "value": round(1.0 / sec_per_volume, 3),
        "unit": "volumes/sec/gpu",
        "vs_baseline": round(BASELINE_SECONDS_PER_VOLUME / sec_per_volume,
                             3),
    }))


if __name__ == "__main__":
    main()
