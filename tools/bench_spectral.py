"""GPU A/B of the HNOSeg-XS spectral layer choices, in one process.

  * the spectral core as the reference runs it (full FFT via cuFFT + crop,
    zero-pad + inverse FFT) against the pruned matmul chains
    (``dht_crop`` / ``dht_pad_inverse``) at the flagship block grid;
  * which dot algorithm XLA picks for fp32 ``Precision.HIGH`` /
    ``DEFAULT`` / ``HIGHEST`` (read from the optimized HLO).

Each A/B runs in turns (A, B, B, A) and reports the median of each arm.
Usage: ``python tools/bench_spectral.py [--out FILE]``. Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_3d_image_segmentation.ops import spectral  # noqa: E402
from multimodal_3d_image_segmentation.utils.profiling import (  # noqa: E402
    setup_compilation_cache, time_calls)

BLOCK_GRID = (1, 78, 121, 121, 24)
MODES = (10, 14, 14)


def ab(name, fa, fb, args_a, args_b, iters):
    """Median seconds of two callables, measured A, B, B, A."""
    ta, tb = [], []
    for order in ("a", "b", "b", "a"):
        f, args, acc = ((fa, args_a, ta) if order == "a"
                        else (fb, args_b, tb))
        acc += time_calls(f, *args, iters=iters, warmup=1)
    ma, mb = float(np.median(ta)), float(np.median(tb))
    print(f"{name}: A {ma * 1e3:.4f} ms  B {mb * 1e3:.4f} ms  "
          f"B/A {mb / ma:.3f}", flush=True)
    return {"a_ms": ma * 1e3, "b_ms": mb * 1e3}


def fft_crop(x, modes):
    h = spectral.dht_full(x)
    for ax, m in zip((1, 2, 3), modes):
        n = x.shape[ax]
        h = jnp.take(h, np.concatenate([np.arange(m), np.arange(n - m, n)]),
                     axis=ax)
    return h


def fft_pad_inverse(y, sizes):
    for ax, n in zip((1, 2, 3), sizes):
        m = y.shape[ax] // 2
        shape = list(y.shape)
        shape[ax] = n - 2 * m
        lo, hi = jnp.split(y, [m], axis=ax)
        y = jnp.concatenate([lo, jnp.zeros(shape, y.dtype), hi], axis=ax)
    return spectral.dht_full(y, is_inverse=True)


def _config_fields(line):
    """The precision-relevant fields of an HLO backend_config."""
    keys = ("operand_precision", "algorithm", "math_type", "precision_config",
            "tensor_ops", "selected_algorithm")
    return [m.group(0) for k in keys
            for m in re.finditer(r'"%s":(\{[^{}]*\}|\[[^\]]*\]|"[^"]*"|\w+)'
                                 % k, line)]


def dot_algorithms():
    """What the optimized HLO says of one fp32 matmul and one fp32 conv per
    precision setting, and the rate each reaches."""
    n = 8192
    a = jnp.ones((n, n), jnp.float32)
    xc = jnp.ones((1, 78, 120, 120, 4), jnp.float32)
    kc = jnp.ones((2, 2, 2, 4, 24), jnp.float32)
    out = {}
    for prec in ("DEFAULT", "HIGH", "HIGHEST"):
        p = getattr(jax.lax.Precision, prec)
        dot = jax.jit(lambda u, v: jnp.dot(u, v, precision=p))
        conv = jax.jit(lambda u, k: jax.lax.conv_general_dilated(
            u, k, (2, 2, 2), [(1, 1)] * 3,
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"), precision=p))
        fields = []
        for f, args in ((dot, (a, a)), (conv, (xc, kc))):
            hlo = f.lower(*args).compile().as_text()
            for ln in hlo.splitlines():
                target = re.search(r'custom_call_target="([^"]+)"', ln)
                attrs = re.findall(r"(?:operand_precision|algorithm)="
                                   r"(?:\{[^}]*\}|\w+)", ln)
                if target or (attrs and re.search(r" (dot|convolution)\(",
                                                  ln)):
                    fields.append((target.group(1) if target else "",
                                   _config_fields(ln) + attrs))
        out[prec] = fields
        t = float(np.median(time_calls(dot, a, a, iters=10)))
        print(f"[hlo] fp32 Precision.{prec}: {fields}", flush=True)
        print(f"[hlo] {n}^3 fp32 dot at Precision.{prec}: {t * 1e3:.3f} ms "
              f"= {2 * n ** 3 / t / 1e12:.1f} TFLOP/s", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    setup_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"device {dev.device_kind} x{len(jax.devices())}; card: {card}",
          flush=True)
    res = {"card": card, "device_kind": dev.device_kind}
    res["hlo"] = dot_algorithms()
    spectral_core_ab(res, np.random.default_rng(0))

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


def spectral_core_ab(res, rng):
    # A = pruned chains, B = cuFFT + crop / pad
    xb = jnp.asarray(rng.standard_normal(BLOCK_GRID).astype(np.float32))
    sizes = BLOCK_GRID[1:4]
    for mode in ("high", "highest"):
        spectral.set_fp32_transform_precision(mode)
        pa = jax.jit(lambda v: spectral.dht_pad_inverse(
            spectral.dht_crop(v, MODES), sizes))
        pb = jax.jit(lambda v: fft_pad_inverse(fft_crop(v, MODES), sizes))
        d = float(jnp.max(jnp.abs(pa(xb) - pb(xb))))
        print(f"transform pair pruned ('{mode}') vs cuFFT: max|d| {d:.3e}",
              flush=True)
        res[f"pair_{mode}"] = ab(
            f"transform pair at {BLOCK_GRID} (A pruned '{mode}', B cuFFT)",
            pa, pb, (xb,), (xb,), iters=50)
        ca = jax.jit(lambda v: spectral.dht_crop(v, MODES))
        cb = jax.jit(lambda v: fft_crop(v, MODES))
        res[f"crop_{mode}"] = ab(
            f"forward crop (A pruned '{mode}', B cuFFT)", ca, cb, (xb,),
            (xb,), iters=50)
        y = ca(xb)
        ia = jax.jit(lambda v: spectral.dht_pad_inverse(v, sizes))
        ib = jax.jit(lambda v: fft_pad_inverse(v, sizes))
        res[f"inverse_{mode}"] = ab(
            f"pad + inverse (A pruned '{mode}', B cuFFT)", ia, ib, (y,),
            (y,), iters=50)
    spectral.set_fp32_transform_precision("highest")


if __name__ == "__main__":
    main()
