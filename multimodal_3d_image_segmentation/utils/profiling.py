"""Tracing, timing and compile-cache utilities.

The reference measures wall-clock time and CUDA allocator peaks
(``experiments/train_test.py:384-426``). Here:

  * ``trace(logdir)`` — context manager around ``jax.profiler`` producing
    XPlane traces;
  * ``device_memory_stats()`` — per-device memory stats;
  * ``Timer`` — wall-clock timing with warm-up exclusion, matching the
    reference's measurement protocol;
  * ``time_calls`` — host clock around ``fn(*args)`` ending in
    ``block_until_ready``, warm-up calls excluded;
  * ``setup_compilation_cache`` — JAX's persistent compile cache at one
    fixed place.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List

import numpy as np

import jax

__all__ = ["trace", "device_memory_stats", "Timer", "time_calls",
           "setup_compilation_cache", "CACHE_DIR"]

#: Compile-cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset:
#: ``.jax_cache/`` in the checkout (listed in ``.gitignore``). The path is
#: part of the cache key, so it must not move between runs.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


@contextlib.contextmanager
def trace(logdir: str):
    """Collect a jax.profiler trace into ``logdir``."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_memory_stats(device=None) -> Dict[str, float]:
    """Device memory stats in MiB for one device (first local device by
    default)."""
    device = device or jax.local_devices()[0]
    stats = device.memory_stats() or {}
    mib = 1024 ** 2
    return {
        "bytes_in_use_mib": stats.get("bytes_in_use", 0) / mib,
        "peak_bytes_in_use_mib": stats.get("peak_bytes_in_use", 0) / mib,
        "bytes_limit_mib": stats.get("bytes_limit", 0) / mib,
    }


class Timer:
    """Wall-clock timer with warm-up exclusion (the reference's protocol:
    first iteration excluded, ``experiments/train_test.py:413-414``)."""

    def __init__(self, skip_first: int = 1):
        self.skip_first = skip_first
        self.times: List[float] = []
        self._seen = 0

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self._seen += 1
        if self._seen > self.skip_first:
            self.times.append(dt)

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")

    @property
    def median(self) -> float:
        return float(np.median(self.times)) if self.times else float("nan")


def time_calls(fn: Callable, *args, iters: int = 10,
               warmup: int = 1) -> List[float]:
    """Seconds per call of ``fn(*args)``: host clock around each call and
    ``block_until_ready`` on its result. The first ``warmup`` calls
    (compilation included) are run and not reported."""
    times = []
    for i in range(warmup + iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    return times


def setup_compilation_cache() -> str:
    """Point JAX's persistent compile cache at one fixed directory and
    return it. If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses
    it and nothing is changed here; otherwise the cache goes to
    :data:`CACHE_DIR`. Call before the first compile."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
