"""Pytest config: force an 8-device virtual CPU mesh for deterministic,
hardware-independent tests (the standard JAX fake-backend trick).

Must run before the JAX backend is initialized. When the tests run inside
a process that already uses an accelerator (``chip_smoke.py`` runs the
``gpu``-marked tests in its own process), the platform is left alone.
"""
import os
import sys

import jax  # noqa: E402
from jax._src import xla_bridge  # noqa: E402

if not xla_bridge.backends_are_initialized():
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(__file__))
