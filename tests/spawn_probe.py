"""Reader for the data loader that reports, from inside a worker process,
whether JAX is imported and whether it has initialized a backend."""
import os
import sys

import numpy as np


def probe_reader(path):
    imported = "jax" in sys.modules
    initialized = False
    if imported:
        from jax._src import xla_bridge
        initialized = xla_bridge.backends_are_initialized()
    return np.array([float(imported), float(initialized), float(os.getpid())],
                    np.float64)
