"""Optional golden-parity oracle: the upstream PyTorch reference.

When the reference checkout is available (``$PYTORCH_REFERENCE_PATH``, by
default a ``reference/`` directory beside this repository), tests import its
modules and compare our JAX implementation numerically against them with
identical weights. When it is absent, the parity tests skip and the
analytic/FFT-oracle tests still guarantee correctness.
"""
import os
import sys

import pytest

REFERENCE_PATH = os.environ.get(
    "PYTORCH_REFERENCE_PATH",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "reference"))


def get_reference_nets():
    """Import the reference `nets` package (torch), or skip the test."""
    if not os.path.isdir(os.path.join(REFERENCE_PATH, "nets")):
        pytest.skip("reference checkout not available")
    torch = pytest.importorskip("torch")
    if REFERENCE_PATH not in sys.path:
        sys.path.insert(0, REFERENCE_PATH)
    import nets  # noqa: F401
    return nets, torch


def to_torch_channel_first(x_np, torch):
    """(B, *spatial, C) numpy -> (B, C, *spatial) torch tensor."""
    import numpy as np
    nd = x_np.ndim
    perm = (0, nd - 1) + tuple(range(1, nd - 1))
    return torch.from_numpy(np.ascontiguousarray(x_np.transpose(perm)))


def from_torch_channel_first(t):
    """(B, C, *spatial) torch tensor -> (B, *spatial, C) numpy."""
    import numpy as np
    x = t.detach().cpu().numpy()
    nd = x.ndim
    perm = (0,) + tuple(range(2, nd)) + (1,)
    return np.ascontiguousarray(x.transpose(perm))
