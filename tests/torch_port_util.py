"""Shared setup for the PyTorch-port parity tests (``test_torch_*.py``).

Every such test module imports this one right after ``torch``.  Inputs are
made with numpy from a seed and handed to both packages; JAX stays on the
CPU and the port runs with ``device="cpu"`` (its plain PyTorch versions).
"""
import sys

import numpy as np
import torch


def _plain_warning_registries():
    # torch.ops and torch.classes answer every attribute lookup with a new
    # lazy namespace, so their ``__warningregistry__`` is not a dict; give
    # them real empty registries so code that clears every module's
    # registry (the autouse fixture in conftest.py) keeps working once
    # torch has been imported into the process
    for name in ("torch.ops", "torch.classes"):
        mod = sys.modules.get(name)
        if mod is not None:
            mod.__warningregistry__ = {}


_plain_warning_registries()

CPU = "cpu"


def t(a, dtype=None):
    """numpy (or JAX) array -> CPU tensor, copying."""
    arr = np.array(a, copy=True)
    out = torch.from_numpy(arr)
    return out if dtype is None else out.to(dtype)


def n(x):
    """tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
