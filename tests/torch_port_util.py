"""Shared setup for the PyTorch-port parity tests (``test_torch_*.py``).

Every such test module imports this one right after ``torch``.  Inputs are
made with numpy from a seed and handed to both packages; JAX stays on the
CPU and the port runs with ``device="cpu"`` (its plain PyTorch versions).
"""
import contextlib
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


def bf16_ulp(x) -> float:
    """The spacing of bfloat16 numbers at magnitude ``x`` (8 significant
    bits: 2**(floor(log2 |x|) - 7))."""
    x = max(abs(float(x)), float(np.finfo(np.float32).tiny))
    return float(2.0 ** (np.floor(np.log2(x)) - 7))


def assert_bf16_close(got, want, ulps: float, what: str = "") -> float:
    """``|got - want| <= ulps`` bf16 ulps of ``max |want|``; returns the
    max difference."""
    got = np.asarray(n(got), dtype=np.float32)
    want = np.asarray(n(want), dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all() and np.isfinite(want).all(), what
    bar = ulps * bf16_ulp(np.abs(want).max())
    diff = float(np.abs(got - want).max())
    assert diff <= bar, f"{what}: max diff {diff} over {ulps} ulps = {bar}"
    return diff


def assert_top1_beyond(got, want, bar: float) -> None:
    """Top-1 equal on every row whose top-2 margin (in ``want``) exceeds
    ``bar``."""
    got = np.asarray(n(got), dtype=np.float32).reshape(-1, np.shape(want)[-1])
    want = np.asarray(n(want), dtype=np.float32).reshape(got.shape)
    top2 = np.sort(want, axis=-1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > bar
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])


@contextlib.contextmanager
def one_thread():
    """Run the block on one intra-op thread, then restore the count.  For
    long runs of small ops (a training loop, a field scenario): the test
    workers share the machine's cores, and eight spinning threads a small
    op in each of them thrash it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _c_to_py(expr: str) -> str:
    """A constant expression of C++ integers, comparisons and right-nested
    ternaries (``a ? b : c ? d : e``) as Python."""
    if "?" not in expr:
        return expr.replace(" / ", " // ")
    cond, rest = expr.split("?", 1)
    then, other = rest.split(":", 1)
    return (f"({_c_to_py(then.strip())} if {_c_to_py(cond.strip())} "
            f"else {_c_to_py(other.strip())})")


def tf32x3_shape(dp: int) -> dict:
    """``TfShape<DP>``'s constants as ``csrc/flash_attention.cu`` states
    them, evaluated at head dim ``dp``: BQ, BK, THREADS, LD, SMEM, ..."""
    import os
    import re
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "src", "repro_torch", "kernels", "csrc",
        "flash_attention.cu")
    with open(src) as f:
        text = f.read()
    body = text[text.index("struct TfShape {"):]
    body = body[:body.index("};")]
    names = {"DP": dp}
    for name, expr in re.findall(
            r"static constexpr (?:int|bool) (\w+) =\s*([^;]+);", body):
        names[name] = eval(_c_to_py(" ".join(expr.split())), {}, names)
    return names
