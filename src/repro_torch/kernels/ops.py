"""Public kernel entry points — thin fabric wrappers (``repro/kernels/ops.py``).

Each op counts its dispatch under ``fabric.dispatch.<op>.<target>`` (the
target is the tensor's device: ``cuda`` or ``reference``) and calls the
kernel wrapper, which launches the CUDA kernel for a CUDA tensor and runs
the plain PyTorch version for a CPU tensor.  Float operands only: the int8
MAC path is a later slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import conv1d as _conv1d
from repro_torch.kernels import edit_distance as _ed
from repro_torch.kernels import fabric
from repro_torch.kernels import matmul as _mm


def mat_mul(a, b, bias=None, *, activation: str = "none"):
    """activation(a @ b + bias) for arbitrary (M, K) x (K, N)."""
    fabric.dispatch("matmul", a)
    return _mm.matmul(a, b, bias, activation=activation)


def conv1d(x, w, bias=None, *, stride: int = 1, padding: str = "same",
           activation: str = "none"):
    """Conv1d over (B, T, Cin) with (K, Cin, Cout) weights.  ``"same"``
    pads ``ceil(T / stride)`` outputs' worth, the smaller half on the left
    (``repro/kernels/ops.py``); ``"valid"`` pads nothing."""
    ksize = w.shape[0]
    if padding == "same":
        t = x.shape[1]
        t_out = -(-t // stride)
        pad_total = max((t_out - 1) * stride + ksize - t, 0)
        x = F.pad(x, (0, 0, pad_total // 2, pad_total - pad_total // 2))
    elif padding != "valid":
        raise ValueError(padding)
    fabric.dispatch("conv1d", x)
    return _conv1d.conv1d(x.contiguous(), w, bias, stride=stride,
                          activation=activation)


def conv1d_stream(x, w, bias=None, carry=None, *, stride: int = 1,
                  activation: str = "none"):
    """Stateful chunked conv1d over (B, T, Cin); T % stride == 0.

    ``carry`` is the (B, K - stride, Cin) tail of the preceding chunks
    (None at stream start).  Emits exactly T / stride frames and the new
    carry, so chunk-by-chunk output equals one conv over the whole read
    under "stream" (left-heavy) padding."""
    ksize = w.shape[0]
    if x.shape[1] % stride:
        raise ValueError(f"chunk length {x.shape[1]} not a multiple of "
                         f"stride {stride}")
    c = _conv1d.stream_carry_len(ksize, stride)
    if carry is None:
        carry = torch.zeros((x.shape[0], c, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    elif carry.shape[1] != c:
        raise ValueError(f"carry has {carry.shape[1]} rows, expected "
                         f"K - stride = {c}")
    buf = torch.cat([carry.to(x.dtype), x], dim=1)
    y = conv1d(buf, w, bias, stride=stride, padding="valid",
               activation=activation)
    return y, buf[:, buf.shape[1] - c:, :]


def banded_align(query, target, *, band: int, match: int = 2,
                 mismatch: int = -4, gap: int = -2, local: bool = False):
    """Banded NW/SW alignment scores; (P, m) x (P, n) -> (P,) int32."""
    fabric.dispatch("banded_align", query)
    return _ed.banded_align(query.to(torch.int32).contiguous(),
                            target.to(torch.int32).contiguous(), band=band,
                            match=match, mismatch=mismatch, gap=gap,
                            local=local)
