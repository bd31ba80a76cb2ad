"""Shape utilities shared by kernels and model code
(``repro/utils/shapes.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def next_multiple(x: int, m: int) -> int:
    return ceil_div(x, m) * m


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int, value=0
                    ) -> torch.Tensor:
    """Pad ``axis`` of ``x`` up to the next multiple of ``multiple`` with
    the constant ``value`` (``x`` itself where it already is one)."""
    size = x.shape[axis]
    target = next_multiple(size, multiple)
    if target == size:
        return x
    # F.pad lists (left, right) pairs from the last dim backwards
    pads = [0, 0] * (x.dim() - axis % x.dim())
    pads[-1] = target - size
    return F.pad(x, pads, value=value)
