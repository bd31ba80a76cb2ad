"""Banded NW/SW alignment scores: the CUDA kernel (``csrc/banded_align.cu``)
and its wrapper.

Replaces ``repro/kernels/edit_distance.py::banded_align`` (via ``_wavefront``,
Pallas body ``_wavefront_kernel``).  ``levenshtein`` is the same DP with unit
costs; its wrapper comes with the genomics-pipeline slice, whose barcode
demux is its only caller.  The source note in ``csrc/banded_align.cu`` says
what bounds the kernel on an H100 and what its design does about it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def banded_align(query: torch.Tensor, target: torch.Tensor, *, band: int,
                 match: int = 2, mismatch: int = -4, gap: int = -2,
                 local: bool = False) -> torch.Tensor:
    """Banded NW (global) / SW (local) int32 scores; (P, m) x (P, n) ->
    (P,).

    A CPU tensor runs the plain version (:func:`ref.banded_align`); a CUDA
    tensor launches the kernel or raises."""
    if query.device.type == "cpu":
        return ref.banded_align(query, target, band=band, match=match,
                                mismatch=mismatch, gap=gap, local=local)
    p, m = query.shape
    p2, n = target.shape
    if p != p2:
        raise ValueError(f"banded_align: {p} queries vs {p2} targets")
    _build.check_tensor("banded_align query", query, torch.int32)
    _build.check_tensor("banded_align target", target, torch.int32,
                        device=query.device)
    if band < 0:
        raise ValueError(f"banded_align: band must be >= 0, got {band}")
    if (2 * m + 1) * 32 * 4 > _build.SMEM_LIMIT:
        raise ValueError(f"banded_align: query length {m} does not fit a "
                         "block's shared memory")
    out = torch.empty((p,), dtype=torch.int32, device=query.device)
    if p == 0:
        return out
    _build.launch(
        "banded_align", "launch_banded_align", _ARGS, query.data_ptr(),
        target.data_ptr(), out.data_ptr(), p, m, n, band, match, mismatch,
        gap, int(local), _build.stream_handle(query.device))
    banded_align.launches += 1
    return out


banded_align.launches = 0
