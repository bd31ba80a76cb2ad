"""The ED engine's wavefront DP on the card: one CUDA kernel
(``csrc/banded_align.cu``) behind two wrappers.

Replaces ``repro/kernels/edit_distance.py``, whose two entry points share
one Pallas body (``_wavefront_kernel`` via ``_wavefront``):

* :func:`banded_align` — banded Needleman-Wunsch / Smith-Waterman int32
  scores (seed extension, the pathogen panel compare);
* :func:`levenshtein` — unit-cost edit distance (barcode demux).  The
  Pallas body says how the two relate: "levenshtein == match=0,
  mismatch=-1, gap=-1, band=inf, local=False, and distance = -score".  It
  launches the same kernel with those constants and ``band = max(m, n)``,
  which bands nothing (every cell has ``|i - j| <= max(m, n)``).

The source note in ``csrc/banded_align.cu`` says what bounds the kernel on
an H100 and what its design does about it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def needs_scratch(m: int) -> bool:
    """Whether the wavefront kernel's DP row and query (``(2m + 1) * 32 *
    4`` bytes a block of 32 pairs) outgrow a block's shared memory, so that
    query length ``m`` runs the variant that keeps them in device scratch
    (m >= 908)."""
    return (2 * m + 1) * 32 * 4 > _build.SMEM_LIMIT


def _wavefront(what: str, query, target, *, band, match, mismatch, gap,
               local) -> tuple[torch.Tensor, bool]:
    """Check the operands and launch the wavefront kernel once: the
    shared-memory one, or the scratch one where :func:`needs_scratch`
    holds.  Returns the scores and whether the scratch kernel ran."""
    p, m = query.shape
    p2, n = target.shape
    if p != p2:
        raise ValueError(f"{what}: {p} queries vs {p2} targets")
    _build.check_tensor(f"{what} query", query, torch.int32)
    _build.check_tensor(f"{what} target", target, torch.int32,
                        device=query.device)
    out = torch.empty((p,), dtype=torch.int32, device=query.device)
    scratch = None
    if needs_scratch(m):
        scratch = torch.empty(((2 * m + 1) * p,), dtype=torch.int32,
                              device=query.device)
    if p:
        _build.launch(
            "banded_align", "launch_banded_align", _ARGS, query.data_ptr(),
            target.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), p, m, n, band,
            match, mismatch, gap, int(local),
            _build.stream_handle(query.device))
    return out, scratch is not None


def banded_align(query: torch.Tensor, target: torch.Tensor, *, band: int,
                 match: int = 2, mismatch: int = -4, gap: int = -2,
                 local: bool = False) -> torch.Tensor:
    """Banded NW (global) / SW (local) int32 scores; (P, m) x (P, n) ->
    (P,).

    A CPU tensor runs the plain version (:func:`ref.banded_align`); a CUDA
    tensor launches the kernel or raises (the scratch variant, counted also
    in ``scratch_launches``, where :func:`needs_scratch` holds)."""
    if query.device.type == "cpu":
        return ref.banded_align(query, target, band=band, match=match,
                                mismatch=mismatch, gap=gap, local=local)
    if band < 0:
        raise ValueError(f"banded_align: band must be >= 0, got {band}")
    out, scratch = _wavefront("banded_align", query, target, band=band,
                              match=match, mismatch=mismatch, gap=gap,
                              local=local)
    if out.numel():
        banded_align.launches += 1
        banded_align.scratch_launches += scratch
    return out


banded_align.launches = 0
banded_align.scratch_launches = 0


def levenshtein(query: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Unit-cost edit distance, int32; (P, m) x (P, n) int32 tokens ->
    (P,).

    A CPU tensor runs the plain version (:func:`ref.edit_distance`, the
    row-scan DP); a CUDA tensor launches the wavefront kernel with unit
    costs, global and unbanded, and negates its score, or raises (the
    scratch variant, counted also in ``scratch_launches``, as
    :func:`banded_align`)."""
    if query.device.type == "cpu":
        return ref.edit_distance(query, target)
    band = max(query.shape[1], target.shape[1])
    score, scratch = _wavefront("levenshtein", query, target, band=band,
                                match=0, mismatch=-1, gap=-1, local=False)
    if score.numel():
        levenshtein.launches += 1
        levenshtein.scratch_launches += scratch
    return torch.neg(score)


levenshtein.launches = 0
levenshtein.scratch_launches = 0


def blocks_per_sm(m: int) -> int:
    """Blocks of the wavefront kernel one SM holds at query length ``m``
    (shared memory bounds it: ``(2m + 1) * 32 * 4`` bytes a block); asks
    the card."""
    blocks = ctypes.c_int(0)
    _build.launch("banded_align", "banded_align_blocks_per_sm",
                  [ctypes.c_int, ctypes.POINTER(ctypes.c_int)], m,
                  ctypes.byref(blocks))
    return blocks.value
