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
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import fabric
from repro_torch.kernels import ref

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]

LANES = 32       # lanes of a warp: the widest group a pair takes
ROWS_MAX = 8     # query rows a lane keeps in registers (csrc BA_RMAX)
ROWS_TARGET = 4  # rows a lane aims for where the query fits one stripe
WARPS = 2        # warps a block (csrc BA_WARPS)


class Plan(NamedTuple):
    """How the wavefront kernel lays one launch out (``csrc/banded_align.cu``):
    ``groups`` lanes a pair (G, a power of two), ``rows`` query rows a lane
    (R), ``stripes`` of G * R rows run one after another, and where a
    stripe hands its last row to the next: ``"none"`` (one stripe),
    ``"shared"`` (a block's buffers fit its shared memory) or
    ``"scratch"`` (device memory the wrapper allocates)."""
    groups: int
    rows: int
    stripes: int
    handoff: str


def plan(m: int, n: int) -> Plan:
    """The lane layout for queries of length ``m`` against targets of
    length ``n``.  A query of at most 32 * 8 = 256 rows takes one stripe:
    the fewest lanes (a power of two) that give each at most four rows,
    then the rows that covers (the demux's 12: 4 x 3; the mapper's 48: 16
    x 3; the firehose's 256: 32 x 8).  A longer one runs stripes of 32
    lanes x 8 rows, handing n ints a pair from stripe to stripe."""
    if m <= LANES * ROWS_MAX:
        g = 1
        while g < LANES and g * ROWS_TARGET < m:
            g *= 2
        return Plan(g, max(1, -(-m // g)), 1, "none")
    shared = WARPS * n * 4 <= _build.SMEM_LIMIT  # a pair a warp
    return Plan(LANES, ROWS_MAX, -(-m // (LANES * ROWS_MAX)),
                "shared" if shared else "scratch")


def _wavefront(what: str, query, target, *, band, match, mismatch, gap,
               local) -> tuple[torch.Tensor, Plan]:
    """Check the operands and launch the wavefront kernel once, laid out
    by :func:`plan`.  Returns the scores and the plan."""
    p, m = query.shape
    p2, n = target.shape
    if p != p2:
        raise ValueError(f"{what}: {p} queries vs {p2} targets")
    _build.check_tensor(f"{what} query", query, torch.int32)
    _build.check_tensor(f"{what} target", target, torch.int32,
                        device=query.device)
    out = torch.empty((p,), dtype=torch.int32, device=query.device)
    lay = plan(m, n)
    scratch = None
    if lay.handoff == "scratch":
        scratch = torch.empty((p * n,), dtype=torch.int32,
                              device=query.device)
    if p:
        _build.launch(
            "banded_align", "launch_banded_align", _ARGS, query.data_ptr(),
            target.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), p, m, n, band,
            match, mismatch, gap, int(local), lay.groups, lay.rows,
            _build.stream_handle(query.device))
    return out, lay


def _count(fn, lay: Plan) -> None:
    fn.launches += 1
    fn.stripe_launches += lay.stripes > 1
    fn.scratch_launches += lay.handoff == "scratch"


def banded_align(query: torch.Tensor, target: torch.Tensor, *, band: int,
                 match: int = 2, mismatch: int = -4, gap: int = -2,
                 local: bool = False) -> torch.Tensor:
    """Banded NW (global) / SW (local) int32 scores; (P, m) x (P, n) ->
    (P,).

    A CPU tensor runs the plain version (:func:`ref.banded_align`); a CUDA
    tensor launches the kernel or raises.  ``stripe_launches`` counts the
    launches whose queries ran in more than one stripe, ``scratch_launches``
    those that handed stripes through device scratch (:func:`plan`)."""
    if query.device.type == "cpu":
        return ref.banded_align(query, target, band=band, match=match,
                                mismatch=mismatch, gap=gap, local=local)
    _build.refuse_grad("banded_align", query, target)
    if query.device.type == "meta":
        return fabric.meta_kernel("banded_align", lambda q, t: (
            ref.banded_align(q, t, band=band, match=match, mismatch=mismatch,
                             gap=gap, local=local)), query, target)
    if band < 0:
        raise ValueError(f"banded_align: band must be >= 0, got {band}")
    out, lay = _wavefront("banded_align", query, target, band=band,
                          match=match, mismatch=mismatch, gap=gap,
                          local=local)
    if out.numel():
        _count(banded_align, lay)
    return out


banded_align.launches = 0
banded_align.stripe_launches = 0
banded_align.scratch_launches = 0


def levenshtein(query: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Unit-cost edit distance, int32; (P, m) x (P, n) int32 tokens ->
    (P,).

    A CPU tensor runs the plain version (:func:`ref.edit_distance`, the
    row-scan DP); a CUDA tensor launches the wavefront kernel with unit
    costs, global and unbanded, and negates its score, or raises (its
    ``stripe_launches`` and ``scratch_launches`` count as
    :func:`banded_align`'s)."""
    if query.device.type == "cpu":
        return ref.edit_distance(query, target)
    _build.refuse_grad("levenshtein", query, target)
    if query.device.type == "meta":
        return fabric.meta_kernel("levenshtein", ref.edit_distance, query,
                                  target)
    band = max(query.shape[1], target.shape[1])
    score, lay = _wavefront("levenshtein", query, target, band=band,
                            match=0, mismatch=-1, gap=-1, local=False)
    if score.numel():
        _count(levenshtein, lay)
    return torch.neg(score)


levenshtein.launches = 0
levenshtein.stripe_launches = 0
levenshtein.scratch_launches = 0

