"""BWT / FM-index seeding (``repro/core/fm_index.py``).

Index construction is the JAX package's host-side numpy build, copied;
:func:`backward_search` is a batched gather loop on the device, with int32
values and int64 indices.

Alphabet: tokens 1..4 (A,C,G,T); 0 is the sentinel.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def suffix_array(seq: np.ndarray) -> np.ndarray:
    """O(n log^2 n) key-doubling suffix array; seq must end with unique 0."""
    n = len(seq)
    rank = np.asarray(seq, np.int64).copy()
    sa = np.argsort(rank, kind="stable")
    tmp = np.empty(n, np.int64)
    k = 1
    while k < n:
        key2 = np.full(n, -1, np.int64)
        key2[: n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        r_ord, k_ord = rank[order], key2[order]
        bump = np.empty(n, np.int64)
        bump[0] = 0
        bump[1:] = (r_ord[1:] != r_ord[:-1]) | (k_ord[1:] != k_ord[:-1])
        tmp[order] = np.cumsum(bump)
        rank = tmp.copy()
        sa = order
        if rank[sa[-1]] == n - 1:
            break
        k *= 2
    return sa.astype(np.int64)


@dataclasses.dataclass(frozen=True)
class FMIndex:
    """Dense-checkpoint FM-index over a 1..4 token genome."""
    sa: np.ndarray          # (n+1,) suffix array of seq+[0]
    occ: np.ndarray         # (n+2, 4) cumulative occurrences of 1..4 in BWT
    counts: np.ndarray      # (6,) C array: counts[c] = #symbols < c, c in 0..5
    length: int             # genome length (without sentinel)

    @staticmethod
    def build(genome: np.ndarray) -> "FMIndex":
        seq = np.concatenate([np.asarray(genome, np.int64), [0]])
        n = len(seq)
        sa = suffix_array(seq)
        bwt = seq[(sa - 1) % n]
        occ = np.zeros((n + 1, 4), np.int32)
        for c in range(1, 5):
            occ[1:, c - 1] = np.cumsum(bwt == c)
        hist = np.bincount(seq, minlength=5)
        counts = np.zeros(6, np.int64)
        counts[1:] = np.cumsum(hist)[:5]
        return FMIndex(sa=sa, occ=occ, counts=counts, length=len(genome))

    def device_arrays(self, device) -> dict:
        """The index as int32 tensors for :func:`backward_search`."""
        return {
            "occ": torch.from_numpy(self.occ).to(device),
            "counts": torch.from_numpy(self.counts.astype(np.int32)).to(device),
            "sa": torch.from_numpy(self.sa.astype(np.int32)).to(device),
        }


def _jax_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """An index as a JAX gather reads it: negative values count from the
    end, then out-of-range values clamp to the nearest end (a token outside
    1..4, such as the -1 that marks a read's padded tail, walks off the
    index, where torch would raise or, on a card, fault)."""
    return torch.where(idx < 0, idx + size, idx).clamp(0, size - 1)


def backward_search(index_arrays: dict, seeds: torch.Tensor, *,
                    max_hits: int = 8):
    """Batched exact search.  seeds: (P, k) tokens 1..4.

    Returns (count (P,) int32, positions (P, max_hits) int32 with -1
    padding); positions are genome offsets of the first seed base."""
    occ, counts, sa = (index_arrays["occ"], index_arrays["counts"],
                       index_arrays["sa"])
    p, k = seeds.shape
    dev = seeds.device
    rows, cols = occ.shape
    lo = torch.zeros((p,), dtype=torch.int32, device=dev)
    hi = torch.full((p,), rows - 1, dtype=torch.int32, device=dev)
    for i in range(k):
        c = seeds[:, k - 1 - i].long()           # backward: last char first
        cc = counts[_jax_index(c, counts.shape[0])]
        col = _jax_index(c - 1, cols)
        lo = cc + occ[_jax_index(lo.long(), rows), col]
        hi = cc + occ[_jax_index(hi.long(), rows), col]
    count = hi - lo
    offs = torch.arange(max_hits, dtype=torch.int32, device=dev)[None, :]
    idx = torch.clamp(lo[:, None] + offs, max=sa.shape[0] - 1)
    pos = sa[idx.long()]
    pos = torch.where(offs < count[:, None], pos, -1)
    return count, pos


def search_np(index: FMIndex, seed: np.ndarray) -> np.ndarray:
    """Host-side single-seed search (``repro/core/fm_index.py::search_np``):
    the oracle the tests hold :func:`backward_search` to.  Returns the
    sorted genome offsets of every exact occurrence of ``seed``."""
    lo, hi = 0, len(index.sa)
    for ch in seed[::-1]:
        c = int(ch)
        lo = index.counts[c] + index.occ[lo, c - 1]
        hi = index.counts[c] + index.occ[hi, c - 1]
        if lo >= hi:
            return np.zeros(0, np.int64)
    return np.sort(index.sa[lo:hi])
