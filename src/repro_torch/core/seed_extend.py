"""Seed-and-extend alignment (``repro/core/seed_extend.py``): FM-index seeds
vetted by banded dynamic-programming extension.

Per read batch: k-mer seeds at fixed offsets, batched FM-index backward
search on the device, diagonal voting on the host (numpy, copied from the
JAX package), then banded Smith-Waterman extension of each read against its
candidate windows on the ``banded_align`` kernel.  The window gather, the
-10**9 score of absent candidates and the voting are copied exactly, so
results equal the JAX package's bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import fm_index
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    seed_len: int = 12
    seed_stride: int = 8
    max_hits_per_seed: int = 8
    max_candidates: int = 4
    band: int = 24
    match: int = 2
    mismatch: int = -4
    gap: int = -2
    min_score_frac: float = 0.5  # accept if score > frac * max_possible


@dataclasses.dataclass
class AlignmentResult:
    positions: np.ndarray   # (R,) best ref start, -1 if unaligned
    scores: np.ndarray      # (R,) banded SW score
    mapq: np.ndarray        # (R,) score gap to runner-up (proxy)
    accepted: np.ndarray    # (R,) bool


def _extract_seeds(reads: torch.Tensor, cfg: AlignConfig):
    """(R, L) -> (R, S, k) seeds + (S,) offsets."""
    _, length = reads.shape
    offsets = np.arange(0, length - cfg.seed_len + 1, cfg.seed_stride)
    seeds = torch.stack([reads[:, int(o): int(o) + cfg.seed_len]
                         for o in offsets], dim=1)
    return seeds, offsets


def _vote_candidates(hits: np.ndarray, offsets: np.ndarray, genome_len: int,
                     cfg: AlignConfig):
    """hits: (R, S, H) genome positions (-1 invalid) -> (R, C) candidate
    starts by diagonal voting (host-side numpy; small and irregular)."""
    r, s, h = hits.shape
    starts = hits - offsets[None, :, None]
    starts = np.where(hits >= 0, starts, -(10 ** 9))
    bucket = cfg.band  # diagonal tolerance
    cands = np.full((r, cfg.max_candidates), -1, np.int64)
    for i in range(r):
        vals = starts[i][starts[i] > -(10 ** 8)]
        if len(vals) == 0:
            continue
        keys, votes = np.unique(vals // bucket, return_counts=True)
        order = np.argsort(-votes)
        top = keys[order[: cfg.max_candidates]]
        for j, b in enumerate(top):
            member = vals[vals // bucket == b]
            pos = int(np.median(member))
            cands[i, j] = min(max(pos, 0), max(genome_len - 1, 0))
    return cands


def align_reads(index: fm_index.FMIndex, genome: np.ndarray,
                reads: np.ndarray, cfg: AlignConfig = AlignConfig(), *,
                device, index_arrays=None) -> AlignmentResult:
    """Align a batch of reads (R, L) of 1..4 tokens against ``genome``.

    ``index_arrays`` (from ``index.device_arrays(device)``) saves moving
    the index to the device on every call."""
    reads = np.asarray(reads, np.int32)
    r, length = reads.shape
    arrays = index_arrays or index.device_arrays(device)
    reads_t = torch.from_numpy(reads).to(device)
    seeds, offsets = _extract_seeds(reads_t, cfg)
    s = seeds.shape[1]
    _, pos = fm_index.backward_search(
        arrays, seeds.reshape(r * s, cfg.seed_len),
        max_hits=cfg.max_hits_per_seed)
    hits = pos.cpu().numpy().reshape(r, s, cfg.max_hits_per_seed)
    cands = _vote_candidates(hits, offsets, index.length, cfg)

    # window extraction (host gather; windows are read-length + band slack)
    wlen = length + 2 * cfg.band
    gpad = np.concatenate([
        np.zeros(cfg.band, np.int32), np.asarray(genome, np.int32),
        np.zeros(wlen, np.int32)])  # zeros mismatch every base
    win_idx = np.clip(cands, 0, None)[..., None] + np.arange(wlen)[None, None, :]
    windows = gpad[win_idx]  # (R, C, wlen); cand -1 -> window of leading pad

    # banded extension: query = read vs each candidate window
    q = torch.from_numpy(np.repeat(reads, cfg.max_candidates, axis=0)).to(device)
    t = torch.from_numpy(np.ascontiguousarray(
        windows.reshape(r * cfg.max_candidates, wlen))).to(device)
    scores = ops.banded_align(
        q, t, band=2 * cfg.band, match=cfg.match, mismatch=cfg.mismatch,
        gap=cfg.gap, local=True)
    scores = scores.cpu().numpy().reshape(r, cfg.max_candidates)
    scores = np.where(cands >= 0, scores, -(10 ** 9))

    best = np.argmax(scores, axis=1)
    best_score = scores[np.arange(r), best]
    sorted_sc = np.sort(scores, axis=1)
    gap2 = best_score - (sorted_sc[:, -2] if cfg.max_candidates > 1
                         else np.zeros(r))
    positions = cands[np.arange(r), best]
    max_possible = cfg.match * length
    accepted = (best_score > cfg.min_score_frac * max_possible)
    positions = np.where(accepted, positions, -1)
    return AlignmentResult(
        positions=positions,
        scores=best_score,
        mapq=np.clip(gap2, 0, 60),
        accepted=accepted,
    )
