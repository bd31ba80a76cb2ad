"""Map called read prefixes against an enrichment target panel
(``repro/realtime/mapper.py``): FM-index seeds, diagonal voting and banded
extension on the ``banded_align`` kernel, over fixed-shape batches of the
short, noisy prefixes the streaming basecaller emits.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import fm_index, seed_extend
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TargetPanel:
    """Reference genome plus the intervals to enrich for."""
    reference: np.ndarray       # (N,) 1..4 tokens
    target_mask: np.ndarray     # (N,) bool, True inside enrichment targets
    intervals: tuple            # ((start, end), ...) half-open

    @staticmethod
    def build(reference: np.ndarray, intervals) -> "TargetPanel":
        reference = np.asarray(reference, np.int32)
        mask = np.zeros(len(reference), bool)
        clean = []
        for start, end in intervals:
            start, end = max(int(start), 0), min(int(end), len(reference))
            mask[start:end] = True
            clean.append((start, end))
        return TargetPanel(reference=reference, target_mask=mask,
                           intervals=tuple(clean))

    @property
    def target_frac(self) -> float:
        return float(self.target_mask.mean())


@dataclasses.dataclass
class MapResult:
    mapped: np.ndarray      # (R,) bool — confident alignment found
    on_target: np.ndarray   # (R,) bool — alignment lands in a target
    positions: np.ndarray   # (R,) int  — best reference start (-1 unmapped)
    mapq: np.ndarray        # (R,) float — score gap to runner-up (0..60)
    scores: np.ndarray      # (R,) int  — banded-SW score of the best hit


# Prefixes are short (~50 bases) and noisy: denser/shorter seeds than the
# offline aligner, a generous band for CTC indels, and a lower score floor.
PREFIX_ALIGN_CFG = seed_extend.AlignConfig(
    seed_len=10, seed_stride=6, max_hits_per_seed=8, max_candidates=4,
    band=16, min_score_frac=0.35)


class PrefixMapper:
    """Fixed-shape batched prefix->panel mapping for the decision loop.
    The FM-index lives on ``device`` for the mapper's lifetime."""

    def __init__(self, panel: TargetPanel,
                 align_cfg: seed_extend.AlignConfig = PREFIX_ALIGN_CFG, *,
                 device="cuda"):
        self.panel = panel
        self.cfg = align_cfg
        self.device = resolve_device(device)
        self.index = fm_index.FMIndex.build(panel.reference)
        self._arrays = self.index.device_arrays(self.device)

    def map_prefixes(self, prefixes: np.ndarray) -> MapResult:
        """prefixes: (R, L) called bases (1..4; 0-padded rows are ignored
        by the caller)."""
        res = seed_extend.align_reads(self.index, self.panel.reference,
                                      np.asarray(prefixes, np.int32),
                                      self.cfg, device=self.device,
                                      index_arrays=self._arrays)
        pos = np.clip(res.positions, 0, len(self.panel.reference) - 1)
        on_target = np.where(res.accepted, self.panel.target_mask[pos], False)
        return MapResult(mapped=res.accepted, on_target=on_target,
                         positions=res.positions, mapq=res.mapq,
                         scores=res.scores)
