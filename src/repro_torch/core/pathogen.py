"""Pathogen detection, the paper's flagship use case (Sec III), on the port
(``repro/core/pathogen.py``).

"Together [MAT + ED + cores] can serve as an engine for rapid pathogen
detection: the basecaller converting raw data to reads with the help of
MAT, and ED quickly comparing it to some sample of a pathogenic genome."

Two comparison engines against a panel of (<= 30 Kbase) genomes:

* ``ed``: tile each genome into windows and Smith-Waterman every read
  against every window on the ``banded_align`` kernel: R x W independent
  DPs, the ED engine's firehose.
* ``fm``: seed-and-extend per genome (``fm_index`` + ``seed_extend``).

:func:`detect` turns per-read classifications into per-pathogen abundance
and a presence call.  The read-by-window pairs are formed on the device;
the per-genome best scores come back in one copy, and the argmax over the
panel runs in numpy, so ties break as in JAX (first maximum).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import fm_index, seed_extend
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass
class Panel:
    names: list[str]
    genomes: list[np.ndarray]          # token arrays 1..4
    indexes: list[fm_index.FMIndex] | None = None

    @staticmethod
    def build(named_genomes: dict[str, np.ndarray],
              with_index: bool = True) -> "Panel":
        names = list(named_genomes)
        genomes = [np.asarray(named_genomes[n], np.int32) for n in names]
        indexes = ([fm_index.FMIndex.build(g) for g in genomes]
                   if with_index else None)
        return Panel(names=names, genomes=genomes, indexes=indexes)


@dataclasses.dataclass(frozen=True)
class DetectConfig:
    window: int = 512          # ED mode: genome tile length
    min_read_frac: float = 0.6  # SW score threshold (fraction of max)
    match: int = 2
    mismatch: int = -4
    gap: int = -2
    min_reads: int = 5          # presence call: min classified reads
    min_abundance: float = 0.02


def _genome_windows(genome: np.ndarray, window: int, overlap: int):
    stride = max(window - overlap, 1)
    n_win = max(1, -(-(len(genome) - overlap) // stride))
    pad = np.zeros(n_win * stride + overlap, np.int32)
    pad[: len(genome)] = genome[: len(pad)]
    idx = np.arange(n_win)[:, None] * stride + np.arange(window)[None, :]
    return pad[np.minimum(idx, len(pad) - 1)]


def read_window_pairs(reads: np.ndarray, genome: np.ndarray,
                      cfg: DetectConfig = DetectConfig(), *, device="cuda"):
    """The ED firehose's operands on ``device``: every read against every
    window of ``genome`` (windows overlap by the read width), as int32
    ``(q (R*W, L), t (R*W, window))``, read-major like JAX's
    ``np.repeat(reads, W)`` / ``np.tile(windows, (R, 1))``."""
    dev = resolve_device(device)
    r, length = reads.shape
    wins = _genome_windows(genome, cfg.window, overlap=length)
    w = wins.shape[0]
    reads_t = torch.from_numpy(np.ascontiguousarray(reads, np.int32)).to(dev)
    q = reads_t.repeat_interleave(w, dim=0)
    t = torch.from_numpy(wins).to(dev).repeat(r, 1)
    return q, t


def score_reads_ed(reads: np.ndarray, genome: np.ndarray,
                   cfg: DetectConfig = DetectConfig(), *, device="cuda"):
    """Best SW score of each read against any window of ``genome``.

    reads: (R, L).  Returns (R,) int32 best scores: R x n_windows local
    DPs in one ``banded_align`` launch, band = window."""
    r = reads.shape[0]
    if r == 0:
        return np.zeros(0, np.int32)
    q, t = read_window_pairs(reads, genome, cfg, device=device)
    scores = ops.banded_align(
        q, t, band=cfg.window, match=cfg.match, mismatch=cfg.mismatch,
        gap=cfg.gap, local=True)
    return scores.view(r, -1).amax(dim=1).cpu().numpy()


@dataclasses.dataclass
class DetectionReport:
    counts: dict[str, int]
    abundance: dict[str, float]
    present: dict[str, bool]
    read_assignment: np.ndarray   # (R,) panel index or -1
    read_scores: np.ndarray       # (R,) best score


def detect(panel: Panel, reads: np.ndarray,
           cfg: DetectConfig = DetectConfig(), *, mode: str = "ed",
           read_lens: np.ndarray | None = None,
           device="cuda") -> DetectionReport:
    """Classify reads against the panel and call presence per pathogen.

    ``read_lens`` (optional, per read) marks each read's true length: the
    padded tail becomes the sentinel token -1, which matches nothing (the
    zero padding of the last genome window would otherwise "match"
    zero-padded reads), and each read's score threshold comes from its true
    length instead of the array width."""
    dev = resolve_device(device)
    r, length = reads.shape
    if read_lens is not None:
        lens_arr = np.asarray(read_lens, np.int64)
        offs = np.arange(length)[None, :]
        reads = np.where(offs < lens_arr[:, None], reads, -1).astype(
            np.asarray(reads).dtype)
    all_scores = np.zeros((len(panel.genomes), r), np.int64)
    for gi, genome in enumerate(panel.genomes):
        if mode == "ed":
            all_scores[gi] = score_reads_ed(reads, genome, cfg, device=dev)
        elif mode == "fm":
            if panel.indexes is None:
                raise ValueError("fm mode needs a panel built with_index")
            res = seed_extend.align_reads(
                panel.indexes[gi], genome, reads,
                seed_extend.AlignConfig(match=cfg.match,
                                        mismatch=cfg.mismatch, gap=cfg.gap,
                                        min_score_frac=cfg.min_read_frac),
                device=dev)
            all_scores[gi] = np.where(res.accepted, res.scores, 0)
        else:
            raise ValueError(mode)

    best = all_scores.argmax(axis=0)
    best_score = all_scores[best, np.arange(r)]
    lens = (np.full(r, length) if read_lens is None
            else np.asarray(read_lens, np.int64))
    threshold = cfg.min_read_frac * cfg.match * lens
    assign = np.where(best_score >= threshold, best, -1)

    counts = {}
    abundance = {}
    present = {}
    for gi, name in enumerate(panel.names):
        c = int((assign == gi).sum())
        counts[name] = c
        abundance[name] = c / max(r, 1)
        present[name] = (c >= cfg.min_reads
                         and abundance[name] >= cfg.min_abundance)
    return DetectionReport(counts=counts, abundance=abundance,
                           present=present, read_assignment=assign,
                           read_scores=best_score)


class IncrementalDetector:
    """Presence calling over a growing read set, one batch at a time.

    A read's panel assignment depends only on its own scores, so counts,
    abundance and presence over N reads decompose into per-batch
    classification plus running totals: :meth:`report` equals
    :func:`detect` over the concatenation of every batch seen, for any
    batch split.  This is the field aggregator's per-uplink path."""

    def __init__(self, panel: Panel, cfg: DetectConfig = DetectConfig(), *,
                 mode: str = "ed", device="cuda"):
        self.panel = panel
        self.cfg = cfg
        self.mode = mode
        self.device = resolve_device(device)
        self.counts: dict[str, int] = {n: 0 for n in panel.names}
        self.total_reads = 0
        self._assign: list[np.ndarray] = []
        self._scores: list[np.ndarray] = []

    def ingest(self, reads: np.ndarray,
               read_lens: np.ndarray | None = None) -> DetectionReport:
        """Classify one (R, L) batch and fold it into the running totals;
        returns the cumulative report."""
        reads = np.atleast_2d(np.asarray(reads))
        if reads.shape[0]:
            rep = detect(self.panel, reads, self.cfg, mode=self.mode,
                         read_lens=read_lens, device=self.device)
            for name in self.panel.names:
                self.counts[name] += rep.counts[name]
            self.total_reads += reads.shape[0]
            self._assign.append(rep.read_assignment)
            self._scores.append(rep.read_scores)
        return self.report()

    def report(self) -> DetectionReport:
        """Cumulative surveillance state: equal to :func:`detect` over every
        read ingested so far."""
        abundance = {}
        present = {}
        for name in self.panel.names:
            c = self.counts[name]
            abundance[name] = c / max(self.total_reads, 1)
            present[name] = (c >= self.cfg.min_reads
                             and abundance[name] >= self.cfg.min_abundance)
        cat = (np.concatenate(self._assign) if self._assign
               else np.zeros(0, np.int64))
        sc = (np.concatenate(self._scores) if self._scores
              else np.zeros(0, np.int64))
        return DetectionReport(counts=dict(self.counts), abundance=abundance,
                               present=present, read_assignment=cat,
                               read_scores=sc)
