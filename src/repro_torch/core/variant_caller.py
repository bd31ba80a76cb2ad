"""Lightweight pileup-based variant caller (paper Sec II-B.3), the
inference half of ``repro/core/variant_caller.py``.

Aligned reads are summarized into a per-position pileup tensor (host
numpy, copied from the JAX package), and a small CNN over a window around
each candidate site emits genotype and alternate-base logits.  The conv
layers run through ``kernels.ops.conv1d`` ("same", ReLU): the fp32
``conv1d`` kernel on the card, its plain version on the CPU.  The dense
layer and the two heads are plain float32 products (``torch.matmul`` with
TF32 off), as the JAX package leaves them to XLA outside any Pallas kernel.

Pileup features per reference position (C=9):
  0..3  base counts A,C,G,T (depth-normalized)
  4     coverage (log1p, scaled)
  5..8  reference base one-hot
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.basecaller import load_numpy_params  # noqa: F401
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref

N_FEATURES = 9
N_GENOTYPES = 3  # hom-ref, het, hom-alt


@dataclasses.dataclass(frozen=True)
class CallerConfig:
    window: int = 33
    channels: tuple[int, ...] = (48, 96)
    kernel: int = 5
    hidden: int = 128
    dtype: torch.dtype = torch.float32


def base_counts(genome_len: int, reads: np.ndarray, positions: np.ndarray,
                lengths: np.ndarray | None = None) -> np.ndarray:
    """(G, 4) per-position base counts from aligned reads, one flattened
    ``np.add.at`` scatter over every (read, offset) pair.  ``positions <
    0`` marks unaligned reads (skipped); ``lengths`` (optional, per read)
    masks padding columns of ragged batches."""
    counts = np.zeros((genome_len, 4), np.float32)
    reads = np.asarray(reads)
    if reads.size == 0:
        return counts
    pos = np.asarray(positions, np.int64)
    valid = pos >= 0
    if not valid.any():
        return counts
    offs = np.arange(reads.shape[1], dtype=np.int64)[None, :]
    gi = pos[valid][:, None] + offs                    # (R', L) genome index
    keep = gi < genome_len
    if lengths is not None:
        keep &= offs < np.asarray(lengths, np.int64)[valid][:, None]
    # column index mirrors the oracle's ``reads - 1`` fancy index, where a
    # stray 0 token wraps to column 3 the way numpy's -1 does
    col = (np.asarray(reads[valid], np.int64) - 1) % 4
    np.add.at(counts.reshape(-1), gi[keep] * 4 + col[keep], 1.0)
    return counts


def counts_to_features(genome: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """(G, 4) base counts -> the (G, 9) pileup feature tensor."""
    g = len(genome)
    cov = counts.sum(axis=1)
    feat = np.zeros((g, N_FEATURES), np.float32)
    feat[:, :4] = counts / np.maximum(cov, 1.0)[:, None]
    feat[:, 4] = np.log1p(cov) / 5.0
    feat[np.arange(g), 4 + genome_clip(genome)] = 1.0
    return feat


def build_pileup(genome: np.ndarray, reads: np.ndarray,
                 positions: np.ndarray) -> np.ndarray:
    """(G, 9) pileup tensor from aligned reads (host-side aggregation)."""
    return counts_to_features(
        genome, base_counts(len(genome), reads, positions))


def build_pileup_loop(genome: np.ndarray, reads: np.ndarray,
                      positions: np.ndarray) -> np.ndarray:
    """Reference O(reads) loop: the oracle :func:`build_pileup` is held
    against."""
    g = len(genome)
    counts = np.zeros((g, 4), np.float32)
    r, length = reads.shape
    for i in range(r):
        p = int(positions[i])
        if p < 0:
            continue
        end = min(p + length, g)
        span = end - p
        idx = np.arange(p, end)
        np.add.at(counts, (idx, reads[i, :span] - 1), 1.0)
    return counts_to_features(genome, counts)


class PileupState:
    """Incremental pileup over a growing read set: the running (G, 4)
    counts, each batch folded in with one scatter, so :meth:`features`
    equals :func:`build_pileup` over the concatenated reads for any batch
    split or arrival order."""

    def __init__(self, genome: np.ndarray):
        self.genome = np.asarray(genome)
        self.counts = np.zeros((len(self.genome), 4), np.float32)
        self.n_reads = 0

    def ingest(self, reads, positions) -> "PileupState":
        """Fold a batch in.  ``reads`` is an (R, L) array or a list of
        variable-length 1-D base arrays (padded internally)."""
        if isinstance(reads, (list, tuple)):
            lengths = np.array([len(r) for r in reads], np.int64)
            width = int(lengths.max()) if len(reads) else 0
            padded = np.zeros((len(reads), width), np.int64)
            for i, r in enumerate(reads):
                padded[i, :len(r)] = np.asarray(r, np.int64)
            reads = padded
        else:
            reads = np.atleast_2d(np.asarray(reads))
            lengths = None
        self.counts += base_counts(len(self.genome), reads,
                                   np.atleast_1d(positions), lengths)
        self.n_reads += len(reads)
        return self

    def features(self) -> np.ndarray:
        """Render the (G, 9) pileup tensor for the reads ingested so far."""
        return counts_to_features(self.genome, self.counts)


def genome_clip(genome: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(genome, np.int64), 1, 4)


def extract_windows(pileup: np.ndarray, sites: np.ndarray,
                    window: int) -> np.ndarray:
    """(S, window, 9) windows centered at candidate sites."""
    half = window // 2
    pad = np.pad(pileup, ((half, half), (0, 0)))
    idx = sites[:, None] + np.arange(window)[None, :]
    return pad[idx]


def candidate_sites(pileup: np.ndarray, *, min_alt_frac: float = 0.2,
                    min_cov: float = 4.0) -> np.ndarray:
    """Positions whose non-reference allele fraction exceeds the threshold."""
    ref_onehot = pileup[:, 5:9]
    alt_frac = (pileup[:, :4] * (1.0 - ref_onehot)).sum(axis=1)
    cov = np.expm1(pileup[:, 4] * 5.0)
    return np.nonzero((alt_frac >= min_alt_frac) & (cov >= min_cov))[0]


def init(generator: torch.Generator, cfg: CallerConfig = CallerConfig(), *,
         device="cuda"):
    """He-initialised parameters ``{"conv1", "conv2", "dense", "head_gt",
    "head_alt"}`` drawn from ``generator`` (a CPU ``torch.Generator``),
    then moved to ``device``; the JAX layout, so JAX params carry across
    with :func:`load_numpy_params`."""
    dev = resolve_device(device)

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=cfg.dtype)

    params = {}
    cin = N_FEATURES
    for i, cout in enumerate(cfg.channels):
        params[f"conv{i + 1}"] = {
            "w": normal(cfg.kernel, cin, cout)
            * math.sqrt(2.0 / (cfg.kernel * cin)),
            "b": torch.zeros((cout,), dtype=cfg.dtype)}
        cin = cout
    # flatten conv features over the window: the variant evidence lives in
    # the center columns; pooling would dilute it (Clair keeps position)
    flat = cin * cfg.window
    params["dense"] = {"w": normal(flat, cfg.hidden) * math.sqrt(2.0 / flat),
                       "b": torch.zeros((cfg.hidden,), dtype=cfg.dtype)}
    for name, n_out in (("head_gt", N_GENOTYPES), ("head_alt", 4)):
        params[name] = {
            "w": normal(cfg.hidden, n_out) * math.sqrt(1.0 / cfg.hidden),
            "b": torch.zeros((n_out,), dtype=cfg.dtype)}
    return {k: {kk: vv.to(dev) for kk, vv in v.items()}
            for k, v in params.items()}


def apply(params, windows: torch.Tensor, cfg: CallerConfig = CallerConfig()):
    """windows: (S, W, 9) -> (genotype logits (S, 3), alt-base logits
    (S, 4)), on the windows' device."""
    ref.full_fp32()
    x = windows.to(cfg.dtype)
    for i in range(len(cfg.channels)):
        p = params[f"conv{i + 1}"]
        x = ops.conv1d(x, p["w"], p["b"], padding="same", activation="relu")
    x = x.reshape(x.shape[0], -1)  # keep positions: flatten (W, C)
    h = F.relu(x @ params["dense"]["w"] + params["dense"]["b"])
    gt = h @ params["head_gt"]["w"] + params["head_gt"]["b"]
    alt = h @ params["head_alt"]["w"] + params["head_alt"]["b"]
    return gt, alt


def loss_fn(params, windows, gt_labels, alt_labels,
            cfg: CallerConfig = CallerConfig()) -> torch.Tensor:
    """Genotype cross-entropy plus the alt-base cross-entropy on the sites
    that are not hom-ref (``repro/core/variant_caller.py::loss_fn``)."""
    gt, alt = apply(params, windows, cfg)
    gt_labels = torch.as_tensor(gt_labels, device=gt.device).long()
    alt_labels = torch.as_tensor(alt_labels, device=gt.device).long()
    gt_l = -torch.log_softmax(gt, dim=-1).gather(1, gt_labels[:, None]).mean()
    mask = (gt_labels > 0).float()
    alt_ll = torch.log_softmax(alt, dim=-1).gather(1, alt_labels[:, None])[:, 0]
    alt_l = -(alt_ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return gt_l + alt_l
