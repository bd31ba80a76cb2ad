"""Nanopore squiggle simulator — the raw-data source the SoC ingests.

Models the measurement chain of a nanopore channel (paper Fig. 2/3, and the
CMOS readout of ref. [12]):

  DNA k-mer in pore -> characteristic ionic current level (pore model)
  -> dwell time per base (geometric, motor-protein stochasticity)
  -> additive Gaussian noise + slow baseline drift
  -> digitization; per-read median/MAD normalization (a CORE-side job in the
     SoC, a cheap vectorized op here).

The pore model is a deterministic pseudo-random map from k-mer to current
level, which preserves the statistics that matter for basecalling (distinct
levels per context, neighbor-dependence over K bases) without shipping a
real pore table.  K=5 contexts over ~9 samples/base means the basecaller's
71-sample receptive field spans ~8 bases — matching the paper's "window of
8 bases" design point.

Data rate sanity (paper Sec II-B.1): at 4 kHz x 16-bit per channel one
sensor yields 64 kb/s; 512 channels ~ 33 Mb/s — the ">100x audio (256 kb/s)"
claim reproduced in benchmarks/bench_pipeline.py.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PoreModel:
    k: int = 5                      # context length (k-mer)
    mean_dwell: float = 9.0         # samples per base
    min_dwell: int = 4
    noise: float = 0.08             # relative to level spread
    drift: float = 0.01             # slow baseline wander
    sample_rate_hz: float = 4000.0
    adc_bits: int = 16
    seed: int = 1234                # pore-table seed (fixed physics)

    def levels(self) -> np.ndarray:
        """(4**k,) current level per k-mer, zero-mean unit-spread."""
        rng = np.random.default_rng(self.seed)
        lv = rng.normal(0.0, 1.0, size=4 ** self.k)
        return (lv - lv.mean()) / lv.std()


def _kmer_index(seq: np.ndarray, k: int) -> np.ndarray:
    """Sliding k-mer index (centered); seq uses 1..4 tokens."""
    s = seq - 1
    pad = k // 2
    sp = np.concatenate([s[:pad], s, s[-pad:]]) if pad else s
    idx = np.zeros(len(seq), np.int64)
    for i in range(k):
        idx = idx * 4 + sp[i: i + len(seq)]
    return idx


def simulate_read(rng: np.random.Generator, seq: np.ndarray,
                  pm: PoreModel = PoreModel()):
    """seq (L,) 1..4 -> (signal (T,) f32, frame_to_base (T,) int32)."""
    levels = pm.levels()
    lv = levels[_kmer_index(seq, pm.k)]
    dwell = pm.min_dwell + rng.geometric(
        1.0 / max(pm.mean_dwell - pm.min_dwell, 1e-6), size=len(seq))
    sig = np.repeat(lv, dwell).astype(np.float32)
    frame_to_base = np.repeat(np.arange(len(seq), dtype=np.int32), dwell)
    t = len(sig)
    noise = rng.normal(0.0, pm.noise, size=t).astype(np.float32)
    drift = np.cumsum(rng.normal(0.0, pm.drift / np.sqrt(pm.mean_dwell),
                                 size=t)).astype(np.float32)
    drift -= np.linspace(0, drift[-1], t, dtype=np.float32)
    return sig + noise + drift, frame_to_base


def normalize(signal: np.ndarray) -> np.ndarray:
    """Median/MAD normalization (the SoC's CORE-side conditioning step)."""
    med = np.median(signal)
    mad = np.median(np.abs(signal - med)) + 1e-6
    return ((signal - med) / (1.4826 * mad)).astype(np.float32)


def make_ctc_batch(rng: np.random.Generator, *, batch: int, seq_len: int,
                   pm: PoreModel = PoreModel(), genome: np.ndarray | None = None):
    """Training batch for the basecaller.

    Returns dict of numpy arrays:
      signal (B, T) f32, signal_paddings (B, T), labels (B, L) int32,
      label_paddings (B, L).  T is sized for worst-case dwell and padded.
    """
    t_max = int(seq_len * (pm.mean_dwell + 3 * pm.mean_dwell ** 0.5)) + 8
    signals = np.zeros((batch, t_max), np.float32)
    spad = np.ones((batch, t_max), np.float32)
    labels = np.zeros((batch, seq_len), np.int32)
    lpad = np.zeros((batch, seq_len), np.float32)
    for i in range(batch):
        if genome is None:
            seq = rng.integers(1, 5, size=seq_len).astype(np.int32)
        else:
            start = rng.integers(0, len(genome) - seq_len)
            seq = genome[start: start + seq_len]
        sig, _ = simulate_read(rng, seq, pm)
        sig = normalize(sig)[:t_max]
        signals[i, : len(sig)] = sig
        spad[i, : len(sig)] = 0.0
        labels[i] = seq
    return {
        "signal": signals,
        "signal_paddings": spad,
        "labels": labels,
        "label_paddings": lpad,
    }


def raw_bitrate_bps(pm: PoreModel = PoreModel(), channels: int = 512) -> float:
    """Raw sensor-array data rate (paper: ~30 Mb/s for a hand-sized device)."""
    return pm.sample_rate_hz * pm.adc_bits * channels
