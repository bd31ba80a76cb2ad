"""The CORE-side helpers of the heterogeneous streaming pipeline
(``repro/core/pipeline.py``): chunk normalization, barcode demux on the ED
engine, primer trimming.

Paper Sec III: CORE1/CORE2 run "small intermediate support processes"
(demultiplexing, primer trimming, chunking, filtering, normalization) in
parallel with the accelerator jobs.  The streaming pipeline itself is
``repro_torch.engine.build("pathogen_pipeline", ...)``.  Normalization and
trimming are host numpy, as in JAX; :func:`demux_reads` compares every read
with every barcode on the ``levenshtein`` kernel and picks the best barcode
on the host, so ties break as ``numpy.argmin`` breaks them (first minimum).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    chunk_samples: int = 2048      # raw samples per device dispatch row
    batch_channels: int = 32       # sensor channels batched per dispatch
    depth: int = 2                 # in-flight device jobs (double buffering)
    barcode_len: int = 12
    barcode_max_dist: int = 3


def normalize_chunk(x: np.ndarray) -> np.ndarray:
    """Median/MAD per channel (CORE-side conditioning)."""
    med = np.median(x, axis=-1, keepdims=True)
    mad = np.median(np.abs(x - med), axis=-1, keepdims=True) + 1e-6
    return ((x - med) / (1.4826 * mad)).astype(np.float32)


def demux_reads(reads: np.ndarray, barcodes: np.ndarray, *,
                max_dist: int = 3, device="cuda") -> np.ndarray:
    """Assign reads to samples by barcode edit distance (paper: "a low-cost
    un-gapped string comparison"; the ED kernel subsumes it).

    reads: (R, L) with the barcode at the 5' end; barcodes: (S, Lb).
    Returns (R,) sample index or -1.  The R x S pairs are formed on
    ``device`` and run there (the kernel on a card, the plain DP on the
    CPU); one (R, S) copy comes back for the host-side argmin."""
    dev = resolve_device(device)
    r = reads.shape[0]
    s, lb = barcodes.shape
    prefix = torch.from_numpy(
        np.ascontiguousarray(reads[:, :lb], dtype=np.int32)).to(dev)
    bars = torch.from_numpy(
        np.ascontiguousarray(barcodes, dtype=np.int32)).to(dev)
    q = prefix.repeat_interleave(s, dim=0)      # np.repeat(prefix, s, 0)
    t = bars.repeat(r, 1)                        # np.tile(barcodes, (r, 1))
    d = ops.edit_distance(q, t).cpu().numpy().reshape(r, s)
    best = d.argmin(axis=1)
    return np.where(d[np.arange(r), best] <= max_dist, best, -1)


def trim_primer(tokens: np.ndarray, lens: np.ndarray, primer_len: int):
    """Drop the first ``primer_len`` bases (CORE-side editing): every row
    reads ``tokens[i, j + primer_len]`` into column ``j``, masked to the
    trimmed length."""
    lens = np.asarray(lens)
    new_lens = np.maximum(lens - primer_len, 0)
    width = tokens.shape[1]
    src = np.minimum(np.arange(width) + primer_len, width - 1)
    mask = np.arange(width)[None, :] < new_lens[:, None]
    out = np.where(mask, tokens[:, src], 0).astype(tokens.dtype)
    return out, new_lens
