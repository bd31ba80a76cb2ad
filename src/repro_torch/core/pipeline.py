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
``StreamingBasecallPipeline`` remains, as in JAX, a deprecation shim over
the engine.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Iterable, Iterator

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


@dataclasses.dataclass
class PipelineStats:
    """Deprecated stats shape, populated from the unified ``Telemetry``."""
    chunks: int = 0
    device_dispatches: int = 0
    bases_called: int = 0
    samples_in: int = 0
    wall_s: float = 0.0

    def bases_per_s(self) -> float:
        return self.bases_called / max(self.wall_s, 1e-9)


class StreamingBasecallPipeline:
    """Deprecated: ``repro_torch.engine.build("pathogen_pipeline", ...)``.

    The old generator API (``run`` yields ``(tokens, lens)`` per chunk, the
    host decode of job k overlapping the device compute of job k+1) over
    the unified engine.  JAX's boolean ``use_kernel`` picked the Pallas
    kernels or the jnp reference; here ``device`` picks them, as for every
    entry point of the port: the card (the default) runs the conv1d and
    matmul kernels, the CPU their plain versions.  ``use_kernel=True``
    insists on the card; there is no reference fallback on it."""

    def __init__(self, params, cfg=None,
                 pipe_cfg: PipelineConfig = PipelineConfig(), *,
                 use_kernel: bool = False, device="cuda"):
        if use_kernel and torch.device(device).type != "cuda":
            raise ValueError(f"use_kernel=True runs the kernels on the "
                             f"card, not on device={device!r}")
        warnings.warn(
            "StreamingBasecallPipeline is deprecated; use "
            'repro_torch.engine.build("pathogen_pipeline") instead',
            DeprecationWarning, stacklevel=2)
        import repro_torch.engine as engine_api
        from repro_torch.core import basecaller as bc
        cfg = cfg if cfg is not None else bc.BasecallerConfig()
        self.pipe_cfg = pipe_cfg
        self._eng = engine_api.build("pathogen_pipeline", params=params,
                                     cfg=cfg, depth=pipe_cfg.depth,
                                     device=device)

    @property
    def stats(self) -> PipelineStats:
        tel = self._eng.telemetry
        return PipelineStats(
            chunks=tel.counters.get("chunks", 0),
            device_dispatches=tel.dispatches, bases_called=tel.bases,
            samples_in=tel.samples, wall_s=tel.wall_s)

    def run(self, chunks: Iterable[np.ndarray],
            on_read: Callable[[np.ndarray, np.ndarray], None] | None = None
            ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """chunks: iterator of (channels, chunk_samples) raw signal arrays.

        Yields (tokens (B, T'), lens (B,)) per chunk."""
        eng = self._eng
        for chunk in chunks:
            eng.submit(chunk)
            while eng.outputs:
                yield self._emit(on_read)
        while eng.step():
            yield self._emit(on_read)

    def _emit(self, on_read):
        tokens_np, lens_np = self._eng.outputs.popleft()
        if on_read is not None:
            on_read(tokens_np, lens_np)
        return tokens_np, lens_np
