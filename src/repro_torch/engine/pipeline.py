"""Pathogen-pipeline engine: the heterogeneous streaming path end to end
(``repro/engine/pipeline.py``).

Paper Sec III at system level: raw squiggle chunks -> normalize [CORE] ->
basecall [MAT] -> CTC decode [CORE] -> optional panel compare [ED].
``submit`` normalizes a chunk on the host, copies it to the device (the
one transfer there, from pinned memory, asynchronous on a card) and
launches the whole-chunk CNN; the logits stay on the device.  PyTorch's
launches return before the card finishes, as JAX's dispatch does, so the
host decode of job *k* overlaps the device compute of job *k+1*.  The
in-flight bound (``depth``, the software analogue of a committed
scratchpad budget) is the ``SlotScheduler``'s: past ``depth`` in flight,
``submit`` decodes the oldest job first (double buffering).
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.engine.base import EngineBase, quantize_edge_params
from repro_torch.engine.registry import register


class PathogenPipelineEngine(EngineBase):
    """Depth-bounded streaming basecall pipeline with optional ED-engine
    panel classification of the called reads."""

    workload = "pathogen_pipeline"

    def __init__(self, params, bc_cfg, *, depth: int = 2, panel=None,
                 detect_cfg=None, device="cuda", trace=False):
        # the slot pool IS the in-flight bound: one slot per in-flight job
        super().__init__(slots=depth, tracer=trace)
        self.device = resolve_device(device)
        self.params = params
        self.cfg = bc_cfg
        self.panel = panel
        self.detect_cfg = detect_cfg
        self.outputs: collections.deque = collections.deque()

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(x)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ---------------------------------------------------------- dispatch --
    def submit(self, chunk: np.ndarray, **_) -> None:
        """Dispatch one raw ``(channels, chunk_samples)`` chunk; past
        ``depth`` in flight, decodes the oldest job to make room."""
        from repro_torch.core import basecaller
        from repro_torch.core.pipeline import normalize_chunk
        t0 = time.perf_counter()
        tel = self.telemetry
        tel.count("chunks")
        tel.samples += int(np.asarray(chunk).size)
        with tel.scope():
            with tel.stage("normalize"):
                sig = self._to_device(normalize_chunk(np.asarray(chunk)))
            with tel.stage("basecall"):
                logits = basecaller.apply(self.params, sig, self.cfg)
            tel.dispatches += 1
            self.scheduler.submit(logits)   # the device may still compute
            while not self.scheduler.admit():
                self._drain_one()       # at depth: decode the oldest
        tel.gauge("in_flight", self.scheduler.n_busy)
        tel.wall_s += time.perf_counter() - t0

    def _drain_one(self) -> tuple[np.ndarray, np.ndarray]:
        from repro_torch.core import ctc
        tel = self.telemetry
        logits = self.scheduler.release(self.scheduler.oldest())
        with tel.stage("decode"):
            tokens, lens = ctc.greedy_decode(logits)
            tokens_np, lens_np = tokens.cpu().numpy(), lens.cpu().numpy()
        tel.bases += int(lens_np.sum())
        tel.steps += 1
        tel.completed += len(lens_np)
        self.outputs.append((tokens_np, lens_np))
        return tokens_np, lens_np

    def step(self) -> bool:
        """Drain one in-flight device job; False when the pipe is empty."""
        self.scheduler.admit()
        if self.scheduler.n_busy == 0:
            return False
        t0 = time.perf_counter()
        with self.telemetry.scope():
            self._drain_one()
        self.telemetry.wall_s += time.perf_counter() - t0
        return True

    # ----------------------------------------------------------- results --
    def reads(self, read_len: int) -> np.ndarray:
        """All drained reads as a fixed-width ``(R, read_len)`` array
        (truncated / zero-padded), ready for the ED panel compare."""
        rows = []
        for tokens, lens in self.outputs:
            for i in range(len(tokens)):
                called = tokens[i][: int(lens[i])][:read_len]
                rows.append(np.pad(called, (0, read_len - len(called))))
        if not rows:
            return np.zeros((0, read_len), np.int32)
        return np.stack(rows).astype(np.int32)

    def detect(self, read_len: int, mode: str = "ed"):
        """ED-engine panel comparison of everything basecalled so far."""
        if self.panel is None:
            raise ValueError("no pathogen panel configured for this engine")
        from repro_torch.core import pathogen
        with self.telemetry.scope(), self.telemetry.stage("classify"):
            report = pathogen.detect(
                self.panel, self.reads(read_len),
                self.detect_cfg or pathogen.DetectConfig(), mode=mode,
                device=self.device)
        return report


@register("pathogen_pipeline", presets={
    "default": {"depth": 2},
    "smoke": {"depth": 2},
    "edge_int8": {"depth": 2, "quantize": "int8"},
})
def build_pathogen_pipeline(params=None, cfg=None, *, depth: int,
                            quantize: str | None = None, panel=None,
                            detect_cfg=None, seed: int = 0, device="cuda",
                            trace=False):
    """Make the engine: supply trained (params, cfg), and a
    ``pathogen.Panel`` to enable ``detect``, or get a fresh paper-shaped
    CNN drawn from ``seed``.  ``quantize="int8"`` (the ``edge_int8``
    preset) calibrates at chunk 2048, as JAX's ``pathogen_pipeline`` does,
    and stores the CNN weights int8 once; already-quantized params pass
    through.  ``trace`` enables span tracing (True, or a shared Tracer)."""
    from repro_torch.core import basecaller as bc
    dev = resolve_device(device)
    if cfg is None:
        cfg = bc.BasecallerConfig()
    if params is None:
        params = bc.init(torch.Generator().manual_seed(seed), cfg,
                         device=dev)
    else:
        params = bc.params_to(params, dev)
    if quantize is not None:
        params = quantize_edge_params(params, cfg, scheme=quantize,
                                      chunk=2048, seed=seed)
    return PathogenPipelineEngine(params, cfg, depth=depth, panel=panel,
                                  detect_cfg=detect_cfg, device=dev,
                                  trace=trace)
