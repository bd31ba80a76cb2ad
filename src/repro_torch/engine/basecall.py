"""Basecall engine: batched basecalls of signal chunks
(``repro/engine/basecall.py``).

Raw signal rows queue up; each step basecalls up to ``batch`` of them in one
dispatch of the whole-read CNN ("same" padding), CTC-decodes them and
records one latency observation per dispatch, weighted by the rows it
served.  The ``edge_int8`` preset stores the weights int8 once at build and
runs every layer on the int8 kernels.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.engine.base import EngineBase, quantize_edge_params
from repro_torch.engine.registry import register


class BasecallEngine(EngineBase):
    """Fixed-batch basecall dispatch over a queue of signal rows."""

    workload = "basecall"

    def __init__(self, params, bc_cfg, *, batch: int, chunk: int,
                 device="cuda", trace=False):
        super().__init__(slots=batch, tracer=trace)
        self.device = resolve_device(device)
        self.params = params
        self.cfg = bc_cfg
        self.batch = batch
        self.chunk = chunk
        # undrained decoded reads; serve() consumes the slice it produced
        self.reads: list[np.ndarray] = []

    def submit(self, signal_rows, **_) -> None:
        """Enqueue one or more ``(chunk,)`` signal rows."""
        rows = np.asarray(signal_rows, np.float32)
        if rows.ndim == 1:
            rows = rows[None]
        for row in rows:
            self.scheduler.submit(row)

    def step(self) -> bool:
        """Dispatch one batch (up to ``self.batch`` queued rows)."""
        from repro_torch.core import basecaller, ctc
        admitted = self.scheduler.admit()
        if not admitted:
            return False
        tel = self.telemetry
        t_wall = time.perf_counter()
        chunk_rows = np.stack([row for _, row in admitted])
        t0 = time.perf_counter()
        with tel.scope():
            with tel.stage("basecall"):
                signal = torch.from_numpy(chunk_rows).to(self.device)
                logits = basecaller.apply(self.params, signal, self.cfg)
            with tel.stage("decode"):
                tokens, lens = ctc.greedy_decode(logits)
                tokens, lens = tokens.cpu().numpy(), lens.cpu().numpy()
        dt = (time.perf_counter() - t0) * 1e3
        tel.observe_latency(dt, weight=len(chunk_rows))
        tel.dispatches += 1
        tel.steps += 1
        for j, (slot, _) in enumerate(admitted):
            ln = int(lens[j])
            self.reads.append(tokens[j, :ln].copy())
            tel.bases += ln
            tel.completed += 1
            self.scheduler.release(slot)
        tel.samples += int(chunk_rows.size)
        tel.wall_s += time.perf_counter() - t_wall
        tel.gauge("queue_depth", self.scheduler.pending)
        return True

    def serve(self, signal_chunks) -> list[np.ndarray]:
        """Submit ``(N, chunk)`` rows, drain, and return the reads this call
        produced (decoded token arrays, in submit order)."""
        mark = len(self.reads)
        self.submit(signal_chunks)
        self.drain()
        out = self.reads[mark:]
        del self.reads[mark:]
        return out


@register("basecall", presets={
    "default": {"batch": 16, "chunk": 2048},
    "smoke": {"batch": 4, "chunk": 512},
    # the paper's edge configuration: weights stored int8 once at build,
    # every dispatch on the fixed-point MAC path (calibrated activations)
    "edge_int8": {"batch": 16, "chunk": 2048, "quantize": "int8"},
})
def build_basecall(params=None, cfg=None, *, batch: int, chunk: int,
                   quantize: str | None = None, device="cuda",
                   seed: int = 0, trace=False):
    """Builder: supply (params, cfg) or get a fresh paper-shaped CNN drawn
    from ``seed``.  ``quantize="int8"`` (the ``edge_int8`` preset)
    calibrates and quantizes the weights once; already-quantized params
    pass through.  ``trace`` enables span tracing (True, or a shared
    Tracer)."""
    from repro_torch.core import basecaller as bc
    dev = resolve_device(device)
    if cfg is None:
        cfg = bc.BasecallerConfig()
    if params is None:
        params = bc.init(torch.Generator().manual_seed(seed), cfg,
                         device=dev)
    if quantize is not None:
        params = quantize_edge_params(params, cfg, scheme=quantize,
                                      chunk=chunk, seed=seed)
    return BasecallEngine(params, cfg, batch=batch, chunk=chunk, device=dev,
                          trace=trace)
