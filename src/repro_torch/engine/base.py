"""What the basecalling engines share (``repro/engine/base.py``): the
scheduler + telemetry plumbing, the drain loop and summary of the chunk
engines, the fleet's time-slicing hooks, the SoC energy block of their
summaries and the build-time int8 quantization behind the ``edge_int8``
presets."""
from __future__ import annotations

import warnings

import numpy as np

from repro_torch.engine.scheduler import SlotScheduler
from repro_torch.engine.telemetry import Telemetry


class EngineBase:
    """The plumbing of an engine that owns ``telemetry``, a ``scheduler``,
    ``step()`` and CNN ``params`` / ``cfg`` (the ``basecall`` and
    ``pathogen_pipeline`` engines).  ``tracer`` is a builder's ``trace=``
    (``False``, ``True`` or a shared :class:`repro_torch.obs.trace.Tracer`);
    the scheduler's admit/assign/release land on its scheduler track."""

    workload = ""

    def __init__(self, *, slots: int, depth: int | None = None,
                 tracer=None):
        self.telemetry = Telemetry(workload=self.workload, tracer=tracer)
        self.scheduler = SlotScheduler(
            slots, depth=depth,
            on_event=self.telemetry.tracer.scheduler_hook(
                self.telemetry.trace_pid))

    # Fleet time-slicing hooks: the fleet brackets every engine tick with
    # resume_tick()/suspend_tick() so an engine that keeps work in flight
    # across ticks (the depth-2 flowcell runtime) can hand the card to the
    # next tenant with nothing of its own pending.  No-ops here: a chunk
    # engine's step leaves nothing behind that another tenant waits on.
    def resume_tick(self) -> None:
        """The fleet is about to run one of this engine's ticks."""

    def suspend_tick(self) -> None:
        """The fleet is done with this engine's tick."""

    def drain(self, max_steps: int = 100_000) -> dict:
        """Step until the scheduler is empty (or ``max_steps``); returns the
        summary."""
        steps = 0
        while not self.scheduler.drained and steps < max_steps:
            if not self.step():
                break
            self.telemetry.tick_export()
            steps += 1
        return self.summary()

    def summary(self) -> dict:
        """Telemetry summary plus the SoC energy block."""
        out = self.telemetry.summary()
        out.update(energy_block(self.params, self.cfg,
                                self.telemetry.samples))
        return out


def energy_block(params, cfg, samples) -> dict:
    """The ``soc_energy_*`` keys for an engine with CNN ``params`` and a
    ``BasecallerConfig`` (none otherwise)."""
    from repro_torch.core.basecaller import BasecallerConfig
    if params is None or not isinstance(cfg, BasecallerConfig):
        return {}
    from repro_torch.core.soc_model import energy_summary
    return energy_summary(params, cfg, samples)


def quantize_edge_params(params, bc_cfg, *, scheme: str = "int8",
                         chunk: int = 2048, calib_chunks: int = 4,
                         seed: int = 0):
    """Build-time quantization behind the ``edge_int8`` presets.

    Calibrates the activation scales from ``calib_chunks`` seeded
    ``(2, chunk)`` normal chunks (percentile observer, 99.9) and stores the
    CNN weights int8 once, per output channel.  Params that already carry
    stored int8 pass through (with a warning when they lack calibrated
    activation scales: dynamic scales are chunk-local, so streaming will
    not equal the whole-read output)."""
    if scheme != "int8":
        raise ValueError(f"unknown quantization scheme {scheme!r}")
    from repro_torch import quant
    from repro_torch.core import basecaller as bc
    from repro_torch.quant.params import param_leaves
    if quant.params_precision(params) == "int8":
        if any(quant.is_quantized(x) and x.act_scale is None
               for _, x in param_leaves(params)):
            warnings.warn(
                "edge_int8: supplied quantized params have no calibrated "
                "activation scales; streaming basecalls will not equal the "
                "whole-read output", stacklevel=3)
        return params
    rng = np.random.default_rng(seed)
    chunks = [rng.normal(size=(2, chunk)).astype(np.float32)
              for _ in range(calib_chunks)]
    return bc.quantize(params, bc_cfg, chunks=chunks, observer="percentile",
                       pct=99.9)
