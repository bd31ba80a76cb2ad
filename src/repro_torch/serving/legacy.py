"""Deprecated serving surfaces, thin shims over :mod:`repro_torch.engine`
(``repro/serving/legacy.py``).

``LMServer``, ``BasecallServer`` and ``AdaptiveSamplingServer`` keep the
old signatures, warn with a :class:`DeprecationWarning` and delegate to
the engines that ``repro_torch.engine.build`` makes, so they give the
engines' results.  Each takes the port's ``device=`` (default
``"cuda"``); the old placement booleans (``use_kernel``, ``interpret``)
place nothing, since the device picks every kernel's target
(:func:`repro_torch.engine.adaptive.legacy_adaptive_policy`).

New code:

    eng = repro_torch.engine.build("lm_decode", model=m, params=p, cfg=cfg,
                                   slots=4, max_len=64)
"""
from __future__ import annotations

import warnings

import numpy as np

import repro_torch.engine as engine_api
from repro_torch.engine.lm import Request  # noqa: F401  (re-export)


def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"{old} is deprecated; use repro_torch.engine.build({new}) instead",
        DeprecationWarning, stacklevel=3)


class _LegacyStatsView:
    """Old ``ServeStats`` surface backed by the unified ``Telemetry``."""

    def __init__(self, telemetry):
        self._tel = telemetry

    @property
    def latencies_ms(self):
        return self._tel.latencies_ms

    @property
    def bases(self):
        return self._tel.bases

    @property
    def samples(self):
        return self._tel.samples

    @property
    def wall_s(self):
        return self._tel.wall_s

    def summary(self) -> dict:
        return {
            "p50_ms": self._tel.latency_percentile(50),
            "p99_ms": self._tel.latency_percentile(99),
            "bases_per_s": self._tel.per_second(self._tel.bases),
            "samples_per_s": self._tel.per_second(self._tel.samples),
        }


class LMServer:
    """Deprecated: ``repro_torch.engine.build("lm_decode", ...)``."""

    def __init__(self, model, params, cfg, *, slots: int, max_len: int,
                 eos: int = -1, device="cuda"):
        _deprecated("LMServer", '"lm_decode"')
        self._eng = engine_api.build("lm_decode", model=model, params=params,
                                     cfg=cfg, slots=slots, max_len=max_len,
                                     eos=eos, device=device)

    @property
    def finished(self):
        return self._eng.finished

    @property
    def queue(self):
        return self._eng.scheduler.queue

    @property
    def active(self):
        return self._eng.scheduler.active

    def submit(self, req: Request):
        self._eng.submit(req)

    def step(self) -> bool:
        return self._eng.step()

    def run_until_drained(self, max_steps: int = 100_000) -> int:
        start = self._eng.telemetry.steps
        self._eng.drain(max_steps)
        return self._eng.telemetry.steps - start


class BasecallServer:
    """Deprecated: ``repro_torch.engine.build("basecall", ...)``."""

    def __init__(self, params, bc_cfg, *, batch: int, chunk: int,
                 use_kernel: bool = False, device="cuda"):
        _deprecated("BasecallServer", '"basecall"')
        del use_kernel   # the device picks the kernel or its plain version
        self._eng = engine_api.build("basecall", params=params, cfg=bc_cfg,
                                     batch=batch, chunk=chunk, device=device)

    @property
    def stats(self) -> _LegacyStatsView:
        return _LegacyStatsView(self._eng.telemetry)

    def serve(self, signal_chunks: np.ndarray) -> list[np.ndarray]:
        return self._eng.serve(signal_chunks)


class AdaptiveSamplingServer:
    """Deprecated: ``repro_torch.engine.build("adaptive_sampling", ...)``."""

    def __init__(self, params, bc_cfg, reference, target_intervals, *,
                 channels: int = 32, chunk: int = 256, policy=None,
                 align_cfg=None, use_kernel: bool = False, interpret=None,
                 device="cuda"):
        _deprecated("AdaptiveSamplingServer", '"adaptive_sampling"')
        from repro_torch.engine.adaptive import legacy_adaptive_policy
        self.placement = legacy_adaptive_policy(use_kernel, interpret,
                                                device=device)
        self._eng = engine_api.build(
            "adaptive_sampling", params=params, cfg=bc_cfg,
            reference=reference, targets=target_intervals, channels=channels,
            chunk=chunk, policy=policy, align_cfg=align_cfg, device=device)

    @property
    def runtime(self):
        return self._eng.runtime

    @property
    def records(self):
        return self._eng.records

    def submit(self, signal: np.ndarray, *, read_id: int = 0,
               on_target: bool | None = None, position: int = -1) -> None:
        self._eng.submit(signal, read_id=read_id, on_target=on_target,
                         position=position)

    def step(self) -> bool:
        return self._eng.step()

    def run_until_drained(self, max_ticks: int = 100_000) -> dict:
        return self._eng.drain(max_ticks)

    def summary(self) -> dict:
        return self._eng.summary()
