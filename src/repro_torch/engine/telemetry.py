"""Engine telemetry (``repro/engine/telemetry.py``), trimmed for the port.

Weighted latency percentiles (exact: every observation is kept), bases/s
and samples/s, signal-saved fraction, per-stage wall time, workload
counters and gauges, and the engine's own kernel-dispatch counters
(``fabric.dispatch.<op>.<target>``).  ``summary()`` keeps the keys
``realtime.runtime.report()`` reads.  No span tracer and no bucket folding
yet: those come with the observability slice.
"""
from __future__ import annotations

import collections
import contextlib
import time

import numpy as np

from repro_torch.kernels import fabric

__all__ = ["Telemetry", "weighted_percentile"]


def weighted_percentile(values, weights, q: float) -> float:
    """Percentile ``q`` (0..100) of ``values`` under weights, lower-style
    on the weighted CDF (``repro/obs/metrics.py``)."""
    v = np.asarray(values, np.float64)
    w = np.asarray(weights, np.float64)
    if v.size == 0:
        return 0.0
    order = np.argsort(v, kind="stable")
    v, w = v[order], w[order]
    cdf = np.cumsum(w)
    target = q / 100.0 * cdf[-1]
    return float(v[np.searchsorted(cdf, target, side="left").clip(0, len(v) - 1)])


class Telemetry:
    """Shared accounting for one engine."""

    def __init__(self, workload: str = ""):
        self.workload = workload
        self.wall_s = 0.0
        self.steps = 0              # ticks
        self.dispatches = 0         # device step dispatches
        self.completed = 0          # finished reads
        self.bases = 0              # bases called
        self.samples = 0            # raw signal samples processed
        self.samples_saved = 0      # signal never sequenced (adaptive)
        self.latencies_ms: list[float] = []
        self.latency_weights: list[float] = []
        self.counters: collections.Counter = collections.Counter()
        self.stage_s: dict = {}
        self.gauges: dict = {}
        self.fabric_scope = fabric.ScopedCounters()

    def scope(self):
        """Attribute kernel dispatches in this block to this engine."""
        return fabric.scoped(self.fabric_scope)

    def fabric_counters(self) -> dict:
        return self.fabric_scope.snapshot()

    def observe_latency(self, ms: float, weight: float = 1.0) -> None:
        self.latencies_ms.append(float(ms))
        self.latency_weights.append(float(weight))

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    @contextlib.contextmanager
    def stage(self, name: str):
        """Accumulate wall time of a pipeline stage."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stage_s[name] = (self.stage_s.get(name, 0.0)
                                  + time.perf_counter() - t0)

    def latency_percentile(self, q: float) -> float:
        return weighted_percentile(self.latencies_ms, self.latency_weights, q)

    def per_second(self, quantity: int) -> float:
        return quantity / max(self.wall_s, 1e-9)

    @property
    def signal_saved_frac(self) -> float:
        total = self.samples + self.samples_saved
        return self.samples_saved / max(total, 1)

    def summary(self) -> dict:
        """The report every engine returns from ``drain``; a merged key
        that would shadow a scalar field is namespaced (``counters.steps``)."""
        out = {
            "workload": self.workload,
            "p50_ms": self.latency_percentile(50),
            "p99_ms": self.latency_percentile(99),
            "bases_per_s": self.per_second(self.bases),
            "samples_per_s": self.per_second(self.samples),
            "signal_saved_frac": self.signal_saved_frac,
            "wall_s": self.wall_s,
            "steps": self.steps,
            "dispatches": self.dispatches,
            "completed": self.completed,
        }
        for prefix, items in (
                ("stage", {f"stage_{k}_s": v for k, v in self.stage_s.items()}),
                ("gauges", self.gauges),
                ("counters", self.counters),
                ("fabric", self.fabric_counters())):
            for k, v in items.items():
                out[f"{prefix}.{k}" if k in out else k] = v
        return out
