"""Unified telemetry for every streaming workload
(``repro/engine/telemetry.py``).

One accounting surface for every engine: weighted latency percentiles,
throughput (bases/s, samples/s, tokens/s), signal-saved fraction,
per-stage wall time, and free-form workload counters.

Latency accounting records **one observation per dispatch** with an
explicit weight (the number of rows/reads the dispatch served), so
percentiles are computed over the weighted distribution and a half-full
tail batch does not skew p50/p99.

The accounting is **bounded and mergeable** (see
:mod:`repro_torch.obs.metrics`): latencies live in a
:class:`~repro_torch.obs.metrics.LogHistogram` that keeps raw
observations (exact percentiles) for short runs and folds into log-spaced
buckets past ``latency_exact_window``, so a long-running flowcell stays
O(buckets) in memory; :meth:`Telemetry.merge` rolls several engines'
telemetry into one fleet view.

Observability hooks: pass ``tracer=`` (a
:class:`repro_torch.obs.trace.Tracer`) to record per-stage spans and
fabric-dispatch instants on the engine's own process track (host times: on
the card a stage span times the host's issue of its kernels), and attach a
:class:`repro_torch.obs.export.TimeSeriesExporter`
to ``exporter`` to stream per-interval delta snapshots (engines call
:meth:`tick_export` once per step).
"""
from __future__ import annotations

import contextlib
import time

from repro_torch.kernels import fabric as _fabric
from repro_torch.obs.metrics import (Counters, Gauges, LogHistogram,
                                     weighted_percentile)
from repro_torch.obs.trace import NULL_TRACER, as_tracer

__all__ = ["Telemetry", "weighted_percentile"]


class Telemetry:
    """Shared accounting across all engines (the SoC's one perf counter bank).

    Scalar attributes cover the quantities every workload reports; workload-
    specific event counts (accepted / ejected / chunks / ...) live in
    ``counters``; ``stage_s`` accumulates wall time per pipeline stage
    (sense / basecall / map / decide / prefill / ...); ``gauges`` hold
    point-in-time values (queue depth, occupancy).
    """

    def __init__(self, workload: str = "", *, tracer=None,
                 latency_exact_window: int = 4096):
        self.workload = workload
        self.wall_s = 0.0
        self.steps = 0              # decode steps / ticks / drained chunks
        self.dispatches = 0         # device dispatches
        self.completed = 0          # finished requests / reads
        self.bases = 0              # bases called (genomics) or emitted
        self.samples = 0            # raw signal samples processed
        self.samples_saved = 0      # signal never sequenced (adaptive)
        self.tokens = 0             # LM tokens decoded
        self.latency_hist = LogHistogram(exact_until=latency_exact_window)
        self.counters = Counters()
        self.stage_s: dict = {}
        self.gauges = Gauges()
        self.exporter = None        # optional TimeSeriesExporter

        # span tracing: one trace-event process per Telemetry, host track
        # for stage spans, fabric track fed by the scoped-counter listener
        self.tracer = as_tracer(tracer) if tracer is not None else NULL_TRACER
        if self.tracer.enabled:
            self.trace_pid = self.tracer.pid(workload or "engine")
            self._host_tid = self.tracer.tid(self.trace_pid, "host")
            listener = self.tracer.fabric_hook(self.trace_pid)
        else:
            self.trace_pid = 0
            self._host_tid = 0
            listener = None

        # kernel-dispatch accounting: a per-engine scoped counter receives a
        # copy of every fabric bump recorded while this engine's compute is
        # active (``with telemetry.scope(): ...``) — exact attribution even
        # when several engines interleave in one process (the process-wide
        # baseline delta this replaces misattributed concurrent traffic).
        self.fabric_scope = _fabric.ScopedCounters(listener=listener)

    # ------------------------------------------------------------- fabric --
    def scope(self):
        """Attribute fabric dispatches in this block to *this* engine:
        ``with telemetry.scope(): <compute>``.  Re-entrant (nested engine
        internals never double-count)."""
        return _fabric.scoped(self.fabric_scope)

    def fabric_counters(self) -> dict:
        """Kernel-dispatch counters attributed to this engine,
        ``fabric.dispatch.<op>.<target>`` (target ``cuda`` or
        ``reference``), one per call.  Attribution is exact per engine:
        only bumps recorded under this telemetry's :meth:`scope` land here,
        so two engines interleaving in one process never see each other's
        traffic."""
        return self.fabric_scope.snapshot()

    # ------------------------------------------------------------ record --
    @property
    def latencies_ms(self) -> list:
        """Raw latency observations (exact mode only: empty once the
        histogram folds past ``latency_exact_window`` — use
        ``latency_percentile`` / ``latency_hist``)."""
        return self.latency_hist.values

    @property
    def latency_weights(self) -> list:
        return self.latency_hist.weights

    def observe_latency(self, ms: float, weight: float = 1.0) -> None:
        """One latency observation per dispatch/decision, weighted by how
        many rows it served (the ServeStats duplication fix)."""
        self.latency_hist.observe(float(ms), float(weight))

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def gauge(self, name: str, value: float) -> None:
        """Point-in-time quantity (per-channel occupancy, queue depth, ...):
        the latest value wins, unlike monotonically accumulating counters."""
        self.gauges[name] = value

    @contextlib.contextmanager
    def stage(self, name: str):
        """Accumulate wall time of a pipeline stage: ``with tel.stage("map")``
        — and record it as an X span on the engine's host track when a
        tracer is attached."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - t0
            self.stage_s[name] = self.stage_s.get(name, 0.0) + dur
            self.tracer.complete(name, t0, dur, pid=self.trace_pid,
                                 tid=self._host_tid, cat="stage")

    def tick_export(self) -> None:
        """Give the attached time-series exporter (if any) a chance to emit
        an interval snapshot; engines call this once per step/tick."""
        if self.exporter is not None:
            self.exporter.poll()

    # ----------------------------------------------------------- derive --
    def latency_percentile(self, q: float) -> float:
        return self.latency_hist.percentile(q)

    def per_second(self, quantity: int) -> float:
        return quantity / max(self.wall_s, 1e-9)

    @property
    def signal_saved_frac(self) -> float:
        total = self.samples + self.samples_saved
        return self.samples_saved / max(total, 1)

    def summary(self) -> dict:
        """The unified report every engine returns from ``drain``.

        Merged dicts (stages, gauges, counters, fabric) keep their flat keys
        unless one would shadow an already-present key — collisions are
        namespaced (``counters.steps``, ``gauges.wall_s``, ...) instead of
        silently replacing the scalar field."""
        out = {
            "workload": self.workload,
            "p50_ms": self.latency_percentile(50),
            "p99_ms": self.latency_percentile(99),
            "bases_per_s": self.per_second(self.bases),
            "samples_per_s": self.per_second(self.samples),
            "tokens_per_s": self.per_second(self.tokens),
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

    # ------------------------------------------------------ wire format --
    _SCALARS = ("wall_s", "steps", "dispatches", "completed", "bases",
                "samples", "samples_saved", "tokens")

    def to_dict(self) -> dict:
        """JSON-safe snapshot of the full mergeable state: scalars, latency
        histogram (exact values or folded buckets), counters, per-stage
        walls, gauges (with write-sequence numbers), and fabric-dispatch
        counts.  ``Telemetry.from_dict(json.loads(json.dumps(t.to_dict())))``
        restores a telemetry whose :meth:`merge` behaviour is identical to
        the original — the uplink contract for fleet rollups that cross a
        process/wire boundary."""
        return {
            "workload": self.workload,
            **{f: getattr(self, f) for f in self._SCALARS},
            "latency_hist": self.latency_hist.to_dict(),
            "counters": dict(self.counters),
            "stage_s": dict(self.stage_s),
            "gauges": self.gauges.to_dict(),
            "fabric": {k: int(v) for k, v in self.fabric_counters().items()},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Telemetry":
        """Inverse of :meth:`to_dict` (tracer/exporter hooks are process-
        local and intentionally not restored)."""
        out = cls(workload=d.get("workload", ""))
        for f in cls._SCALARS:
            setattr(out, f, d[f])
        out.latency_hist = LogHistogram.from_dict(d["latency_hist"])
        out.counters = Counters(d["counters"])
        out.stage_s = dict(d["stage_s"])
        out.gauges = Gauges.from_dict(d["gauges"])
        for k, v in d.get("fabric", {}).items():
            out.fabric_scope.counts[k] += v
        return out

    # ------------------------------------------------------------ merge --
    def merge(self, other: "Telemetry") -> "Telemetry":
        """Fold ``other`` into ``self`` (in place; returns self) — the
        fleet rollup: totals and counters sum, latency histograms merge
        (associative), gauges keep the freshest write, ``wall_s`` takes the
        max (fleet engines run concurrently, so summed wall time would
        deflate every per-second rate)."""
        self.wall_s = max(self.wall_s, other.wall_s)
        for f in ("steps", "dispatches", "completed", "bases", "samples",
                  "samples_saved", "tokens"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        self.latency_hist.merge(other.latency_hist)
        self.counters.merge(other.counters)
        self.gauges.merge(other.gauges)
        for k, v in other.stage_s.items():
            self.stage_s[k] = self.stage_s.get(k, 0.0) + v
        for k, v in other.fabric_counters().items():
            self.fabric_scope.counts[k] += v
        return self
