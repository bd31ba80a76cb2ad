"""Periodic time-series export: per-tick deltas -> JSONL + live dashboard
(``repro/obs/export.py``).

An operator watching a field deployment needs the run **live**, not as an
end-of-run summary: bases/s right now, channel occupancy, queue depth, the
dispatch/fallback mix, and which counters are moving (the escalation-ready
deltas).  :class:`TimeSeriesExporter` snapshots a
:class:`~repro_torch.engine.telemetry.Telemetry` on a wall-clock interval and
emits one JSON object per snapshot — rates are **per-interval deltas**, so
a stall shows up as a zero-rate sample instead of being averaged away by
the cumulative totals.

Wiring: engines call ``telemetry.tick_export()`` once per step/tick (a
no-op until an exporter is attached); the serve CLI attaches one for
``--timeseries PATH`` (JSONL) and/or ``--monitor`` (live TTY dashboard).
"""
from __future__ import annotations

import json
import sys
import time

_SPARK = "▁▂▃▄▅▆▇█"


def _sparkline(values, width: int = 32) -> str:
    vals = [v for v in values[-width:] if v == v]   # drop NaN
    if not vals:
        return ""
    hi = max(vals) or 1.0
    return "".join(_SPARK[min(int(v / hi * (len(_SPARK) - 1)),
                              len(_SPARK) - 1)] for v in vals)


class TimeSeriesExporter:
    """Interval snapshots of one engine's telemetry as delta records."""

    def __init__(self, telemetry, *, scheduler=None, interval_s: float = 0.5,
                 path: str | None = None, stream=None, dashboard=False,
                 clock=time.perf_counter):
        self.telemetry = telemetry
        self.scheduler = scheduler
        self.interval_s = interval_s
        self.records: list[dict] = []
        self._clock = clock
        self._t0 = clock()
        self._file = open(path, "w") if path else None
        self._stream = stream
        self._dash = dashboard if isinstance(dashboard, TTYDashboard) else (
            TTYDashboard() if dashboard else None)
        self._prev = self._raw()

    # ----------------------------------------------------------- sample --
    def _raw(self) -> dict:
        tel = self.telemetry
        counters = dict(tel.counters)
        counters.update(tel.fabric_counters())
        return {"t": self._clock(), "bases": tel.bases,
                "samples": tel.samples, "tokens": tel.tokens,
                "completed": tel.completed, "dispatches": tel.dispatches,
                "steps": tel.steps, "counters": counters}

    def poll(self, force: bool = False) -> dict | None:
        """Emit a snapshot if ``interval_s`` has elapsed (or ``force``)."""
        if not force and self._clock() - self._prev["t"] < self.interval_s:
            return None
        return self.emit()

    def emit(self) -> dict:
        cur = self._raw()
        prev, self._prev = self._prev, cur
        dt = max(cur["t"] - prev["t"], 1e-9)
        deltas = {k: v - prev["counters"].get(k, 0)
                  for k, v in cur["counters"].items()
                  if v != prev["counters"].get(k, 0)}
        rec = {
            "t_s": round(cur["t"] - self._t0, 6),
            "interval_s": round(dt, 6),
            "steps": cur["steps"],
            "completed": cur["completed"],
            "bases_per_s": (cur["bases"] - prev["bases"]) / dt,
            "samples_per_s": (cur["samples"] - prev["samples"]) / dt,
            "tokens_per_s": (cur["tokens"] - prev["tokens"]) / dt,
            "dispatch_rate": (cur["dispatches"] - prev["dispatches"]) / dt,
            # the port's fabric has no fallback counters, so this stays 0;
            # the key is kept so a record reads like JAX's
            "fallback_rate": sum(v for k, v in deltas.items()
                                 if k.startswith("fabric.fallback.")) / dt,
            "counter_deltas": deltas,
            "gauges": {k: v for k, v in self.telemetry.gauges.items()
                       if isinstance(v, (int, float))},
        }
        if self.scheduler is not None:
            rec["queue_depth"] = self.scheduler.pending
            rec["in_flight"] = self.scheduler.n_busy
            rec["occupancy"] = self.scheduler.n_busy / self.scheduler.slots
        self.records.append(rec)
        line = json.dumps(rec, default=float)
        if self._file is not None:
            self._file.write(line + "\n")
            self._file.flush()
        if self._stream is not None:
            self._stream.write(line + "\n")
        if self._dash is not None:
            self._dash.render(self)
        return rec

    def close(self) -> None:
        """Final forced snapshot; flushes and closes the JSONL file."""
        self.emit()
        if self._file is not None:
            self._file.close()
            self._file = None
        if self._dash is not None:
            self._dash.finish()


class TTYDashboard:
    """Minimal live terminal view: redraws a fixed block of lines in place
    (ANSI cursor-up) every snapshot — ``serve --monitor``."""

    def __init__(self, stream=None):
        self.stream = stream if stream is not None else sys.stderr
        self._lines = 0

    def render(self, exporter: TimeSeriesExporter) -> None:
        rec = exporter.records[-1]
        tel = exporter.telemetry
        spark = _sparkline([r["bases_per_s"] for r in exporter.records])
        lines = [
            f"── {tel.workload or 'engine'} ── t={rec['t_s']:8.2f}s "
            f"steps={rec['steps']} completed={rec['completed']}",
            f"  bases/s {rec['bases_per_s']:12.0f}  {spark}",
            f"  samples/s {rec['samples_per_s']:10.0f}  "
            f"dispatch/s {rec['dispatch_rate']:8.1f}  "
            f"fallback/s {rec['fallback_rate']:6.1f}",
        ]
        if "queue_depth" in rec:
            lines.append(
                f"  queue {rec['queue_depth']:6d}  in-flight "
                f"{rec['in_flight']:4d}  occupancy {rec['occupancy']:.2f}")
        moving = sorted(rec["counter_deltas"].items(),
                        key=lambda kv: -abs(kv[1]))[:3]
        lines.append("  moving: " + (", ".join(
            f"{k}+{v}" for k, v in moving) if moving else "(idle)"))
        out = self.stream
        if self._lines:
            out.write(f"\x1b[{self._lines}F\x1b[J")
        out.write("\n".join(lines) + "\n")
        out.flush()
        self._lines = len(lines)

    def finish(self) -> None:
        self._lines = 0


def validate_timeseries(path: str,
                        required=("t_s", "interval_s", "bases_per_s",
                                  "samples_per_s", "dispatch_rate",
                                  "counter_deltas")) -> list[str]:
    """Schema check for an exported JSONL time series; returns errors."""
    errors: list[str] = []
    last_t = -float("inf")
    n = 0
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            n += 1
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"line {i}: not JSON ({e})")
                continue
            missing = [k for k in required if k not in rec]
            if missing:
                errors.append(f"line {i}: missing keys {missing}")
                continue
            if rec["t_s"] < last_t:
                errors.append(f"line {i}: t_s not monotone")
            last_t = rec["t_s"]
            if rec["interval_s"] < 0:
                errors.append(f"line {i}: negative interval")
    if n == 0:
        errors.append("no records")
    return errors
