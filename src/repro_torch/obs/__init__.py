"""Observability for the port (``repro/obs``): tracing, bounded metrics and
live time-series export.

  trace.py    per-read span tracer -> Chrome trace-event JSON (Perfetto),
              and ``profile_window``, a torch.profiler trace of the card
  metrics.py  bounded, mergeable primitives (log-bucketed histogram,
              counters, gauges) for long-running flowcells + fleet rollups
  export.py   periodic per-tick delta snapshots -> JSONL time series and
              the live TTY dashboard
  validate.py schema checks for the exported artifacts
              (``python -m repro_torch.obs.validate trace.json``)

:class:`repro_torch.engine.telemetry.Telemetry` is a facade over these
primitives; engines opt into tracing with ``repro_torch.engine.build(...,
trace=True)``.
"""
from repro_torch.obs.metrics import (Counters, Gauges, LogHistogram,  # noqa: F401
                                     weighted_percentile)
from repro_torch.obs.trace import (NULL_TRACER, Tracer, as_tracer,  # noqa: F401
                                   profile_window, read_spans,
                                   validate_chrome_trace)
from repro_torch.obs.export import (TimeSeriesExporter,  # noqa: F401
                                    TTYDashboard, validate_timeseries)
