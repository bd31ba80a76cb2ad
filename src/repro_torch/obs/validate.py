"""CI schema gate for exported observability artifacts.

    PYTHONPATH=src python -m repro_torch.obs.validate trace_flowcell.json \
        --timeseries timeseries_flowcell.jsonl [--min-read-spans N]

Exit 0 when the Chrome trace-event JSON and the JSONL time series both
validate (see :func:`repro_torch.obs.trace.validate_chrome_trace` and
:func:`repro_torch.obs.export.validate_timeseries`); exit 1 with the error list
otherwise.  ``--min-read-spans`` additionally requires at least N completed
per-read spans correlated by ``read_id`` — the flowcell-smoke CI contract.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.export import validate_timeseries
from repro_torch.obs.trace import read_spans, validate_chrome_trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="Chrome trace-event JSON to validate")
    ap.add_argument("--timeseries", default=None,
                    help="JSONL time series to validate alongside")
    ap.add_argument("--min-read-spans", type=int, default=0,
                    help="require >= N completed read spans with read_id")
    args = ap.parse_args(argv)

    errors: list[str] = []
    with open(args.trace) as f:
        doc = json.load(f)
    errors += [f"{args.trace}: {e}" for e in validate_chrome_trace(doc)]
    spans = read_spans(doc)
    with_id = [s for s in spans if s["read_id"] is not None]
    if len(with_id) < args.min_read_spans:
        errors.append(f"{args.trace}: {len(with_id)} read spans with "
                      f"read_id, need >= {args.min_read_spans}")
    if args.timeseries:
        errors += [f"{args.timeseries}: {e}"
                   for e in validate_timeseries(args.timeseries)]

    if errors:
        for e in errors:
            print(f"INVALID: {e}", file=sys.stderr)
        return 1
    n_events = sum(1 for e in doc.get("traceEvents", [])
                   if e.get("ph") != "M")
    print(f"OK: {n_events} events, {len(with_id)} read spans"
          + (f", time series valid ({args.timeseries})"
             if args.timeseries else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
