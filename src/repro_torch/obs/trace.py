"""Low-overhead span tracer -> Chrome trace-event JSON (Perfetto-loadable)
(``repro/obs/trace.py``).

One :class:`Tracer` records the per-read lifecycle across the engine stack:

  * **reads** as matched B/E spans on a per-lane thread track (``begin`` at
    pore capture / slot admit, ``end`` at the accept/eject/exhaust
    decision), correlated by ``read_id`` in the event args;
  * **stages** (sense / basecall / map / decide / prefill / ...) as
    complete ``X`` spans on the engine's host track — emitted for free by
    ``Telemetry.stage``;
  * **scheduler** admit / assign / release transitions and **fabric
    dispatches** as instant events (the latter ride the scoped-counter
    listener in :mod:`repro_torch.kernels.fabric`, so they land when the
    wrapper launches the kernel);
  * per-tick **counter** tracks (busy lanes, queue depth) that Perfetto
    renders as time series.

The exported document is the Chrome trace-event format::

    {"traceEvents": [...], "displayTimeUnit": "ms"}

with stable pid/tid mappings announced via ``process_name`` /
``thread_name`` metadata events — open it at https://ui.perfetto.dev.

Disabled tracers (the default — ``NULL_TRACER``) return immediately from
every method and hand out one shared null context manager, so the traced
hot path costs a single attribute check per call when tracing is off.

Timestamps are microseconds on ``time.perf_counter`` relative to the
tracer's construction.  They are host times: on the card a stage span
times the host's issue of the kernels, not the kernels themselves (a
device trace of the same window comes from :func:`profile_window`).
Buffer growth is bounded by ``max_events`` (overflow increments
``dropped`` and suppresses the E of any dropped B so the exported stream
stays well formed).
"""
from __future__ import annotations

import contextlib
import json
import threading
import time


class _NullSpan:
    """Shared no-op context manager for the disabled path (zero alloc)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Trace-event recorder; one per process is fine (pids separate
    engines), one per engine works too."""

    def __init__(self, enabled: bool = True, *, max_events: int = 500_000,
                 detail: bool = False, clock=time.perf_counter):
        self.enabled = enabled
        self.detail = detail            # opt-in high-volume events
        self.max_events = max_events
        self.events: list[dict] = []
        self.meta: list[dict] = []      # process_name / thread_name events
        self.dropped = 0
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._pid_labels: dict[int, str] = {}
        self._tids: dict[tuple, int] = {}       # (pid, label) -> tid
        self._open: dict[tuple, list] = {}      # (pid, tid) -> [name, ...]

    # -------------------------------------------------------- identity --
    def pid(self, label: str) -> int:
        """Allocate a fresh process id labelled ``label`` (engines get one
        pid each; duplicate labels are disambiguated)."""
        if not self.enabled:
            return 0
        with self._lock:
            pid = len(self._pid_labels) + 1
            if any(v == label for v in self._pid_labels.values()):
                label = f"{label}#{pid}"
            self._pid_labels[pid] = label
            self.meta.append({"name": "process_name", "ph": "M", "pid": pid,
                              "tid": 0, "args": {"name": label}})
        return pid

    def relabel_pid(self, pid: int, label: str) -> None:
        """Rename an allocated process track (the fleet relabels an
        engine's track to its tenant once ownership is known).  Duplicate
        labels are disambiguated like :meth:`pid`; unknown pids no-op."""
        if not self.enabled or pid not in self._pid_labels:
            return
        with self._lock:
            if any(v == label for p, v in self._pid_labels.items()
                   if p != pid):
                label = f"{label}#{pid}"
            self._pid_labels[pid] = label
            for ev in self.meta:
                if ev["name"] == "process_name" and ev["pid"] == pid:
                    ev["args"] = {"name": label}
                    return

    def tid(self, pid: int, label: str) -> int:
        """Stable thread id for ``label`` within ``pid`` (lane / host /
        slot tracks)."""
        if not self.enabled:
            return 0
        with self._lock:
            key = (pid, label)
            if key not in self._tids:
                tid = sum(1 for p, _ in self._tids if p == pid) + 1
                self._tids[key] = tid
                self.meta.append({"name": "thread_name", "ph": "M",
                                  "pid": pid, "tid": tid,
                                  "args": {"name": label}})
            return self._tids[key]

    # --------------------------------------------------------- recording --
    def now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def _add(self, ev: dict) -> bool:
        with self._lock:
            if len(self.events) >= self.max_events:
                self.dropped += 1
                return False
            self.events.append(ev)
            return True

    def begin(self, name: str, *, pid: int, tid: int, cat: str = "span",
              args: dict | None = None) -> None:
        """Open a B span (pair with :meth:`end` on the same pid/tid)."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "B", "ts": self.now_us(),
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        if self._add(ev):
            self._open.setdefault((pid, tid), []).append(name)
        # a dropped B never opens: the matching end() is suppressed too

    def end(self, *, pid: int, tid: int, args: dict | None = None) -> None:
        stack = self._open.get((pid, tid))
        if not self.enabled or not stack:
            return                      # unmatched/suppressed E: drop
        name = stack.pop()
        ev = {"name": name, "ph": "E", "ts": self.now_us(),
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)          # always close an opened span

    @contextlib.contextmanager
    def _span_ctx(self, name, pid, tid, cat, args):
        t0 = self._clock()
        try:
            yield self
        finally:
            self.complete(name, t0, self._clock() - t0, pid=pid, tid=tid,
                          cat=cat, args=args)

    def span(self, name: str, *, pid: int, tid: int, cat: str = "span",
             args: dict | None = None):
        """``with tracer.span("map", pid=p, tid=t): ...`` -> one X event."""
        if not self.enabled:
            return _NULL_SPAN
        return self._span_ctx(name, pid, tid, cat, args)

    def complete(self, name: str, t0_s: float, dur_s: float, *, pid: int,
                 tid: int, cat: str = "span",
                 args: dict | None = None) -> None:
        """Record a complete X span from host-clock start/duration."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": (t0_s - self._t0) * 1e6, "dur": max(dur_s, 0.0) * 1e6,
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self._add(ev)

    def instant(self, name: str, *, pid: int, tid: int, cat: str = "event",
                args: dict | None = None) -> None:
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "i", "ts": self.now_us(),
              "s": "t", "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self._add(ev)

    def counter(self, name: str, values: dict, *, pid: int) -> None:
        """A Perfetto counter track sample (``ph='C'``) — the in-trace time
        series (busy lanes, queue depth, bases/s)."""
        if not self.enabled:
            return
        self._add({"name": name, "ph": "C", "ts": self.now_us(),
                   "pid": pid, "tid": 0,
                   "args": {k: float(v) for k, v in values.items()}})

    # ------------------------------------------------------------ hooks --
    def scheduler_hook(self, pid: int):
        """``SlotScheduler.on_event`` adapter: admit/assign/release become
        instant events on a dedicated scheduler track."""
        if not self.enabled:
            return None
        tid = self.tid(pid, "scheduler")

        def hook(kind: str, slot: int) -> None:
            self.instant(f"sched.{kind}", pid=pid, tid=tid, cat="sched",
                         args={"slot": slot})
        return hook

    def fabric_hook(self, pid: int):
        """Scoped-counter listener adapter: every fabric dispatch counted in
        the engine's scope lands as an instant event at execution time."""
        if not self.enabled:
            return None
        tid = self.tid(pid, "fabric")

        def hook(items) -> None:
            for key, n in items:
                if key.startswith("fabric.dispatch."):
                    self.instant(key, pid=pid, tid=tid, cat="fabric",
                                 args={"n": n})
        return hook

    # ------------------------------------------------------------ export --
    def to_chrome(self) -> dict:
        """The trace-event document: metadata first, then events sorted by
        timestamp; any still-open B span is closed at export time (flagged
        ``open_at_export``) so B/E stay matched."""
        with self._lock:
            events = list(self.events)
            open_spans = {k: list(v) for k, v in self._open.items()
                          if v}
        now = self.now_us()
        closers = []
        for (pid, tid), names in open_spans.items():
            for name in reversed(names):
                closers.append({"name": name, "ph": "E", "ts": now,
                                "pid": pid, "tid": tid,
                                "args": {"open_at_export": True}})
        events = sorted(events + closers, key=lambda e: e["ts"])
        return {"traceEvents": list(self.meta) + events,
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export_chrome(self, path: str) -> dict:
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc


NULL_TRACER = Tracer(enabled=False, max_events=0)


def as_tracer(value) -> Tracer:
    """Coerce an engine builder's ``trace=`` argument: ``False``/``None`` ->
    the shared disabled tracer, ``True`` -> a fresh enabled tracer, a
    :class:`Tracer` -> itself (share one across engines for a fleet-wide
    trace)."""
    if isinstance(value, Tracer):
        return value
    if value:
        return Tracer(enabled=True)
    return NULL_TRACER


@contextlib.contextmanager
def profile_window(logdir: str | None, enabled: bool = True, *,
                   device="cuda"):
    """Capture a ``torch.profiler`` trace of ``device`` around a window of
    the run, written as Chrome JSON to ``logdir/device_trace.json``
    (``logdir=None`` or ``enabled=False``: a no-op that yields None).

    Unlike a best-effort window, a requested one must start: asking for
    the card where there is none, or a profiler that fails to start,
    raises, so a caller who asked for a device trace never gets an empty
    one."""
    if not enabled or logdir is None:
        yield None
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "device_trace.json"))


# ---------------------------------------------------------- validation ----
def validate_chrome_trace(doc: dict) -> list[str]:
    """Schema check for an exported trace document; returns error strings
    (empty = valid).  Pinned invariants: event fields present, non-M events
    sorted by ``ts``, B/E matched per (pid, tid) with stack discipline,
    X events carry a non-negative ``dur``, and every (pid, tid) that emits
    events has stable ``process_name``/``thread_name`` metadata."""
    errors: list[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    named_pids, named_tids = set(), set()
    last_ts = -float("inf")
    stacks: dict[tuple, list] = {}
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph is None or "name" not in ev or "pid" not in ev:
            errors.append(f"event {i}: missing ph/name/pid")
            continue
        if ph == "M":
            if ev["name"] == "process_name":
                named_pids.add(ev["pid"])
            elif ev["name"] == "thread_name":
                named_tids.add((ev["pid"], ev.get("tid")))
            continue
        ts = ev.get("ts")
        if ts is None:
            errors.append(f"event {i} ({ev['name']}): missing ts")
            continue
        if ts < last_ts:
            errors.append(f"event {i} ({ev['name']}): ts not monotone "
                          f"({ts} < {last_ts})")
        last_ts = ts
        key = (ev["pid"], ev.get("tid"))
        if ph == "B":
            stacks.setdefault(key, []).append(ev["name"])
        elif ph == "E":
            if not stacks.get(key):
                errors.append(f"event {i}: E without open B on {key}")
            else:
                stacks[key].pop()
        elif ph == "X":
            if ev.get("dur", -1) < 0:
                errors.append(f"event {i} ({ev['name']}): X without "
                              f"non-negative dur")
        elif ph not in ("i", "I", "C"):
            errors.append(f"event {i}: unknown phase {ph!r}")
        if ev["pid"] not in named_pids:
            errors.append(f"event {i}: pid {ev['pid']} has no process_name "
                          f"metadata")
            named_pids.add(ev["pid"])   # report once
    for key, stack in stacks.items():
        if stack:
            errors.append(f"unclosed B span(s) {stack} on {key}")
    return errors


def read_spans(doc: dict) -> list[dict]:
    """Extract completed per-read spans from a trace document: one entry
    per matched read B/E pair with ``read_id``, duration (us) and the
    decision args recorded at span end."""
    out = []
    open_spans: dict[tuple, list] = {}
    for ev in doc.get("traceEvents", []):
        ph, name = ev.get("ph"), ev.get("name")
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "B" and name == "read":
            open_spans.setdefault(key, []).append(ev)
        elif ph == "E" and open_spans.get(key):
            b = open_spans[key].pop()
            if b.get("name") != "read":
                continue
            args = dict(b.get("args", {}))
            args.update(ev.get("args", {}))
            out.append({"read_id": args.get("read_id"),
                        "dur_us": ev["ts"] - b["ts"], "args": args})
    return out
