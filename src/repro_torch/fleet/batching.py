"""Engine units: the schedulable wrappers the fleet time-slices
(``repro/fleet/batching.py``).

A *unit* owns one engine instance and feeds it from one or more tenants'
fleet-level queues.  Three shapes:

  * :class:`BasecallUnit` — **continuous cross-tenant batching** for the
    fixed-batch basecall engine: compatible tenants share one engine, and
    each dispatch's batch is filled by a weighted interleave of the member
    queues, so idle slots in one tenant's batch carry another tenant's
    rows.  Results demultiplex back per tenant by the staging FIFO (the
    engine admits and emits strictly in order).
  * :class:`LMUnit` — the same idea over the LM decode engine's slot
    pool: requests from several tenants occupy one pool and decode in the
    same step; finished requests route back by ownership.
  * :class:`GenericUnit` — single-tenant wrapper for engines whose state is
    inherently per-tenant (a flowcell's pore lifecycle, the pathogen
    pipeline's in-flight depth).  No sharing; the fleet still time-slices
    its ticks against everyone else's.

Per-member accounting: the **engine's** telemetry stays the exact record of
everything the unit dispatched (fabric counters included — attribution is
scoped per engine).  Shared units additionally maintain one mergeable
:class:`~repro_torch.engine.telemetry.Telemetry` view per member
(completed / bases / tokens / weighted latency, wall time split by rows
served) for the per-tenant rollup; a unit that has only ever served one
tenant reports the engine telemetry itself, so the solo path loses nothing.
"""
from __future__ import annotations

import time

from repro_torch.engine.telemetry import Telemetry

__all__ = ["BasecallUnit", "LMUnit", "GenericUnit", "make_unit",
           "weighted_fill", "SHAREABLE_WORKLOADS"]

#: workloads whose engines can serve several tenants from one step
SHAREABLE_WORKLOADS = ("basecall", "lm_decode")


def weighted_fill(states, capacity: int, pull) -> dict[str, int]:
    """Move up to ``capacity`` queued entries from the member queues into
    the engine, interleaved by weight (per-member deficit counters, reset
    when a queue empties — the same isolation rule as the tick scheduler).

    ``states`` maps member name -> :class:`TenantState`; a queue entry is
    the fleet's ``(item, kwargs)`` pair and ``pull(name, entry)`` stages it,
    returning how many engine rows it became (a 2-D basecall submit is
    several rows).  Returns rows staged per member."""
    fed = {name: 0 for name in states}
    if capacity <= 0:
        return fed
    credit = {name: 0.0 for name in states}
    backlogged = [n for n, st in states.items() if st.queue]
    while capacity > 0 and backlogged:
        for name in list(backlogged):
            st = states[name]
            if not st.queue:
                credit[name] = 0.0
                backlogged.remove(name)
                continue
            credit[name] += st.weight
            while credit[name] >= 1.0 and st.queue and capacity > 0:
                rows = pull(name, st.queue.popleft()) or 1
                fed[name] += rows
                credit[name] -= 1.0
                capacity -= rows
        backlogged = [n for n in backlogged if states[n].queue]
    return fed


class _UnitBase:
    """Shared member bookkeeping for every unit shape."""

    def __init__(self, key: str, engine, workload: str):
        self.key = key
        self.engine = engine
        self.workload = workload
        self.members: list[str] = []
        self.outputs: dict[str, list] = {}       # per-tenant finished work
        self.inflight: dict[str, int] = {}       # rows staged, not yet back
        self.member_telemetry: dict[str, Telemetry] = {}
        self._ever_shared = False

    # ---------------------------------------------------------- members --
    def add_member(self, name: str) -> None:
        if self.members and not self.shareable:
            raise ValueError(
                f"workload {self.workload!r} engines cannot be shared "
                f"across tenants (unit {self.key!r} already serves "
                f"{self.members[0]!r})")
        self.members.append(name)
        self.outputs[name] = []
        self.inflight[name] = 0
        self.member_telemetry[name] = Telemetry(workload=self.workload)
        if len(self.members) > 1:
            self._ever_shared = True

    def remove_member(self, name: str) -> None:
        """Detach a member; staged in-flight rows finish and still demux
        into its (retained) outputs list."""
        self.members.remove(name)

    @property
    def shareable(self) -> bool:
        return self.workload in SHAREABLE_WORKLOADS

    def telemetry_for(self, name: str) -> Telemetry:
        """Per-tenant telemetry: the engine's own (exact, fabric included)
        while the unit serves one tenant; the member view once shared."""
        if not self._ever_shared:
            return self.engine.telemetry
        return self.member_telemetry[name]

    # ------------------------------------------------------------- ticks --
    def tick(self, states: dict) -> bool:
        """Feed from member queues, run one engine tick between the
        resume/suspend hooks; True if any work happened."""
        fed = self.feed(states)
        resume = getattr(self.engine, "resume_tick", None)
        if resume is not None:
            resume()
        t0 = time.perf_counter()
        worked = self.engine.step()
        dt = time.perf_counter() - t0
        suspend = getattr(self.engine, "suspend_tick", None)
        if suspend is not None:
            suspend()
        self.collect(dt)
        return worked or any(fed.values())

    def feed(self, states: dict) -> dict[str, int]:  # pragma: no cover
        raise NotImplementedError

    def collect(self, dt: float) -> None:
        """Demultiplex freshly finished engine outputs per member."""


class BasecallUnit(_UnitBase):
    """Cross-tenant continuous batching over one fixed-batch basecaller.

    Staging keeps at most one full batch pending inside the engine, so a
    fleet tick produces exactly the dispatch a solo engine would make for
    the same queue — the bit-identity the fleet-vs-solo oracle pins — while
    the weighted interleave decides whose rows fill the batch."""

    def feed(self, states: dict) -> dict[str, int]:
        eng = self.engine
        capacity = eng.batch - eng.scheduler.pending
        tags = self._tags

        def pull(name, entry):
            item, kw = entry
            before = eng.scheduler.pending
            eng.submit(item, **kw)
            rows = eng.scheduler.pending - before   # 2-D submit = many rows
            tags.extend([name] * rows)
            self.inflight[name] += rows
            return rows

        return weighted_fill(states, capacity, pull)

    def add_member(self, name: str) -> None:
        if not hasattr(self, "_tags"):
            import collections
            self._tags = collections.deque()
        super().add_member(name)

    def collect(self, dt: float) -> None:
        eng = self.engine
        if not eng.reads:
            return
        reads, eng.reads = eng.reads, []   # the fleet owns consumption
        dt_ms = dt * 1e3
        served: dict[str, int] = {}
        for read in reads:
            name = self._tags.popleft()
            self.outputs[name].append(read)
            self.inflight[name] -= 1
            served[name] = served.get(name, 0) + 1
            tel = self.member_telemetry[name]
            tel.completed += 1
            tel.bases += int(len(read))
            tel.samples += eng.chunk
        total = len(reads)
        for name, n in served.items():
            tel = self.member_telemetry[name]
            tel.observe_latency(dt_ms, weight=n)
            tel.wall_s += dt * (n / total)
            tel.steps += 1


class LMUnit(_UnitBase):
    """Cross-tenant continuous batching over one LM decode slot pool.
    Each request's tokens depend on its own slot's rows alone (every
    kernel of the step computes a row from that row), so a tenant's
    tokens equal its solo run's."""

    def add_member(self, name: str) -> None:
        if not hasattr(self, "_owner"):
            self._owner = {}            # id(request) -> (member, request)
        super().add_member(name)

    def feed(self, states: dict) -> dict[str, int]:
        eng = self.engine
        sched = eng.scheduler
        capacity = sched.slots - sched.n_busy - sched.pending

        def pull(name, entry):
            req, kw = entry
            self._owner[id(req)] = (name, req)
            eng.submit(req, **kw)
            self.inflight[name] += 1
            return 1

        return weighted_fill(states, capacity, pull)

    def collect(self, dt: float) -> None:
        eng = self.engine
        if not eng.finished:
            return
        finished, eng.finished = eng.finished, []
        dt_ms = dt * 1e3
        for req in finished:
            name, _ = self._owner.pop(id(req), (None, None))
            if name is None:            # submitted around the fleet: keep
                eng.finished.append(req)
                continue
            self.outputs[name].append(req)
            self.inflight[name] -= 1
            tel = self.member_telemetry[name]
            tel.completed += 1
            tel.tokens += len(req.tokens_out)
            tel.observe_latency((req.done_at - req.submitted_at) * 1e3
                                if req.done_at else dt_ms)
            tel.steps += 1
            tel.wall_s += dt


class GenericUnit(_UnitBase):
    """Single-tenant unit for engines with per-tenant physical state
    (flowcell adaptive sampling, the pathogen pipeline, any third-party
    workload).  Feeding is workload-aware but never shared."""

    def feed(self, states: dict) -> dict[str, int]:
        (name,) = self.members or ("",)
        st = states.get(name)
        if st is None or not st.queue:
            return {}
        eng = self.engine
        if self.workload == "pathogen_pipeline":
            capacity = 1    # submit() *is* the dispatch: one per tick slice
        else:
            sched = getattr(eng, "scheduler", None)
            capacity = (sched.slots - sched.pending if sched is not None
                        else len(st.queue))
        fed = {name: 0}
        while capacity > 0 and st.queue:
            item, kw = st.queue.popleft()
            eng.submit(item, **kw)
            fed[name] += 1
            capacity -= 1
        return fed


def make_unit(key: str, engine, workload: str) -> _UnitBase:
    cls = {"basecall": BasecallUnit, "lm_decode": LMUnit}.get(workload,
                                                              GenericUnit)
    return cls(key, engine, workload)
