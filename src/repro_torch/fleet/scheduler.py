"""Weighted-fair admission of device ticks across tenants
(``repro/fleet/scheduler.py``, pure Python, the same order of picks).

The device (one card here, a mesh in JAX) is one resource; a *tick* (one
engine ``step`` — one batch of fixed-shape dispatches) is the unit of
service.  :class:`FleetScheduler` decides whose tick runs next with
**deficit round robin** over per-tenant queues, layered under a strict
**priority** ordering:

  * every tenant has a ``weight``; each pass of the round-robin ring tops
    the tenant's deficit up by its weight, and serving one tick costs 1 —
    so a tenant's long-run tick share converges to
    ``weight / sum(weights of backlogged tenants)``;
  * higher ``priority`` classes always run first; DRR applies within a
    class (a latency-critical Read-Until flowcell preempts a bulk offline
    basecall without starving it once the flowcell idles);
  * a tenant that goes idle forfeits its accumulated deficit (the standard
    DRR reset): bursty tenants cannot bank credit while idle and then
    monopolize the mesh — the isolation half of weighted fairness;
  * per-tenant **backpressure**: each tenant's fleet-level request queue is
    bounded by ``max_pending``; ``submit`` beyond it is rejected (and
    counted by the fleet), never silently dropped or unboundedly buffered.

The scheduler is engine-agnostic — it never touches device state or engine
objects, which keeps it property-testable with stub tenants (see
``tests/test_fleet_props.py``).  Each tenant's *inner* scheduling (slot
admission, recycling, bounded in-flight depth) remains the per-engine
:class:`repro_torch.engine.scheduler.SlotScheduler`; this class only
arbitrates *between* tenants.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class TenantState:
    """Per-tenant scheduling state (fleet-level queue + DRR bookkeeping)."""
    name: str
    weight: float = 1.0
    priority: int = 0
    max_pending: Optional[int] = None      # None = unbounded queue
    queue: collections.deque = dataclasses.field(
        default_factory=collections.deque)
    deficit: float = 0.0
    active: bool = True                    # eligible for picking
    ticks: int = 0                         # ticks actually served
    submitted: int = 0
    rejected: int = 0

    @property
    def pending(self) -> int:
        return len(self.queue)


class FleetScheduler:
    """Deficit-round-robin tick arbitration + bounded per-tenant queues."""

    def __init__(self):
        self._tenants: dict[str, TenantState] = {}
        self._ring: list[str] = []         # rotation order (attach order)
        self._cursor = 0
        self._fresh = True                 # cursor position not yet granted
        self.total_ticks = 0

    # ----------------------------------------------------------- tenants --
    def add(self, name: str, *, weight: float = 1.0, priority: int = 0,
            max_pending: Optional[int] = None) -> TenantState:
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already attached")
        if weight <= 0:
            raise ValueError(f"tenant weight must be positive, got {weight}")
        if max_pending is not None and max_pending <= 0:
            raise ValueError(f"max_pending must be positive, got {max_pending}")
        st = TenantState(name=name, weight=float(weight),
                         priority=int(priority), max_pending=max_pending)
        self._tenants[name] = st
        self._ring.append(name)
        return st

    def remove(self, name: str) -> TenantState:
        """Detach a tenant at any tick; the ring closes over the gap (the
        cursor is re-anchored so rotation order of the others is kept)."""
        st = self._tenants.pop(name)    # KeyError for unknown names is right
        i = self._ring.index(name)
        self._ring.pop(i)
        if i <= self._cursor:
            self._fresh = True          # cursor lands on a new position
        if i < self._cursor:
            self._cursor -= 1
        if self._ring:
            self._cursor %= len(self._ring)
        else:
            self._cursor = 0
        return st

    def __contains__(self, name: str) -> bool:
        return name in self._tenants

    def __getitem__(self, name: str) -> TenantState:
        return self._tenants[name]

    def tenants(self) -> list[TenantState]:
        return [self._tenants[n] for n in self._ring]

    # ------------------------------------------------------------ intake --
    def submit(self, name: str, item: Any) -> bool:
        """Queue ``item`` for ``name``; False (rejected, counted) when the
        tenant's bounded queue is full — the backpressure signal callers
        must handle instead of assuming infinite buffering."""
        st = self._tenants[name]
        if st.max_pending is not None and st.pending >= st.max_pending:
            st.rejected += 1
            return False
        st.queue.append(item)
        st.submitted += 1
        st.active = True                # queued work re-arms an idle tenant
        return True

    # -------------------------------------------------------------- pick --
    def pick(self) -> Optional[str]:
        """The tenant whose tick runs next, or None when nobody is active.

        Strict priority first; within the top class, deficit round robin:
        the cursor walks the ring, each *arrival* at an eligible tenant
        tops its deficit up by ``weight`` (once per arrival — a picked
        tenant served across several consecutive ``pick`` calls is not
        re-granted until the cursor leaves and returns), and the first
        tenant whose deficit covers one tick is picked.  Call
        :meth:`charge` after the tick ran, or :meth:`idle` if the pick
        turned out to have no work.
        """
        active = [n for n in self._ring if self._tenants[n].active]
        if not active:
            return None
        top = max(self._tenants[n].priority for n in active)
        eligible = {n for n in active if self._tenants[n].priority == top}
        # Bounded walk that always produces a pick: every full ring pass
        # grants each eligible tenant one quantum of ``weight``; a tenant
        # with weight w accumulates a full tick within ceil(1/w) passes.
        max_passes = max(int(1.0 / self._tenants[n].weight) + 1
                         for n in eligible) + 1
        for _ in range(max_passes * max(len(self._ring), 1)):
            name = self._ring[self._cursor]
            st = self._tenants[name]
            if name in eligible:
                if self._fresh:
                    st.deficit += st.weight
                    self._fresh = False
                if st.deficit >= 1.0:
                    return name         # cursor stays: serve until exhausted
            self._advance()
        return None                     # unreachable with positive weights

    def _advance(self) -> None:
        if self._ring:
            self._cursor = (self._cursor + 1) % len(self._ring)
        self._fresh = True

    def charge(self, name: str) -> None:
        """Account one served tick to ``name`` (deficit -= 1) and advance
        the cursor when its credit is spent."""
        st = self._tenants[name]
        st.deficit -= 1.0
        st.ticks += 1
        self.total_ticks += 1
        if st.deficit < 1.0:
            self._advance()

    def idle(self, name: str) -> None:
        """A picked tenant produced no work: deactivate it until new work
        arrives and forfeit its banked deficit (the DRR idle reset — idle
        tenants cannot hoard credit for a later burst)."""
        st = self._tenants[name]
        st.active = False
        st.deficit = 0.0
        self._advance()

    def wake(self, name: str) -> None:
        """Re-arm an idled tenant (new queued work / source became ready)."""
        self._tenants[name].active = True

    # ----------------------------------------------------------- derived --
    def tick_shares(self) -> dict[str, float]:
        """Observed fraction of all served ticks per tenant (the quantity
        the weighted-fairness property pins against the weights)."""
        total = max(self.total_ticks, 1)
        return {n: self._tenants[n].ticks / total for n in self._ring}

    def fairness_ratio(self) -> float:
        """max over backlogged tenants of observed-share / weight-share —
        1.0 is perfectly weighted-fair; large values mean someone is eating
        more of the mesh than their weight warrants."""
        tenants = [self._tenants[n] for n in self._ring]
        if not tenants or not self.total_ticks:
            return 1.0
        wsum = sum(t.weight for t in tenants)
        worst = 1.0
        for t in tenants:
            expect = t.weight / wsum
            got = t.ticks / self.total_ticks
            if expect > 0 and got > 0:
                worst = max(worst, got / expect)
        return worst
