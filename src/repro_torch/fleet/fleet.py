"""The fleet facade: many flowcells, many users, one card
(``repro/fleet/fleet.py``).

:class:`Fleet` multiplexes several tenants' engines onto one card::

    fleet = Fleet()                     # device="cuda"
    fleet.add_tenant("lab-a", "adaptive_sampling", "flowcell_smoke", weight=2)
    fleet.add_tenant("lab-b", "basecall", "smoke")
    fleet.submit("lab-b", chunk_row)
    while fleet.step():
        ...
    report = fleet.drain()

Responsibilities split three ways:

  * :class:`~repro_torch.fleet.scheduler.FleetScheduler` arbitrates whose
    tick runs next (weighted DRR + priority + bounded per-tenant queues);
  * units (:mod:`repro_torch.fleet.batching`) own engines and do
    cross-tenant batching for shareable workloads;
  * this facade builds engines through the registry (each on the fleet's
    ``device``), wires shared tracing (one Chrome trace, one track per
    tenant), supports live attach / detach without draining the card, and
    rolls observability up with :meth:`Telemetry.merge` into per-tenant
    and fleet-wide summaries.

``mesh=`` (JAX's: a lane mesh, ``"auto"`` or a device count) goes to every
``adaptive_sampling`` tenant that names none, which shards its lanes over
it (``engine.adaptive.resolve_lane_mesh``).  The single-engine path
(``repro_torch.engine.build(...)``) remains the one-tenant fast path.
"""
from __future__ import annotations

import time
from typing import Any, Optional

from repro_torch.device import resolve_device
from repro_torch.engine.telemetry import Telemetry
from repro_torch.fleet.batching import SHAREABLE_WORKLOADS, make_unit
from repro_torch.fleet.scheduler import FleetScheduler, TenantState
from repro_torch.obs.trace import NULL_TRACER, as_tracer

__all__ = ["Fleet", "Tenant"]


class Tenant:
    """Handle for one tenant: submit sugar, outputs, per-tenant summary."""

    def __init__(self, fleet: "Fleet", name: str, workload: str,
                 preset: str, unit, state: TenantState):
        self.fleet = fleet
        self.name = name
        self.workload = workload
        self.preset = preset
        self.unit = unit
        self.state = state          # survives detach (scheduler returns it)
        self.draining = False

    @property
    def engine(self):
        return self.unit.engine

    @property
    def telemetry(self) -> Telemetry:
        return self.unit.telemetry_for(self.name)

    @property
    def outputs(self) -> list:
        """Finished work demultiplexed back to this tenant."""
        return self.unit.outputs.get(self.name, [])

    @property
    def shared(self) -> bool:
        return self.unit._ever_shared

    def submit(self, item: Any, **kw) -> bool:
        return self.fleet.submit(self.name, item, **kw)

    def summary(self) -> dict:
        """This tenant's rollup: engine/member telemetry + scheduling view."""
        if not self.shared and hasattr(self.engine, "summary"):
            out = dict(self.engine.summary())
        else:
            out = self.telemetry.summary()
        st = self.state
        total = max(self.fleet.scheduler.total_ticks, 1)
        out.update({
            "tenant": self.name,
            "workload": self.workload,
            "preset": self.preset,
            "weight": st.weight,
            "priority": st.priority,
            "ticks": st.ticks,
            "tick_share": st.ticks / total,
            "queue_pending": st.pending,
            "submitted": st.submitted,
            "rejected": st.rejected,
            "shared_engine": self.shared,
        })
        return out


class Fleet:
    """Multi-tenant serving over one card (``device``, default ``"cuda"``;
    ``"cpu"`` runs every tenant's plain versions), its flowcell tenants'
    lanes over ``mesh`` where one is given."""

    def __init__(self, *, device="cuda", mesh=None, trace: bool = False,
                 max_pending: int = 256):
        self.mesh = mesh
        self.device = resolve_device(device)
        self.tracer = as_tracer(trace) if trace else NULL_TRACER
        self.scheduler = FleetScheduler()
        self.tenants: dict[str, Tenant] = {}
        self.telemetry = Telemetry(workload="fleet", tracer=self.tracer)
        self._default_max_pending = max_pending
        self._units_by_key: dict[Any, Any] = {}   # share key -> unit
        self._departed = Telemetry(workload="fleet")   # dropped units' totals
        self._departed_summaries: dict[str, dict] = {}

    # ----------------------------------------------------------- tenants --
    def add_tenant(self, name: str, workload: str, preset: str = "default",
                   *, weight: float = 1.0, priority: int = 0,
                   max_pending: Optional[int] = None, share: Any = "auto",
                   engine=None, **overrides) -> Tenant:
        """Attach a tenant — live, at any tick, without draining the card.

        ``share="auto"`` packs compatible tenants (same shareable workload,
        preset and overrides) onto one engine so their requests batch into
        shared steps; pass an explicit string to force a named share
        group, or ``share=False`` for a private engine.  ``engine=`` skips
        the registry build and attaches a prebuilt engine (the
        ``registry.build(..., fleet=...)`` path lands here).
        """
        if name in self.tenants:
            raise ValueError(f"tenant {name!r} already attached")
        if max_pending is None:
            max_pending = self._default_max_pending

        unit = None
        key: Any = None
        if engine is None:
            key = self._share_key(name, workload, preset, share, overrides)
            unit = self._units_by_key.get(key)
            if unit is not None and unit.workload != workload:
                raise ValueError(
                    f"share group {key!r} already runs workload "
                    f"{unit.workload!r}, cannot join with {workload!r}")
            if unit is None:
                engine = self._build_engine(workload, preset, overrides)
        if unit is None:
            if key is None:             # prebuilt engine: private unit
                key = ("solo", name)
            unit = make_unit(str(key), engine, workload)
            if key is not None and workload in SHAREABLE_WORKLOADS:
                self._units_by_key[key] = unit

        unit.add_member(name)
        state = self.scheduler.add(name, weight=weight, priority=priority,
                                   max_pending=max_pending)
        tenant = Tenant(self, name, workload, preset, unit, state)
        self.tenants[name] = tenant
        self._relabel_track(unit)
        self.telemetry.count(f"tenant.{name}.attached")
        return tenant

    def attach(self, name: str, engine, *, workload: Optional[str] = None,
               preset: str = "attached", weight: float = 1.0,
               priority: int = 0,
               max_pending: Optional[int] = None) -> Tenant:
        """Attach a prebuilt engine as a (private) tenant."""
        workload = workload or getattr(engine, "workload", "") or "engine"
        return self.add_tenant(name, workload, preset, weight=weight,
                               priority=priority, max_pending=max_pending,
                               share=False, engine=engine)

    def remove_tenant(self, name: str, *, drain: bool = True) -> dict:
        """Detach a tenant at any tick; the rest of the fleet keeps running.

        ``drain=True`` stops intake (a flowcell tenant stops capturing new
        molecules via ``detach_source``) but lets staged work finish; the
        tenant is finalized once its engine goes idle.  ``drain=False``
        flushes in-flight device work and finalizes immediately, dropping
        its queued requests (counted).  Returns the tenant's summary (final
        for ``drain=False``, a snapshot otherwise)."""
        tenant = self.tenants[name]
        tenant.draining = True
        engine = tenant.engine
        if not tenant.shared:
            detach = getattr(engine, "detach_source", None)
            if detach is not None:
                detach()
        if drain:
            self.scheduler.wake(name)      # make sure it gets final ticks
            return tenant.summary()
        dropped = len(tenant.state.queue)
        tenant.state.queue.clear()
        if dropped:
            self.telemetry.count(f"tenant.{name}.dropped", dropped)
        if not tenant.shared:
            flush = getattr(engine, "flush", None)
            if flush is not None:
                flush()
        return self._finalize(tenant)

    # ------------------------------------------------------------ intake --
    def submit(self, tenant, item: Any, **kw) -> bool:
        """Queue one request; False when the tenant's bounded queue rejects
        it (backpressure — counted in telemetry, never silently dropped)."""
        name = tenant.name if isinstance(tenant, Tenant) else tenant
        t = self.tenants[name]
        if t.draining:
            raise ValueError(f"tenant {name!r} is detaching; submit refused")
        if getattr(t.engine, "flowcell", None) is not None:
            # mirror AdaptiveSamplingRuntime.submit: a source-fed flowcell
            # owns its channels' pore lifecycle — reads arrive by capture
            raise ValueError(
                f"tenant {name!r} is source-fed (flowcell attached): reads "
                f"arrive by pore capture, not submit()")
        ok = self.scheduler.submit(name, (item, kw))
        if not ok:
            self.telemetry.count(f"tenant.{name}.rejected")
            if self.tracer.enabled:
                pid = self.telemetry.trace_pid
                self.tracer.instant(f"reject:{name}", pid=pid,
                                    tid=self.tracer.tid(pid, "admission"),
                                    cat="fleet")
        return ok

    # ------------------------------------------------------------- ticks --
    def step(self) -> bool:
        """Run the next tenant's tick; False when the fleet is idle.

        One call serves at most one tick.  Picks that turn out to have no
        work idle that tenant (and finalize it if it was detaching) and the
        walk continues, so a single ``step`` never stalls behind empty
        tenants."""
        for _ in range(len(self.tenants) + 1):
            name = self.scheduler.pick()
            if name is None:
                return False
            tenant = self.tenants[name]
            t0 = time.perf_counter()
            worked = tenant.unit.tick(self._states_for(tenant.unit))
            self.telemetry.wall_s += time.perf_counter() - t0
            if worked:
                self.scheduler.charge(name)
                self.telemetry.steps += 1
                self.telemetry.count(f"tenant.{name}.ticks")
                self.telemetry.tick_export()
                return True
            self.scheduler.idle(name)
            if tenant.draining:
                self._finalize(tenant)
        return False

    def drain(self, max_steps: int = 1_000_000) -> dict:
        """Step until every tenant is idle; returns the fleet summary."""
        steps = 0
        while steps < max_steps and self.step():
            steps += 1
        return self.summary()

    # ----------------------------------------------------------- rollups --
    def summary(self) -> dict:
        """Fleet-wide rollup (``Telemetry.merge`` over every live engine
        plus departed tenants) with per-tenant summaries attached.

        The merged ``wall_s`` is overridden by the fleet's own measured
        wall: engines time-slice one card, so their serial tick times sum —
        taking the concurrent-engine ``max`` would overstate rates."""
        roll = Telemetry(workload="fleet")
        for unit in self._live_units():
            roll.merge(unit.engine.telemetry)
        roll.merge(self._departed)
        if self.telemetry.wall_s:
            roll.wall_s = self.telemetry.wall_s
        out = roll.summary()
        out["tenants"] = {n: t.summary() for n, t in self.tenants.items()}
        out["tenants"].update(self._departed_summaries)
        out["fleet"] = {
            "n_tenants": len(self.tenants),
            "ticks": self.scheduler.total_ticks,
            "wall_s": self.telemetry.wall_s,
            "tick_shares": self.scheduler.tick_shares(),
            "weights": {n: t.state.weight for n, t in self.tenants.items()},
            "fairness_ratio": self.scheduler.fairness_ratio(),
            "counters": dict(self.telemetry.counters),
        }
        return out

    def export_trace(self, path: str) -> dict:
        """Chrome trace with one process track per tenant (plus fabric)."""
        return self.tracer.export_chrome(path)

    # ----------------------------------------------------------- helpers --
    def _live_units(self):
        seen, units = set(), []
        for tenant in self.tenants.values():
            if id(tenant.unit) not in seen:
                seen.add(id(tenant.unit))
                units.append(tenant.unit)
        return units

    def _states_for(self, unit) -> dict[str, TenantState]:
        return {m: self.scheduler[m] for m in unit.members
                if m in self.scheduler}

    def _share_key(self, name, workload, preset, share, overrides):
        if share is False or share is None:
            return ("solo", name)
        if isinstance(share, str) and share != "auto":
            return ("named", share)
        if workload not in SHAREABLE_WORKLOADS:
            return ("solo", name)
        try:
            sig = frozenset(overrides.items())
        except TypeError:               # unhashable override: private engine
            return ("solo", name)
        return ("auto", workload, preset, sig)

    def _build_engine(self, workload: str, preset: str, overrides: dict):
        from repro_torch.engine import registry
        kw = dict(overrides)
        kw.setdefault("device", self.device)
        if (self.mesh is not None and workload == "adaptive_sampling"
                and "mesh" not in kw):
            kw["mesh"] = self.mesh
        if self.tracer.enabled and "trace" not in kw:
            kw["trace"] = self.tracer
        return registry.build(workload, preset, **kw)

    def _relabel_track(self, unit) -> None:
        if not self.tracer.enabled:
            return
        pid = getattr(unit.engine.telemetry, "trace_pid", None)
        if pid is None:
            return
        label = (f"tenant:{unit.members[0]}" if len(unit.members) == 1
                 else "tenants:" + ",".join(unit.members))
        self.tracer.relabel_pid(pid, f"{label} ({unit.workload})")

    def _finalize(self, tenant: Tenant) -> dict:
        """Remove a detaching tenant: snapshot its summary, merge telemetry
        of fully-departed engines into the fleet rollup, drop its unit
        membership and scheduler state."""
        final = tenant.summary()
        self._departed_summaries[tenant.name] = final
        if tenant.name in self.scheduler:
            self.scheduler.remove(tenant.name)
        unit = tenant.unit
        unit.remove_member(tenant.name)
        if not unit.members:            # last member out: keep its totals
            self._departed.merge(unit.engine.telemetry)
            for key, u in list(self._units_by_key.items()):
                if u is unit:
                    del self._units_by_key[key]
        del self.tenants[tenant.name]
        self.telemetry.count(f"tenant.{tenant.name}.detached")
        return final
