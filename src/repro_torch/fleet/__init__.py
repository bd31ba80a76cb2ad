"""Multi-tenant serving on one card (``repro/fleet``): many flowcells, many
users.

A :class:`Fleet` time-slices device ticks across tenants (weighted-fair
deficit round robin with strict priorities, per-tenant quota and
backpressure), packs compatible ``basecall`` and ``lm_decode`` tenants
into shared steps (continuous cross-tenant batching), supports live attach/detach, and rolls
every engine's telemetry up into per-tenant and fleet-wide summaries.
"""
from repro_torch.fleet.batching import (BasecallUnit, GenericUnit,  # noqa: F401
                                        LMUnit, SHAREABLE_WORKLOADS,
                                        make_unit)
from repro_torch.fleet.fleet import Fleet, Tenant  # noqa: F401
from repro_torch.fleet.scheduler import FleetScheduler, TenantState  # noqa: F401

__all__ = ["Fleet", "Tenant", "FleetScheduler", "TenantState",
           "BasecallUnit", "LMUnit", "GenericUnit", "make_unit",
           "SHAREABLE_WORKLOADS"]
