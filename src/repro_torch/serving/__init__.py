"""Serving surface (``repro/serving``): the multi-tenant fleet facade,
plus the deprecated server shims.

New code serves through the fleet (many tenants, one card, see
:mod:`repro_torch.fleet`)::

    from repro_torch.serving import Fleet
    fleet = Fleet()
    fleet.add_tenant("lab-a", "adaptive_sampling", "flowcell_smoke")

or, for the one-tenant fast path, builds an engine directly with
``repro_torch.engine.build``.  The deprecated servers (``LMServer``,
``BasecallServer``, ``AdaptiveSamplingServer``) live in
:mod:`repro_torch.serving.legacy` and delegate to
``repro_torch.engine.build`` with a :class:`DeprecationWarning`."""
from repro_torch.fleet import Fleet, FleetScheduler, Tenant  # noqa: F401
from repro_torch.serving.legacy import (AdaptiveSamplingServer,  # noqa: F401
                                        BasecallServer, LMServer, Request)

__all__ = ["Fleet", "FleetScheduler", "Tenant", "LMServer",
           "BasecallServer", "AdaptiveSamplingServer", "Request"]
