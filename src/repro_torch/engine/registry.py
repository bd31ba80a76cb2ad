"""Workload registry + the public entry point ``repro_torch.engine.build``
(``repro/engine/registry.py``).

    engine = repro_torch.engine.build("adaptive_sampling", preset="smoke",
                                      device="cpu")

``build`` resolves the workload's builder, starts from the named preset's
keywords and applies ``**overrides`` on top.  Workload modules import
lazily.  All five of JAX's workloads are ported: ``adaptive_sampling``,
``basecall``, ``pathogen_pipeline``, ``field_aggregator`` and
``lm_decode``.
"""
from __future__ import annotations

import importlib
from typing import Any, Callable, Optional

_WORKLOAD_MODULES: dict[str, str] = {
    "adaptive_sampling": "repro_torch.engine.adaptive",
    "basecall": "repro_torch.engine.basecall",
    "pathogen_pipeline": "repro_torch.engine.pipeline",
    "field_aggregator": "repro_torch.field.aggregator",
    "lm_decode": "repro_torch.engine.lm",
}

_BUILDERS: dict[str, Callable[..., Any]] = {}
_PRESETS: dict[str, dict[str, dict]] = {}


class UnknownWorkloadError(ValueError, KeyError):
    """Unknown workload or preset name (a ``ValueError`` naming the
    available options, and a ``KeyError``)."""

    def __str__(self) -> str:
        return self.args[0] if self.args else ""


def register(workload: str, presets: Optional[dict[str, dict]] = None):
    """Decorator: register ``fn`` as the builder for ``workload``."""
    def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
        _BUILDERS[workload] = fn
        table = dict(presets or {})
        table.setdefault("default", {})
        _PRESETS[workload] = table
        return fn
    return deco


def _resolve(workload: str) -> Callable[..., Any]:
    if workload not in _BUILDERS and workload in _WORKLOAD_MODULES:
        importlib.import_module(_WORKLOAD_MODULES[workload])
    if workload not in _BUILDERS:
        raise UnknownWorkloadError(
            f"unknown workload {workload!r}; available: {sorted(workloads())}")
    return _BUILDERS[workload]


def workloads() -> list[str]:
    """All buildable workload names."""
    return sorted(set(_WORKLOAD_MODULES) | set(_BUILDERS))


def presets(workload: str) -> dict[str, dict]:
    """Preset table for a workload (triggers its lazy import)."""
    _resolve(workload)
    return {k: dict(v) for k, v in _PRESETS[workload].items()}


def build(workload: str, preset: str = "default", *, fleet=None,
          tenant: Optional[str] = None, weight: float = 1.0,
          priority: int = 0, **overrides: Any):
    """Construct an engine from a preset plus overrides.  Every workload
    takes ``device=`` (default ``"cuda"``; ``"cpu"`` runs the plain
    PyTorch versions of the kernels) and ``trace=`` (True, or a shared
    :class:`repro_torch.obs.trace.Tracer`).

    ``fleet=`` attaches the built engine to a
    :class:`repro_torch.fleet.Fleet` as tenant ``tenant`` (default: the
    workload name) with the given ``weight``/``priority`` and returns the
    :class:`~repro_torch.fleet.Tenant` handle instead of the engine."""
    builder = _resolve(workload)
    table = _PRESETS[workload]
    if preset not in table:
        raise UnknownWorkloadError(
            f"unknown preset {preset!r} for workload "
            f"{workload!r}; available: {sorted(table)}")
    kwargs = dict(table[preset])
    kwargs.update(overrides)
    engine = builder(**kwargs)
    if fleet is None:
        return engine
    return fleet.attach(tenant or workload, engine, workload=workload,
                        preset=preset, weight=weight, priority=priority)
