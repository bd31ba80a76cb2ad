"""The compute fabric, trimmed for the port: the tensor's device picks the
target, and every dispatch is counted.

Targets
-------
``cuda``       the hand-written Hopper kernel (a tensor on a CUDA device)
``reference``  the plain PyTorch version (a tensor on the CPU)
``meta``       the plain version on ``meta`` tensors, which computes shapes
               only (:func:`meta_kernel`): the tracing device of the dry
               run (``analysis.cost``), asked for by name, never a fallback

There is no ``auto`` that degrades and no shape-based fallback: a shape the
Hopper kernel cannot take raises on CUDA.  The TPU tile floors of the JAX
fabric (``m_lt_8``, ``n_lt_128``, ``cout_lt_128``, ``cin_lt_8``,
``lanes_lt_8``, ``tpu_channel_align``) have no counterpart here.

Counters
--------
Every dispatch is counted under ``fabric.dispatch.<op>.<target>`` — the
JAX fabric's key format (``repro/kernels/fabric.py``), so engine summaries
compare key for key.  Counts go to a process-wide counter and to every
:class:`ScopedCounters` entered with :func:`scoped` (a contextvar scope),
so each engine's ``Telemetry`` sees only its own dispatches.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import threading

import torch


def target_of(t: torch.Tensor) -> str:
    """The execution target a tensor's device selects."""
    if t.device.type == "cuda":
        return "cuda"
    if t.device.type == "cpu":
        return "reference"
    if t.device.type == "meta":
        return "meta"
    raise ValueError(f"no kernel target for device {t.device}")


# the dry run's accounting of a kernel on meta tensors (analysis.cost sets
# it around one traced cell); None runs the plain version bare
_META_HOOK = None


@contextlib.contextmanager
def meta_hook(hook):
    """Route every :func:`meta_kernel` call in this block through
    ``hook(op, plain, inputs)``, which must return ``plain(*inputs)``."""
    global _META_HOOK
    prev, _META_HOOK = _META_HOOK, hook
    try:
        yield
    finally:
        _META_HOOK = prev


def meta_kernel(op: str, plain, *inputs):
    """Kernel ``op`` on meta tensors: its plain version, which on ``meta``
    computes the output's shape and dtype only, run with autograd off as
    the launch is (a wrapper puts this where the launch would go, so
    ``_build.with_plain_grad`` gives it the plain version's gradient).
    Inside :func:`meta_hook` the hook runs it, so that a dry run counts
    the kernel as one unit: its FLOPs, its inputs and outputs in device
    memory, and none of the plain version's intermediates, which the
    kernel keeps on chip."""
    with torch.no_grad():
        if _META_HOOK is None:
            return plain(*inputs)
        return _META_HOOK(op, plain, inputs)


class ScopedCounters:
    """A per-engine counter scope: receives a copy of every bump recorded
    while it is active (``with fabric.scoped(scope): ...``).

    ``listener`` (optional) is called with the raw ``((key, n), ...)``
    items on every bump: the span tracer's fabric-dispatch hook."""

    __slots__ = ("counts", "listener", "_lock")

    def __init__(self, listener=None):
        self.counts = collections.Counter()
        self.listener = listener
        self._lock = threading.Lock()

    def bump(self, items: tuple) -> None:
        with self._lock:
            for key, n in items:
                self.counts[key] += n
        if self.listener is not None:
            self.listener(items)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.counts)

    def clear(self) -> None:
        with self._lock:
            self.counts.clear()


_COUNTS: collections.Counter = collections.Counter()
_COUNTS_LOCK = threading.Lock()
_SCOPES: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repro_torch_fabric_scopes", default=())


@contextlib.contextmanager
def scoped(scope: ScopedCounters):
    """Attribute every counter bump in this block to ``scope`` as well as
    to the process-wide counters.  Re-entrant: an already active scope is
    not entered twice, so nested engine internals never double-count."""
    stack = _SCOPES.get()
    if scope in stack:
        yield scope
        return
    token = _SCOPES.set(stack + (scope,))
    try:
        yield scope
    finally:
        _SCOPES.reset(token)


def record(key: str, n: int = 1) -> None:
    """Increment an arbitrary ``fabric.*`` counter."""
    with _COUNTS_LOCK:
        _COUNTS[key] += n
    scopes = _SCOPES.get()
    if scopes:
        items = ((key, n),)
        for scope in scopes:
            scope.bump(items)


def dispatch(op: str, t: torch.Tensor) -> str:
    """Resolve and count the target for one call of ``op`` on tensor
    ``t``; returns the target name."""
    target = target_of(t)
    record(f"fabric.dispatch.{op}.{target}")
    return target


def counters() -> dict:
    """Snapshot of the process-wide fabric counters."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def counters_delta(baseline: dict) -> dict:
    """Counters accumulated since ``baseline`` (a :func:`counters`
    snapshot); non-positive entries are dropped."""
    now = counters()
    return {k: v - baseline.get(k, 0) for k, v in now.items()
            if v - baseline.get(k, 0) > 0}
