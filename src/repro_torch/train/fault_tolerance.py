"""Fault tolerance: failure injection, recovery, stragglers, elasticity
(``repro/train/fault_tolerance.py``).

  node crash        -> ``FailureInjector`` raises ``SimulatedFailure`` at
                       configured steps; ``run_resilient`` catches, restores
                       the last checkpoint and replays.  The token pipeline
                       is step-addressable (data/tokens.py), so recovery is
                       *bitwise identical* to an uninterrupted run (the
                       train step is deterministic on the card too).
  silent corruption -> checkpoint sha256 + NaN/inf guard on the loss; a
                       non-finite step triggers rollback-and-skip.
  stragglers        -> ``StragglerMonitor`` tracks per-step wall times and
                       flags steps slower than k * median.
  lost capacity     -> ``elastic_remesh``: on one card, the state re-placed
                       on its device; a larger mesh raises (the ranks of a
                       mesh restart from its checkpoint instead).

Under a mesh of ranks (``launch/train.py --mesh DxM``) every rank runs
``run_resilient`` with the same injector: they fail at the same step,
save together (``checkpoint.save_on_mesh``) and restore the same step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.utils.tree import leaves, tree_map


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Raises at the configured global steps (once each)."""
    fail_at_steps: tuple[int, ...] = ()
    nan_at_steps: tuple[int, ...] = ()
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and ("f", step) not in self._fired:
            self._fired.add(("f", step))
            raise SimulatedFailure(f"injected node failure at step {step}")

    def corrupt_loss(self, step: int, loss):
        if step in self.nan_at_steps and ("n", step) not in self._fired:
            self._fired.add(("n", step))
            return float("nan")
        return loss


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 3.0
    window: int = 32
    times: list = dataclasses.field(default_factory=list)
    flagged: int = 0

    def record(self, dt: float) -> bool:
        self.times.append(dt)
        hist = self.times[-self.window:]
        med = float(np.median(hist)) if hist else 0.0
        is_straggler = len(hist) >= 8 and dt > self.factor * med
        if is_straggler:
            self.flagged += 1
        return is_straggler


def run_resilient(step_fn: Callable, state, batch_fn: Callable,
                  *, n_steps: int, ckpt_dir: str, ckpt_every: int = 10,
                  injector: Optional[FailureInjector] = None,
                  max_restarts: int = 10,
                  monitor: Optional[StragglerMonitor] = None,
                  mesh=None, plan=None):
    """Run ``n_steps`` with checkpoint/restart semantics.

    step_fn(state, batch) -> (state, metrics);  batch_fn(step) -> batch.
    Returns (state, history, restarts).  On failure the loop restores the
    newest checkpoint and resumes from its step: the control flow a
    cluster supervisor drives, in-process for testability.  A checkpoint
    is written synchronously, so a step that updates the state in place
    (``make_train_step``) cannot reach it.  ``mesh`` (a bound mesh of
    more than one rank) saves and restores through
    ``checkpoint.save_on_mesh`` and ``restore_on_mesh``; ``plan`` is its
    ``sharding.mesh_plan``, whose blocks each rank holds."""
    if mesh is not None and mesh.size > 1:
        def save(state, step):
            ckpt_mod.save_on_mesh(ckpt_dir, state, step, mesh=mesh,
                                  plan=plan)

        def restore(state):
            return ckpt_mod.restore_on_mesh(ckpt_dir, state, mesh=mesh,
                                            plan=plan)
    else:
        def save(state, step):
            ckpt_mod.save(ckpt_dir, state, step)

        def restore(state):
            return ckpt_mod.restore(ckpt_dir, state)
    history: dict[int, float] = {}
    restarts = 0
    step = 0
    # resume if a checkpoint exists (cold-start restart case)
    last = ckpt_mod.latest_step(ckpt_dir) if ckpt_dir else None
    if last is not None:
        state, step = restore(state)
    while step < n_steps:
        try:
            if injector is not None:
                injector.check(step)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch_fn(step))
            loss = float(metrics["loss"])
            if injector is not None:
                loss = injector.corrupt_loss(step, loss)
            if not np.isfinite(loss):
                raise SimulatedFailure(f"non-finite loss at step {step}")
            if monitor is not None:
                monitor.record(time.perf_counter() - t0)
            history[step] = loss
            step += 1
            if ckpt_dir and step % ckpt_every == 0:
                save(state, step)
        except SimulatedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            last = ckpt_mod.latest_step(ckpt_dir) if ckpt_dir else None
            if last is None:
                raise
            state, step = restore(state)
    return state, history, restarts


def elastic_remesh(state, new_mesh, rules: dict, param_axes,
                   state_shapes):
    """Re-place a state tree onto ``new_mesh`` on one card: ``new_mesh``
    None, 1 or "auto" re-places every leaf on the device the state lives
    on (the leaves themselves where they are already there); any other
    mesh raises (a mesh of ranks restarts from its checkpoint, at the
    step-addressable batches).  The axes tree is checked against the
    state's shapes as JAX's re-placement reads it."""
    from repro_torch.train.trainer import _pad_axes, state_axes

    if not (new_mesh is None or new_mesh == "auto" or new_mesh == 1):
        raise ValueError(f"mesh={new_mesh!r}: elastic_remesh re-places a "
                         "state on one card; a mesh of ranks restarts "
                         "from its checkpoint")
    _pad_axes(state_axes(param_axes), state_shapes)
    flat = leaves(state)
    if not flat:
        return state
    dev = flat[0].device
    return tree_map(lambda t: t.to(dev), state)
