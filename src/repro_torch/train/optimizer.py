"""AdamW and its learning-rate schedules (``repro/train/optimizer.py``).

The update is JAX's, leaf for leaf: global-norm clipping (over a
(data, model) mesh of ranks, :func:`global_norm`, each rank
updating its own blocks of the params and moments), bias
correction, moments kept in float32 or bf16 (the update math runs in
float32 either way), and weight decay on leaves of rank >= 2 only.  The
schedules are cosine, WSD (warmup-stable-decay), linear and constant.
Every quantity is a float32 tensor on the params' device, as JAX's arrays.
``opt_state_axes`` names the moments' logical axes (their params').
:func:`apply_update_` writes the update into the state's own tensors, a
slice at a time (what lets a full-size LM's params, gradients and two
f32 moments fit one card); :func:`apply_update` runs it on copies.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.utils.tree import leaves, tree_global_norm, tree_map

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"        # cosine | wsd | linear | constant
    wsd_decay_frac: float = 0.1     # final fraction of steps spent decaying
    min_lr_frac: float = 0.1
    state_dtype: str = "float32"    # float32 | bfloat16 moments


def schedule_lr(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), a
    float32 tensor."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(s / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    if cfg.schedule == "cosine":
        base = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
    elif cfg.schedule == "wsd":
        # stable at 1.0 until the final decay_frac, then linear to min
        decay_start = 1.0 - cfg.wsd_decay_frac
        frac = torch.clamp((t - decay_start) / cfg.wsd_decay_frac, 0, 1)
        base = 1.0 - (1.0 - cfg.min_lr_frac) * frac
    elif cfg.schedule == "linear":
        base = 1.0 - (1.0 - cfg.min_lr_frac) * t
    elif cfg.schedule == "constant":
        base = torch.ones_like(t)
    else:
        raise ValueError(cfg.schedule)
    return cfg.lr * warm * base


def init_opt_state(params, cfg: OptimizerConfig) -> dict:
    """Zero moments in ``cfg.state_dtype`` beside each leaf, and step 0 (an
    int32 tensor on the params' device)."""
    dt = _STATE_DTYPES[cfg.state_dtype]
    first = leaves(params)
    dev = first[0].device if first else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_state_axes(param_axes):
    """Optimizer moments shard exactly like their parameters."""
    return {"m": param_axes, "v": param_axes, "step": ()}


def global_norm(grads, plan=None, *, mesh=None) -> torch.Tensor:
    """The gradient's global L2 norm.  ``mesh`` (a bound mesh of more than
    one rank, ``plan`` its ``sharding.mesh_plan`` or None) makes it the
    norm of a mesh rank's blocks: each split leaf's squares summed over
    the groups that split it, each whole one counted once
    (``tp.mesh_grad_norm_sq``), so that every rank clips by one device's
    scale."""
    if mesh is None or mesh.size == 1:
        return tree_global_norm(grads)
    from repro_torch.distributed import tp
    return torch.sqrt(tp.mesh_grad_norm_sq(grads, plan, mesh))


def _scalars(grads, opt_state, cfg: OptimizerConfig, gnorm=None):
    """The step's shared scalars: (step, grad norm, clip scale, lr, the
    two bias corrections)."""
    step = opt_state["step"] + 1
    if gnorm is None:
        gnorm = tree_global_norm(grads)
    scale = (torch.clamp_max(cfg.clip_norm / (gnorm + 1e-9), 1.0)
             if cfg.clip_norm > 0 else torch.ones((), device=gnorm.device))
    lr = schedule_lr(cfg, step)
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.beta1, device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.beta2, device=sf.device), sf)
    return step, gnorm, scale, lr, bc1, bc2


def _update(p, g, m, v, decay, scalars, cfg: OptimizerConfig):
    """One leaf's (or slice's) new param and moments, JAX's math."""
    _, _, scale, lr, bc1, bc2 = scalars
    b1, b2 = cfg.beta1, cfg.beta2
    dt = _STATE_DTYPES[cfg.state_dtype]
    g = g.float() * scale
    mf = b1 * m.float() + (1 - b1) * g
    vf = b2 * v.float() + (1 - b2) * torch.square(g)
    delta = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
    if cfg.weight_decay > 0:
        delta = delta + (cfg.weight_decay * decay) * p.float()
    new_p = p.float() - lr * delta
    return new_p.to(p.dtype), mf.to(dt), vf.to(dt)


def apply_update(params, grads, opt_state, cfg: OptimizerConfig):
    """One AdamW step.  Returns ``(new_params, new_state, metrics)``, new
    trees: :func:`apply_update_` on copies of ``params`` and ``opt_state``
    (the arguments stay as they were); ``metrics`` holds ``grad_norm`` and
    ``lr``."""
    def copy(t):
        return t.detach().clone(memory_format=torch.contiguous_format)
    return apply_update_(tree_map(copy, params), grads,
                         tree_map(copy, opt_state), cfg)


SLICE = 1 << 24     # elements a slice of the in-place update


def apply_update_(params, grads, opt_state, cfg: OptimizerConfig, *,
                  gnorm=None):
    """One AdamW step written into ``params`` and ``opt_state``'s own
    (contiguous) tensors, the step counter too: each leaf a slice of
    ``SLICE`` elements at a time, so the update's float32 temporaries stay
    a few slices whatever the leaf's size.  ``gnorm`` is the clipping
    norm where the caller has it (over a mesh, :func:`global_norm`).
    Returns ``(params, opt_state, metrics)``, the trees passed in."""
    sc = _scalars(grads, opt_state, cfg, gnorm)

    def upd_(p, g, m, v):
        decay = 1.0 if p.dim() >= 2 else 0.0
        flat = [t.view(-1) for t in (p, m, v)]
        gf = g.reshape(-1)
        for i in range(0, p.numel(), SLICE):
            part = [t[i: i + SLICE] for t in flat]
            new = _update(part[0], gf[i: i + SLICE], part[1], part[2],
                          decay, sc, cfg)
            for t, n in zip(part, new):
                t.copy_(n)
    with torch.no_grad():
        tree_map(upd_, params, grads, opt_state["m"], opt_state["v"])
        opt_state["step"].copy_(sc[0])
    return params, opt_state, {"grad_norm": sc[1], "lr": sc[3]}
