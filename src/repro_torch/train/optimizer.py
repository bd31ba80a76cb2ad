"""AdamW and its learning-rate schedules (``repro/train/optimizer.py``).

The update is JAX's, leaf for leaf: global-norm clipping, bias
correction, moments kept in float32 or bf16 (the update math runs in
float32 either way), and weight decay on leaves of rank >= 2 only.  The
schedules are cosine, WSD (warmup-stable-decay), linear and constant.
Every quantity is a float32 tensor on the params' device, as JAX's arrays;
``opt_state_axes`` (the sharded layout) waits for the port's tensor
parallelism.
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


def apply_update(params, grads, opt_state, cfg: OptimizerConfig):
    """One AdamW step.  Returns ``(new_params, new_state, metrics)``, new
    trees (nothing is updated in place); ``metrics`` holds ``grad_norm``
    and ``lr``."""
    step = opt_state["step"] + 1
    gnorm = tree_global_norm(grads)
    scale = (torch.clamp_max(cfg.clip_norm / (gnorm + 1e-9), 1.0)
             if cfg.clip_norm > 0 else torch.ones((), device=gnorm.device))
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.tensor(b2, device=sf.device), sf)
    dt = _STATE_DTYPES[cfg.state_dtype]

    def upd(p, g, m, v):
        g = g.float() * scale
        mf = b1 * m.float() + (1 - b1) * g
        vf = b2 * v.float() + (1 - b2) * torch.square(g)
        delta = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        if cfg.weight_decay > 0:
            decay = 1.0 if p.dim() >= 2 else 0.0
            delta = delta + (cfg.weight_decay * decay) * p.float()
        new_p = p.float() - lr * delta
        return new_p.to(p.dtype), mf.to(dt), vf.to(dt)

    out = tree_map(lambda *a: upd(*a), params, grads, opt_state["m"],
                   opt_state["v"])

    def part(i):
        return tree_map(lambda _, o: o[i], params, out)
    new_state = {"m": part(1), "v": part(2), "step": step}
    return part(0), new_state, {"grad_norm": gnorm, "lr": lr}
