"""Trainer: microbatch accumulation and the train step
(``repro/train/trainer.py``).

``make_train_step`` builds the update that ``launch/train.py`` runs:

  * gradient accumulation: the global batch is split into (accum, micro,
    ...) and the micro-batches run in order; each gradient is cast to
    the accumulation dtype and summed, then divided by ``accum`` and cast
    to float32, as JAX's scan; with ``accum == 1`` the gradients pass to
    the optimizer in the params' dtype;
  * the update is written into the state's own tensors
    (:func:`optimizer.apply_update_`), as JAX's ``jit_train_step``
    donates the state: a full-size LM holds one copy of its params and
    moments, not two.  A caller that needs the old state clones it.

The trainer is model-agnostic: any ``loss(params, batch, cfg) -> (loss,
aux)`` works.  Gradients come from ``torch.autograd``; the kernels on the
path carry their plain versions' gradients on the card
(``kernels/_build.py::with_plain_grad``).  ``jit_train_step`` (GSPMD
shardings over a mesh) waits for ROADMAP.md Queue 1 item 5c.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models.param import torch_dtype
from repro_torch.train import optimizer as opt_mod
from repro_torch.utils.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    grad_accum: int = 1
    accum_dtype: str = "float32"
    aux_weight: float = 0.01


def init_state(model_init, cfg, opt_cfg: opt_mod.OptimizerConfig,
               gen: torch.Generator, *, device="cuda"):
    """``({"params", "opt"}, axes)``: the model's params from ``gen`` (a
    generator on ``device``) and zero moments."""
    params, axes = model_init(gen, cfg, device=device)
    return {"params": params,
            "opt": opt_mod.init_opt_state(params, opt_cfg)}, axes


def state_axes(param_axes):
    return {"params": param_axes,
            "opt": opt_mod.opt_state_axes(param_axes)}


def _split_micro(batch, accum: int):
    def split(x):
        if x.shape[0] % accum:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"into {accum} micro-batches")
        return x.reshape((accum, x.shape[0] // accum) + tuple(x.shape[1:]))
    return tree_map(split, batch)


def loss_and_grads(loss_fn, params, batch, model_cfg):
    """``(loss, aux), grads``: the loss at ``params`` and its gradient, a
    tree like ``params`` in their dtypes (zeros for a leaf the loss does
    not use, as ``jax.grad``)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, aux = loss_fn(live, batch, model_cfg)
    flat = leaves(live)
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, got)}
    return (loss.detach(), aux), tree_map(lambda p: by_id[id(p)], live)


def make_train_step(loss_fn: Callable, model_cfg,
                    opt_cfg: opt_mod.OptimizerConfig,
                    trainer_cfg: TrainerConfig = TrainerConfig()):
    """Returns ``step(state, batch) -> (state, metrics)``, which updates
    ``state``'s tensors in place and returns them; ``metrics`` holds
    ``loss``, ``grad_norm`` and ``lr`` (tensors on the state's device)."""
    accum = trainer_cfg.grad_accum
    acc_dt = torch_dtype(trainer_cfg.accum_dtype)

    def step(state, batch):
        params = state["params"]
        if accum == 1:
            (loss, aux), grads = loss_and_grads(loss_fn, params, batch,
                                                model_cfg)
        else:
            micros = _split_micro(batch, accum)
            g_acc = tree_map(lambda p: torch.zeros(
                p.shape, dtype=acc_dt, device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=leaves(params)[0].device)
            for i in range(accum):
                micro = tree_map(lambda x: x[i], micros)
                (loss_i, _), g = loss_and_grads(loss_fn, params, micro,
                                                model_cfg)
                tree_map(lambda a, b: a.add_(b.to(acc_dt)), g_acc, g)
                loss_sum = loss_sum + loss_i
                del g
            grads = tree_map(lambda g: (g / accum).to(torch.float32), g_acc)
            del g_acc
            loss = loss_sum / accum
            aux = {}
        new_params, new_opt, om = opt_mod.apply_update_(
            params, grads, state["opt"], opt_cfg)
        return {"params": new_params, "opt": new_opt}, {"loss": loss, **om}

    return step


def jit_train_step(*_, **__):
    """JAX's GSPMD shardings over a mesh and ``jax.jit``: not ported."""
    raise NotImplementedError(
        "jit_train_step: GSPMD shardings over a mesh are not ported yet "
        "(ROADMAP.md, Queue 1 item 5c: training over a mesh); "
        "make_train_step runs on one device")


def _pad_axes(axes_tree, shape_tree):
    """Fill non-param leaves (the opt step scalar) with empty axes: each
    axes tuple whose length is not its leaf's rank becomes all None."""
    if isinstance(axes_tree, dict):
        return {k: _pad_axes(a, shape_tree[k]) for k, a in axes_tree.items()}
    shape = tuple(shape_tree.shape)
    if isinstance(axes_tree, tuple) and len(axes_tree) == len(shape):
        return axes_tree
    return tuple(None for _ in shape)
