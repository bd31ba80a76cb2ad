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
(``kernels/_build.py::with_plain_grad``).

``jit_train_step`` is the step over a (data, model) mesh of ranks, what
JAX's GSPMD shardings of the same step compute (``launch/train.py --mesh
DxM``).  Each rank holds the blocks of the params and moments that JAX's
``spec_tree`` gives it (``sharding.mesh_plan``, ``tp.partition_params``):
the model axis's slices, the ``fsdp`` archs' ``embed`` dims over data
(ZeRO-3) and the experts over data (expert parallelism).  It takes its
data coordinate's contiguous block of every micro-batch of the global
batch (JAX's micro-batch ``i`` is global rows ``i * B / accum`` on,
sharded over data) and accumulates them as above inside ``tp.mesh_ctx``:
its model group as the TP axis, its data group for the MoE layer's
global-batch statistics, overflow and token exchange, and the plan for
the leaves gathered at use, whose gradients come back reduce-scattered.
Then the gradients of the leaves an axis holds whole are summed over it
(``tp.reduce_mesh_grads``), everything is divided by the data extent,
and AdamW clips by the mesh's global norm (``optimizer.global_norm``)
and updates the rank's own blocks in place.

Both steps' metrics carry the loss's ``moe_aux`` (averaged over the
micro-batches) where the loss reports one.
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


def loss_and_grads(loss_fn, params, batch, model_cfg, *, seed: float = 1.0):
    """``(loss, aux), grads``: the loss at ``params`` and its gradient, a
    tree like ``params`` in their dtypes (zeros for a leaf the loss does
    not use, as ``jax.grad``).  ``seed`` scales the backward's seed (a
    tensor-parallel rank's share, ``1 / tp``)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, aux = loss_fn(live, batch, model_cfg)
    flat = leaves(live)
    got = torch.autograd.grad(
        loss, flat, allow_unused=True,
        grad_outputs=None if seed == 1.0 else torch.full_like(loss, seed))
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, got)}
    return (loss.detach(), aux), tree_map(lambda p: by_id[id(p)], live)


def _moe_aux(aux) -> dict:
    out = aux.get("moe_aux") if isinstance(aux, dict) else None
    return {} if out is None else {"moe_aux": out.detach()}


def _accumulated_grads(loss_fn, params, batch, model_cfg, accum: int,
                       acc_dt, seed: float = 1.0):
    """``(loss, metrics, grads)`` over ``accum`` micro-batches, as JAX's
    scan; ``metrics`` the loss's ``moe_aux`` averaged, where it has one."""
    if accum == 1:
        (loss, aux), grads = loss_and_grads(loss_fn, params, batch,
                                            model_cfg, seed=seed)
        return loss, _moe_aux(aux), grads
    micros = _split_micro(batch, accum)
    g_acc = tree_map(lambda p: torch.zeros(
        p.shape, dtype=acc_dt, device=p.device), params)
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=leaves(params)[0].device)
    aux_sum = None
    for i in range(accum):
        micro = tree_map(lambda x: x[i], micros)
        (loss_i, aux), g = loss_and_grads(loss_fn, params, micro, model_cfg,
                                          seed=seed)
        tree_map(lambda a, b: a.add_(b.to(acc_dt)), g_acc, g)
        loss_sum = loss_sum + loss_i
        aux = _moe_aux(aux)
        if aux:
            aux_sum = aux["moe_aux"] + (0 if aux_sum is None else aux_sum)
        del g
    grads = tree_map(lambda g: (g / accum).to(torch.float32), g_acc)
    del g_acc
    metrics = {} if aux_sum is None else {"moe_aux": aux_sum / accum}
    return loss_sum / accum, metrics, grads


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
        loss, aux, grads = _accumulated_grads(loss_fn, params, batch,
                                              model_cfg, accum, acc_dt)
        new_params, new_opt, om = opt_mod.apply_update_(
            params, grads, state["opt"], opt_cfg)
        return ({"params": new_params, "opt": new_opt},
                {"loss": loss, **om, **aux})

    return step


def _data_rows(x: torch.Tensor, index: int, n: int,
               accum: int = 1) -> torch.Tensor:
    """Data rank ``index`` of ``n``'s rows of the global batch: its
    contiguous block of each of the ``accum`` micro-batches, in order (JAX
    splits the global batch into micro-batches, then shards each over
    ``data``)."""
    if x.shape[0] % (n * accum):
        raise ValueError(f"global batch of {x.shape[0]} rows does not "
                         f"split over {n} data ranks x {accum} "
                         "micro-batches")
    b = x.shape[0] // (n * accum)
    x = x.reshape((accum, n * b) + tuple(x.shape[1:]))
    return x[:, index * b: (index + 1) * b].reshape(
        (accum * b,) + tuple(x.shape[2:]))


def _mesh_axes(mesh, plan):
    from repro_torch.distributed.sharding import MeshPlan
    d = mesh.shape.get("data", 1)
    m = mesh.shape.get("model", 1)
    if plan is None and m > 1:
        raise ValueError(f"a model axis of {m} needs the mesh's "
                         "sharding.mesh_plan")
    if plan is not None and not (isinstance(plan, MeshPlan)
                                 and (plan.data, plan.model) == (d, m)):
        raise ValueError(f"a {d}x{m} mesh needs its sharding.mesh_plan, "
                         f"got {plan!r:.80}")
    return d, m


def mesh_loss_and_grads(loss_fn, params, batch, model_cfg,
                        trainer_cfg: TrainerConfig = TrainerConfig(), *,
                        mesh, plan=None):
    """``(loss, grads)`` of the *global* ``batch`` on a bound ``(data,
    model)`` mesh, every rank calling together: this data rank's rows of
    each micro-batch, accumulated as :func:`make_train_step`, inside
    ``tp.mesh_ctx`` (the loss seeded ``1 / m``); then the gradients
    reduced over the axes (``tp.reduce_mesh_grads``) and the loss
    averaged over data.  ``grads`` holds this rank's blocks, each the
    whole gradient of its block; ``plan`` is the mesh's
    ``sharding.mesh_plan`` (None at model 1: every leaf whole)."""
    loss, _, grads = _mesh_loss_aux_grads(
        loss_fn, params, batch, model_cfg, trainer_cfg, mesh=mesh, plan=plan)
    return loss, grads


def _mesh_loss_aux_grads(loss_fn, params, batch, model_cfg, trainer_cfg, *,
                         mesh, plan, local_batch=False):
    """:func:`mesh_loss_and_grads` with the loss's ``moe_aux`` between
    (the global batch's already: the router reduces over data).
    ``local_batch``: ``batch`` is already this data rank's rows."""
    from repro_torch.distributed import tp
    d, m = _mesh_axes(mesh, plan)
    di = mesh.index("data") if d > 1 else 0
    accum = trainer_cfg.grad_accum
    local = batch if local_batch else tree_map(
        lambda x: _data_rows(x, di, d, accum), batch)
    with tp.mesh_ctx(mesh, plan):
        loss, aux, grads = _accumulated_grads(
            loss_fn, params, local, model_cfg, accum,
            torch_dtype(trainer_cfg.accum_dtype), seed=1.0 / m)
    tp.reduce_mesh_grads(grads, plan, mesh, extra=[loss])
    return loss, aux, grads


def jit_train_step(loss_fn: Callable, model_cfg,
                   opt_cfg: opt_mod.OptimizerConfig,
                   trainer_cfg: TrainerConfig = TrainerConfig(), *, mesh,
                   plan=None, local_batch: bool = False):
    """The train step over a ``(data, model)`` mesh of ranks (JAX's
    ``jit_train_step`` with GSPMD shardings): ``step(state, batch) ->
    (state, metrics)`` with ``state`` this rank's slice (its params cut by
    ``tp.partition_params(params, plan, rank=mesh.index(("data",
    "model")))`` and moments beside them) and ``batch`` the *global* batch
    (:func:`mesh_loss_and_grads`).  AdamW clips by the mesh's global norm
    and updates the rank's blocks in place.  ``plan`` is the mesh's
    ``sharding.mesh_plan`` (needed where the model axis exceeds 1).
    ``local_batch=True`` takes this data rank's rows (its block of each
    micro-batch, in order) in place of the global batch (the dry run's
    cells, which hold one rank's arguments).
    Every rank of the mesh calls this, and each step, together; a 1x1
    mesh is :func:`make_train_step`."""
    from repro_torch.launch.mesh import bind
    if mesh.size == 1:
        return make_train_step(loss_fn, model_cfg, opt_cfg, trainer_cfg)
    mesh = bind(mesh)
    _mesh_axes(mesh, plan)

    def step(state, batch):
        params = state["params"]
        loss, aux, grads = _mesh_loss_aux_grads(
            loss_fn, params, batch, model_cfg, trainer_cfg, mesh=mesh,
            plan=plan, local_batch=local_batch)
        gnorm = opt_mod.global_norm(grads, plan, mesh=mesh)
        new_params, new_opt, om = opt_mod.apply_update_(
            params, grads, state["opt"], opt_cfg, gnorm=gnorm)
        return ({"params": new_params, "opt": new_opt},
                {"loss": loss, **om, **aux})

    return step


def _pad_axes(axes_tree, shape_tree):
    """Fill non-param leaves (the opt step scalar) with empty axes: each
    axes tuple whose length is not its leaf's rank becomes all None."""
    if isinstance(axes_tree, dict):
        return {k: _pad_axes(a, shape_tree[k]) for k, a in axes_tree.items()}
    shape = tuple(shape_tree.shape)
    if isinstance(axes_tree, tuple) and len(axes_tree) == len(shape):
        return axes_tree
    return tuple(None for _ in shape)
