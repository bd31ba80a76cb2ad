"""The rank side of ``tests/test_torch_mesh_train.py``,
``tests/test_torch_seq_decode.py``, ``tests/test_torch_families_train.py``,
``tests/test_torch_families_tp.py``, ``tests/test_torch_fsdp.py``,
``tests/test_torch_context_parallel.py`` and
``tests/test_torch_seq_decode_tp.py``:
what each rank of a (data, model) mesh runs, in a module that imports
neither JAX nor the JAX package (the ranks are spawned processes that
import this module by name).

Inputs arrive as numpy trees; every rank returns numpy results (flat
``{checkpoint key: array}`` dicts of its slice), which the parent holds
against JAX.
"""
import argparse
import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.distributed import sharding, tp
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models import attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import load_numpy_params
from repro_torch.models.registry import get_model
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import trainer

OPT = dict(lr=1e-4, warmup_steps=0, total_steps=10)


def config(arch: str) -> ModelConfig:
    """The arch's smoke config in float32."""
    return dataclasses.replace(ARCHS[arch].smoke_config(),
                               dtype=torch.float32)


def plan_for(cfg, m: int):
    """``tp.build_plan`` at model degree ``m`` (None at 1)."""
    if m == 1:
        return None
    shapes, axes = get_model(cfg).abstract_params(cfg)
    layout = Mesh(("data", "model"), (1, m))
    return tp.build_plan(axes, shapes, cfg=cfg, tp=m,
                         rules=sharding.default_rules(layout))


def mesh_plan_for(arch: str, cfg, d: int, m: int):
    """``sharding.mesh_plan`` of ``cfg`` on a ``(d, m)`` mesh under the
    arch's rules (its ``fsdp`` and overrides), as ``launch.train``'s."""
    spec = ARCHS[arch]
    shapes, axes = get_model(cfg).abstract_params(cfg)
    layout = Mesh(("data", "model"), (d, m))
    return sharding.mesh_plan(axes, shapes, cfg=cfg, mesh=layout,
                              rules=sharding.default_rules(
                                  layout, fsdp=spec.fsdp,
                                  overrides=spec.rules_overrides))


def local_params(arch: str, cfg, tree, mesh):
    """This rank's blocks of the numpy ``tree`` on ``mesh`` and the plan."""
    d, m = mesh.sizes
    plan = mesh_plan_for(arch, cfg, d, m)
    params = tp.partition_params(load_numpy_params(tree, "cpu"), plan,
                                 rank=mesh.index(("data", "model")))
    return params, plan


def flat(tree) -> dict:
    return {k: v.detach().float().numpy().copy()
            for k, _, v in tp._flatten_with_keys(tree)}


def mesh_step(rank: int, world: int, spec: dict) -> dict:
    """One ``jit_train_step`` on each arch over the ``(d, m)`` mesh of
    ``spec``: this rank's loss, gradients, new params and moments (flat,
    its slice), the clip norm, and its coordinates."""
    torch.set_num_threads(1)
    d, m = spec["mesh"]
    mesh = make_mesh((d, m), ("data", "model"))
    out = {"coords": list(mesh.coords)}
    batch = {k: torch.from_numpy(v) for k, v in spec["batch"].items()}
    ocfg = opt_mod.OptimizerConfig(**OPT)
    tcfg = trainer.TrainerConfig(grad_accum=spec["accum"])
    for arch, tree in spec["params"].items():
        cfg = config(arch)
        model = get_model(cfg)
        params, plan = local_params(arch, cfg, tree, mesh)
        loss, grads = trainer.mesh_loss_and_grads(
            model.loss, params, batch, cfg, tcfg, mesh=mesh, plan=plan)
        gnorm = opt_mod.global_norm(grads, plan, mesh=mesh)
        state = {"params": params, "opt": opt_mod.init_opt_state(params,
                                                                 ocfg)}
        step = trainer.jit_train_step(model.loss, cfg, ocfg, tcfg,
                                      mesh=mesh, plan=plan)
        new, metrics = step(state, batch)
        out[arch] = {"loss": float(loss), "step_loss": float(metrics["loss"]),
                     "gnorm": float(gnorm),
                     "step_gnorm": float(metrics["grad_norm"]),
                     "grads": flat(grads), "params": flat(new["params"]),
                     "m": flat(new["opt"]["m"]), "v": flat(new["opt"]["v"])}
    return out


def family_config(arch: str, over: dict) -> ModelConfig:
    """The arch's f32 smoke config with the fields of ``over`` replaced
    (``moe_impl``, ``moe_capacity_factor``)."""
    return dataclasses.replace(config(arch), **over)


def family_mesh_step(rank: int, world: int, spec: dict) -> dict:
    """One ``jit_train_step`` of each case of ``spec`` (``{name: (arch,
    config overrides, (d, m), micro-batches)}``) on its params and global
    batch (numpy, ``spec["params"][arch]``, ``spec["batches"][arch]``): as
    :func:`mesh_step`, with the step's ``moe_aux`` beside."""
    torch.set_num_threads(1)
    ocfg = opt_mod.OptimizerConfig(**OPT)
    out = {}
    for name, (arch, over, (d, m), accum) in spec["cases"].items():
        tcfg = trainer.TrainerConfig(grad_accum=accum)
        mesh = make_mesh((d, m), ("data", "model"))
        cfg = family_config(arch, over)
        model = get_model(cfg)
        params, plan = local_params(arch, cfg, spec["params"][arch], mesh)
        batch = {k: torch.from_numpy(v)
                 for k, v in spec["batches"][arch].items()}
        _, grads = trainer.mesh_loss_and_grads(model.loss, params, batch,
                                               cfg, tcfg, mesh=mesh,
                                               plan=plan)
        step = trainer.jit_train_step(model.loss, cfg, ocfg, tcfg, mesh=mesh,
                                      plan=plan)
        state = {"params": params,
                 "opt": opt_mod.init_opt_state(params, ocfg)}
        new, metrics = step(state, batch)
        aux = metrics.get("moe_aux")
        out[name] = {"coords": list(mesh.coords),
                     "loss": float(metrics["loss"]),
                     "gnorm": float(metrics["grad_norm"]),
                     "moe_aux": None if aux is None else float(aux),
                     "grads": flat(grads), "params": flat(new["params"]),
                     "m": flat(new["opt"]["m"]), "v": flat(new["opt"]["v"])}
    return out


def family_launch(rank: int, world: int, spec: dict) -> dict:
    """``launch.train``'s loop on this rank for each ``{name: argv}`` of
    ``spec`` (a ``--mesh`` of the world's size): its losses."""
    torch.set_num_threads(1)
    out = {}
    for name, argv in spec.items():
        args = _train_args(argv)
        d, m = launch_train.parse_mesh(args.mesh)
        res = launch_train.run(args, mesh=make_mesh((d, m), ("data",
                                                             "model")),
                               verbose=False)
        out[name] = [res["history"][s] for s in sorted(res["history"])]
    return out


def family_tp_decode(rank: int, world: int, spec: dict) -> dict:
    """Tensor-parallel decode over the world (``LMDecodeEngine(mesh=
    world)``, 2 slots) of each ``{arch: numpy params}`` of
    ``spec["params"]`` for ``spec["steps"]`` steps from tokens 3 and 5,
    each feeding back its argmax (JAX's ``decode_logits``); then
    ``serve --tp`` on this rank for each argv of ``spec["serve"]``
    (``serve._serve_rank``, what ``serve.main`` starts a rank with)."""
    from repro_torch.engine import build
    from repro_torch.launch import serve
    torch.set_num_threads(1)
    out = {}
    for arch, tree in spec["params"].items():
        cfg = config(arch)
        eng = build("lm_decode", model=get_model(cfg),
                    params=load_numpy_params(tree, "cpu"), cfg=cfg,
                    slots=2, max_len=16, mesh=world, device="cpu")
        toks = np.array([[3], [5]], np.int32)
        logits = []
        for i in range(spec["steps"]):
            eng.pos[:] = i
            logits.append(eng._step(toks))
            toks = logits[-1].argmax(-1)[:, None].astype(np.int32)
        out[arch] = logits
    for name, argv in spec["serve"].items():
        rep = serve._serve_rank(rank, world, argv)
        out[name] = {k: rep[k] for k in ("completed", "steps", "dispatches")}
    return out


def identity_backward_grads(rank: int, world: int, spec: dict) -> dict:
    """The tensor-parallel gradient as before the collectives had a
    backward: ``psum`` and ``pmax`` a ``clone`` then an in-place
    ``all_reduce`` (autograd sees the clone: the identity), the loss
    seeded 1, nothing summed after."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    arch = spec["arch"]
    cfg = config(arch)
    model = get_model(cfg)
    mesh = make_mesh((1, world), ("data", "model"))
    plan = plan_for(cfg, world)
    params = tp.partition_params(load_numpy_params(spec["tree"], "cpu"),
                                 plan, rank=rank)
    batch = {k: torch.from_numpy(v) for k, v in spec["batch"].items()}

    class _Old(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, grp):
            out = x.detach().clone()
            dist.all_reduce(out, group=grp)
            return out

        @staticmethod
        def backward(ctx, g):
            return g, None

    def old_pmax(x, grp=None):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=tp._TP_GROUP)
        return out

    saved = tp._Psum, tp.pmax
    tp._Psum, tp.pmax = _Old, old_pmax
    try:
        with tp.axis_ctx("model", world, group=mesh.group("model")):
            _, grads = trainer.loss_and_grads(model.loss, params, batch, cfg)
    finally:
        tp._Psum, tp.pmax = saved
    return flat(grads)


def _train_args(argv: list) -> argparse.Namespace:
    return launch_train.parser().parse_args(argv)


def mesh_recovery(rank: int, world: int, spec: dict) -> dict:
    """``launch.train``'s loop on this rank for each mesh of ``spec``
    (the world's size each), uninterrupted and with ``--fail-at``: the
    histories, restarts and a digest of the rank's state."""
    torch.set_num_threads(1)
    out = {}
    for name, argv in spec["runs"].items():
        args = _train_args(argv)
        d, m = launch_train.parse_mesh(args.mesh)
        res = launch_train.run(args, mesh=make_mesh(
            (d, m), ("data", "model")), verbose=False)
        state = flat(res["state"])
        out[name] = {"history": res["history"],
                     "restarts": res["restarts"], "state": state}
        if args.ckpt_dir:
            out[name]["ckpt"] = sorted(os.listdir(args.ckpt_dir))
    return out


def seq_decode(rank: int, world: int, spec: dict) -> dict:
    """``decode_attention`` over each sequence-sharded case of ``spec``:
    this rank's slice of the caches, the ``kv_seq`` rule set as JAX's
    ``launch/steps.py`` sets it; the output and the rank's caches after
    the write."""
    torch.set_num_threads(1)
    cfg = ModelConfig(**spec["cfg"])
    p = {k: torch.from_numpy(v) for k, v in spec["params"].items()}
    x = torch.from_numpy(spec["x"])
    pos = torch.from_numpy(spec["pos"]).long()
    out = {}
    for name, (shape, rule) in spec["cases"].items():
        mesh = make_mesh(shape, ("data", "model"))
        axes = (rule,) if isinstance(rule, str) else tuple(rule)
        n, i = (int(np.prod([mesh.shape[a] for a in axes])),
                mesh.index(axes))
        s_local = spec["ck"].shape[1] // n
        ck = torch.from_numpy(spec["ck"][:, i * s_local:(i + 1) * s_local]
                              .copy())
        cv = torch.from_numpy(spec["cv"][:, i * s_local:(i + 1) * s_local]
                              .copy())
        rules = sharding.default_rules(mesh, overrides={"kv_seq": rule})
        with torch.no_grad(), sharding.use_sharding(mesh, rules):
            got, ck, cv = attention.decode_attention(p, x, cfg, ck, cv, pos)
        out[name] = {"out": got.numpy(), "ck": ck.numpy(), "cv": cv.numpy(),
                     "index": i, "n": n}
    return out


def mesh_checkpoint(rank: int, world: int, spec: dict) -> dict:
    """One ``jit_train_step`` of ``spec["arch"]`` (f32 smoke) on the
    world's ``spec["mesh"]``, the state saved by
    ``checkpoint.save_on_mesh`` at step 1 into ``spec["dir"]`` and read
    back into zeros by ``restore_on_mesh``: the rank's state and what
    came back (flat, its blocks)."""
    from repro_torch.train import checkpoint as ck
    from repro_torch.utils.tree import tree_map
    torch.set_num_threads(1)
    arch = spec["arch"]
    mesh = make_mesh(spec["mesh"], ("data", "model"))
    cfg = config(arch)
    model = get_model(cfg)
    params, plan = local_params(arch, cfg, spec["params"], mesh)
    ocfg = opt_mod.OptimizerConfig(**OPT)
    batch = {k: torch.from_numpy(v) for k, v in spec["batch"].items()}
    _, grads = trainer.mesh_loss_and_grads(model.loss, params, batch, cfg,
                                           mesh=mesh, plan=plan)
    step = trainer.jit_train_step(model.loss, cfg, ocfg, mesh=mesh,
                                  plan=plan)
    state, _ = step({"params": params,
                     "opt": opt_mod.init_opt_state(params, ocfg)}, batch)
    ck.save_on_mesh(spec["dir"], state, 1, mesh=mesh, plan=plan)
    back, at = ck.restore_on_mesh(spec["dir"], tree_map(torch.zeros_like,
                                                        state),
                                  mesh=mesh, plan=plan)
    return {"state": flat(state), "back": flat(back), "step": at,
            "grads": flat(grads)}


def cp_config() -> ModelConfig:
    """The context-parallel config: minicpm-2b's f32 smoke config with 3
    heads and 3 KV heads (q_dim 48), which a model axis of 2 does not
    divide (JAX's spec splits 1.5 heads a rank), d_ff 128."""
    return dataclasses.replace(config("minicpm-2b"), num_heads=3,
                               num_kv_heads=3)


def mesh_rules(arch: str, cfg, mesh, kind: str, seq: int, batch: int, *,
               opt: bool = False) -> dict:
    """JAX's rules for a ``kind`` cell of ``batch`` x ``seq`` on ``mesh``
    (``launch.steps.make_rules``: ``act_seq`` where the heads do not
    divide the model axis; ``opt``: ``kv_seq`` over model for a
    decode)."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import steps
    return steps.make_rules(ARCHS[arch], mesh, ShapeCell(kind, kind, seq,
                                                         batch), cfg, opt=opt)


def _rules_plan(arch, cfg, mesh, rules):
    shapes, axes = get_model(cfg).abstract_params(cfg)
    return sharding.mesh_plan(axes, shapes, cfg=cfg, mesh=mesh, rules=rules)


def context_parallel(rank: int, world: int, spec: dict) -> dict:
    """Context-parallel attention on each mesh of ``spec["meshes"]`` the
    world fills, at each sequence length of ``spec["seqs"]``: this data
    rank's rows of the first block's attention (causal and not, whole
    weights), of the loss's gradients (this rank's blocks, by the mesh
    plan under the ``act_seq`` rule) and of the prefill's last logits."""
    from repro_torch.launch import steps
    torch.set_num_threads(1)
    cfg = cp_config()
    model = get_model(cfg)
    tree = spec["params"]
    attn_p = {k: torch.from_numpy(v[0]) for k, v in
              tree["blocks"]["l0"]["attn"].items()}
    out = {}
    for name, (d, m) in spec["meshes"].items():
        if d * m != world:
            continue
        mesh = make_mesh((d, m), ("data", "model"))
        di = mesh.index("data")
        for seq in spec["seqs"]:
            x = torch.from_numpy(spec["x"][seq])
            batch = {k: torch.from_numpy(v)
                     for k, v in spec["batch"][seq].items()}
            rows = x.shape[0] // d
            mine = slice(di * rows, (di + 1) * rows)
            rules = mesh_rules("minicpm-2b", cfg, mesh, "train", seq,
                               x.shape[0])
            plan = _rules_plan("minicpm-2b", cfg, mesh, rules)
            params = tp.partition_params(load_numpy_params(tree, "cpu"),
                                         plan, rank=mesh.index(("data",
                                                                "model")))
            pos = torch.arange(seq).expand(rows, seq)
            res = {"coords": list(mesh.coords), "rules": {
                k: rules[k] for k in ("act_seq", "kv_seq", "act_heads_q")}}
            with sharding.use_sharding(mesh, rules):
                with torch.no_grad():
                    for causal in (True, False):
                        res[f"attn/causal={causal}"] = (
                            attention.attention_block(
                                attn_p, x[mine], cfg, pos,
                                causal=causal).numpy())
                    with tp.mesh_ctx(mesh, plan):
                        res["logits"] = steps._prefill_body(
                            params, batch["tokens"][mine], cfg).numpy()
                loss, grads = trainer.mesh_loss_and_grads(
                    model.loss, params, batch, cfg, mesh=mesh, plan=plan)
            res.update(loss=float(loss), grads=flat(grads))
            out[f"{name}/{seq}"] = res
    return out


def seq_decode_tp(rank: int, world: int, spec: dict) -> dict:
    """The sequence-sharded decode beside tensor-parallel heads: jamba's
    f32 smoke config on each ``spec["cases"]`` mesh the world fills,
    ``kv_seq`` by ``launch.steps.make_rules(opt=True)`` (over ``model`` at
    1x2; over ``(data, model)`` where the batch is smaller than the data
    axis), this rank's blocks of the params (ZeRO-3 and experts over
    data, heads over model), its cache built by ``init_cache`` inside the
    rules (its S / n positions) and filled with its positions of
    ``spec["cache"]``; ``spec["steps"]`` ``serve_step`` s from
    ``spec["pos0"]``, each feeding back its argmax.  Returns the logits,
    tokens, the cache's shape and the rank's index along the axes."""
    torch.set_num_threads(1)
    arch = "jamba-v0.1-52b"
    cfg = config(arch)
    model = get_model(cfg)
    out = {}
    for name, ((d, m), toks0) in spec["cases"].items():
        if d * m != world:
            continue
        mesh = make_mesh((d, m), ("data", "model"))
        b, s = len(toks0), spec["cache"]["k"].shape[3]
        rules = mesh_rules(arch, cfg, mesh, "decode", s, b, opt=True)
        plan = _rules_plan(arch, cfg, mesh, rules)
        params = tp.partition_params(load_numpy_params(spec["params"], "cpu"),
                                     plan, rank=mesh.index(("data", "model")))
        local_batch = b % d == 0
        rows = b // d if local_batch else b
        r0 = mesh.index("data") * rows if local_batch else 0
        with sharding.use_sharding(mesh, rules), \
                tp.mesh_ctx(mesh, plan, batch=local_batch), torch.no_grad():
            n = attention.decode_seq_extent()
            seq_axes, _ = attention.decode_seq_axes()
            i = mesh.index(seq_axes)
            cache = model.init_cache(cfg, rows, s // n, device="cpu")
            shapes = {k: list(v.shape) for k, v in cache.items()}
            for k in ("k", "v"):
                cache[k].copy_(torch.from_numpy(
                    spec["cache"][k][:, :, r0:r0 + rows,
                                     i * (s // n):(i + 1) * (s // n)]))
            toks = torch.tensor(toks0[r0:r0 + rows],
                                dtype=torch.int32)[:, None]
            logits = []
            for t in range(spec["steps"]):
                pos = torch.full((rows,), spec["pos0"] + t, dtype=torch.long)
                lg, cache = model.serve(params, cache, toks, pos, cfg)
                logits.append(lg.numpy().copy())
                toks = lg.argmax(-1).to(torch.int32)
        out[name] = {"logits": logits, "cache_shapes": shapes, "index": i,
                     "n": n, "seq_axes": list(seq_axes), "rows": [r0, rows],
                     "rules": {k: rules[k] for k in ("kv_seq", "act_seq")}}
    return out


def run_jobs(rank: int, world: int, jobs: dict) -> dict:
    """Each ``{name: (case function, spec)}`` of ``jobs`` in turn, in one
    start of the ranks."""
    return {name: globals()[fn](rank, world, spec)
            for name, (fn, spec) in jobs.items()}
