"""Training launcher: LM pretraining with fault tolerance
(``repro/launch/train.py``), on one card or a mesh of ranks.

Runs the same loop as JAX's: deterministic data (``data/tokens.py``),
checkpoints every ``--ckpt-every`` steps, failure injection and recovery
(``--fail-at``), straggler monitoring.  The step updates the state in
place, as JAX's donated ``jit``; the LR schedule is the arch's
(``ArchSpec.schedule``: WSD for minicpm, cosine otherwise, as JAX's).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --smoke --steps 20 --ckpt-dir /tmp/lm_ckpt --fail-at 7

``--device cuda`` (the default) runs the hand kernels on the card and
raises where there is none; ``--device cpu`` runs their plain versions.
``--mesh DxM`` starts ``D * M`` gloo ranks (``distributed.launch.run``;
on the card rank ``r`` takes ``cuda:r % device_count``, so ranks share a
card), each on its coordinates of a (data, model) mesh and holding the
blocks of the params and moments that JAX's rules give it
(``sharding.mesh_plan`` under :func:`mesh_rules`): the model axis
tensor-parallel (or, where the heads do not divide it, context-parallel
attention: each model rank a block of the sequence), the ``fsdp`` archs'
params and moments ZeRO-3 over data, the experts spread over data
(expert parallelism), the data axis averaging the gradients
(``trainer.jit_train_step``), the checkpoint ``full`` from rank 0 where
every rank holds the whole state, else ``sharded`` a rank
(``checkpoint.save_on_mesh``), and every rank restarting from the same
step after ``--fail-at``.  Rank 0 prints JAX's
lines, and ``main`` returns its summary.  Every arch trains, with JAX's
batches by family (``family_batch``): the vlm's zero patch embeddings,
the encdec's zero frames with its tokens cut to ``seq_len // 8``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.data import tokens as tokens_mod
from repro_torch.device import resolve_device
from repro_torch.models.registry import get_model
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import fault_tolerance as ft
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import trainer as trainer_mod
from repro_torch.utils.tree import leaves


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="qwen3-4b",
                    choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (a multiple "
                         "of the block pattern), widths unchanged")
    ap.add_argument("--mesh", default="1x1",
                    help="DxM data x model, e.g. 2x2: D * M ranks")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject simulated node failures at these steps")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand kernels) or cpu (their plain "
                         "versions)")
    return ap


def parse_mesh(text: str) -> tuple[int, int]:
    try:
        d, m = (int(x) for x in text.split("x"))
    except ValueError:
        raise ValueError(f"--mesh {text!r}: expected DxM, e.g. 2x2") from None
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {text!r}: both extents must be >= 1")
    return d, m


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    d, m = parse_mesh(args.mesh)
    if d * m == 1:
        return run(args)
    resolve_device(args.device)
    # the layout's errors (heads, d_ff not divisible) before any rank
    _plan(args, _config(args))
    from repro_torch.distributed import launch
    ranks = launch.run(train_rank, d * m, args=(args,))
    out = dict(ranks[0])
    out["rank_state_sha256"] = [r["state_sha256"] for r in ranks]
    out["rank_peak_gb"] = [r["peak_gb"] for r in ranks]
    out["rank_step_peak_gb"] = [r["step_peak_gb"] for r in ranks]
    return out


def _config(args):
    spec = ARCHS[args.arch]
    cfg = spec.smoke_config() if args.smoke else spec.config()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
        if cfg.num_layers % len(cfg.block_pattern) or cfg.num_layers < 1:
            raise ValueError(f"--layers {args.layers}: {cfg.name}'s block "
                             f"pattern is {len(cfg.block_pattern)} layers")
    return cfg


def mesh_rules(args, cfg) -> dict:
    """The ``--mesh``'s rules: JAX's for a train cell
    (``launch.steps.make_rules``: the arch's ``fsdp`` and overrides, and
    ``act_seq`` over model where the heads do not divide it).  JAX's
    launcher runs the same function under GSPMD on any mesh; the port
    realises its ``act_seq`` as context-parallel attention
    (``attention._context_parallel``)."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import Mesh
    layout = Mesh(("data", "model"), parse_mesh(args.mesh))
    shape = ShapeCell("train", "train", args.seq_len, args.global_batch)
    return steps.make_rules(ARCHS[args.arch], layout, shape, cfg)


def _plan(args, cfg):
    """The ``--mesh``'s ``sharding.mesh_plan`` under :func:`mesh_rules`."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import Mesh
    shapes, axes = get_model(cfg).abstract_params(cfg)
    layout = Mesh(("data", "model"), parse_mesh(args.mesh))
    return sharding.mesh_plan(axes, shapes, cfg=cfg, mesh=layout,
                              rules=mesh_rules(args, cfg))


def family_batch(batch: dict, cfg, seq_len: int) -> dict:
    """JAX's batch for ``cfg``'s family (``repro/launch/train.py``) from a
    token batch: a vlm adds zero ``input_embeds`` (B, frontend_tokens,
    d_model) in bf16; an encdec takes zero ``frames`` (B, seq_len,
    d_model) in bf16 and the first ``seq_len // 8`` tokens and labels."""
    tok = batch["tokens"]
    if cfg.family == "vlm":
        batch = dict(batch, input_embeds=torch.zeros(
            (tok.shape[0], cfg.frontend_tokens, cfg.d_model),
            dtype=torch.bfloat16, device=tok.device))
    if cfg.family == "encdec":
        batch = {"frames": torch.zeros((tok.shape[0], seq_len, cfg.d_model),
                                       dtype=torch.bfloat16,
                                       device=tok.device),
                 "tokens": tok[:, : seq_len // 8],
                 "labels": batch["labels"][:, : seq_len // 8]}
    return batch


def train_rank(rank: int, world: int, args) -> dict:
    """One rank of ``--mesh DxM`` (``distributed.launch.run``'s target):
    its summary with a digest of its state in place of the state."""
    import hashlib

    from repro_torch.launch.mesh import make_mesh
    d, m = parse_mesh(args.mesh)
    if args.device != "cpu":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        args = argparse.Namespace(**{**vars(args), "device": str(dev)})
    mesh = make_mesh((d, m), ("data", "model"))
    out = run(args, mesh=mesh, verbose=rank == 0)
    h = hashlib.sha256()
    for t in leaves(out.pop("state")):
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    out["state_sha256"] = h.hexdigest()
    return out


def run(args, mesh=None, verbose: bool = True) -> dict:
    """The training loop of ``args`` on one device, or as this rank of a
    bound ``mesh``; returns the summary with this rank's ``state``."""
    dev = resolve_device(args.device)
    spec = ARCHS[args.arch]
    cfg = _config(args)
    if cfg.family == "vlm" and args.seq_len < cfg.frontend_tokens:
        # JAX's launcher fails here on a shape mismatch in RoPE
        raise ValueError(
            f"--seq-len {args.seq_len}: {cfg.name}'s {cfg.frontend_tokens} "
            "patch embeddings take the first positions of each row; give "
            "at least as many")
    model = get_model(cfg)

    opt_cfg = opt_mod.OptimizerConfig(
        lr=args.lr, total_steps=args.steps,
        schedule=spec.schedule,
        state_dtype=spec.optimizer_state_dtype)
    tcfg = trainer_mod.TrainerConfig(grad_accum=args.grad_accum,
                                     accum_dtype=spec.grad_accum_dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    plan = None
    if mesh is None:
        state, _ = trainer_mod.init_state(model.init, cfg, opt_cfg, gen,
                                          device=dev)
    else:
        # the single-device init, then this rank's blocks of it (JAX's
        # params under GSPMD are the same arrays, sharded)
        from repro_torch.distributed import tp
        plan = _plan(args, cfg)
        params, _ = model.init(gen, cfg, device=dev)
        params = tp.partition_params(params, plan,
                                     rank=mesh.index(("data", "model")))
        state = {"params": params,
                 "opt": opt_mod.init_opt_state(params, opt_cfg)}
    if dev.type == "cuda":
        # the whole params of the init are gone: the loop's own peak
        torch.cuda.empty_cache()
        init_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    if mesh is None:
        step_fn = trainer_mod.make_train_step(model.loss, cfg, opt_cfg, tcfg)
    else:
        from repro_torch.distributed import sharding
        mesh_step = trainer_mod.jit_train_step(model.loss, cfg, opt_cfg, tcfg,
                                               mesh=mesh, plan=plan)
        rules = mesh_rules(args, cfg)

        def step_fn(state, batch):
            # the rules the attention reads (act_seq), on the bound mesh
            with sharding.use_sharding(mesh, rules):
                return mesh_step(state, batch)
    pipe_cfg = tokens_mod.TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch)

    def batch_fn(step):
        return family_batch(tokens_mod.batch_at_step(pipe_cfg, step,
                                                     device=dev),
                            cfg, args.seq_len)

    injector = ft.FailureInjector(fail_at_steps=tuple(args.fail_at))
    monitor = ft.StragglerMonitor()
    t0 = time.time()
    state, history, restarts = ft.run_resilient(
        step_fn, state, batch_fn, n_steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        injector=injector if args.fail_at else None, monitor=monitor,
        mesh=mesh, plan=plan)
    ckpt_mod.wait_pending()
    wall = time.time() - t0
    losses = [history[s] for s in sorted(history)]
    if verbose:
        print(f"\n{args.arch}: {args.steps} steps in {wall:.1f}s "
              f"({wall / max(args.steps, 1):.2f}s/step), "
              f"restarts={restarts}, stragglers={monitor.flagged}")
        print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not np.isfinite(losses).all():
        raise RuntimeError(f"non-finite loss: {losses}")
    return {"state": state, "history": history, "restarts": restarts,
            "stragglers": monitor.flagged, "wall_s": wall,
            "step_s": list(monitor.times), "opt_cfg": opt_cfg,
            "mesh": [1, 1] if mesh is None else list(mesh.sizes),
            "peak_gb": (max(init_peak, torch.cuda.max_memory_allocated(dev))
                        / 2 ** 30 if dev.type == "cuda" else None),
            "step_peak_gb": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                             if dev.type == "cuda" else None)}


if __name__ == "__main__":
    main()
