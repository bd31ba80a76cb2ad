"""Training launcher: LM pretraining with fault tolerance
(``repro/launch/train.py``), on one card.

Runs the same loop as JAX's: deterministic data (``data/tokens.py``),
checkpoints every ``--ckpt-every`` steps, failure injection and recovery
(``--fail-at``), straggler monitoring.  The step updates the state in
place, as JAX's donated ``jit``; the LR schedule is the arch's
(``ArchSpec.schedule``: WSD for minicpm, cosine otherwise, as JAX's).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --smoke --steps 20 --ckpt-dir /tmp/lm_ckpt --fail-at 7

``--device cuda`` (the default) runs the hand kernels on the card and
raises where there is none; ``--device cpu`` runs their plain versions.
``--mesh`` other than 1x1 raises: GSPMD training over a mesh waits for
ROADMAP.md Queue 1 item 5c.  An arch whose family is not
ported (vlm, moe, encdec, hybrid) raises by name (item 6).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, WAITING_ARCHS
from repro_torch.data import tokens as tokens_mod
from repro_torch.device import resolve_device
from repro_torch.models.registry import get_model
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import fault_tolerance as ft
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import trainer as trainer_mod


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="qwen3-4b",
                    choices=sorted(ARCHS) + sorted(WAITING_ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="1x1",
                    help="DxM data x model; one card runs 1x1 only")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject simulated node failures at these steps")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand kernels) or cpu (their plain "
                         "versions)")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    if args.arch in WAITING_ARCHS:
        raise NotImplementedError(
            f"{args.arch}: the {WAITING_ARCHS[args.arch]} family is not "
            "ported yet (ROADMAP.md, Queue 1 item 6: MoE and the other "
            "families)")
    d, m = (int(x) for x in args.mesh.split("x"))
    if (d, m) != (1, 1):
        raise NotImplementedError(
            f"--mesh {args.mesh}: GSPMD training over a mesh is not "
            "ported yet (ROADMAP.md, Queue 1 item 5c); one card runs 1x1")
    dev = resolve_device(args.device)
    spec = ARCHS[args.arch]
    cfg = spec.smoke_config() if args.smoke else spec.config()
    model = get_model(cfg)

    opt_cfg = opt_mod.OptimizerConfig(
        lr=args.lr, total_steps=args.steps,
        schedule=spec.schedule,
        state_dtype=spec.optimizer_state_dtype)
    tcfg = trainer_mod.TrainerConfig(grad_accum=args.grad_accum,
                                     accum_dtype=spec.grad_accum_dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, _ = trainer_mod.init_state(model.init, cfg, opt_cfg, gen,
                                      device=dev)
    step_fn = trainer_mod.make_train_step(model.loss, cfg, opt_cfg, tcfg)
    pipe_cfg = tokens_mod.TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch)

    def batch_fn(step):
        return tokens_mod.batch_at_step(pipe_cfg, step, device=dev)

    injector = ft.FailureInjector(fail_at_steps=tuple(args.fail_at))
    monitor = ft.StragglerMonitor()
    t0 = time.time()
    state, history, restarts = ft.run_resilient(
        step_fn, state, batch_fn, n_steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        injector=injector if args.fail_at else None, monitor=monitor)
    ckpt_mod.wait_pending()
    wall = time.time() - t0
    losses = [history[s] for s in sorted(history)]
    print(f"\n{args.arch}: {args.steps} steps in {wall:.1f}s "
          f"({wall / max(args.steps, 1):.2f}s/step), "
          f"restarts={restarts}, stragglers={monitor.flagged}")
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not np.isfinite(losses).all():
        raise RuntimeError(f"non-finite loss: {losses}")
    return {"state": state, "history": history, "restarts": restarts,
            "stragglers": monitor.flagged, "wall_s": wall,
            "opt_cfg": opt_cfg}


if __name__ == "__main__":
    main()
