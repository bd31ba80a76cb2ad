#!/usr/bin/env python3
"""Where one f32 smoke train step differs between the card and the CPU,
leaf by leaf.

    python3 scripts/lm_train_step_diff.py [--seqs 64,128]

For each f32 smoke config of ``chip_smoke.py``'s ``lm_parity_f32`` (the
same params, seed 0, and the same token batch, 4 x seq): the gradients
(``trainer.loss_and_grads``) and one ``make_train_step`` step (AdamW at
``chip_smoke.LM_TRAIN_OPT``) on the card and on the CPU.  Prints one JSON
line per config and length: ``chip_smoke.train_step_excess`` (the loss,
the gradients, and the card's new state against the CPU's AdamW on the
card's gradients, by ``chip_smoke.LM_TRAIN_RULE``), and the three leaves
whose updated params differ most from the CPU's whole step against 1e-4
of the leaf's largest entry (``param_over_leaf_bar``), each with the
entry's value and clipped gradient on both sides.  Needs a CUDA card;
exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def leaf_lines(cpu, card, cpu_norm) -> list:
    """Per leaf: the updated param's largest difference over 1e-4 of the
    leaf's largest entry, at the entry where it is largest.  ``cpu`` and
    ``card`` are ``(flat gradients, flat params)``."""
    cpu_g, cpu_p = cpu
    card_g, card_p = card
    clip = min(1.0, 1.0 / (cpu_norm + 1e-9))
    rows = []
    for key in cpu_p:
        w, g = cpu_p[key], card_p[key]
        d = (g - w).abs()
        i = int(d.argmax())
        gw = cpu_g[key] * clip
        rows.append({
            "leaf": key, "leaf_max": w.abs().max().item(),
            "param_over_leaf_bar": (d.max() / (1e-4 * w.abs().max())).item(),
            "param_cpu": w.reshape(-1)[i].item(),
            "param_card": g.reshape(-1)[i].item(),
            "clipped_grad_cpu": gw.reshape(-1)[i].item(),
            "clipped_grad_card": (card_g[key] * clip).reshape(-1)[i].item(),
            "grad_over_leaf_max": ((card_g[key] - cpu_g[key]).abs().max()
                                   / cpu_g[key].abs().max()).item()})
    rows.sort(key=lambda r: -r["param_over_leaf_bar"])
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seqs", default="64,128")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lm_train_step_diff: no CUDA device is available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import basecaller as bc
    from repro_torch.data import tokens
    from repro_torch.kernels import ref
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_model
    from repro_torch.train import checkpoint
    from repro_torch.train import trainer
    ref.full_fp32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    from repro_torch.utils.tree import tree_map

    def flat(tree):
        return {k: v.cpu() for k, v in checkpoint._flatten(tree)}
    for label, cfg in cs.f32_parity_configs():
        params, _ = transformer.init(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
        for seq in (int(s) for s in args.seqs.split(",")):
            pipe = tokens.TokenPipelineConfig(
                vocab_size=cfg.vocab_size, seq_len=seq,
                global_batch=cs.LM_TRAIN_SMOKE_BATCH)
            out, norm = {}, {}
            for name, dev in (("cpu", torch.device("cpu")),
                              ("cuda", torch.device("cuda"))):
                # a copy: the step updates the state in place
                p = tree_map(torch.clone, bc.params_to(params, dev))
                batch = tokens.batch_at_step(pipe, 0, device=dev)
                _, grads = trainer.loss_and_grads(get_model(cfg).loss, p,
                                                  batch, cfg)
                state, step = cs.lm_train_state(torch, cfg, p)
                new, m = step(state, batch)
                out[name] = (float(m["loss"]),
                             tree_map(lambda t: t.cpu(), grads),
                             tree_map(lambda t: t.cpu(), new))
                norm[name] = float(m["grad_norm"])
            rule = cs.train_step_excess(torch, params, out["cuda"],
                                        out["cpu"])
            rows = leaf_lines(*((flat(out[n][1]), flat(out[n][2]["params"]))
                                for n in ("cpu", "cuda")), norm["cpu"])
            print(json.dumps({"config": label, "seq": seq, **rule,
                              "worst_leaves": rows[:3]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
