"""Dry run: trace every (arch x shape x mesh) cell on meta tensors
(``repro/launch/dryrun.py``).

JAX lowers and compiles each cell for a TPU pod on 512 host devices.  The
port builds one rank's cell (``launch.steps.build_cell``: rank 0 of a
``DxM`` mesh of H100s, its blocks of the params, state, cache and batch
as JAX's specs place them)
and traces it once on ``meta`` tensors (``launch.steps.lower_cell``), so
it needs no card and allocates nothing.  Per cell it records, into a JSON
report that ``analysis/report.py`` reads:

  * the trace's wall time (``trace_s``, where JAX had lower + compile),
  * the rank's memory (argument, output, alias, temp and peak bytes) and
    whether the peak fits one H100's 80 GB (``fits_80gb``),
  * rank 0's param and moment bytes beside JAX's spec arithmetic for the
    same cell (``state_bytes``; a cell where they differ fails),
  * the traced cost: dot FLOPs, operand + result bytes, and the recorded
    collectives with their ring-model wire bytes (``analysis/cost.py``),
  * the three roofline terms at the H100's rates and the dominant one.

A cell that needs what the port lacks (a model axis the KV heads do not
divide, say) is ``skipped`` with the reason; the exit code is non-zero if
any cell ``failed``.  ``--opt`` builds every cell under JAX's optimized
rule set (``launch.steps.make_rules(opt=True)``), and each record keeps
an ``opt`` key.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh 8x8 --out dryrun_8x8.json
  python -m repro_torch.launch.dryrun --all --mesh 8x8 --opt \
      --out dryrun_8x8_opt.json
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import traceback

from repro_torch.analysis import roofline as roofline_mod
from repro_torch.configs import ARCHS, SHAPES, applicable
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_mesh

MESHES = ("1x1", "8x8")       # one card; 64 cards, TP inside a node


def parse_mesh(text: str) -> tuple[int, int]:
    """``"DxM"`` -> (data, model)."""
    try:
        d, m = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh {text!r}: expected DxM, e.g. 8x8") from None
    if d < 1 or m < 1:
        raise ValueError(f"mesh {text!r}: extents must be >= 1")
    return d, m


def run_cell(arch: str, shape_name: str, mesh_name: str = "1x1", *,
             smoke: bool = False, opt: bool = False) -> dict:
    """One cell's record (JAX's ``run_cell`` keys; ``trace_s`` for
    ``lower_s``/``compile_s``, ``fits_80gb`` added)."""
    spec = ARCHS[arch]
    shape = SHAPES[shape_name]
    cfg = spec.smoke_config() if smoke else spec.config()
    d, m = parse_mesh(mesh_name)
    rec: dict = {
        "arch": arch, "shape": shape_name, "opt": opt, "mesh": mesh_name,
        "family": cfg.family,
        "params": cfg.param_count_estimate(),
        "active_params": roofline_mod.model_params(cfg, active=True),
    }
    ok, why = applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    try:
        mesh = make_mesh((d, m), ("data", "model"))
        try:
            cell = steps_mod.build_cell(arch, spec, shape, mesh,
                                        smoke=smoke, opt=opt)
        except steps_mod.Unsupported as e:
            rec.update(status="skipped", reason=str(e))
            return rec
        traced = steps_mod.lower_cell(cell)
        rec["trace_s"] = round(traced.trace_s, 2)
        rec["memory"] = traced.memory()
        rec["fits_80gb"] = traced.peak_bytes <= roofline_mod.HBM_CAPACITY
        rec["state_bytes"] = steps_mod.state_bytes(cell)
        if rec["state_bytes"]["rank0"] != rec["state_bytes"]["spec"]:
            raise RuntimeError(f"rank 0 holds {rec['state_bytes']} state "
                               "bytes: not JAX's spec arithmetic")
        rl = roofline_mod.analyze(
            traced.cost, cfg, shape.kind, shape.seq_len, shape.global_batch,
            (d, m), grad_accum=spec.accum_for(shape.name), fsdp=spec.fsdp,
            opt_state_bytes=2 if spec.optimizer_state_dtype == "bfloat16"
            else 4)
        rec["roofline"] = rl.as_dict()
        rec["flops_by_kernel"] = traced.cost.flops_by_kernel
        rec["status"] = "ok"
        del cell, traced
        gc.collect()
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape cell (default: all)")
    ap.add_argument("--mesh", default=None,
                    help="DxM (data x model ranks), e.g. 1x1 or 8x8; "
                         f"default: {' and '.join(MESHES)}")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' smoke configs")
    ap.add_argument("--opt", action="store_true",
                    help="JAX's optimized rule set (make_rules(opt=True))")
    ap.add_argument("--out", default=None, help="JSON report path (append)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [args.mesh] if args.mesh else list(MESHES)
    for name in meshes:
        parse_mesh(name)

    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    def key_of(r):
        return r["arch"], r["shape"], r["mesh"], bool(r.get("opt"))
    done = {key_of(r) for r in results
            if r.get("status") in ("ok", "skipped")}

    for arch in archs:
        for shape_name in shapes:
            for mesh_name in meshes:
                key = (arch, shape_name, mesh_name, args.opt)
                if key in done:
                    continue
                rec = run_cell(arch, shape_name, mesh_name,
                               smoke=args.smoke, opt=args.opt)
                results = [r for r in results if key_of(r) != key]
                results.append(rec)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    peak = rec["memory"]["peak_bytes"] / 2**30
                    dom = rec["roofline"]["dominant"]
                    extra = (f"peak={peak:.2f}GiB fits={rec['fits_80gb']} "
                             f"dom={dom} trace={rec['trace_s']}s")
                elif status == "failed":
                    extra = rec["error"][:160]
                else:
                    extra = rec["reason"][:160]
                print(f"[{status:7s}] {arch:28s} {shape_name:12s} "
                      f"{mesh_name:6s} {extra}", flush=True)
                if args.out:
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_fail = sum(r["status"] == "failed" for r in results)
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
