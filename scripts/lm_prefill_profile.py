#!/usr/bin/env python3
"""Where a prefill's time goes on the card: one ``torch.profiler`` trace of
``repro_torch.launch.steps.prefill`` per architecture.

    python3 scripts/lm_prefill_profile.py [--seq 4096] [--archs qwen3-4b,mamba2-780m]

For each architecture (published widths and depths, random bf16 params
from ``torch.Generator`` seed 0 on the card, tokens from numpy seed 0):
one warm-up prefill, one traced prefill of 1 x ``--seq`` tokens.  Prints
one JSON line per architecture: the traced wall ms (host clock around the
prefill, ending in ``torch.cuda.synchronize()``), the device time summed
over every kernel, the idle share (1 - device time / wall; kernels run on
one stream, so they do not overlap), and the device time by group: the
port's kernels by name, cuBLAS GEMMs (the dense projections and the
unembedding) and everything else (norms, RoPE, copies, elementwise), with
the top kernels by device time.  Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_KERNELS = {"flash_attention_kernel": "flash_attention",
                "matmul_bf16_wgmma_kernel": "matmul_bf16",
                "matmul_bf16_kernel": "matmul_bf16",
                "ssd_chunk_state_kernel": "ssd_scan",
                "ssd_state_scan_kernel": "ssd_scan",
                "ssd_chunk_out_kernel": "ssd_scan"}


def group_of(name: str) -> str:
    for key, group in PORT_KERNELS.items():
        if key in name:
            return group
    low = name.lower()
    if any(w in low for w in ("gemm", "xmma", "cutlass", "gemv", "nvjet")):
        return "cublas_gemm"
    return "other"


def profile(torch, arch: str, seq: int) -> dict:
    import numpy as np
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from repro_torch.configs import ARCHS
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    dev = torch.device("cuda")
    cfg = ARCHS[arch].config()
    params, _ = transformer.init(torch.Generator(dev).manual_seed(0), cfg,
                                 device=dev)
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, seq))
    steps.prefill(params, tok, cfg)                      # warm-up
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps.prefill(params, tok, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = collections.Counter()
    count = collections.Counter()
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name] += ev.time_range.elapsed_us() / 1e3
            count[ev.name] += 1
    by_group = collections.Counter()
    for name, ms in by_kernel.items():
        by_group[group_of(name)] += ms
    device_ms = sum(by_kernel.values())
    top = [{"kernel": k[:90], "ms": v, "launches": count[k]}
           for k, v in by_kernel.most_common(8)]
    del params
    torch.cuda.empty_cache()
    # a trace with no device events measured nothing about the card
    idle = max(0.0, 1.0 - device_ms / wall_ms) if device_ms else None
    return {"phase": "lm_prefill_profile", "arch": arch, "batch": 1,
            "seq": seq, "layers": cfg.num_layers, "wall_ms": wall_ms,
            "device_ms": device_ms if device_ms else None,
            "idle_share": idle,
            "device_ms_by_group": dict(by_group.most_common()),
            "top_kernels": top}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--archs", default="qwen3-4b,mamba2-780m")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lm_prefill_profile: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    for arch in args.archs.split(","):
        print(json.dumps(profile(torch, arch, args.seq)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
