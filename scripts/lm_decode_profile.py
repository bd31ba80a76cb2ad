#!/usr/bin/env python3
"""Where a decode step's time goes on the card: a ``torch.profiler``
trace of ``repro_torch.models.transformer.serve_step`` per architecture.

    python3 scripts/lm_decode_profile.py [--slots 8] [--max-len 512] \\
        [--steps 4] [--archs qwen3-4b,mamba2-780m]

For each architecture (published widths and depths, random bf16 params
from ``torch.Generator`` seed 0 on the card): a cache of ``--slots`` x
``--max-len`` (the ``lm_decode`` ``full`` preset's by default), rows at
positions spread over the first half, two warm-up steps, then
``--steps`` traced steps, each ending in ``torch.cuda.synchronize()``.
Prints one JSON line per architecture: the wall ms a step (host clock),
the device ms a step summed over every kernel, the idle share (1 -
device / wall; one stream, so kernels do not overlap), kernels a step,
the host's copy and sync calls a step (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaMemcpy*``: a synchronize blocks the
host, an async device-to-device copy does not), and the device time by group (the port's kernels,
cuBLAS GEMMs, everything else) with the top kernels.  Needs a CUDA
card; exits 2 without one.
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
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from lm_prefill_profile import group_of  # noqa: E402

COPY_AND_SYNC = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaMemcpy", "cudaMemcpyAsync")


def profile(torch, arch: str, slots: int, max_len: int, steps: int) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer
    dev = torch.device("cuda")
    cfg = ARCHS[arch].config()
    params, _ = transformer.init(torch.Generator(dev).manual_seed(0), cfg,
                                 device=dev)
    cache = transformer.init_cache(cfg, slots, max_len, device=dev)
    gen = torch.Generator(dev).manual_seed(1)
    pos = torch.randint(0, max_len // 2, (slots,), generator=gen,
                        device=dev)
    tok = torch.randint(1, cfg.vocab_size, (slots, 1), generator=gen,
                        device=dev)

    def step():
        nonlocal cache
        with torch.inference_mode():
            logits, cache = transformer.serve_step(params, cache, tok, pos,
                                                   cfg)
        return logits
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    walls = []
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    by_kernel = collections.Counter()
    count = collections.Counter()
    copy_sync = collections.Counter()
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name] += ev.time_range.elapsed_us() / 1e3
            count[ev.name] += 1
        elif ev.name in COPY_AND_SYNC:
            copy_sync[ev.name] += 1
    by_group = collections.Counter()
    for name, ms in by_kernel.items():
        by_group[group_of(name)] += ms
    device_ms = sum(by_kernel.values()) / steps
    wall_ms = sum(walls) / steps
    top = [{"kernel": k[:90], "ms_a_step": v / steps,
            "launches_a_step": count[k] / steps}
           for k, v in by_kernel.most_common(8)]
    del params, cache
    torch.cuda.empty_cache()
    # a trace with no device events measured nothing about the card
    idle = max(0.0, 1.0 - device_ms / wall_ms) if device_ms else None
    return {"phase": "lm_decode_profile", "arch": arch, "slots": slots,
            "max_len": max_len, "layers": cfg.num_layers, "steps": steps,
            "wall_ms_a_step": wall_ms, "wall_ms": walls,
            "device_ms_a_step": device_ms if device_ms else None,
            "idle_share": idle,
            "kernels_a_step": sum(count.values()) / steps,
            "copy_and_sync_calls_a_step": {k: v / steps
                                           for k, v in copy_sync.items()},
            "device_ms_a_step_by_group": {
                k: v / steps for k, v in by_group.most_common()},
            "top_kernels": top}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--archs", default="qwen3-4b,mamba2-780m")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lm_decode_profile: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    for arch in args.archs.split(","):
        print(json.dumps(profile(torch, arch, args.slots, args.max_len,
                                 args.steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
