#!/usr/bin/env python3
"""The ``basecall`` workload's dispatch latency on one card, over enough
dispatches for a p50: the paper's CNN (seed 0) at 16 x 2048 a dispatch,
``default`` (fp32) and ``edge_int8``.

    python3 scripts/basecall_dispatch.py [--dispatches 16] [--tag NAME]

``chip_smoke.py`` phase 5 serves two dispatches a preset, so its p50 moves
by milliseconds from run to run on the host-bound int8 path; this script
serves one warm-up and then ``--dispatches`` of them.  It runs the port of
the checkout it sits in, so comparing two commits means running each
checkout's copy in turns in one call (parent, change, change, parent).
Prints one JSON line a preset.  Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("basecall_dispatch: no CUDA device is available",
              file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--dispatches", type=int, default=16)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch.engine as te
    from repro_torch.core import basecaller as bc
    from repro_torch.kernels import ref
    ref.full_fp32()
    cfg = bc.BasecallerConfig()
    params = bc.init(torch.Generator().manual_seed(0), cfg)
    for preset in ("default", "edge_int8"):
        eng = te.build("basecall", preset=preset, cfg=cfg, params=params)
        sig = np.random.default_rng(11).standard_normal(
            (eng.batch * args.dispatches, 2048)).astype(np.float32)
        eng.serve(sig[:eng.batch])                     # warm-up dispatch
        eng.telemetry = type(eng.telemetry)(workload=eng.workload)
        t0 = time.perf_counter()
        eng.serve(sig)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = eng.summary()
        print(json.dumps({
            "tag": args.tag, "card": torch.cuda.get_device_name(0),
            "preset": preset, "batch": eng.batch, "chunk": 2048,
            "dispatches": rep["dispatches"], "dispatch_p50_ms": rep["p50_ms"],
            "dispatch_p99_ms": rep["p99_ms"], "serve_wall_s": wall,
            "stage_s": {k: v for k, v in rep.items()
                        if k.startswith("stage_")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
