#!/usr/bin/env python3
"""Seconds ``nvcc`` takes to build each kernel source alone, one at a time,
with the port's own flags (``repro_torch.kernels._build``), and each
kernel's registers and spills from ``-Xptxas -v``.

    python3 scripts/build_times.py [--csrc DIR] [--only ssd_scan,...]

``--csrc`` builds another tree's sources (for example a parent commit
unpacked under ``build/``) into ``build/build_times/<hash>/``; the
checkout's own are the default.  Needs ``nvcc`` (the machine with the
card); prints one JSON line per source.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", default=str(_build._CSRC))
    ap.add_argument("--only", default=",".join(_build.SOURCES))
    args = ap.parse_args()
    csrc = Path(args.csrc).resolve()
    _build._CSRC = csrc
    tag = hashlib.sha256(str(csrc).encode()).hexdigest()[:8]
    _build.BUILD_DIR = Path(ROOT) / "build" / "build_times" / tag
    for name in args.only.split(","):
        lib = _build._lib_path(name)
        if lib.exists():
            lib.unlink()
        t0 = time.perf_counter()
        _build.build_all((name,))
        print(json.dumps({
            "source": f"{name}.cu", "csrc": str(csrc),
            "build_s": time.perf_counter() - t0,
            "ptxas": _build.ptxas_summary(_build.PTXAS_LOG[name])}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
