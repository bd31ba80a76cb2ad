"""``chip_smoke.py``'s phase ``mesh`` alone, on the card: builds the
kernels, runs the unmeshed full-width flowcells and the field (the
references the lane meshes are held to) after the dry run's cells (the
predicted peaks of the fsdp runs), then the mesh phase; its JSON lines
as ``chip_smoke.py`` prints them.

    python3 scripts/mesh_phase.py        # from the root of a checkout
    python3 scripts/mesh_phase.py --fsdp-full grok-1-314b:1 --fsdp-steps 3
    python3 scripts/mesh_phase.py --cp-only

``--cp-only`` runs the phase's context-parallel and sequence-sharded
decode parts alone (``chip_smoke.cp_jobs`` and ``cp_lines``: the smoke
steps at 1x2 and 2x2, jamba's 2x2 decode, minicpm-2b's ``launch.train
--mesh 1x8``, the causal Sq < Skv flash shapes).
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.analysis.roofline import peaks_for  # noqa: E402
from repro_torch.core import basecaller as bc  # noqa: E402
from repro_torch.engine.base import quantize_edge_params  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402



def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fsdp-full", default=None,
                    help="ARCH:LAYERS,... in place of chip_smoke.py's "
                         "FSDP_FULL (the full-width runs at --mesh 2x1)")
    ap.add_argument("--fsdp-steps", type=int, default=None,
                    help="their steps, in place of FSDP_FULL_STEPS")
    ap.add_argument("--cp-only", action="store_true",
                    help="only the context-parallel parts")
    args = ap.parse_args()
    if args.fsdp_full:
        cs.FSDP_FULL = tuple((a, int(n)) for a, n in (
            item.split(":") for item in args.fsdp_full.split(",")))
    if args.fsdp_steps:
        cs.FSDP_FULL_STEPS = args.fsdp_steps
    ref.full_fp32()
    # the fsdp runs' predicted peaks (the dry run's cells of FSDP_FULL)
    t0 = time.perf_counter()
    cs.dryrun_predict(cs.DRYRUN_OUT)
    print(json.dumps({"dryrun_s": time.perf_counter() - t0}), flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(json.dumps({"built_s": time.perf_counter() - t0}), flush=True)
    paths = cs.PathLaunches()
    if args.cp_only:
        return cp_only(paths)
    cfg = bc.BasecallerConfig()
    params = bc.init(torch.Generator().manual_seed(0), cfg)
    qparams = quantize_edge_params(params, cfg, chunk=512)
    t0 = time.perf_counter()
    full = paths.drive("flowcell_512 fp32", ("fused_stream",),
                       lambda: cs.phase_full_width(torch))
    full_int8 = paths.drive("edge_int8 full width", ("fused_stream_int8",),
                            lambda: cs.phase_full_width_int8(torch, cfg, qparams))
    field = cs.phase_field(torch, paths)
    print(json.dumps({"refs_s": time.perf_counter() - t0}), flush=True)
    t0 = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    cs.phase_mesh(torch, F, peaks_for(card), paths,
                  {"flowcell_512": full["goldens"],
                   "edge_int8": full_int8["goldens"]},
                  field, cfg, qparams, card)
    print(json.dumps({"mesh_s": time.perf_counter() - t0,
                      "total": paths.total}), flush=True)


def cp_only(paths):
    """``--cp-only``: the references, the ranks of ``cs.cp_jobs``, then
    ``cs.cp_lines``."""
    from repro_torch.distributed import launch
    card = torch.cuda.get_device_name(0)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    refs = cs.cp_smoke_refs(torch, dev)
    dec = cs.cp_decode_refs(torch, dev)
    print(json.dumps({"refs_s": time.perf_counter() - t0}), flush=True)
    ranks = {}
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    for world, jobs in cs.cp_jobs(dec).items():
        t0 = time.perf_counter()
        got = launch.run(cs.mesh_rank, world, args=(jobs,), timeout_s=900)
        print(json.dumps({f"ranks_{world}_s": time.perf_counter() - t0}),
              flush=True)
        for name in jobs:
            ranks[name] = [g[name] for g in got]
    rows = cs.cp_lines(torch, F, peaks_for(card), paths, ranks, refs, dec,
                       card)
    print(json.dumps({"cp_rows": rows, "total": paths.total}), flush=True)


if __name__ == "__main__":
    main()
