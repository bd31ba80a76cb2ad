"""``chip_smoke.py``'s phase ``mesh`` alone, on the card: builds the
kernels, runs the unmeshed full-width flowcells and the field (the
references the lane meshes are held to), then the mesh phase; its JSON
lines as ``chip_smoke.py`` prints them.

    python3 scripts/mesh_phase.py        # from the root of a checkout
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import basecaller as bc  # noqa: E402
from repro_torch.engine.base import quantize_edge_params  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402



def main():
    ref.full_fp32()
    t0 = time.perf_counter()
    _build.build_all()
    print(json.dumps({"built_s": time.perf_counter() - t0}), flush=True)
    paths = cs.PathLaunches()
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
    cs.phase_mesh(torch, paths, {"flowcell_512": full["goldens"],
                                 "edge_int8": full_int8["goldens"]},
                  field, cfg, qparams)
    print(json.dumps({"mesh_s": time.perf_counter() - t0,
                      "total": paths.total}), flush=True)


if __name__ == "__main__":
    main()
