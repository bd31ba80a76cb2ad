"""Re-shard a full checkpoint for a tensor-parallel degree, offline
(``scripts/checkpoint_converter.py``, JAX's flags and ``convert``).

    PYTHONPATH=src python -m repro_torch.train.checkpoint_converter \\
        --src runs/ckpt --dest runs/ckpt_tp2 --tp 2 --arch qwen3-4b --smoke

Reads a ``format: "full"`` checkpoint (or reassembles a sharded one),
builds the slicing plan for the architecture and degree (the plan the
serving engine derives, so the layouts cannot disagree) and writes a
``format: "sharded"`` checkpoint: one ``shard_<k>.npz`` a model shard and
the manifest's ``shard_info``.  QuantizedTensor leaves slice payload and
per-channel scales along the same axis, so int8 params load
pre-partitioned at serve time (``tp.load_sharded_params``).

Runs on the host alone: no device is touched.
"""
from __future__ import annotations

import argparse


def convert(src: str, dest: str, *, tp: int, arch: str, smoke: bool = True,
            step: int | None = None, prefix: str = "",
            keep_last: int = 3, verify: bool = True) -> str:
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import tp as tp_mod
    from repro_torch.models.registry import get_model
    from repro_torch.train import checkpoint as ck

    spec = ARCHS[arch]
    cfg = spec.smoke_config() if smoke else spec.config()
    shapes, axes = get_model(cfg).abstract_params(cfg)
    plan = tp_mod.build_plan(axes, shapes, cfg=cfg, tp=tp)

    manifest, flat = ck._load_flat(src, step, verify)
    shards, info = tp_mod.shard_state(flat, plan, prefix=prefix)
    out = ck.save_sharded(dest, shards, manifest["step"], shard_info=info,
                          keep_last=keep_last)
    sharded = sum(1 for v in info.values() if v != "replicated")
    print(f"wrote {out}: {len(info)} leaves, {sharded} sharded over tp={tp}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="source checkpoint dir")
    ap.add_argument("--dest", required=True, help="destination dir")
    ap.add_argument("--tp", type=int, required=True,
                    help="target model-axis shards")
    ap.add_argument("--arch", default="qwen3-4b",
                    help="architecture key (for the slicing plan)")
    ap.add_argument("--smoke", action="store_true", default=False,
                    help="use the arch's smoke config")
    ap.add_argument("--step", type=int, default=None,
                    help="source step (default: latest)")
    ap.add_argument("--prefix", default="",
                    help="key prefix wrapping the params tree "
                         "(e.g. 'params' for train-state checkpoints)")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip sha256 verification of the source")
    args = ap.parse_args(argv)
    convert(args.src, args.dest, tp=args.tp, arch=args.arch,
            smoke=args.smoke, step=args.step, prefix=args.prefix,
            verify=not args.no_verify)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
