"""Serving launcher: the CLI entry point of every ported streaming
workload (``repro/launch/serve.py``), on the card unless ``--device cpu``.

Routes through ``repro_torch.engine.build``; pick a workload and a preset:

  PYTHONPATH=src python -m repro_torch.launch.serve --workload lm_decode \
      --arch qwen3-4b --smoke --requests 12 --slots 4
  PYTHONPATH=src python -m repro_torch.launch.serve --workload basecall \
      --preset smoke --requests 32
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --workload adaptive_sampling --preset smoke --requests 16
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --workload pathogen_pipeline --requests 4

``--device cpu`` runs the plain PyTorch versions of the kernels (no card
needed); the default, ``cuda``, runs the hand kernels and raises where
there is no card.  ``lm_decode`` is the default workload, as in JAX; its
flags (``--arch``, ``--smoke``, ``--slots``, ``--max-len``,
``--new-tokens``, ``--tp``, ``--ckpt``, ``--ckpt-step``) do what JAX's do,
with JAX's rule that ``lm_decode`` builds the full-size arch unless
``--smoke`` is given.  Given with another workload, such a flag raises by
its name.  ``--tp N`` (N > 1) serves tensor-parallel: the slicing plan is
checked here, then N ranks start (``distributed.launch.run``, gloo, on the
one card or the CPU by ``--device``), each builds its own engine with
``mesh=N`` and drives the same requests, and rank 0 prints the report::

  PYTHONPATH=src python -m repro_torch.launch.serve --workload lm_decode \
      --smoke --tp 2 --ckpt DIR     # DIR from train.checkpoint_converter

Discovery: ``--list-workloads`` prints every buildable workload,
``--list-presets <workload>`` its preset table; an unknown ``--workload``
or ``--preset`` fails with a ``ValueError`` naming the options.

Fleet mode (:mod:`repro_torch.fleet`): ``--fleet SPEC.json`` serves several
tenants on one card from a spec file::

    {"tenants": [
       {"name": "lab-a", "workload": "adaptive_sampling",
        "preset": "flowcell_smoke", "weight": 2},
       {"name": "lab-b", "workload": "basecall", "preset": "smoke",
        "requests": 32}]}

Field mode (:mod:`repro_torch.field`): ``--field SPEC.json`` runs the field
deployment, N edge sequencers uplinking read frames through a lossy
channel to one aggregator, from :class:`~repro_torch.field.FieldSpec`
fields::

    {"n_devices": 8, "n_infected": 2, "n_reads": 32, "seed": 0}

Observability (:mod:`repro_torch.obs`):

  --trace PATH       export a Chrome trace-event JSON of the run
  --timeseries PATH  stream per-interval delta snapshots as JSONL
  --monitor          live TTY dashboard while the run drains
  --profile-dir DIR  capture a torch.profiler device trace around the run
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

import repro_torch.engine as engine_api


def _run_lm_decode(eng, args, rng) -> dict:
    from repro_torch.engine.lm import Request
    for uid in range(args.requests):
        eng.submit(Request(
            uid=uid, prompt=rng.integers(1, eng.cfg.vocab_size, 4),
            max_new_tokens=args.new_tokens))
    return eng.drain()


def _run_basecall(eng, args, rng) -> dict:
    eng.submit(rng.normal(size=(args.requests, eng.chunk)).astype(np.float32))
    return eng.drain()


def _run_adaptive_sampling(eng, args, rng) -> dict:
    for i in range(args.requests):
        eng.submit(rng.normal(size=8 * eng.runtime.chunk_samples
                              ).astype(np.float32),
                   read_id=i, on_target=bool(i % 2))
    return eng.drain()


def _run_pathogen_pipeline(eng, args, rng) -> dict:
    for _ in range(args.requests):
        eng.submit(rng.normal(size=(8, 512)).astype(np.float32))
    return eng.drain()


_RUNNERS = {
    "lm_decode": _run_lm_decode,
    "basecall": _run_basecall,
    "adaptive_sampling": _run_adaptive_sampling,
    "pathogen_pipeline": _run_pathogen_pipeline,
}


# the flags that only lm_decode reads (``--smoke`` a switch, the rest
# values); given with another workload, each raises by its name
LM_DECODE_FLAGS = (
    ("--arch", {}), ("--smoke", {"action": "store_true", "default": None}),
    ("--slots", {"type": int}), ("--max-len", {"type": int}),
    ("--new-tokens", {"type": int}), ("--tp", {"type": int}),
    ("--ckpt", {"metavar": "DIR"}), ("--ckpt-step", {"type": int}))
NEW_TOKENS = 8          # JAX's --new-tokens default


def _lm_decode_only(flag: str, workload: str) -> ValueError:
    return ValueError(
        f"{flag} is read by the lm_decode workload only, not by "
        f"{workload!r}; run --workload lm_decode")


def _lm_overrides(args) -> dict:
    """JAX's lm_decode flags as builder overrides."""
    out: dict = {"smoke": bool(args.smoke)}
    if args.arch is not None:
        out["arch"] = args.arch
    if args.tp is not None:
        out["mesh"] = args.tp
    if args.ckpt is not None:
        out["ckpt_dir"] = args.ckpt
        if args.ckpt_step is not None:
            out["ckpt_step"] = args.ckpt_step
    if args.slots is not None:
        out["slots"] = args.slots
    if args.max_len is not None:
        out["max_len"] = args.max_len
    return out


def _submit_tenant_work(tenant, spec, rng) -> None:
    """Queue one tenant's requests in its workload's input shape (a
    source-fed flowcell tenant feeds itself and takes none)."""
    n = int(spec.get("requests", 12))
    workload = tenant.workload
    if workload == "adaptive_sampling":
        eng = tenant.engine
        if eng.flowcell is not None:
            return
        from repro_torch.realtime import SimulatedRead
        for i in range(n):
            sig = rng.normal(size=8 * eng.runtime.chunk_samples
                             ).astype(np.float32)
            tenant.submit(SimulatedRead(signal=sig, read_id=i,
                                        on_target=bool(i % 2)))
    elif workload == "lm_decode":
        from repro_torch.engine.lm import Request
        vocab = tenant.engine.cfg.vocab_size
        for uid in range(n):
            tenant.submit(Request(uid=uid,
                                  prompt=rng.integers(1, vocab, 4),
                                  max_new_tokens=int(
                                      spec.get("new_tokens", NEW_TOKENS))))
    elif workload == "basecall":
        chunk = tenant.engine.chunk
        for _ in range(n):
            tenant.submit(rng.normal(size=chunk).astype(np.float32))
    else:
        for _ in range(n):
            tenant.submit(rng.normal(size=(8, 512)).astype(np.float32))


def _run_fleet(args) -> dict:
    """``--fleet SPEC.json``: many tenants, one card, one drained report;
    the spec's ``mesh`` is the flowcell tenants' lane mesh (JAX's)."""
    from repro_torch.fleet import Fleet
    with open(args.fleet) as f:
        spec = json.load(f)
    fleet = Fleet(device=args.device, mesh=spec.get("mesh"),
                  trace=args.trace is not None,
                  max_pending=int(spec.get("max_pending", 256)))
    rng = np.random.default_rng(args.seed)
    tenants = []
    for t in spec["tenants"]:
        tenant = fleet.add_tenant(
            t["name"], t["workload"], t.get("preset", "default"),
            weight=float(t.get("weight", 1.0)),
            priority=int(t.get("priority", 0)),
            max_pending=t.get("max_pending"),
            **t.get("overrides", {}))
        tenants.append((tenant, t))
    for tenant, t in tenants:
        _submit_tenant_work(tenant, t, rng)
    report = fleet.drain()
    if args.trace is not None:
        fleet.export_trace(args.trace)
        print(f"trace -> {args.trace} (open at https://ui.perfetto.dev)")
    if args.json:
        print(json.dumps(report, default=float, indent=2))
    else:
        fl = report["fleet"]
        print(f"fleet: {fl['n_tenants']} tenants, {fl['ticks']} ticks, "
              f"fairness_ratio={fl['fairness_ratio']:.3f}")
        for name, ts in report["tenants"].items():
            print(f"  {name:16s} ticks={ts['ticks']:<6d} "
                  f"share={ts['tick_share']:.3f} "
                  f"completed={ts.get('completed', 0)} "
                  f"p99={ts.get('p99_ms', 0.0):.2f}ms")
    return report


def _run_field(args) -> dict:
    """``--field SPEC.json``: the end-to-end field surveillance drill."""
    from repro_torch.field import FieldSpec, run_field_scenario
    with open(args.field) as f:
        spec = FieldSpec(**json.load(f))
    res = run_field_scenario(spec, trace_path=args.trace, device=args.device)
    if args.json:
        print(json.dumps(res, default=float, indent=2))
    else:
        ob, wire, cons = res["outbreak"], res["wire"], res["conservation"]
        print(f"field: {spec.n_devices} devices ({spec.n_infected} "
              f"infected), {res['ticks']} ticks")
        print(f"  outbreak   detected={ob['detected']} "
              f"latency_ticks={ob['latency_ticks']} "
              f"decoy_absent={ob['decoy_absent']}")
        print(f"  wire       {wire['bytes_on_wire']} B vs "
              f"{wire['raw_signal_bytes_sequenced']} B raw signal "
              f"({wire['reduction_vs_sequenced']:.1f}x; read path "
              f"{wire['read_path_reduction']:.1f}x)")
        print(f"  conserved  exact={cons['per_device_exact']} "
              f"reads={cons['reads_ingested_unique']}"
              f"/{cons['accepted_reads_sum']} "
              f"dup={cons['dup_frames_detected']} "
              f"late={cons['late_frames']}")
        if args.trace:
            print(f"trace -> {args.trace} "
                  f"(open at https://ui.perfetto.dev)")
    return res


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--workload", default="lm_decode")
    ap.add_argument("--preset", default="default")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand kernels, default) or cpu (their "
                         "plain PyTorch versions)")
    ap.add_argument("--list-workloads", action="store_true",
                    help="print buildable workloads and exit")
    ap.add_argument("--list-presets", default=None, metavar="WORKLOAD",
                    help="print a workload's presets and exit")
    ap.add_argument("--fleet", default=None, metavar="SPEC.json",
                    help="multi-tenant mode: serve every tenant in the "
                         "spec file on one card (see repro_torch.fleet)")
    ap.add_argument("--field", default=None, metavar="SPEC.json",
                    help="field mode: run the N-device edge deployment "
                         "described by the FieldSpec JSON")
    ap.add_argument("--requests", type=int, default=12,
                    help="requests / chunks / reads to drive through")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true",
                    help="print the telemetry summary as JSON")
    # lm_decode knobs (builder overrides; --new-tokens defaults to 8)
    for flag, kw in LM_DECODE_FLAGS:
        ap.add_argument(flag, **{"default": None, **kw},
                        help="lm_decode only")
    # observability (repro_torch.obs)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="export a Chrome trace-event JSON of the run")
    ap.add_argument("--timeseries", default=None, metavar="PATH",
                    help="stream per-interval delta snapshots as JSONL")
    ap.add_argument("--monitor", action="store_true",
                    help="live TTY dashboard while the run drains")
    ap.add_argument("--interval", type=float, default=0.5,
                    help="time-series / dashboard snapshot interval (s)")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace around the run")
    return ap


def main(argv=None):
    """Parse ``argv`` (default ``sys.argv[1:]``), run, and return the
    drained report (None for the listings)."""
    args = parser().parse_args(argv)

    if args.list_workloads:
        for w in engine_api.workloads():
            print(w)
        return None
    if args.list_presets is not None:
        for name, kw in sorted(engine_api.presets(args.list_presets).items()):
            pretty = ", ".join(f"{k}={v!r}" for k, v in sorted(kw.items()))
            print(f"{name:16s} {pretty}" if pretty else name)
        return None
    if args.workload != "lm_decode":
        for flag, _ in LM_DECODE_FLAGS:
            if getattr(args, flag[2:].replace("-", "_")) is not None:
                raise _lm_decode_only(flag, args.workload)
    if args.fleet is not None:
        return _run_fleet(args)
    if args.field is not None:
        return _run_field(args)
    if args.workload == "lm_decode" and (args.tp or 1) > 1:
        return _run_tensor_parallel(args, sys.argv[1:] if argv is None
                                    else list(argv))
    return _serve(args)


def _run_tensor_parallel(args, argv: list) -> dict:
    """``--tp N``: check that the arch shards over N (here, before any
    rank starts), start N ranks that each serve the whole run, and return
    rank 0's report (which rank 0 printed)."""
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import launch
    from repro_torch.distributed import tp as tp_mod
    from repro_torch.models.registry import get_model, require_train_and_tp
    spec = ARCHS[args.arch or "qwen3-4b"]
    cfg = spec.smoke_config() if args.smoke else spec.config()
    require_train_and_tp(cfg, "serve --tp")
    shapes, axes = get_model(cfg).abstract_params(cfg)
    tp_mod.build_plan(axes, shapes, cfg=cfg, tp=args.tp)
    threads = (max(1, launch.max_ranks() // args.tp) if args.device == "cpu"
               else None)
    # by the module's name: under ``python -m`` this module is __main__
    from repro_torch.launch import serve
    return launch.run(serve._serve_rank, args.tp, args=(argv,),
                      threads=threads)[0]


def _serve_rank(rank: int, world: int, argv: list) -> dict:
    """One rank of ``--tp``: the whole run with ``mesh=world``; on the
    card, rank k takes card k modulo the cards there are."""
    args = parser().parse_args(argv)
    if args.device == "cuda":
        import torch
        torch.cuda.set_device(rank % torch.cuda.device_count())
    return _serve(args, rank=rank)


def _serve(args, rank: int = 0) -> dict:
    """Build the engine, drive the requests, print the report (rank 0
    only; the other ranks of a ``--tp`` run export nothing either)."""
    lead = rank == 0
    overrides: dict = {"seed": args.seed, "device": args.device}
    if args.workload == "lm_decode":
        overrides.update(_lm_overrides(args))
        if args.new_tokens is None:
            args.new_tokens = NEW_TOKENS
    if args.trace is not None and lead:
        overrides["trace"] = True

    eng = engine_api.build(args.workload, preset=args.preset, **overrides)
    if args.workload not in _RUNNERS:
        raise ValueError(f"workload {args.workload!r} has no request "
                         f"runner here; run one of {sorted(_RUNNERS)} or "
                         "use --field")
    tel = eng.telemetry
    if (args.timeseries or args.monitor) and lead:
        from repro_torch.obs.export import TimeSeriesExporter
        tel.exporter = TimeSeriesExporter(
            tel, scheduler=eng.scheduler, interval_s=args.interval,
            path=args.timeseries, dashboard=args.monitor)
    rng = np.random.default_rng(args.seed)
    from repro_torch.obs.trace import profile_window
    try:
        with profile_window(args.profile_dir if lead else None,
                            device=args.device):
            report = _RUNNERS[args.workload](eng, args, rng)
    finally:
        if tel.exporter is not None:
            tel.exporter.close()
    if not lead:
        return report
    if args.trace is not None:
        doc = tel.tracer.export_chrome(args.trace)
        n = sum(1 for e in doc["traceEvents"] if e.get("ph") != "M")
        print(f"trace: {n} events -> {args.trace} "
              f"(open at https://ui.perfetto.dev)")
    if args.json:
        print(json.dumps(report, default=float, indent=2))
    else:
        print(f"workload={args.workload} preset={args.preset} "
              f"device={args.device}")
        for k in ("completed", "steps", "dispatches", "p50_ms", "p99_ms",
                  "bases_per_s", "samples_per_s", "tokens_per_s",
                  "signal_saved_frac", "wall_s"):
            v = report.get(k, 0)
            print(f"  {k:18s} {v:.3f}" if isinstance(v, float)
                  else f"  {k:18s} {v}")
    return report


if __name__ == "__main__":
    main()
