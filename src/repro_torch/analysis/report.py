"""The dry run's tables, and the quantization, field and trace sections
(``repro/analysis/report.py``).

  PYTHONPATH=src python -m repro_torch.analysis.report \
      --dryrun dryrun_1x1.json dryrun_8x8.json

reads the port's dry-run reports (``python -m repro_torch.launch.dryrun
--all --mesh 1x1 --out dryrun_1x1.json``, and ``--mesh 8x8``): one table
for each mesh the reports name (and for each under ``--opt``, JAX's
optimized rule set), each cell's rank memory against one H100's 80 GB
and the roofline at the H100's rates.

The accuracy-vs-energy quantization table renders the ``quant:*`` rows of
a benchmark JSON, the field section its ``field:*`` rows, and the trace
section summarizes a Chrome trace the port's engines export (span stats
by track, the per-read decision breakdown):

  PYTHONPATH=src python -m repro_torch.analysis.report --section trace \
      --trace trace.json

These three are pure functions of the same dicts as JAX's, and print the
same text.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.analysis.roofline import HBM_CAPACITY, PEAK_FLOPS


def _gib(b):
    return b / 2**30


def dryrun_table(cells: list[dict]) -> str:
    lines = [
        "| arch | shape | mesh | status | peak GiB/rank | fits 80 GB "
        "| args GiB | FLOPs/rank | wire GiB/rank | collectives |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in cells:
        if r["status"] == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | N/A | — | — "
                f"| — | — | — | {r['reason'][:60]} |")
            continue
        if r["status"] != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | FAILED | — | "
                f"— | — | — | — | {r.get('error', '')[:60]} |")
            continue
        m, rl = r["memory"], r["roofline"]
        colls = ", ".join(f"{k}x{int(v)}"
                          for k, v in sorted(rl["collective_ops"].items()))
        fits = "yes" if m["peak_bytes"] <= HBM_CAPACITY else "no"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok "
            f"| {_gib(m['peak_bytes']):.2f} | {fits} "
            f"| {_gib(m['argument_bytes']):.2f} "
            f"| {rl['flops_per_device']:.2e} "
            f"| {_gib(rl['wire_bytes_per_device']):.2f} "
            f"| {colls[:80]} |")
    return "\n".join(lines)


def roofline_table(cells: list[dict]) -> str:
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "MODEL_FLOPS | useful ratio | what moves the dominant term |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in cells:
        if r["status"] != "ok":
            continue
        rl = r["roofline"]
        hint = _hint(r)
        lines.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {rl['compute_s']:.4f} | {rl['memory_s']:.4f} "
            f"| {rl['collective_s']:.4f} | **{rl['dominant']}** "
            f"| {rl['model_flops_total']:.2e} "
            f"| {rl['useful_flops_ratio']:.3f} | {hint} |")
    return "\n".join(lines)


def _hint(r: dict) -> str:
    rl = r["roofline"]
    dom = rl["dominant"]
    wire = rl["collective_wire_bytes"]
    if dom == "collective":
        top = max(wire, key=wire.get) if wire else "?"
        if top == "all-reduce":
            return ("cast TP activation all-reduces to bf16 + save-AR-output "
                    "remat policy (halves replayed fwd collectives)")
        if top == "all-gather":
            return "head-sharded attention constraints remove q/k/v gathers"
        return f"reduce {top} volume (resharding schedule)"
    if dom == "memory":
        if r["shape"].startswith("decode") or r["shape"].startswith("long"):
            return "decode is weight-bound: quantize KV cache / params int8"
        return "larger microbatches amortize param sweeps"
    return "compute-bound: raise tensor-core utilization via tile shapes"


def fraction_summary(cells: list[dict]) -> str:
    """Roofline fraction = useful model FLOPs time / achievable step time."""
    lines = ["| arch | shape | roofline fraction (useful-compute / dominant) |",
             "|---|---|---|"]
    for r in cells:
        if r["status"] != "ok":
            continue
        rl = r["roofline"]
        dom_s = max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
        useful_s = (rl["model_flops_total"]
                    / (PEAK_FLOPS * _ndev(r["mesh"])))
        frac = useful_s / dom_s if dom_s else 0.0
        lines.append(f"| {r['arch']} | {r['shape']} | {frac:.3f} |")
    return "\n".join(lines)


def _ndev(mesh: str) -> int:
    n = 1
    for p in mesh.split("x"):
        n *= int(p)
    return n


def _parse_derived(derived: str) -> dict:
    """``k1=v1;k2=v2`` benchmark derived-column -> dict of strings."""
    out = {}
    for part in derived.split(";"):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k] = v
    return out


def quant_table(rows: list[dict]) -> str:
    """Accuracy-vs-energy table from ``quant:*`` benchmark rows: the
    fp32 / bf16 / int8 trade the edge deployment decides on (fixed seeds,
    read accuracy deltas against fp32, SoC-modeled MAC energy)."""
    lines = [
        "| precision | read acc | Δacc vs fp32 | host bases/s "
        "| modeled pJ/base | energy vs fp32 |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        if not r["name"].startswith("quant:"):
            continue
        d = _parse_derived(r["derived"])
        precision = r["name"].split(":", 1)[1]
        lines.append(
            f"| {precision} | {d.get('read_acc', '—')} "
            f"| {d.get('acc_delta_vs_fp32', '—')} "
            f"| {d.get('host_bases_per_s', '—')} "
            f"| {d.get('soc_pj_per_base', '—')} "
            f"| {d.get('energy_ratio_vs_fp32', '—')}x |")
    return "\n".join(lines)


def field_tables(rows: list[dict]) -> str:
    """Field-deployment summary from ``field:*`` benchmark rows: the
    outbreak headline, the bytes-on-wire table (three baselines), and the
    per-device enrichment breakdown."""
    named = {r["name"]: _parse_derived(r["derived"]) for r in rows
             if r["name"].startswith("field:")}
    out = []
    e2e = named.get("field:e2e", {})
    out.append("**Outbreak**: "
               f"{e2e.get('devices', '?')} devices "
               f"({e2e.get('infected', '?')} infected), "
               f"detected={e2e.get('detected', '—')}, "
               f"latency={e2e.get('latency_ticks', '—')} ticks, "
               f"decoy_absent={e2e.get('decoy_absent', '—')}\n")
    wire = named.get("field:wire", {})
    out.append("| bytes on wire | raw signal (sequenced) "
               "| reduction vs sequenced | vs accepted | read path only |")
    out.append("|---|---|---|---|---|")
    out.append(f"| {wire.get('bytes_on_wire', '—')} "
               f"| {wire.get('raw_sequenced', '—')} "
               f"| {wire.get('reduction_vs_sequenced', '—')}x "
               f"(bar {wire.get('bar', '20')}x) "
               f"| {wire.get('reduction_vs_accepted', '—')}x "
               f"| {wire.get('read_path_reduction', '—')}x |")
    cons = named.get("field:conservation", {})
    out.append(f"\n**Conservation**: accepted={cons.get('accepted_sum', '—')}"
               f", unique ingested={cons.get('ingested_unique', '—')} "
               f"(exact={cons.get('per_device_exact', '—')}), "
               f"dup dropped={cons.get('dup_detected', '—')}, "
               f"late={cons.get('late', '—')}\n")
    out.append("| device | infected | accepted reads | wire bytes "
               "| enrichment |")
    out.append("|---|---|---|---|---|")
    for name in sorted(n for n in named if n.startswith("field:device:")):
        d = named[name]
        out.append(f"| {name.rsplit(':', 1)[1]} "
                   f"| {d.get('infected', '—')} "
                   f"| {d.get('accepted_reads', '—')} "
                   f"| {d.get('wire_bytes', '—')} "
                   f"| {d.get('enrichment', '—')} |")
    var = named.get("field:variants", {})
    if var:
        out.append(f"\n**Variants**: {var.get('seeded_snps', '—')} SNPs "
                   f"seeded, {var.get('candidate_sites', '—')} candidate "
                   f"sites, {var.get('recovered_snps', '—')} recovered")
    return "\n".join(out)


def trace_tables(doc: dict) -> str:
    """Span/event statistics from an exported Chrome trace document: one
    row per (process, event name) with counts and X-span duration stats,
    plus the per-read decision breakdown from matched read B/E spans."""
    from repro_torch.obs.trace import read_spans
    pids = {e["pid"]: e["args"]["name"]
            for e in doc.get("traceEvents", [])
            if e.get("ph") == "M" and e.get("name") == "process_name"}
    stats: dict = {}
    for e in doc.get("traceEvents", []):
        ph = e.get("ph")
        if ph in ("M", "E"):
            continue
        key = (pids.get(e["pid"], str(e["pid"])), e["name"], ph)
        s = stats.setdefault(key, {"n": 0, "dur_us": []})
        s["n"] += 1
        if ph == "X":
            s["dur_us"].append(e.get("dur", 0.0))
    lines = ["| process | event | ph | count | mean ms | max ms |",
             "|---|---|---|---|---|---|"]
    for (proc, name, ph), s in sorted(stats.items()):
        durs = s["dur_us"]
        mean = f"{sum(durs) / len(durs) / 1e3:.3f}" if durs else "—"
        mx = f"{max(durs) / 1e3:.3f}" if durs else "—"
        lines.append(f"| {proc} | {name} | {ph} | {s['n']} "
                     f"| {mean} | {mx} |")
    spans = read_spans(doc)
    if spans:
        by_dec: dict = {}
        for s in spans:
            dec = s["args"].get("decision", "open")
            d = by_dec.setdefault(dec, {"n": 0, "dur": [], "saved": 0})
            d["n"] += 1
            d["dur"].append(s["dur_us"])
            d["saved"] += int(s["args"].get("samples_saved", 0))
        lines.append("\n**Per-read spans** (matched B/E, correlated by "
                     "read_id):\n")
        lines.append("| decision | reads | mean span ms | samples saved |")
        lines.append("|---|---|---|---|")
        for dec, d in sorted(by_dec.items()):
            lines.append(f"| {dec} | {d['n']} "
                         f"| {sum(d['dur']) / len(d['dur']) / 1e3:.2f} "
                         f"| {d['saved']} |")
    return "\n".join(lines)


def _by_mesh(cells: list[dict]) -> dict:
    """The records by ``(mesh, opt)``, in the order they first appear."""
    out: dict = {}
    for r in cells:
        out.setdefault((r["mesh"], bool(r.get("opt"))), []).append(r)
    return out


def _title(mesh: str, opt: bool) -> str:
    return f"mesh {mesh}" + (", --opt rules" if opt else "")


def _load(path: str, hint: str):
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SystemExit(f"{path} not found: {hint}") from None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", nargs="+",
                    default=["dryrun_1x1.json", "dryrun_8x8.json"],
                    help="reports of repro_torch.launch.dryrun --out")
    ap.add_argument("--quant", default="BENCH_quant.json",
                    help="benchmark rows with quant:* names")
    ap.add_argument("--trace", default="trace_flowcell.json",
                    help="Chrome trace JSON (repro_torch.launch.serve "
                         "--trace, an engine's tracer.export_chrome)")
    ap.add_argument("--field", default="BENCH_field.json",
                    help="benchmark rows with field:* names")
    ap.add_argument("--section", default="all",
                    choices=["all", "dryrun", "roofline", "fractions",
                             "quant", "trace", "field"])
    args = ap.parse_args(argv)
    if args.section == "field":
        rows = _load(args.field, "benchmark rows with field:* names")
        print("### Field deployment — outbreak latency & bytes on wire\n")
        print(field_tables(rows))
        return
    if args.section == "trace":
        doc = _load(args.trace, "export one with repro_torch.launch.serve "
                    "--trace PATH")
        print("### Trace — span statistics\n")
        print(trace_tables(doc))
        return
    if args.section == "quant":
        rows = _load(args.quant, "benchmark rows with quant:* names")
        print("### Quantization — accuracy vs energy (fixed seeds)\n")
        print(quant_table(rows))
        return
    cells = []
    for path in args.dryrun:
        cells += _load(path, "run python -m repro_torch.launch.dryrun "
                       "--all --mesh DxM --out PATH first")
    meshes = _by_mesh(cells)
    if args.section in ("all", "dryrun"):
        for (mesh, opt), rows in meshes.items():
            print(f"### Dry run on meta tensors — {_title(mesh, opt)} "
                  f"({_ndev(mesh)} H100s, rank 0)\n")
            print(dryrun_table(rows) + "\n")
    if args.section in ("all", "roofline"):
        for (mesh, opt), rows in meshes.items():
            print(f"### Roofline at the H100's rates — {_title(mesh, opt)}"
                  "\n")
            print(roofline_table(rows) + "\n")
    if args.section in ("all", "fractions"):
        for (mesh, opt), rows in meshes.items():
            print(f"### Roofline fractions — {_title(mesh, opt)}\n")
            print(fraction_summary(rows) + "\n")


if __name__ == "__main__":
    main()
