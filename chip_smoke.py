#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``card``: the card's name and power limit (nvidia-smi) and the time to
   build the four CUDA kernels with nvcc (one nvcc per source, in parallel).
2. ``kernel``: each kernel against its plain PyTorch version on the card,
   at the flowcell tick's shapes (512 lanes x chunk 256, the paper's CNN)
   and at edge shapes: max abs error (bitwise for int32 outputs), kernel,
   plain and library times, and the bound the card's data sheet sets.
3. ``step_goldens``: the step-codec flowcell (8 lanes) on the card, fused
   and unfused x pipeline depth 1 and 2, and once on the CPU (plain): all
   five per-read goldens must be equal.
4. ``full_width``: the ``flowcell_512`` preset with the paper's CNN
   (``BasecallerConfig()``, random weights from a seed) on the pore
   encoder, fused and unfused: reads, bases/s, decision p50/p99, mean
   tick, the ``fabric.dispatch.*`` counters, and the fused/unfused golden
   diff (a differing read is allowed only where the plain logits' top-2
   margin on its evidence is < 1e-4).
5. ``{"kernels": [...]}``: every kernel with its launches in phase 4.

TF32 is off for the whole run (``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32``): the plain versions and the
library calls are fp32, like the kernels.  Any failed check exits non-zero.
The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# Published peaks (NVIDIA data sheets, dense, no sparsity): fp32 on the
# CUDA cores and device-memory bandwidth, by H100 part.
PEAKS = {
    "sxm": {"fp32_flops": 67e12, "bytes_per_s": 3.35e12},
    "pcie": {"fp32_flops": 51e12, "bytes_per_s": 2.0e12},
    "nvl": {"fp32_flops": 60e12, "bytes_per_s": 3.9e12},
}
# int32 runs on the CUDA cores at half the fp32 lane count (64 INT32 vs
# 128 FP32 lanes per Hopper SM, Hopper architecture white paper)
INT32_SHARE = 0.5
F32_TOL = 2e-5        # the JAX suite's f32 bar per op (tests/test_kernels.py)
STACK_TOL = 1e-4      # five stacked f32 layers reassociate


class CheckFailed(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, msg) -> None:
    if not cond:
        raise CheckFailed(msg)


def peaks_for(name: str) -> dict:
    low = name.lower()
    if "pcie" in low:
        return PEAKS["pcie"]
    if "nvl" in low:
        return PEAKS["nvl"]
    return PEAKS["sxm"]


def bound_ms(peaks, nbytes: float, ops: float, int_ops: bool = False):
    rate = peaks["fp32_flops"] * (INT32_SHARE if int_ops else 1.0)
    t_bytes = nbytes / peaks["bytes_per_s"] * 1e3
    t_ops = ops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# --------------------------------------------------------------- phase 2 --
class KernelTable:
    """Per-kernel accumulation of phase-2 measurements at path shapes."""

    def __init__(self):
        self.rows = {}

    def add(self, name, *, err, ms, plain_ms, bound, bound_by, library_ms):
        r = self.rows.setdefault(name, {
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bound_by": bound_by, "library_ms": None if library_ms is None
            else 0.0, "bound_parts": {}})
        r["max_abs_err"] = max(r["max_abs_err"], float(err))
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += bound
        r["bound_parts"][bound_by] = r["bound_parts"].get(bound_by, 0.0) + bound
        if library_ms is not None:
            r["library_ms"] += library_ms
        r["bound_by"] = max(r["bound_parts"], key=r["bound_parts"].get)


def path_layer_inputs(torch, bc, params, cfg, lanes, chunk, gen):
    """Each conv layer's input at the tick's shapes ([carry | chunk] rows),
    from a random signal run through the plain chain."""
    from repro_torch.kernels import ref
    dev = params["conv1"]["w"].device
    sig = torch.randn((lanes, chunk), generator=gen).to(dev)
    x = sig[..., None]
    inputs = []
    for sp in bc.stream_layer_specs(cfg):
        p = params[sp.name]
        if sp.is_head:
            inputs.append(x)
            break
        carry = 0.1 * torch.randn((lanes, sp.carry_rows, sp.cin),
                                  generator=gen).to(dev).abs()
        buf = torch.cat([carry, x], dim=1).contiguous()
        inputs.append(buf)
        x = ref.conv1d(buf, p["w"], p["b"], stride=sp.stride,
                       activation=sp.activation)
    return inputs


def check_conv1d(torch, F, peaks, table, x, w, b, stride, act, label,
                 on_path):
    from repro_torch.kernels import conv1d as kc
    from repro_torch.kernels import ref
    out = kc.conv1d(x, w, b, stride=stride, activation=act)
    want = ref.conv1d(x, w, b, stride=stride, activation=act)
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    ok = torch.allclose(out, want, rtol=F32_TOL, atol=F32_TOL)
    line = {"phase": "kernel", "kernel": "conv1d", "shape": label,
            "x": list(x.shape), "w": list(w.shape), "stride": stride,
            "max_abs_err": err, "tol": F32_TOL}
    if on_path:
        ms = time_ms(torch, lambda: kc.conv1d(x, w, b, stride=stride,
                                              activation=act))
        plain = time_ms(torch, lambda: ref.conv1d(x, w, b, stride=stride,
                                                  activation=act), reps=5)
        # cuDNN in PyTorch's layout; no single PyTorch call adds the ReLU,
        # so a ReLU layer's library time is F.conv1d then F.relu
        xt = x.permute(0, 2, 1).contiguous()
        wt = w.permute(2, 1, 0).contiguous()
        lib = time_ms(torch, lambda: F.relu(F.conv1d(xt, wt, b, stride=stride))
                      if act == "relu" else F.conv1d(xt, wt, b, stride=stride))
        k, cin, cout = w.shape
        ops = 2.0 * out.shape[0] * out.shape[1] * cout * k * cin
        bnd, by = bound_ms(peaks, nbytes(x, w, b, out), ops)
        line.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                    bound_by=by)
        table.add("conv1d", err=err, ms=ms, plain_ms=plain, bound=bnd,
                  bound_by=by, library_ms=lib)
    emit(line)
    require(ok, f"conv1d {label}: max abs err {err} over {F32_TOL}")


def check_matmul(torch, peaks, table, a, w, b, act, label, on_path):
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import ref
    out = km.matmul(a, w, b, activation=act)
    want = ref.matmul(a, w, b, activation=act)
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    ok = torch.allclose(out, want, rtol=F32_TOL, atol=F32_TOL)
    line = {"phase": "kernel", "kernel": "matmul", "shape": label,
            "a": list(a.shape), "b": list(w.shape), "max_abs_err": err,
            "tol": F32_TOL}
    if on_path:
        ms = time_ms(torch, lambda: km.matmul(a, w, b, activation=act))
        plain = time_ms(torch, lambda: ref.matmul(a, w, b, activation=act))
        lib = time_ms(torch, lambda: torch.addmm(b, a, w))
        m, k = a.shape
        ops = 2.0 * m * k * w.shape[1]
        bnd, by = bound_ms(peaks, nbytes(a, w, b, out), ops)
        line.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                    bound_by=by)
        table.add("matmul", err=err, ms=ms, plain_ms=plain, bound=bnd,
                  bound_by=by, library_ms=lib)
    emit(line)
    require(ok, f"matmul {label}: max abs err {err} over {F32_TOL}")


def check_banded(torch, peaks, table, q, t, band, local, label, on_path):
    from repro_torch.kernels import edit_distance as ke
    from repro_torch.kernels import ref
    kw = dict(band=band, match=2, mismatch=-4, gap=-2, local=local)
    out = ke.banded_align(q, t, **kw)
    want = ref.banded_align(q, t, **kw)
    torch.cuda.synchronize()
    diff = int((out != want).sum().item())
    line = {"phase": "kernel", "kernel": "banded_align", "shape": label,
            "q": list(q.shape), "t": list(t.shape), "band": band,
            "local": local, "mismatches": diff}
    if on_path:
        ms = time_ms(torch, lambda: ke.banded_align(q, t, **kw))
        plain = time_ms(torch, lambda: ref.banded_align(q, t, **kw), reps=3,
                        warm=1)
        m, n = q.shape[1], t.shape[1]
        i = torch.arange(1, m + 1)[:, None]
        j = torch.arange(1, n + 1)[None, :]
        cells = int(((i - j).abs() <= band).sum().item()) * q.shape[0]
        # per cell: 3 adds, 3 max, 1 compare-select, band test (8 int ops)
        bnd, by = bound_ms(peaks, nbytes(q, t, out), 8.0 * cells,
                           int_ops=True)
        line.update(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bnd,
                    bound_by=by, cells=cells)
        table.add("banded_align", err=float(diff), ms=ms, plain_ms=plain,
                  bound=bnd, bound_by=by, library_ms=None)
    emit(line)
    require(diff == 0, f"banded_align {label}: {diff} scores differ")


def fused_inputs(torch, bc, cfg, lanes, chunk, gen, dev):
    specs = bc.stream_layer_specs(cfg)
    n_frames = chunk // cfg.total_stride
    rows = torch.randn((lanes, chunk), generator=gen).to(dev)
    pads = torch.zeros((lanes, n_frames))
    pads[lanes // 2, n_frames // 2:] = 1.0          # a read ending mid-chunk
    reset = torch.zeros((lanes,))
    reset[::3] = 1.0                                # recycled lanes
    conv = [torch.randn((lanes, sp.carry_rows, sp.cin), generator=gen)
            .abs().to(dev) for sp in specs]
    prev = torch.randint(0, 5, (lanes,), generator=gen, dtype=torch.int32)
    bases = torch.randint(0, 100, (lanes,), generator=gen, dtype=torch.int32)
    ticks = torch.randint(0, 10, (lanes,), generator=gen, dtype=torch.int32)
    return (rows, pads.to(dev), reset.to(dev), prev.to(dev), bases.to(dev),
            ticks.to(dev), tuple(conv))


def plain_logits(torch, bc, params, cfg, rows, reset, conv):
    """The plain chain's logits for a fused tick's inputs."""
    from repro_torch.kernels import ref
    rmask = reset > 0
    x = rows[..., None]
    for i, sp in enumerate(bc.stream_layer_specs(cfg)):
        p = params[sp.name]
        if sp.is_head:
            b, t, c = x.shape
            x = ref.matmul(x.reshape(b * t, c), p["w"][0], p["b"]).reshape(
                b, t, sp.cout)
        else:
            carry = torch.where(rmask[:, None, None], 0.0, conv[i])
            x = ref.conv1d(torch.cat([carry, x], 1), p["w"], p["b"],
                           stride=sp.stride, activation=sp.activation)
    return x


def top2_margin(torch, logits):
    top = torch.topk(logits, 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def check_fused(torch, bc, peaks, table, params, cfg, inputs, label,
                on_path):
    """Fused kernel vs its plain twin (and, bit for bit, vs the unfused
    kernels).  Tokens/lens/prev/bases/ticks must be equal wherever the
    plain logits' top-2 margin is >= 1e-4; carries within STACK_TOL."""
    from repro_torch.core import ctc
    from repro_torch.kernels import fused_stream as fs
    rows, pads, reset, prev, bases, ticks, conv = inputs
    args = (rows, pads, reset, prev, bases, ticks, conv, params)
    tok, lens, lane = fs.fused_stream_cuda(*args, cfg=cfg)
    tok_p, lens_p, lane_p = fs._fused_reference(*args, cfg=cfg)
    torch.cuda.synchronize()
    logits = plain_logits(torch, bc, params, cfg, rows, reset, conv)
    classes = ctc.argmax_classes(logits)
    margin = top2_margin(torch, logits)
    near_tie_lanes = ((margin < 1e-4) & (pads <= 0)).any(dim=1)
    int_diff = ((tok != tok_p).any(dim=1) | (lens != lens_p)
                | (lane["prev_class"] != lane_p["prev_class"])
                | (lane["bases"] != lane_p["bases"])
                | (lane["ticks"] != lane_p["ticks"]))
    bad_lanes = int((int_diff & ~near_tie_lanes).sum().item())
    carry_err = max(((a - b).abs().max().item() if a.numel() else 0.0)
                    for a, b in zip(lane["conv"], lane_p["conv"]))
    carry_ok = all(torch.allclose(a, b, rtol=STACK_TOL, atol=STACK_TOL)
                   for a, b in zip(lane["conv"], lane_p["conv"]))
    # the unfused kernels on the same inputs: the same bits by design
    from repro_torch.kernels import conv1d as kc
    from repro_torch.kernels import matmul as km
    rmask = reset > 0
    x = rows[..., None]
    for i, sp in enumerate(bc.stream_layer_specs(cfg)):
        p = params[sp.name]
        if sp.is_head:
            b, t, c = x.shape
            x = km.matmul(x.reshape(b * t, c).contiguous(), p["w"][0],
                          p["b"]).reshape(b, t, sp.cout)
        else:
            carry = torch.where(rmask[:, None, None], 0.0, conv[i])
            x = kc.conv1d(torch.cat([carry, x], 1).contiguous(), p["w"],
                          p["b"], stride=sp.stride, activation=sp.activation)
    prev0 = torch.where(rmask, 0, prev)
    tok_u, lens_u, _ = ctc.greedy_decode_stream(x, prev0, pads)
    unfused_equal = bool(torch.equal(tok_u, tok) and torch.equal(lens_u, lens))
    line = {"phase": "kernel", "kernel": "fused_stream", "shape": label,
            "lanes": rows.shape[0], "chunk": rows.shape[1],
            "int_lanes_differing": int(int_diff.sum().item()),
            "int_lanes_differing_above_margin": bad_lanes,
            "near_tie_lanes": int(near_tie_lanes.sum().item()),
            "carry_max_abs_err": carry_err, "carry_tol": STACK_TOL,
            "equal_to_unfused_kernels": unfused_equal,
            "frames_class_mismatch_vs_plain": int(
                ((classes != ctc.argmax_classes(x)) & (pads <= 0)).sum())}
    if on_path:
        ms = time_ms(torch, lambda: fs.fused_stream_cuda(*args, cfg=cfg))
        plain = time_ms(torch, lambda: fs._fused_reference(*args, cfg=cfg),
                        reps=5)
        lanes, chunk = rows.shape
        macs, t = 0, chunk
        weights = []
        for sp in bc.stream_layer_specs(cfg):
            t //= sp.stride
            macs += lanes * t * sp.cout * sp.ksize * sp.cin
            weights += [params[sp.name]["w"], params[sp.name]["b"]]
        io = nbytes(rows, pads, reset, prev, bases, ticks, *conv, *weights,
                    tok, lens, *lane["conv"], lane["prev_class"],
                    lane["bases"], lane["ticks"])
        bnd, by = bound_ms(peaks, io, 2.0 * macs)
        line.update(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bnd,
                    bound_by=by, gflop=2.0 * macs / 1e9)
        table.add("fused_stream", err=carry_err, ms=ms, plain_ms=plain,
                  bound=bnd, bound_by=by, library_ms=None)
    emit(line)
    require(bad_lanes == 0, f"fused_stream {label}: {bad_lanes} lanes differ "
            "from the plain version away from a near tie")
    require(carry_ok, f"fused_stream {label}: carries off by {carry_err}")
    require(unfused_equal, f"fused_stream {label}: tokens differ from the "
            "unfused kernels")


def phase_kernels(torch, F, peaks):
    from repro_torch.core import basecaller as bc
    from repro_torch.data.flowcell import step_basecaller
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    table = KernelTable()
    cfg = bc.BasecallerConfig()
    params = bc.init(torch.Generator().manual_seed(0), cfg, device=dev)
    lanes, chunk = 512, 256
    inputs = path_layer_inputs(torch, bc, params, cfg, lanes, chunk, gen)
    for sp, x in zip(bc.stream_layer_specs(cfg), inputs):
        p = params[sp.name]
        if sp.is_head:
            b, t, c = x.shape
            check_matmul(torch, peaks, table, x.reshape(b * t, c).contiguous(),
                         p["w"][0], p["b"], "none", f"path {sp.name}", True)
        else:
            check_conv1d(torch, F, peaks, table, x, p["w"], p["b"], sp.stride,
                         sp.activation, f"path {sp.name}", True)
    # edge shapes: Cin=1 -> Cout=5 (the step codec), 7 lanes, odd T, ragged M
    scfg, sparams = step_basecaller(dev)
    x = (torch.randint(0, 5, (7, 63, 1), generator=gen).float() * 2).to(dev)
    check_conv1d(torch, F, peaks, table, x, sparams["conv1"]["w"],
                 sparams["conv1"]["b"], 2, "relu", "edge step conv1", False)
    x = torch.randn((7, 61, 3), generator=gen).to(dev)
    w = torch.randn((5, 3, 70), generator=gen).to(dev)
    check_conv1d(torch, F, peaks, table, x, w, None, 1, "gelu",
                 "edge ragged T/Cout gelu", False)
    a = torch.randn((1000, 37), generator=gen).to(dev)
    w = torch.randn((37, 5), generator=gen).to(dev)
    bias = torch.randn((5,), generator=gen).to(dev)
    for act in ("none", "relu", "silu", "gelu", "squared_relu"):
        check_matmul(torch, peaks, table, a, w, bias, act,
                     f"edge ragged M {act}", False)
    # banded: the mapper's shape (4 candidates x 512 lanes, 48 vs 80)
    q = torch.randint(1, 5, (2048, 48), generator=gen, dtype=torch.int32)
    t = torch.cat([q, torch.randint(0, 5, (2048, 32), generator=gen,
                                    dtype=torch.int32)], 1)
    mut = torch.rand(t.shape, generator=gen) < 0.1
    t = torch.where(mut, torch.randint(0, 5, t.shape, generator=gen,
                                       dtype=torch.int32), t)
    check_banded(torch, peaks, table, q.to(dev), t.to(dev), 32, True,
                 "path 2048x48 vs 80", True)
    for band, local in ((3, False), (3, True), (0, False), (47, False)):
        check_banded(torch, peaks, table, q[:7].to(dev), t[:7, :50].to(dev),
                     band, local, f"edge 7 pairs band {band}", False)
    # fused: the tick at full width, then 7 lanes, then the step codec
    check_fused(torch, bc, peaks, table, params, cfg,
                fused_inputs(torch, bc, cfg, lanes, chunk, gen, dev),
                "path 512 lanes x 256", True)
    check_fused(torch, bc, peaks, table, params, cfg,
                fused_inputs(torch, bc, cfg, 7, 64, gen, dev),
                "edge 7 lanes x 64", False)
    rows = (torch.randint(0, 5, (7, 64), generator=gen).float() * 2)
    sin = list(fused_inputs(torch, bc, scfg, 7, 64, gen, dev))
    sin[0] = rows.to(dev)
    check_fused(torch, bc, peaks, table, sparams, scfg, tuple(sin),
                "edge step codec 7 lanes", False)
    return table


# --------------------------------------------------------------- phase 3 --
def step_engine(lanes, *, device, depth, fused):
    import numpy as np

    import repro_torch.engine as te
    from repro_torch.data import genome as G
    from repro_torch.realtime.policy import Decision, PolicyConfig
    ref = G.random_genome(np.random.default_rng(7), 6_000)
    return te.build(
        "adaptive_sampling", channels=lanes, chunk=64, reference=ref,
        targets=[(0, 3_000)],
        flowcell={"encoder": "step", "n_reads": 24, "read_len": (64, 128),
                  "recovery_samples": 64, "stagger_samples": 16, "seed": 3},
        policy=PolicyConfig(min_prefix_bases=24, map_prefix_bases=32,
                            max_prefix_bases=96, min_mapq=4.0,
                            timeout_decision=Decision.ACCEPT,
                            eject_latency_samples=32),
        device=device, pipeline_depth=depth, fused=fused)


def golden(engine):
    recs = sorted(engine.records, key=lambda r: r.read_id)
    return [(r.read_id, r.decision.value, r.reason, r.bases_at_decision,
             r.mapped_pos) for r in recs]


def phase_step_goldens():
    runs = {}
    for fused in (False, True):
        for depth in (1, 2):
            eng = step_engine(8, device="cuda", depth=depth, fused=fused)
            eng.drain(max_steps=20_000)
            runs[f"cuda fused={fused} depth={depth}"] = golden(eng)
    eng = step_engine(8, device="cpu", depth=1, fused=False)
    eng.drain(max_steps=20_000)
    runs["cpu plain"] = golden(eng)
    first = runs["cpu plain"]
    equal = {k: v == first for k, v in runs.items()}
    decisions = sorted({g[1] for g in first})
    emit({"phase": "step_goldens", "reads": len(first), "equal": equal,
          "decisions": decisions})
    require(len(first) == 24, f"step flowcell resolved {len(first)} of 24")
    require(all(equal.values()), f"step goldens differ: {equal}")


# --------------------------------------------------------------- phase 4 --
FULL_FLOWCELL = {"encoder": "pore", "n_reads": 1024}


def full_engine(fused):
    import torch

    import repro_torch.engine as te
    from repro_torch.core import basecaller as bc
    cfg = bc.BasecallerConfig()
    params = bc.init(torch.Generator().manual_seed(0), cfg)
    return te.build("adaptive_sampling", preset="flowcell_512", cfg=cfg,
                    params=params, flowcell=dict(FULL_FLOWCELL), fused=fused)


def min_margin_on_evidence(torch, engine, rec) -> float:
    """Smallest plain-logit top-2 margin over the frames a read's decision
    rested on (its signal up to the decision, basecalled whole)."""
    from repro_torch.core import basecaller as bc
    from repro_torch.data.flowcell import FlowcellSimulator
    rt = engine.runtime
    sim = FlowcellSimulator(engine.panel.reference, engine.flowcell.config)
    sig = sim._synthesize(rec.read_id).signal
    chunk = rt.chunk_samples
    n = -(-max(rec.samples_at_decision, 1) // chunk) * chunk
    buf = torch.zeros((1, n))
    piece = torch.from_numpy(sig[:n])
    buf[0, :len(piece)] = piece
    cpu_params = {k: {kk: vv.cpu() for kk, vv in v.items()}
                  for k, v in rt.params.items()}
    logits = bc.apply(cpu_params, buf, rt.cfg, padding="stream")
    frames = len(piece) // rt.cfg.total_stride
    return float(top2_margin(torch, logits[0, :frames]).min().item())


def phase_full_width(torch):
    out = {}
    engines = {}
    for fused in (True, False):
        eng = full_engine(fused)
        t0 = time.perf_counter()
        rep = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        engines[fused] = eng
        fab = {k: v for k, v in rep.items() if k.startswith("fabric.")}
        line = {"phase": "full_width", "fused": fused,
                "lanes": eng.runtime.channels,
                "chunk": eng.runtime.chunk_samples,
                "reads": rep["reads"], "accepted": rep["accepted"],
                "ejected": rep["ejected"], "timeouts": rep["timeouts"],
                "exhausted": rep["exhausted"],
                "bases": eng.telemetry.bases,
                "bases_per_s": rep["bases_per_s"],
                "decision_p50_ms": rep["decision_p50_ms"],
                "decision_p99_ms": rep["decision_p99_ms"],
                "ticks": rep["steps"],
                "mean_tick_ms": rep["wall_s"] / max(rep["steps"], 1) * 1e3,
                "stage_s": {k: v for k, v in rep.items()
                            if k.startswith("stage_")},
                "drain_wall_s": wall, "fabric": fab}
        emit(line)
        out[fused] = line
        require(rep["reads"] == FULL_FLOWCELL["n_reads"],
                f"full width fused={fused}: {rep['reads']} reads resolved")
        require(all(k.endswith(".cuda") for k in fab
                    if k.startswith("fabric.dispatch.")),
                f"full width fused={fused}: a dispatch left the card: {fab}")
        want = (("fused_stream", "banded_align") if fused
                else ("conv1d", "matmul", "banded_align"))
        for op in want:
            require(fab.get(f"fabric.dispatch.{op}.cuda", 0) > 0,
                    f"full width fused={fused}: no {op} dispatch")
    g_f, g_u = golden(engines[True]), golden(engines[False])
    by_id = {r.read_id: r for r in engines[True].records}
    differ = [a[0] for a, b in zip(g_f, g_u) if a != b]
    margins = {rid: min_margin_on_evidence(torch, engines[True], by_id[rid])
               for rid in differ}
    emit({"phase": "full_width_goldens", "reads": len(g_f),
          "differing_reads": len(differ),
          "differing_min_margins": margins})
    require(len(g_f) == len(g_u), "fused and unfused resolved other reads")
    require(all(m < 1e-4 for m in margins.values()),
            f"fused/unfused goldens differ away from a near tie: {margins}")
    return out


# ------------------------------------------------------------------ main --
KERNELS = {
    "conv1d": ("src/repro_torch/kernels/csrc/conv1d.cu",
               "src/repro/kernels/conv1d.py:122"),
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
               "src/repro/kernels/matmul.py:120"),
    "fused_stream": ("src/repro_torch/kernels/csrc/fused_stream.cu",
                     "src/repro/kernels/fused_stream.py:376"),
    "banded_align": ("src/repro_torch/kernels/csrc/banded_align.cu",
                     "src/repro/kernels/edit_distance.py:115"),
}


def launch_counters():
    from repro_torch.kernels import conv1d, edit_distance, fused_stream, matmul
    return {"conv1d": conv1d.conv1d, "matmul": matmul.matmul,
            "fused_stream": fused_stream.fused_stream_cuda,
            "banded_align": edit_distance.banded_align}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch is missing; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import ref
    ref.full_fp32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "unknown"
    name = torch.cuda.get_device_name(0)
    peaks = peaks_for(name)
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "card", "nvidia_smi": card, "name": name,
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "peaks": peaks, "built": built, "build_s": build_s,
          "ptxas": {k: [ln for ln in v.splitlines() if "registers" in ln
                        or "smem" in ln] for k, v in _build.PTXAS_LOG.items()}})

    table = phase_kernels(torch, F, peaks)
    phase_step_goldens()

    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    phase_full_width(torch)
    launches = {k: fn.launches for k, fn in counters.items()}
    for k, n in launches.items():
        require(n > 0, f"kernel {k} never launched on the main path")

    kernels = []
    for k, (src, replaces) in KERNELS.items():
        r = table.rows[k]
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[k], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
