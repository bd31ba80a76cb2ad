#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. ``card``: the card's name and power limit (nvidia-smi), the time to
   build the CUDA kernels with nvcc (one nvcc per source, in parallel)
   and each kernel's registers and spill bytes (``ptxas -v``).
2. ``kernel``: each of the eleven main-path kernels (fp32 conv1d, matmul,
   fused_stream and banded_align; int8 conv1d, matmul and fused_stream;
   levenshtein; flash_attention, ssd_scan and the bf16 matmul) against its
   plain PyTorch version on the card, at the flowcell tick's shapes (512
   lanes x chunk 256, the paper's CNN; int8 after the ``edge_int8``
   calibration), the ``basecall`` workload's (16 x 2048, "same" padding;
   fp32 also at its calibration's 2 x 2048), the genomics slice's
   (levenshtein at the demux shape, banded_align at the pathogen
   firehose, the variant caller's convs), the LM prefill's (flash_attention
   at qwen3-4b's 1 x 4096 and at 32768, checked on its first, middle and
   last 512 rows; ssd_scan at mamba2-780m's 48 heads x 4096 and 32768;
   the three qwen3-4b MLP GEMMs at 4096 tokens on the bf16 matmul's wgmma
   kernel, and its general mma.sync kernel at K = 2558, a shape TMA
   cannot address), edge shapes, and sizes the port once refused (fp32
   conv1d at Cin 512 and 65,537 batch rows, int8 conv1d at Cin 2,048, fp32
   matmul past 65,535 x 64 rows, banded_align at m = 908 and 2,048,
   levenshtein at 1,000, banded_align at n = 30,000 (stripes through
   device scratch); int8 matmul at M = 4,194,305, the bf16 matmul's
   mma.sync kernel at M = 8,388,481, flash_attention at Sq = 8,388,481
   and ssd_scan at 65,536 heads, past the 2-D grids' y limits): max abs
   error (bitwise for int32 outputs and for every int8 kernel; bf16 bars
   in the ``tol`` fields), which kernel ran where a function has two
   (``variant``: conv1d on the tensor cores, 3xTF32, or the CUDA cores;
   conv1d_int8 on the tensor cores, mma.sync s8, or dp4a; matmul
   skinny-N or tiled, matmul_int8 by its route (skinny, narrow, tc,
   dp4a); the fused ticks' layers, fp32 and int8,
   on the tensor cores or the CUDA cores; banded_align and levenshtein
   their lane ``plan``: G lanes a pair, R rows a lane, stripes and where
   they hand on), kernel, plain and library times, and
   the bound the card's data sheet sets (conv1d, the fused tick and
   ssd_scan also ``bound_fp32_ms``, at the CUDA cores' fp32 rate, beside
   ``bound_ms`` at the TF32 rate of the products the kernel forms; the
   fused tick ``unfused_ms``, the unfused chain's six launches on the
   same inputs, and whether it equals them bit for bit; the int8 fused
   tick whether its tokens and carries equal the unfused int8 kernels';
   the head matmuls, conv1d_int8, banded_align, levenshtein and both
   fused ticks also ``device_ms``, the kernels' device time with their
   launches queued back to back, since issuing them takes the host
   longer than the card takes to run them; ssd_scan
   ``device_ms_by_pass``, each of its three kernels by the profiler).
   ``kernels_generic``: the 3xTF32 flash route (f32, bf16 and f16 at
   every head dim the bf16 wgmma kernel does not take up to 256, padded
   ones included, causal and not, GQA, ragged Sq) and the CUDA-core
   kernel one head dim past it, each case's kernel asserted by counter,
   against the plain attention at each dtype's bar; both against the
   wgmma kernel on the same bf16 inputs; row 5g timed at qwen3-4b's
   attention in f32 (1 x 4096) on the 3xTF32 wgmma kernel, beside the
   CUDA-core kernel it replaced (``was_ms``) and SDPA f32 (the library,
   its kernel's name from the profiler); row 5m, the 3xTF32 mma.sync
   kernel, at lm_parity_f32's qwen3-4b smoke shape (D 16) and at row
   5g's inputs; the SSD at four (ds, dh) pairs outside DIMS on the
   tensor-core passes (zero-padded to a built pair where they are not
   one) and one past (128, 128) on the recurrence kernel, in f32 and bf16;
   row 6g timed at 24 heads x 4096 with (ds, dh) = (128, 128) beside the
   recurrence kernel, and the recurrence kernel beside the tensor-core
   passes at mamba2-780m's shape.
3. ``step_goldens``: the step-codec flowcell (8 lanes) on the card, fused
   and unfused x pipeline depth 1 and 2, and once on the CPU (plain): all
   five per-read goldens must be equal; once with fp32 params, once with
   int8 params calibrated on the codec's own signal.
4. ``full_width``: the ``flowcell_512`` preset with the paper's CNN
   (``BasecallerConfig()``, random weights from a seed) on the pore
   encoder, fused and unfused: reads, bases/s, decision p50/p99, mean
   tick, the ``fabric.*`` counters, and the fused/unfused golden diff (a
   differing read is allowed only where the plain logits' top-2 margin on
   its evidence is < 1e-4); the unfused run's conv2-conv5 on the
   tensor-core conv1d (4 launches a step) and every head on the skinny
   matmul, every fused step with 4 conv layers on the tensor cores.  Then
   ``edge_int8`` at the same width, with the same CNN calibrated once by
   ``quantize_edge_params``: the same metrics, goldens fused == unfused
   with no exception, every unfused step's conv2-conv5 on the tensor-core
   int8 conv and its head on the skinny int8 matmul, every fused int8
   step with its 4 conv layers on the tensor cores, and three ticks on 8
   lanes equal to the CPU's plain run bit for bit.
5. ``basecall``: the ``basecall`` workload, ``default`` and ``edge_int8``,
   at batch 16 x chunk 2048 on the card and on the CPU (plain): int8 reads
   equal; a float read may differ only where every frame whose class
   differs between card and CPU has a plain top-2 margin < 1e-4;
   ``edge_int8``'s conv2-conv5 on the tensor-core int8 conv.
6. ``pathogen``: the ``pathogen_pipeline`` workload, ``default`` and
   ``edge_int8``, at the paper's widths (32 channels x 2048 samples a
   chunk, depth 2, one warm-up and 8 chunks of squiggles simulated from
   pathogen-X) against the CPU (the rules of phase 5), then ``detect(256)``
   on its reads against a 29,903- and a 10,000-base panel: every read x
   window score equal to the plain banded_align on the card, 16 seeded
   reads' assignment equal to the CPU's.  256 known reads through demux
   (equal to its plain version on card and CPU), primer trim and
   ``detect`` in ``ed`` and ``fm`` modes (pathogen-X present, pathogen-Y
   absent).  The variant caller on a 30-SNP pileup, within 2e-5.
7. ``lm_prefill``: qwen3-4b (36 layers) and mamba2-780m (48 layers) at
   their published widths and depths, random bf16 params from a
   ``torch.Generator`` on the card (seed 0), through
   ``repro_torch.launch.steps.prefill`` at 1 x 4096 (prefill_32k cut for
   the run's time, printed as ``reduced``): median wall ms of 3 runs after
   a warm-up, tokens/s, finite logits, exactly 36 flash_attention and 108
   matmul_bf16 launches a qwen3-4b prefill (all 108 on the wgmma kernel)
   and 48 ssd_scan a mamba2-780m one.  ``lm_parity``: both at depth 2
   and 1 x 512 on the card and on the CPU with the same params: the last
   token's final-normed hidden state, rms of the difference within 2^-7
   of its rms, and its logits within 2 bf16 ulps of max |logit|.
   ``lm_parity_f32``: the f32 smoke configs (qwen3-4b on the 3xTF32
   flash route's mma.sync kernel at D 16 and, at its own head dim 128,
   on its wgmma kernel; mamba2-780m on the SSD passes' DIMS pair, and
   mamba2-780m's smoke at (ds, dh) = (64, 32) zero-padded to the (128,
   64) passes) on the card against the CPU within 1e-4, then each
   distinct flash_attention and ssd_scan call of that path again on its
   own inputs against its plain version, each naming the route and
   kernel it took.
   ``dense_prefill``: nemotron-4-15b, starcoder2-3b and minicpm-2b the
   same way (each freed before the next is built; the peak memory of
   each init printed): 1 x 4096, median of 3 beside the 1,000 ms limit
   (reported), launches a prefill (32 flash_attention and 64 matmul_bf16,
   30 and 60, 40 and 120, all on the wgmma kernel), and ``lm_parity`` at
   depth 2.
   ``lm_decode``: the ``full`` preset (8 slots x 512) for qwen3-4b and
   mamba2-780m at full width and depth, 16 requests with 4-token prompts
   and 32 new tokens: tokens/s, each step's decode-stage ms, request
   p50/p99, matmul_bf16 launches (all on the narrow-M kernel, 108 a
   qwen3-4b step) and the fabric counters; one timed qwen3-4b step at 8
   slots with a 32,768-long cache (decode_32k's batch 128 cut to 8);
   the f32 smoke configs of the five archs card against CPU (equal
   tokens, each step's logits within 1e-4), bf16 at full width and depth
   2 (four steps' logits within 2 bf16 ulps), the f32 forward equal to
   step-by-step decode within JAX's 2e-2, and two ``lm_decode`` tenants
   of one fleet on one ``LMUnit``, each equal to its solo run; then
   ``matmul_bf16_decode`` (row 2d: qwen3-4b's three MLP GEMMs at M = 1,
   8 and 16 on the narrow-M kernel, a row alone equal to the same row of
   the M = 8 call, a second run equal to the first, bit for bit).
   ``lm_tp``: ``matmul_int8_lm`` (row 2l: qwen3-4b's seven decode
   projections at M = 1, 8 and 16 on the narrow-M kernel and at M = 32
   and 4,096 on the tiled tensor-core one, the TP 2 ranks' shapes and two
   ragged ones, every line naming its route, bitwise, beside
   ``torch._int_mm`` at M = 32, the least M it takes); the int8
   qwen3-4b (``quantize_params(stack_dims=1)`` of seeded bf16 params) on
   the ``full`` preset, 16 requests: tokens/s, step ms, 252 narrow-M int8
   launches a step, peak memory, and at depth 2 card against CPU within
   ``lm_decode``'s bf16 bars; two tensor-parallel ranks on the one card
   over gloo (``distributed.launch.run``): the collectives on CUDA
   tensors, the f32 smoke qwen3-4b and mamba2-780m (JAX's 1e-5) against
   TP 1 on the card, the int8 qwen3-4b at full width 8 steps bit for bit
   and token for token against one rank, a converter -> ``sharded``
   checkpoint loaded pre-partitioned (counters, each rank's columns) and
   serving bit for bit; ``serve --tp 2 --ckpt`` in a subprocess.
8. ``fleet``: four tenants on one ``repro_torch.fleet.Fleet`` on the
   card: ``lab-fc`` (``flowcell_512`` with phase 4's CNN, pore encoder,
   1,024 reads, depth 2, fused; weight 2), ``lab-bc1`` and ``lab-bc2``
   (``basecall`` default, 16 x 2048, 36 rows each, sharing one engine) and
   ``lab-pp`` (``pathogen_pipeline`` default, phase 6's 8 chunks, then
   ``detect(256)``).  With every request queued at once, every tenant's
   goldens, reads, tokens and detect report, and every engine's
   ``fabric_counters()``, equal the same engine drained solo on the card
   bit for bit; prints the tick shares against the weights, the DRR
   fairness ratio and ``mesh_yields_inflight``.  A traced run's Chrome
   trace passes ``validate_chrome_trace`` with one read span per
   ``lab-fc`` read and a process track per tenant.  Then the basecall
   rows arrive on benchmarks/fleet.py's bursts: the results again equal
   solo (the shared engine's dispatch count aside), and it prints each
   tenant's p50/p99, each row's arrival-to-result p50/p99 in the fleet
   and solo, and the fleet's wall against the sum of the solo walls.
   Last, ``flowcell_512`` alone, untraced, traced, traced, untraced, with
   the garbage collector live and then frozen after set-up: mean tick,
   the collector's ms by generation, the tracer's us an event and the
   tracing's ``overhead_pct`` (reported, not gated).
9. ``field``: ``run_field_scenario(FieldSpec())`` (8 edge devices on the
   fused ``edge_int8`` tick, 2 infected, 8 channels x chunk 128, 32
   molecules each; the aggregator a fleet tenant) on the card and on the
   CPU: outbreak, conservation, variants, each device's accepted reads
   and the read-frame bytes equal; the card's wall, ticks, bytes on wire
   and the three reductions (``reduction_vs_sequenced`` beside JAX's bar
   of 20); reads conserved per device and the outbreak detected; a
   traced card run's trace validates with 8 device tracks and the
   aggregator's.  Trace timestamps are host times.
10. ``train``: the micro basecaller (``train_micro_basecaller``'s
   DEMO_CFG): one step on the card against the CPU, float and QAT (loss
   within 1e-5, gradients within 1e-4 of their largest entry, the forward
   on the hand conv1d), 220 ``train_step`` calls on the card (the loop of
   tests/test_system.py) to JAX's bar (last loss under half the first,
   read accuracy > 0.55 at default_rng(77)), a QAT
   ``train_micro_basecaller`` run quantized once and served as an
   ``edge_int8`` flowcell on the card
   and the CPU with equal goldens, and a checkpoint round trip, bit for
   bit.
10b. ``lm_train``: LM training (``train/trainer.py`` -> ``models/``):
   each training kernel's gradient by route (flash_attention's wgmma,
   3xTF32 mma.sync and wgmma and CUDA-core kernels, ssd_scan's passes at
   a DIMS pair, padded and past (128, 128), matmul_bf16's wgmma and
   mma.sync kernels) against plain autograd of its plain version on the
   same card inputs; one f32 smoke ``make_train_step`` step of the
   ``lm_parity_f32`` configs on the card against the CPU (the loss, every
   gradient and every updated param by ``LM_TRAIN_RULE``); 20 smoke steps
   of qwen3-4b and mamba2-780m through ``launch.train.main`` with a
   failure at step 7 and a checkpoint every 5, equal bit for bit to the
   uninterrupted run; qwen3-4b and mamba2-780m at full width and depth, 8
   x 128, random bf16 params from a ``torch.Generator`` on the card, the
   launcher's AdamW (f32 moments) and remat, one warm-up and 5 steps:
   finite losses, median step ms, tokens/s, peak memory, launches a step
   (72 flash_attention and 216 matmul_bf16, all on the wgmma kernel, for
   qwen3-4b; 96 ssd_scan for mamba2-780m: remat runs each forward twice)
   and, from one profiled step, the share of the ``PlainGrad``
   backward's span (reported, not gated); ``python -m
   repro_torch.launch.train --smoke --steps 20 --fail-at 7`` in a
   subprocess exits 0.
11. ``serve_cli``: ``python -m repro_torch.launch.serve`` in subprocesses:
   basecall, adaptive_sampling (with ``--trace`` and ``--timeseries``,
   both validated) and pathogen_pipeline, ``--fleet`` on a four-tenant
   spec (one ``lm_decode``), ``--field`` on a two-device spec,
   ``lm_decode`` on its ``smoke`` preset and on ``full`` with 8 requests
   of 16 new tokens; each exits 0, with its wall.
12. ``{"kernels": [...]}``: every kernel with its launches in phases 4-11,
   counted from 0 just before each path and read just after it, and
   ``train_launches``, those of the ``lm_train`` paths
   (``matmul_bf16`` also with ``wgmma_launches`` and ``narrow_launches``,
   those on its wgmma and narrow-M kernels; ``matmul_bf16_decode``, row
   2d, its launches on the ``lm_decode`` paths with ``narrow_launches``,
   ``wgmma_launches``, ``variant``, ``device_ms`` and
   ``library_device_ms`` (``torch.matmul``);
   ``matmul_int8_lm``, row 2l, its launches on the ``lm_tp`` paths with
   ``narrow_launches`` and ``tc_launches``, ``device_ms``,
   ``library_m`` (32: ``library_ms`` is ``torch._int_mm`` there),
   ``kernel_ms_at_library_m``, ``bound_ms_at_library_m`` and
   ``at_4096``;
   ``conv1d`` with ``tc_launches`` and ``bound_fp32_ms``;
   ``conv1d_int8`` with ``tc_launches`` and ``device_ms``;
   ``banded_align`` with ``device_ms``, ``plan`` and ``firehose`` (the
   pathogen compare's pairs, ms, device ms, bound and plan);
   ``levenshtein`` with ``device_ms`` and ``plan``;
   ``matmul`` with ``skinny_launches``; ``matmul_int8`` with
   ``skinny_launches``, ``narrow_launches``, ``tc_launches``,
   ``dp4a_launches``, ``device_ms`` and ``library_device_ms``;
   ``fused_stream`` with ``tc_launches``, ``tc_layers``, ``device_ms``,
   ``unfused_ms``, ``unfused_device_ms`` and ``bound_fp32_ms``;
   ``fused_stream_int8`` with ``tc_launches``, ``tc_layers`` and
   ``device_ms``; ``ssd_scan`` with ``device_ms``, ``device_ms_by_pass``
   and ``bound_fp32_ms``; ``flash_attention_tf32x3_wgmma`` (row 5g),
   ``flash_attention_tf32x3`` (row 5m, the mma.sync kernel) and
   ``ssd_scan_padded`` (row 6g) with ``bound_fp32_ms`` beside
   ``bound_ms`` at the 3xTF32 rate, ``was_ms`` (the CUDA-core kernel,
   same inputs) and ``generic_launches`` (its launches on the main
   paths), row 5g also ``library_kernels``, row 5m also
   ``qwen3_4b_d128_ms`` and ``qwen3_4b_d128_bound_ms`` (at row 5g's
   inputs), row 6g ``device_ms_by_pass``; each 3xTF32 row counts its own
   kernel, ``flash_attention`` its bf16 wgmma kernel only and
   ``ssd_scan`` its ``DIMS`` pairs only).

TF32 is off for the whole run (``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32``): the plain versions and the
float32 library calls are fp32, like the kernels (the bf16 ones sum in
float32).  Any failed check exits non-zero.
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
# CUDA cores, TF32, bf16 and int8 on the tensor cores (TF32 half of bf16)
# and device-memory bandwidth, by H100 part.
PEAKS = {
    "sxm": {"fp32_flops": 67e12, "tf32_flops": 495e12, "bf16_flops": 989e12,
            "int8_ops": 1979e12, "bytes_per_s": 3.35e12},
    "pcie": {"fp32_flops": 51e12, "tf32_flops": 378e12, "bf16_flops": 756e12,
             "int8_ops": 1513e12, "bytes_per_s": 2.0e12},
    "nvl": {"fp32_flops": 60e12, "tf32_flops": 417.5e12,
            "bf16_flops": 835e12, "int8_ops": 1671e12,
            "bytes_per_s": 3.9e12},
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


def bound_ms(peaks, nbytes: float, ops: float, int_ops: bool = False,
             int8: bool = False, bf16: bool = False, tf32x3: bool = False):
    """The least time for ``nbytes`` of traffic and ``ops`` operations:
    fp32 on the CUDA cores, int32 at half that, int8 MACs (2 ops each) at
    the int8 tensor-core peak, bf16 FLOP at the bf16 tensor-core peak, or
    fp32-accurate FLOP as three TF32 products each at the TF32 peak
    (``tf32x3``)."""
    if int8:
        rate = peaks["int8_ops"]
    elif bf16:
        rate = peaks["bf16_flops"]
    elif tf32x3:
        rate = peaks["tf32_flops"] / 3.0
    else:
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


_SLEEP_CYCLES_PER_MS = []


def sleep_cycles_per_ms(torch) -> float:
    """Cycles of ``torch.cuda._sleep`` a millisecond on this card, timed
    once with events (the card's clock under load is not assumed)."""
    if not _SLEEP_CYCLES_PER_MS:
        cycles = 20_000_000
        torch.cuda._sleep(cycles)  # warm
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        stop.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS.append(cycles / start.elapsed_time(stop))
    return _SLEEP_CYCLES_PER_MS[0]


def device_ms(torch, fn, reps: int = 20) -> float:
    """Mean device time of one call of ``fn``, its launches run back to
    back: they are queued behind a kernel that sleeps for three times the
    host's time to issue them plus 1 ms, so the events time the card and
    not the host, where issuing a launch takes longer than running it (the
    event timing of ``time_ms``).  The profiler is not used: over many
    launches it can drop records."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((3 * host_ms + 1) * sleep_cycles_per_ms(torch)))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_device_ms(torch, fn, reps: int = 5) -> dict:
    """Device ms a call of each kernel ``fn`` launches, by kernel name:
    ``torch.profiler`` over ``reps`` calls after a warm-up (a few launches,
    so no record is dropped)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.name.split("(")[0].split("<")[0].split(" ")[-1]
            out[name] = out.get(name, 0.0) + ev.time_range.elapsed_us() / 1e3
    return {k: v / reps for k, v in out.items()}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# --------------------------------------------------------------- phase 2 --
class KernelTable:
    """Per-kernel accumulation of phase-2 measurements at path shapes."""

    def __init__(self):
        self.rows = {}

    def add(self, name, *, err, ms, plain_ms, bound, bound_by, library_ms,
            bound_fp32=None):
        r = self.rows.setdefault(name, {
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bound_by": bound_by, "library_ms": None if library_ms is None
            else 0.0, "bound_parts": {}})
        if bound_fp32 is not None:
            r["bound_fp32_ms"] = r.get("bound_fp32_ms", 0.0) + bound_fp32
        r["max_abs_err"] = max(r["max_abs_err"], float(err))
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += bound
        r["bound_parts"][bound_by] = r["bound_parts"].get(bound_by, 0.0) + bound
        if library_ms is not None:
            r["library_ms"] += library_ms
        r["bound_by"] = max(r["bound_parts"], key=r["bound_parts"].get)


def plain_layer_inputs(torch, bc, params, cfg, x, stream: bool, gen):
    """Each layer's float input from the plain chain (int8 MACs where the
    weights are quantized): ``[carry | chunk]`` rows with a random carry
    in stream mode, "same" padded otherwise.  Returns [(spec, input)]."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.quant import core as qcore
    dev = x.device
    out = []
    for sp in bc.stream_layer_specs(cfg):
        p = params[sp.name]
        if stream and sp.carry_rows:
            carry = 0.1 * torch.randn((x.shape[0], sp.carry_rows, sp.cin),
                                      generator=gen).to(dev).abs()
            x = torch.cat([carry, x], dim=1)
        elif not stream:
            t = x.shape[1]
            t_out = -(-t // sp.stride)
            pad = max((t_out - 1) * sp.stride + sp.ksize - t, 0)
            x = F.pad(x, (0, 0, pad // 2, pad - pad // 2))
        x = x.contiguous()
        out.append((sp, x))
        if sp.is_head:
            break
        mac = ops.int8_reference if qcore.is_quantized(p["w"]) else ref.conv1d
        x = mac(x, p["w"], p["b"], stride=sp.stride, activation=sp.activation)
    return out


def check_conv1d(torch, F, peaks, table, x, w, b, stride, act, label,
                 on_path):
    """fp32 conv1d vs its plain version within F32_TOL; ``variant`` says
    which kernel ran (``tensor_cores``: 3xTF32, or ``cuda_cores``).  On a
    path: kernel, plain and cuDNN ms, ``bound_ms`` at the rate of the
    kernel that ran and ``bound_fp32_ms`` at the CUDA cores' fp32 rate."""
    from repro_torch.kernels import conv1d as kc
    from repro_torch.kernels import ref
    before = kc.conv1d.tc_launches
    out = kc.conv1d(x, w, b, stride=stride, activation=act)
    tc = kc.conv1d.tc_launches > before
    want = ref.conv1d(x, w, b, stride=stride, activation=act)
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    ok = torch.allclose(out, want, rtol=F32_TOL, atol=F32_TOL)
    line = {"phase": "kernel", "kernel": "conv1d", "shape": label,
            "x": list(x.shape), "w": list(w.shape), "stride": stride,
            "variant": "tensor_cores" if tc else "cuda_cores",
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
        io = nbytes(x, w, b, out)
        bnd, by = bound_ms(peaks, io, ops, tf32x3=tc)
        bnd32, _ = bound_ms(peaks, io, ops)
        line.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                    bound_by=by, bound_fp32_ms=bnd32)
    if on_path == "tick":
        table.add("conv1d", err=err, ms=ms, plain_ms=plain, bound=bnd,
                  bound_by=by, library_ms=lib, bound_fp32=bnd32)
    emit(line)
    require(ok, f"conv1d {label}: max abs err {err} over {F32_TOL}")


def check_matmul(torch, peaks, table, a, w, b, act, label, on_path):
    """fp32 matmul vs its plain version within F32_TOL; ``variant`` says
    which kernel ran (``skinny`` for N <= 8, else ``tiled``)."""
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import ref
    before = km.matmul.skinny_launches
    out = km.matmul(a, w, b, activation=act)
    thin = km.matmul.skinny_launches > before
    want = ref.matmul(a, w, b, activation=act)
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    ok = torch.allclose(out, want, rtol=F32_TOL, atol=F32_TOL)
    line = {"phase": "kernel", "kernel": "matmul", "shape": label,
            "a": list(a.shape), "b": list(w.shape),
            "variant": "skinny" if thin else "tiled", "max_abs_err": err,
            "tol": F32_TOL}
    if on_path:
        ms = time_ms(torch, lambda: km.matmul(a, w, b, activation=act))
        plain = time_ms(torch, lambda: ref.matmul(a, w, b, activation=act))
        lib = time_ms(torch, lambda: torch.addmm(b, a, w))
        m, k = a.shape
        ops = 2.0 * m * k * w.shape[1]
        bnd, by = bound_ms(peaks, nbytes(a, w, b, out), ops)
        line.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                    bound_by=by,
                    device_ms=device_ms(
                        torch, lambda: km.matmul(a, w, b, activation=act)),
                    library_device_ms=device_ms(
                        torch, lambda: torch.addmm(b, a, w)))
    if on_path == "tick":
        table.add("matmul", err=err, ms=ms, plain_ms=plain, bound=bnd,
                  bound_by=by, library_ms=lib)
    emit(line)
    require(ok, f"matmul {label}: max abs err {err} over {F32_TOL}")


def wavefront_plan(fn, q, t, before):
    """The lane plan of a wavefront launch (``edit_distance.plan``: G lanes
    a pair, R rows a lane, stripes, handoff), checked against the
    wrapper's ``stripe_launches`` and ``scratch_launches`` since
    ``before``."""
    from repro_torch.kernels import edit_distance as ke
    lay = ke.plan(q.shape[1], t.shape[1])
    ran = (fn.stripe_launches - before[0], fn.scratch_launches - before[1])
    require(ran == (int(lay.stripes > 1), int(lay.handoff == "scratch")),
            f"{fn.__name__} {tuple(q.shape)} x {tuple(t.shape)}: counted "
            f"{ran} stripe/scratch launches for the plan {lay}")
    return lay._asdict()


def dp_bound(torch, peaks, q, t, out, band):
    """The DP's cells (|i - j| <= band) and its bound: 8 int32 operations
    a cell (3 adds, 3 max, a compare-select, the band test) at the int32
    rate, or the bytes of q, t and out."""
    m, n = q.shape[1], t.shape[1]
    if band >= max(m, n):
        cells = m * n * q.shape[0]
    else:
        i = torch.arange(1, m + 1)[:, None]
        j = torch.arange(1, n + 1)[None, :]
        cells = int(((i - j).abs() <= band).sum().item()) * q.shape[0]
    bnd, by = bound_ms(peaks, nbytes(q, t, out), 8.0 * cells, int_ops=True)
    return cells, bnd, by


def check_banded(torch, peaks, table, q, t, band, local, label, on_path):
    """banded_align vs its plain version, bitwise, with the lane plan the
    launch took; on the path its kernel, device and plain ms and bound."""
    from repro_torch.kernels import edit_distance as ke
    from repro_torch.kernels import ref
    kw = dict(band=band, match=2, mismatch=-4, gap=-2, local=local)
    fn = ke.banded_align
    before = (fn.stripe_launches, fn.scratch_launches)
    out = ke.banded_align(q, t, **kw)
    lay = wavefront_plan(fn, q, t, before)
    want = ref.banded_align(q, t, **kw)
    torch.cuda.synchronize()
    diff = int((out != want).sum().item())
    line = {"phase": "kernel", "kernel": "banded_align", "shape": label,
            "q": list(q.shape), "t": list(t.shape), "band": band,
            "local": local, "plan": lay, "mismatches": diff}
    if on_path:
        ms = time_ms(torch, lambda: ke.banded_align(q, t, **kw))
        dms = device_ms(torch, lambda: ke.banded_align(q, t, **kw))
        plain = time_ms(torch, lambda: ref.banded_align(q, t, **kw), reps=3,
                        warm=1)
        cells, bnd, by = dp_bound(torch, peaks, q, t, out, band)
        line.update(ms=ms, device_ms=dms, plain_ms=plain, library_ms=None,
                    bound_ms=bnd, bound_by=by, cells=cells)
        table.add("banded_align", err=float(diff), ms=ms, plain_ms=plain,
                  bound=bnd, bound_by=by, library_ms=None)
        table.rows["banded_align"].update(device_ms=dms, plan=lay)
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
    """Fused kernel vs its plain twin and vs the unfused kernels.
    Tokens/lens/prev/bases/ticks must be equal wherever the plain logits'
    top-2 margin is >= 1e-4; carries within STACK_TOL.  ``variant`` gives
    each layer's kernel inside the fused one (``tensor_cores``: 3xTF32, or
    ``cuda_cores``); whether the fused carries and tokens equal the unfused
    kernels' bit for bit is reported, not required.  On the path: kernel,
    device, plain and unfused (five conv1d launches and the head on the
    same inputs) times, ``bound_ms`` at the rate of the kernel each layer
    runs and ``bound_fp32_ms`` at the CUDA cores' fp32 rate."""
    from repro_torch.core import ctc
    from repro_torch.kernels import fused_stream as fs
    rows, pads, reset, prev, bases, ticks, conv = inputs
    args = (rows, pads, reset, prev, bases, ticks, conv, params)
    specs = bc.stream_layer_specs(cfg)
    before = (fs.fused_stream_cuda.tc_launches, fs.fused_stream_cuda.tc_layers)
    tok, lens, lane = fs.fused_stream_cuda(*args, cfg=cfg)
    tc_layers = fs.fused_stream_cuda.tc_layers - before[1]
    require(fs.fused_stream_cuda.tc_launches - before[0] == (tc_layers > 0),
            f"fused_stream {label}: tc_launches miscounted")
    tc = [fs.on_tensor_cores(sp) for sp in specs]
    require(tc_layers == sum(tc), f"fused_stream {label}: {tc_layers} layers "
            f"on the tensor cores, the predicate says {sum(tc)}")
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
    # the unfused kernels on the same inputs: the same tokens except where
    # the plain logits nearly tie
    from repro_torch.kernels import conv1d as kc
    from repro_torch.kernels import matmul as km
    rmask = reset > 0
    x = rows[..., None]
    layer_in, carries_u = [], []
    for i, sp in enumerate(specs):
        p = params[sp.name]
        if sp.is_head:
            b, t, c = x.shape
            xin = x.reshape(b * t, c).contiguous()
            layer_in.append(xin)
            x = km.matmul(xin, p["w"][0], p["b"]).reshape(b, t, sp.cout)
            carries_u.append(conv[i])
        else:
            carry = torch.where(rmask[:, None, None], 0.0, conv[i])
            xin = torch.cat([carry, x], 1).contiguous()
            layer_in.append(xin)
            carries_u.append(xin[:, xin.shape[1] - sp.carry_rows:])
            x = kc.conv1d(xin, p["w"], p["b"], stride=sp.stride,
                          activation=sp.activation)
    prev0 = torch.where(rmask, 0, prev)
    tok_u, lens_u, _ = ctc.greedy_decode_stream(x, prev0, pads)
    unfused_diff = (tok_u != tok).any(dim=1) | (lens_u != lens)
    unfused_bad = int((unfused_diff & ~near_tie_lanes).sum().item())
    line = {"phase": "kernel", "kernel": "fused_stream", "shape": label,
            "lanes": rows.shape[0], "chunk": rows.shape[1],
            "variant": {sp.name: "tensor_cores" if t else "cuda_cores"
                        for sp, t in zip(specs, tc)},
            "int_lanes_differing": int(int_diff.sum().item()),
            "int_lanes_differing_above_margin": bad_lanes,
            "near_tie_lanes": int(near_tie_lanes.sum().item()),
            "carry_max_abs_err": carry_err, "carry_tol": STACK_TOL,
            "unfused_lanes_differing": int(unfused_diff.sum().item()),
            "unfused_lanes_differing_above_margin": unfused_bad,
            "carries_equal_unfused_bitwise": all(
                torch.equal(a, b) for a, b in zip(lane["conv"], carries_u)),
            "tokens_equal_unfused_bitwise": bool(
                torch.equal(tok_u, tok) and torch.equal(lens_u, lens)),
            "frames_class_mismatch_vs_plain": int(
                ((classes != ctc.argmax_classes(x)) & (pads <= 0)).sum())}
    if on_path:
        def fused():
            fs.fused_stream_cuda(*args, cfg=cfg)

        def unfused():
            for sp, xin in zip(specs, layer_in):
                p = params[sp.name]
                if sp.is_head:
                    km.matmul(xin, p["w"][0], p["b"])
                else:
                    kc.conv1d(xin, p["w"], p["b"], stride=sp.stride,
                              activation=sp.activation)
        ms = time_ms(torch, fused)
        unfused_ms = time_ms(torch, unfused)
        plain = time_ms(torch, lambda: fs._fused_reference(*args, cfg=cfg),
                        reps=5)
        lanes, chunk = rows.shape
        flop = {True: 0.0, False: 0.0}
        t = chunk
        weights = []
        for sp, on_tc in zip(specs, tc):
            t //= sp.stride
            flop[on_tc] += 2.0 * lanes * t * sp.cout * sp.ksize * sp.cin
            weights += [params[sp.name]["w"], params[sp.name]["b"]]
        io = nbytes(rows, pads, reset, prev, bases, ticks, *conv, *weights,
                    tok, lens, *lane["conv"], lane["prev_class"],
                    lane["bases"], lane["ticks"])
        # the least time at each layer's rate: operations add across the
        # two rates, against the bytes of the whole tick
        t_ops = (bound_ms(peaks, 0, flop[True], tf32x3=True)[0]
                 + bound_ms(peaks, 0, flop[False])[0])
        t_io = bound_ms(peaks, io, 0)[0]
        bnd, by = max(t_ops, t_io), ("operations" if t_ops >= t_io
                                     else "bytes")
        bnd32, _ = bound_ms(peaks, io, flop[True] + flop[False])
        line.update(ms=ms, device_ms=device_ms(torch, fused),
                    unfused_ms=unfused_ms,
                    unfused_device_ms=device_ms(torch, unfused),
                    plain_ms=plain, library_ms=None, bound_ms=bnd,
                    bound_by=by, bound_fp32_ms=bnd32,
                    gflop=(flop[True] + flop[False]) / 1e9,
                    gflop_tensor_cores=flop[True] / 1e9)
        table.add("fused_stream", err=carry_err, ms=ms, plain_ms=plain,
                  bound=bnd, bound_by=by, library_ms=None, bound_fp32=bnd32)
        table.rows["fused_stream"].update(
            device_ms=line["device_ms"], unfused_ms=unfused_ms,
            unfused_device_ms=line["unfused_device_ms"])
    emit(line)
    require(bad_lanes == 0, f"fused_stream {label}: {bad_lanes} lanes differ "
            "from the plain version away from a near tie")
    require(carry_ok, f"fused_stream {label}: carries off by {carry_err}")
    require(unfused_bad == 0, f"fused_stream {label}: {unfused_bad} lanes "
            "differ from the unfused kernels away from a near tie")


# ----------------------------------------------------------- int8 checks --
def check_conv1d_int8(torch, peaks, table, x, w, stride, label, on_path):
    """int8 conv kernel vs its plain version, bitwise (int32 out), with the
    weights as ``ops.conv1d_int8`` passes them (B fragments for the
    tensor-core kernel, packed words for the dp4a one); ``variant`` says
    which kernel ran (``tensor_cores`` or ``cuda_cores``).  On a path also
    ``device_ms`` (launches queued back to back)."""
    from repro_torch.kernels import conv1d as kc
    from repro_torch.kernels import ref
    from repro_torch.quant.core import pack_fragments, pack_words
    k, cin, cout = w.shape
    kw = dict(stride=stride, w_packed=None, w_fragments=None)
    if kc.int8_tensor_core_shape(cin, cout, k, stride):
        kw["w_fragments"] = pack_fragments(w)
    elif cin % 4 == 0:
        kw["w_packed"] = pack_words(w)
    before = kc.conv1d_int8.tc_launches
    out = kc.conv1d_int8(x, w, **kw)
    tc = kc.conv1d_int8.tc_launches > before
    want = ref.conv1d_int8(x, w, stride=stride)
    torch.cuda.synchronize()
    diff = int((out != want).sum().item())
    line = {"phase": "kernel", "kernel": "conv1d_int8", "shape": label,
            "x": list(x.shape), "w": list(w.shape), "stride": stride,
            "variant": "tensor_cores" if tc else "cuda_cores",
            "elements_differing": diff}
    if on_path:
        ms = time_ms(torch, lambda: kc.conv1d_int8(x, w, **kw))
        dms = device_ms(torch, lambda: kc.conv1d_int8(x, w, **kw))
        plain = time_ms(torch, lambda: ref.conv1d_int8(x, w, stride=stride),
                        reps=5)
        ops = 2.0 * out.shape[0] * out.shape[1] * cout * k * cin
        bnd, by = bound_ms(peaks, nbytes(x, w, out), ops, int8=True)
        line.update(ms=ms, device_ms=dms, plain_ms=plain, library_ms=None,
                    bound_ms=bnd, bound_by=by)
        if on_path == "tick":
            table.add("conv1d_int8", err=diff, ms=ms, plain_ms=plain,
                      bound=bnd, bound_by=by, library_ms=None)
            r = table.rows["conv1d_int8"]
            r["device_ms"] = r.get("device_ms", 0.0) + dms
    emit(line)
    require(diff == 0, f"conv1d_int8 {label}: {diff} outputs differ")


def check_matmul_int8(torch, peaks, table, a, w, label, on_path):
    """int8 GEMM kernel vs its plain version, bitwise; ``variant`` says
    which kernel ran (``matmul.route_int8``: ``skinny`` for N <= 8,
    ``narrow`` / ``tc`` on the tensor cores, ``dp4a``).  The library
    call is torch._int_mm (cuBLASLt), which needs N % 8 == 0: N is
    zero-padded to 8 for it.  On a path also ``device_ms`` and
    ``library_device_ms`` (``device_ms``): the host takes longer to issue
    the launch than the card to run it."""
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import ref
    route = km.route_int8(a.shape[0], w.shape[1], a.shape[1], a.data_ptr(),
                          w.data_ptr())
    out = km.matmul_int8(a, w)
    want = ref.matmul_int8(a, w)
    torch.cuda.synchronize()
    diff = int((out != want).sum().item())
    line = {"phase": "kernel", "kernel": "matmul_int8", "shape": label,
            "a": list(a.shape), "b": list(w.shape), "variant": route,
            "elements_differing": diff}
    if on_path:
        ms = time_ms(torch, lambda: km.matmul_int8(a, w))
        plain = time_ms(torch, lambda: ref.matmul_int8(a, w))
        n = w.shape[1]
        wpad = torch.zeros((w.shape[0], -(-n // 8) * 8), dtype=torch.int8,
                           device=w.device)
        wpad[:, :n] = w
        lib_out = torch._int_mm(a, wpad)
        require(torch.equal(lib_out[:, :n], want),
                f"matmul_int8 {label}: torch._int_mm disagrees")
        lib = time_ms(torch, lambda: torch._int_mm(a, wpad))
        m, k = a.shape
        bnd, by = bound_ms(peaks, nbytes(a, w, out), 2.0 * m * k * n,
                           int8=True)
        line.update(ms=ms, plain_ms=plain, library_ms=lib,
                    library_call=f"torch._int_mm, N padded {n} -> "
                                 f"{wpad.shape[1]}",
                    bound_ms=bnd, bound_by=by,
                    device_ms=device_ms(torch, lambda: km.matmul_int8(a, w)),
                    library_device_ms=device_ms(
                        torch, lambda: torch._int_mm(a, wpad)))
        if on_path == "tick":
            table.add("matmul_int8", err=diff, ms=ms, plain_ms=plain,
                      bound=bnd, bound_by=by, library_ms=lib)
            table.rows["matmul_int8"]["device_ms"] = line["device_ms"]
            table.rows["matmul_int8"]["library_device_ms"] = line[
                "library_device_ms"]
    emit(line)
    require(diff == 0, f"matmul_int8 {label}: {diff} outputs differ")
    return route


def check_fused_int8(torch, bc, peaks, table, qparams, cfg, inputs, label,
                     on_path):
    """The int8 fused tick vs its plain twin and the unfused int8 kernels:
    tokens, lens, counters and carries bit for bit.  ``variant`` gives each
    layer's kernel inside the fused one (``tensor_cores``: mma.sync s8, or
    ``cuda_cores``), counted in ``tc_layers_int8``.  On the path also the
    device time (``device_ms``)."""
    from repro_torch.core import ctc
    from repro_torch.kernels import fused_stream as fs
    from repro_torch.kernels import ops
    rows, pads, reset, prev, bases, ticks, conv = inputs
    args = (rows, pads, reset, prev, bases, ticks, conv, qparams)
    specs = bc.stream_layer_specs(cfg)
    before = (fs.fused_stream_cuda.tc_launches_int8,
              fs.fused_stream_cuda.tc_layers_int8)
    tok, lens, lane = fs.fused_stream_cuda(*args, cfg=cfg)
    tc_layers = fs.fused_stream_cuda.tc_layers_int8 - before[1]
    require(fs.fused_stream_cuda.tc_launches_int8 - before[0]
            == (tc_layers > 0), f"fused_stream_int8 {label}: "
            "tc_launches_int8 miscounted")
    tc = [fs.on_tensor_cores(sp, quantized=True) for sp in specs]
    require(tc_layers == sum(tc), f"fused_stream_int8 {label}: {tc_layers} "
            f"layers on the tensor cores, the predicate says {sum(tc)}")
    tok_p, lens_p, lane_p = fs._fused_reference(*args, cfg=cfg)
    torch.cuda.synchronize()
    int_diff = ((tok != tok_p).any(dim=1) | (lens != lens_p)
                | (lane["prev_class"] != lane_p["prev_class"])
                | (lane["bases"] != lane_p["bases"])
                | (lane["ticks"] != lane_p["ticks"]))
    carries_equal = all(torch.equal(a, b) for a, b in zip(lane["conv"],
                                                          lane_p["conv"]))
    rmask = reset > 0
    x = rows[..., None]
    carries_u = []
    for i, sp in enumerate(specs):
        p = qparams[sp.name]
        if sp.is_head:
            b, t, c = x.shape
            x = ops.mat_mul(x.reshape(b * t, c), p["w"].head_matrix(),
                            p["b"]).reshape(b, t, sp.cout)
            carries_u.append(conv[i])
        else:
            carry = torch.where(rmask[:, None, None], 0.0, conv[i])
            xin = torch.cat([carry, x], 1)
            carries_u.append(xin[:, xin.shape[1] - sp.carry_rows:])
            x = ops.conv1d(xin, p["w"], p["b"], stride=sp.stride,
                           padding="valid", activation=sp.activation)
    tok_u, lens_u, _ = ctc.greedy_decode_stream(
        x, torch.where(rmask, 0, prev), pads)
    unfused_equal = bool(torch.equal(tok_u, tok) and torch.equal(lens_u, lens))
    # each carry is a layer's input, so the fused layers' outputs equal the
    # unfused kernels' bit for bit
    carries_unfused = all(torch.equal(a, b)
                          for a, b in zip(lane["conv"], carries_u))
    line = {"phase": "kernel", "kernel": "fused_stream_int8", "shape": label,
            "lanes": rows.shape[0], "chunk": rows.shape[1],
            "variant": {sp.name: "tensor_cores" if t else "cuda_cores"
                        for sp, t in zip(specs, tc)},
            "int_lanes_differing": int(int_diff.sum().item()),
            "carries_equal": carries_equal,
            "equal_to_unfused_kernels": unfused_equal,
            "carries_equal_unfused_bitwise": carries_unfused,
            "bases_called": int(lens.sum().item())}
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
            w = qparams[sp.name]["w"]
            weights += [w.q, w.dequant_scale(), w.act_scale,
                        qparams[sp.name]["b"]]
        io = nbytes(rows, pads, reset, prev, bases, ticks, *conv, *weights,
                    tok, lens, *lane["conv"], lane["prev_class"],
                    lane["bases"], lane["ticks"])
        bnd, by = bound_ms(peaks, io, 2.0 * macs, int8=True)
        line.update(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bnd,
                    bound_by=by, gop=2.0 * macs / 1e9,
                    device_ms=device_ms(torch, lambda: fs.fused_stream_cuda(
                        *args, cfg=cfg)))
        table.add("fused_stream_int8", err=float(int_diff.sum().item()),
                  ms=ms, plain_ms=plain, bound=bnd, bound_by=by,
                  library_ms=None)
        table.rows["fused_stream_int8"]["device_ms"] = line["device_ms"]
    emit(line)
    require(not bool(int_diff.any()), f"fused_stream_int8 {label}: lanes "
            "differ from the plain version")
    require(carries_equal, f"fused_stream_int8 {label}: carries differ")
    require(unfused_equal, f"fused_stream_int8 {label}: tokens differ from "
            "the unfused int8 kernels")
    require(carries_unfused, f"fused_stream_int8 {label}: carries differ "
            "from the unfused int8 kernels' layer inputs")


def quantize_step_codec():
    """The step codec stored int8, calibrated on its own signal (the
    synthetic-noise calibration of the edge_int8 preset clips its levels),
    once on the CPU; returns (cfg, params on the CPU)."""
    import numpy as np

    from repro_torch.core import basecaller as bc
    from repro_torch.data import flowcell as fc
    from repro_torch.data import genome as G
    cfg, params = fc.step_basecaller("cpu")
    ref = G.random_genome(np.random.default_rng(7), 6_000)
    chunks = [fc.step_encode(ref[i:i + 200])[None, :512]
              for i in range(0, 4000, 1000)]
    return cfg, bc.quantize(params, cfg, chunks=chunks,
                            observer="percentile", pct=99.9)


def phase_kernels_int8(torch, peaks, table, cfg, qparams, gen):
    from repro_torch.core import basecaller as bc
    from repro_torch.quant import core as qcore
    dev = torch.device("cuda")
    lanes, chunk = 512, 256

    def check_layers(sig, stream, on_path, label):
        for sp, x in plain_layer_inputs(torch, bc, qparams, cfg,
                                        sig[..., None], stream, gen):
            w = qparams[sp.name]["w"]
            xq = qcore.quantize(x, w.act_scale).contiguous()
            if sp.is_head:
                b, t, c = xq.shape
                check_matmul_int8(torch, peaks, table, xq.reshape(b * t, c),
                                  w.q[0].contiguous(), f"{label} {sp.name}",
                                  on_path)
            else:
                check_conv1d_int8(torch, peaks, table, xq, w.q, sp.stride,
                                  f"{label} {sp.name}", on_path)
    check_layers(torch.randn((lanes, chunk), generator=gen).to(dev), True,
                 "tick", "path")
    # the basecall workload: 16 rows x 2048 samples, "same" padding
    check_layers(torch.randn((16, 2048), generator=gen).to(dev), False,
                 "basecall", "basecall")
    # edge shapes: Cin=1 -> Cout=5, odd T, 7 rows, Cin % 4 != 0, ragged M
    i8 = dict(dtype=torch.int8)

    def rnd(*shape):
        return torch.randint(-127, 128, shape, generator=gen, **i8).to(dev)
    check_conv1d_int8(torch, peaks, table, rnd(7, 63, 1), rnd(2, 1, 5), 2,
                      "edge Cin=1 Cout=5 odd T", False)
    check_conv1d_int8(torch, peaks, table, rnd(7, 61, 6), rnd(5, 6, 70), 1,
                      "edge Cin=6 Cout=70", False)
    check_conv1d_int8(torch, peaks, table, rnd(7, 61, 8), rnd(9, 8, 70), 2,
                      "edge packed Cout=70", False)
    check_matmul_int8(torch, peaks, table, rnd(1000, 37), rnd(37, 5),
                      "edge ragged M K=37 N=5", False)
    check_matmul_int8(torch, peaks, table, rnd(65, 5), rnd(5, 5),
                      "edge step head 65x5x5", False)
    # fused: the tick at full width, 7 lanes, and the int8 step codec
    check_fused_int8(torch, bc, peaks, table, qparams, cfg,
                     fused_inputs(torch, bc, cfg, lanes, chunk, gen, dev),
                     "path 512 lanes x 256", True)
    check_fused_int8(torch, bc, peaks, table, qparams, cfg,
                     fused_inputs(torch, bc, cfg, 7, 64, gen, dev),
                     "edge 7 lanes x 64", False)
    scfg, sparams = quantize_step_codec()
    sin = list(fused_inputs(torch, bc, scfg, 7, 64, gen, dev))
    sin[0] = (torch.randint(0, 5, (7, 64), generator=gen).float() * 2).to(dev)
    check_fused_int8(torch, bc, peaks, table, bc.params_to(sparams, dev),
                     scfg, tuple(sin), "edge int8 step codec 7 lanes", False)


def phase_kernels(torch, F, peaks):
    import numpy as np

    from repro_torch.core import basecaller as bc
    from repro_torch.data.flowcell import step_basecaller
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    table = KernelTable()
    cfg = bc.BasecallerConfig()
    params = bc.init(torch.Generator().manual_seed(0), cfg, device=dev)
    lanes, chunk = 512, 256

    def check_layers(sig, stream, on_path, label, head_as_conv=False):
        for sp, x in plain_layer_inputs(torch, bc, params, cfg,
                                        sig[..., None], stream, gen):
            p = params[sp.name]
            if sp.is_head and not head_as_conv:
                b, t, c = x.shape
                check_matmul(torch, peaks, table, x.reshape(b * t, c),
                             p["w"][0], p["b"], sp.activation,
                             f"{label} {sp.name}", on_path)
            else:
                check_conv1d(torch, F, peaks, table, x, p["w"], p["b"],
                             sp.stride, sp.activation, f"{label} {sp.name}",
                             on_path)
    check_layers(torch.randn((lanes, chunk), generator=gen).to(dev), True,
                 "tick", "path")
    # the basecall workload: 16 rows x 2048 samples, "same" padding
    check_layers(torch.randn((16, 2048), generator=gen).to(dev), False,
                 "basecall", "basecall")
    # its edge_int8 build's calibration: the float chain, head as a k=1
    # conv, on quantize_edge_params's first (2, 2048) chunk
    calib = np.random.default_rng(0).normal(size=(2, 2048))
    check_layers(torch.from_numpy(calib.astype(np.float32)).to(dev), False,
                 False, "calibration", head_as_conv=True)
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


def phase_kernels_limits(torch, F, peaks, table, gen):
    """Phase 2 at sizes the port once refused and JAX takes: fp32 conv1d at
    Cin 512 (K 9, stride 2) on both kernels and past 65,535 batch rows,
    int8 conv1d at Cin 2,048, fp32 matmul at N 8 and 9 and past 65,535 x
    64 rows, banded_align at m = 908 and 2,048 and levenshtein at 1,000
    (in stripes of 256 rows), and banded_align at n = 30,000 (the stripes'
    last rows through device scratch)."""
    from repro_torch.kernels import edit_distance as ke
    from repro_torch.kernels import ref
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)
    for cout in (64, 5):
        check_conv1d(torch, F, peaks, table, rnd(4, 300, 512).abs(),
                     rnd(9, 512, cout, scale=(2.0 / (9 * 512)) ** 0.5),
                     rnd(cout), 2, "relu", f"limit Cin=512 K=9 s=2 "
                     f"Cout={cout}", False)
    check_conv1d(torch, F, peaks, table, rnd(65_537, 20, 8), rnd(5, 8, 8),
                 rnd(8), 1, "none", "limit batch 65537", False)
    i8 = dict(dtype=torch.int8, generator=gen)
    check_conv1d_int8(torch, peaks, table,
                      torch.randint(-127, 128, (2, 200, 2048), **i8).to(dev),
                      torch.randint(-127, 128, (9, 2048, 64), **i8).to(dev),
                      2, "limit Cin=2048 K=9 s=2", False)
    a = rnd(1001, 128)
    for n in (8, 9):
        check_matmul(torch, peaks, table, a, rnd(128, n), rnd(n), "relu",
                     f"limit N={n} ragged M", False)
    for k, n in ((16, 5), (4, 9)):
        check_matmul(torch, peaks, table, rnd(4_194_305, k), rnd(k, n),
                     rnd(n), "none", f"limit M=4194305 K={k} N={n}", False)
    tok = dict(dtype=torch.int32, generator=gen)
    for p, m, band in ((1, 908, 908), (64, 2048, 64)):
        q = torch.randint(1, 5, (p, m), **tok)
        t = torch.where(torch.rand((p, m), generator=gen) < 0.1,
                        torch.randint(0, 5, (p, m), **tok), q)
        for local in (False, True):
            check_banded(torch, peaks, table, q.to(dev), t.to(dev), band,
                         local, f"limit {p} pairs m=n={m}", False)
    q = torch.randint(1, 5, (3, 300), **tok)
    t = torch.randint(0, 5, (3, 30_000), **tok)
    t[1, 5000:5300] = q[1]
    check_banded(torch, peaks, table, q.to(dev), t.to(dev), 400, True,
                 "limit 3 pairs m=300 n=30000", False)
    q = torch.randint(1, 5, (5, 1000), **tok)
    t = torch.where(torch.rand(q.shape, generator=gen) < 0.2,
                    torch.randint(1, 5, q.shape, **tok), q)
    q, t = q.to(dev), t.to(dev)
    fn = ke.levenshtein
    before = (fn.stripe_launches, fn.scratch_launches)
    diff = int((ke.levenshtein(q, t) != ref.edit_distance(q, t)).sum())
    emit({"phase": "kernel", "kernel": "levenshtein",
          "shape": "limit 5 pairs m=n=1000",
          "plan": wavefront_plan(fn, q, t, before), "mismatches": diff})
    require(diff == 0, f"levenshtein at m=n=1000: {diff} distances differ")
    phase_grid_limits(torch, gen)


def phase_grid_limits(torch, gen):
    """Sizes past the 2-D grids' y limits that four kernels once had and
    JAX does not: int8 matmul at M = 4,194,305 on each route that numbers
    its blocks along x (N 5 skinny, K 128 N 64 the tiled tensor-core
    kernel, K 124 N 64 the dp4a tile; bitwise), the bf16 matmul's
    mma.sync kernel at M = 8,388,481 (K 12, which TMA cannot address; one
    bf16 ulp of max |out|), flash attention at Sq = 8,388,481 against 128
    keys (the first, middle and last 512 rows within the flash bar) and
    ssd_scan at B * H = 65,536 heads (the first, middle and last 512 heads
    within SSD_TOL)."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as kssd
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(11)
    for k, n, want in ((128, 5, "skinny"), (128, 64, "tc"),
                       (124, 64, "dp4a")):
        a = torch.randint(-127, 128, (4_194_305, k), generator=g,
                          device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                          dtype=torch.int8)
        route = check_matmul_int8(torch, None, None, a, w,
                                  f"limit M=4194305 K={k} N={n}", False)
        require(route == want, f"matmul_int8 at M=4194305 K={k} N={n} ran "
                f"{route}, not {want}")
        del a
    a = torch.randn((8_388_481, 12), generator=g, device=dev).bfloat16()
    w = torch.randn((12, 8), generator=g, device=dev).bfloat16()
    before = km.matmul_bf16.wgmma_launches
    out = km.matmul_bf16(a, w)
    ran = "wgmma" if km.matmul_bf16.wgmma_launches > before else "mma.sync"
    want = ref.matmul(a, w)
    err = (out.float() - want.float()).abs().max().item()
    tol = bf16_ulp(want.float().abs().max().item())
    emit({"phase": "kernel", "kernel": "matmul_bf16",
          "shape": "limit M=8388481 K=12 N=8", "variant": ran,
          "max_abs_err": err, "tol": tol})
    require(ran == "mma.sync" and err <= tol,
            f"matmul_bf16 at M=8388481: {ran}, max abs err {err} over {tol}")
    del a, out, want
    sq = 8_388_481
    q = torch.randn((1, 1, sq, 64), generator=g, device=dev).bfloat16()
    k = torch.randn((1, 1, 128, 64), generator=g, device=dev).bfloat16()
    v = torch.randn((1, 1, 128, 64), generator=g, device=dev).bfloat16()
    out = kfa.flash_attention(q, k, v, causal=False)
    excess = 0.0
    for r in (0, sq // 2 - LM_ROWS // 2, sq - LM_ROWS):
        qq = q[:, :, r:r + LM_ROWS]
        excess = max(excess, flash_excess(
            out[:, :, r:r + LM_ROWS], ref.attention(qq, k, v, causal=False),
            ref.attention(qq, k, v.abs(), causal=False)))
    emit({"phase": "kernel", "kernel": "flash_attention",
          "shape": "limit B=H=1 Sq=8388481 Skv=128 D=64 not causal",
          "checked_rows": [f"first {LM_ROWS}", f"middle {LM_ROWS}",
                           f"last {LM_ROWS}"],
          "err_over_bar": excess, "tol": FA_RULE})
    require(excess <= 1.0, f"flash_attention at Sq=8388481: error {excess} "
            "x its bar")
    del q, out
    bh = 65_536
    x = torch.randn((bh, 64, 16), generator=g, device=dev) * 0.5
    la = -torch.nn.functional.softplus(torch.randn((bh, 64), generator=g,
                                                   device=dev))
    b = torch.randn((bh, 64, 16), generator=g, device=dev) * 0.3
    c = torch.randn((bh, 64, 16), generator=g, device=dev) * 0.3
    y = kssd.ssd_scan(x, la, b, c, chunk=32)
    err = 0.0
    for h in (0, bh // 2 - 256, bh - 512):
        part = slice(h, h + 512)
        want = ref.ssd_scan(x[part], la[part], b[part], c[part])[0]
        err = max(err, (y[part] - want).abs().max().item())
    emit({"phase": "kernel", "kernel": "ssd_scan",
          "shape": "limit BH=65536 T=64 ds=dh=16 chunk 32",
          "checked_heads": ["first 512", "middle 512", "last 512"],
          "max_abs_err": err, "tol": SSD_TOL})
    require(err <= SSD_TOL, f"ssd_scan at BH=65536: max abs err {err}")
    del x, la, b, c, y
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 3 --
def step_engine(lanes, *, device, depth, fused, cfg=None, params=None):
    import numpy as np

    import repro_torch.engine as te
    from repro_torch.core import basecaller as bc
    from repro_torch.data import genome as G
    from repro_torch.realtime.policy import Decision, PolicyConfig
    ref = G.random_genome(np.random.default_rng(7), 6_000)
    extra = {}
    if params is not None:
        extra = {"cfg": cfg, "params": bc.params_to(params, device)}
    return te.build(
        "adaptive_sampling", channels=lanes, chunk=64, reference=ref,
        targets=[(0, 3_000)],
        flowcell={"encoder": "step", "n_reads": 24, "read_len": (64, 128),
                  "recovery_samples": 64, "stagger_samples": 16, "seed": 3},
        policy=PolicyConfig(min_prefix_bases=24, map_prefix_bases=32,
                            max_prefix_bases=96, min_mapq=4.0,
                            timeout_decision=Decision.ACCEPT,
                            eject_latency_samples=32),
        device=device, pipeline_depth=depth, fused=fused, **extra)


def golden(engine):
    recs = sorted(engine.records, key=lambda r: r.read_id)
    return [(r.read_id, r.decision.value, r.reason, r.bases_at_decision,
             r.mapped_pos) for r in recs]


def phase_step_goldens(precision="fp32", cfg=None, params=None):
    runs = {}
    for fused in (False, True):
        for depth in (1, 2):
            eng = step_engine(8, device="cuda", depth=depth, fused=fused,
                              cfg=cfg, params=params)
            eng.drain(max_steps=20_000)
            runs[f"cuda fused={fused} depth={depth}"] = golden(eng)
    eng = step_engine(8, device="cpu", depth=1, fused=False, cfg=cfg,
                      params=params)
    eng.drain(max_steps=20_000)
    runs["cpu plain"] = golden(eng)
    first = runs["cpu plain"]
    equal = {k: v == first for k, v in runs.items()}
    decisions = sorted({g[1] for g in first})
    emit({"phase": "step_goldens", "precision": precision,
          "reads": len(first), "equal": equal, "decisions": decisions})
    require(len(first) == 24, f"step flowcell resolved {len(first)} of 24")
    require(all(equal.values()), f"{precision} step goldens differ: {equal}")
    require(decisions == ["accept", "eject"],
            f"{precision} step flowcell decided only {decisions}")


# --------------------------------------------------------------- phase 4 --
FULL_FLOWCELL = {"encoder": "pore", "n_reads": 1024}


def full_engine(fused, trace=False):
    import torch

    import repro_torch.engine as te
    from repro_torch.core import basecaller as bc
    cfg = bc.BasecallerConfig()
    params = bc.init(torch.Generator().manual_seed(0), cfg)
    return te.build("adaptive_sampling", preset="flowcell_512", cfg=cfg,
                    params=params, flowcell=dict(FULL_FLOWCELL), fused=fused,
                    trace=trace)


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


def drive_full_width(torch, eng, label, fused, want_ops):
    """Drain one full-width flowcell engine and report its metrics."""
    t0 = time.perf_counter()
    rep = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fab = {k: v for k, v in rep.items() if k.startswith("fabric.")}
    line = {"phase": "full_width", "path": label, "fused": fused,
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
            "soc_energy_precision": rep["soc_energy_precision"],
            "drain_wall_s": wall, "fabric": fab}
    emit(line)
    require(rep["reads"] == FULL_FLOWCELL["n_reads"],
            f"{label} fused={fused}: {rep['reads']} reads resolved")
    require(all(k.endswith(".cuda") for k in fab
                if k.startswith("fabric.dispatch.")),
            f"{label} fused={fused}: a dispatch left the card: {fab}")
    for op in want_ops:
        require(fab.get(f"fabric.dispatch.{op}.cuda", 0) > 0,
                f"{label} fused={fused}: no {op} dispatch")
    return line


def phase_full_width(torch):
    out = {}
    engines = {}
    for fused in (True, False):
        eng = full_engine(fused)
        want = (("fused_stream", "banded_align") if fused
                else ("conv1d", "matmul", "banded_align"))
        out[fused] = drive_full_width(torch, eng, "flowcell_512", fused, want)
        engines[fused] = eng
    g_f, g_u = golden(engines[True]), golden(engines[False])
    by_id = {r.read_id: r for r in engines[True].records}
    differ = [a[0] for a, b in zip(g_f, g_u) if a != b]
    margins = {rid: min_margin_on_evidence(torch, engines[True], by_id[rid])
               for rid in differ}
    emit({"phase": "full_width_goldens", "path": "flowcell_512",
          "reads": len(g_f), "differing_reads": len(differ),
          "differing_min_margins": margins})
    require(len(g_f) == len(g_u), "fused and unfused resolved other reads")
    require(all(m < 1e-4 for m in margins.values()),
            f"fused/unfused goldens differ away from a near tie: {margins}")
    return out


def unfused_launches(counts, ticks):
    """The fp32 ticks' launches: unfused, conv2-conv5 on the tensor-core
    conv1d (4 a step), conv1 on the CUDA cores, and every head (one a step)
    on the skinny-N matmul; fused, every step with its 4 conv layers on the
    tensor cores.  ``ticks`` counts the busy ticks only; a step runs 5
    convs and one head."""
    conv, tc = counts.get("conv1d", 0), counts.get("conv1d_tc", 0)
    mm, thin = counts.get("matmul", 0), counts.get("matmul_skinny", 0)
    fused = counts.get("fused_stream", 0)
    ftc = counts.get("fused_stream_tc", 0)
    ftc_layers = counts.get("fused_stream_tc_layers", 0)
    emit({"phase": "full_width_launches", "path": "flowcell_512",
          "busy_ticks": ticks, "steps": mm, "conv1d": conv,
          "conv1d_tc": tc, "matmul": mm, "matmul_skinny": thin,
          "conv1d_tc_per_step": tc / max(mm, 1), "fused_stream": fused,
          "fused_stream_tc": ftc,
          "fused_tc_layers_per_step": ftc_layers / max(fused, 1)})
    require(conv > 0 and 5 * tc == 4 * conv,
            f"flowcell_512 unfused: {tc} of {conv} conv1d launches on the "
            "tensor cores, not 4 of every 5")
    require(mm > 0 and thin == mm,
            f"flowcell_512 unfused: {thin} of {mm} head matmuls skinny")
    require(fused > 0 and ftc == fused and ftc_layers == 4 * fused,
            f"flowcell_512 fused: {ftc} of {fused} steps with conv layers on "
            f"the tensor cores, {ftc_layers} such layers, not 4 a step")


def int8_conv_on_tensor_cores(counts, path):
    """conv2-conv5 of every unfused int8 step on the tensor-core int8 conv
    (4 of its 5 conv1d_int8 launches a step; conv1 on dp4a)."""
    conv, tc = counts.get("conv1d_int8", 0), counts.get("conv1d_int8_tc", 0)
    require(conv > 0 and 5 * tc == 4 * conv,
            f"{path}: {tc} of {conv} conv1d_int8 launches on the tensor "
            "cores, not 4 of every 5")
    return {"conv1d_int8": conv, "conv1d_int8_tc": tc}


def int8_launches(counts):
    """Every unfused edge_int8 step with conv2-conv5 on the tensor-core int8
    conv and its head on the skinny-N int8 matmul (the fused int8 tick
    launches neither), and every fused int8 step with its 4 conv layers on
    the tensor cores."""
    convs = int8_conv_on_tensor_cores(counts, "edge_int8 unfused")
    mm = counts.get("matmul_int8", 0)
    thin = counts.get("matmul_int8_skinny", 0)
    fused = counts.get("fused_stream_int8", 0)
    ftc = counts.get("fused_stream_int8_tc", 0)
    ftc_layers = counts.get("fused_stream_int8_tc_layers", 0)
    emit({"phase": "full_width_launches", "path": "edge_int8", **convs,
          "matmul_int8": mm, "matmul_int8_skinny": thin,
          "fused_stream_int8": fused, "fused_stream_int8_tc": ftc,
          "fused_tc_layers_per_step": ftc_layers / max(fused, 1)})
    require(mm > 0 and thin == mm,
            f"edge_int8 unfused: {thin} of {mm} head matmul_int8 skinny")
    require(fused > 0 and ftc == fused and ftc_layers == 4 * fused,
            f"edge_int8 fused: {ftc} of {fused} steps with conv layers on "
            f"the tensor cores, {ftc_layers} such layers, not 4 a step")


def int8_engine(cfg, qparams, fused):
    import repro_torch.engine as te
    return te.build("adaptive_sampling", preset="edge_int8", cfg=cfg,
                    params=qparams, channels=512, chunk=256,
                    pipeline_depth=2, flowcell=dict(FULL_FLOWCELL),
                    fused=fused)


def phase_full_width_int8(torch, cfg, qparams):
    """edge_int8 at full width, fused and unfused: integer sums, so the
    goldens must be equal read for read, with no near-tie exception."""
    engines, out = {}, {}
    for fused in (True, False):
        eng = int8_engine(cfg, qparams, fused)
        want = (("fused_stream", "banded_align") if fused
                else ("conv1d", "matmul", "banded_align"))
        out[fused] = drive_full_width(torch, eng, "edge_int8", fused, want)
        require(out[fused]["soc_energy_precision"] == "int8",
                "edge_int8 engine is not int8")
        engines[fused] = eng
    g_f, g_u = golden(engines[True]), golden(engines[False])
    differ = sum(a != b for a, b in zip(g_f, g_u))
    emit({"phase": "full_width_goldens", "path": "edge_int8",
          "reads": len(g_f), "differing_reads": differ})
    require(len(g_f) == len(g_u) and differ == 0,
            f"edge_int8 fused/unfused goldens differ in {differ} reads")
    return out


def int8_ticks_vs_cpu(torch, cfg, qparams, lanes=8, chunk=256, ticks=3):
    """Three ticks on 8 lanes, fused and unfused on the card against the
    CPU's plain unfused run: tokens, lens and every lane-state leaf bit for
    bit (lane 3 recycled at tick 1)."""
    from repro_torch.core import basecaller as bc
    from repro_torch.realtime.runtime import build_step_fn, init_lane_state
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    runs = {}
    for name, dev, fused in (("cpu plain", cpu, False),
                             ("cuda unfused", cuda, False),
                             ("cuda fused", cuda, True)):
        params = bc.params_to(qparams, dev)
        gen = torch.Generator().manual_seed(5)
        lane = init_lane_state(cfg, lanes, device=dev)
        step = build_step_fn(cfg, fused=fused)
        outs = []
        for t in range(ticks):
            rows = torch.randn((lanes, chunk), generator=gen).to(dev)
            pads = torch.zeros((lanes, chunk // cfg.total_stride),
                               device=dev)
            reset = torch.zeros((lanes,), device=dev)
            if t == 1:
                reset[3] = 1.0
            if fused:
                tok, lens, lane = step(params, lane, rows, pads, reset)
            else:
                if t == 1:
                    for leaf in (*lane["conv"], lane["prev_class"],
                                 lane["bases"], lane["ticks"]):
                        leaf[3] = 0
                tok, lens, lane = step(params, lane, rows, pads)
            outs += [tok.cpu(), lens.cpu()]
        outs += [t.cpu() for t in (*lane["conv"], lane["prev_class"],
                                   lane["bases"], lane["ticks"])]
        runs[name] = outs
    want = runs["cpu plain"]
    equal = {k: all(torch.equal(a, b) for a, b in zip(v, want))
             for k, v in runs.items()}
    emit({"phase": "int8_ticks_vs_cpu", "lanes": lanes, "chunk": chunk,
          "ticks": ticks, "equal": equal,
          "bases_called": int(sum(int(t.sum()) for t in want[1:2 * ticks:2]))})
    require(all(equal.values()), f"int8 ticks differ from the CPU: {equal}")


# --------------------------------------------------------------- phase 5 --
BASECALL_ROWS = 32          # two dispatches of the preset's 16 x 2048


def split_margin(torch, bc, cfg, card, cpu_params, sig, i) -> float:
    """Largest plain top-2 margin over the frames of row ``i`` whose class
    differs between the card (its dispatch's rows, through the kernels)
    and the CPU's plain run; inf when no class differs."""
    from repro_torch.core import ctc
    b0 = i - i % card.batch
    rows = torch.from_numpy(sig[b0:b0 + card.batch])
    on_card = bc.apply(card.params, rows.to(card.device), cfg)[i - b0].cpu()
    plain = bc.apply(cpu_params, rows, cfg)[i - b0]
    split = ctc.argmax_classes(on_card) != ctc.argmax_classes(plain)
    if not bool(split.any()):
        return float("inf")
    return float(top2_margin(torch, plain)[split].max().item())


def phase_basecall(torch, cfg, params, run_card):
    """The basecall workload on the card (``run_card``, whose launches are
    counted; the edge_int8 builder calibrates ``params`` on the card at
    chunk 2048) and on the CPU plain run with the card engine's params:
    int8 reads equal; a float read may differ only where every frame whose
    class differs has a plain top-2 margin under 1e-4."""
    import numpy as np

    import repro_torch.engine as te
    from repro_torch.core import basecaller as bc
    sig = np.random.default_rng(11).standard_normal(
        (BASECALL_ROWS, 2048)).astype(np.float32)
    out = {}
    for preset in ("default", "edge_int8"):
        card, reads, wall = run_card(preset, params, sig)
        rep = card.summary()
        cpu_params = bc.params_to(card.params, "cpu")
        cpu = te.build("basecall", preset=preset, cfg=cfg, params=cpu_params,
                       device="cpu")
        want = cpu.serve(sig)
        differ = [i for i, (a, b) in enumerate(zip(reads, want))
                  if not np.array_equal(a, b)]
        margins = {i: split_margin(torch, bc, cfg, card, cpu_params, sig, i)
                   for i in differ}
        line = {"phase": "basecall", "preset": preset,
                "rows": BASECALL_ROWS, "chunk": 2048, "batch": card.batch,
                "dispatches": rep["dispatches"],
                "dispatch_p50_ms": rep["p50_ms"],
                "dispatch_p99_ms": rep["p99_ms"],
                "bases": card.telemetry.bases,
                "bases_per_s": rep["bases_per_s"],
                "samples_per_s": rep["samples_per_s"],
                "serve_wall_s": wall,
                "stage_s": {k: v for k, v in rep.items()
                            if k.startswith("stage_")},
                "soc_energy_precision": rep["soc_energy_precision"],
                "reads_differing_from_cpu": len(differ),
                "differing_split_margins": margins,
                "fabric": {k: v for k, v in rep.items()
                           if k.startswith("fabric.")}}
        emit(line)
        out[preset] = line
        require(len(reads) == len(want) == BASECALL_ROWS,
                f"basecall {preset}: {len(reads)} reads")
        require(card.telemetry.bases > 0, f"basecall {preset}: no bases")
        if preset == "edge_int8":
            require(not differ, f"basecall edge_int8: reads {differ} differ "
                    "from the CPU")
        else:
            require(all(m < 1e-4 for m in margins.values()),
                    f"basecall default: reads differ away from a near tie: "
                    f"{margins}")
    return out


# ------------------------------------------------------- phase pathogen --
PANEL = {"pathogen-X": 29_903, "pathogen-Y": 10_000}
READ_LEN = 256              # detect(256): the ED firehose's query length
PIPE_CHUNKS = 8             # timed chunks of 32 channels x 2048 samples


def pathogen_panel():
    """pathogen-X (SARS-CoV-2's genome length; the paper targets viruses
    "below 30K bases") and pathogen-Y, random genomes from seed 13, with
    their FM indexes."""
    import numpy as np

    from repro_torch.core import pathogen
    from repro_torch.data import genome as G
    rng = np.random.default_rng(13)
    return pathogen.Panel.build({name: G.random_genome(rng, n)
                                 for name, n in PANEL.items()})


def pathogen_chunks(genome, n_chunks, channels=32, samples=2048, seed=17):
    """Raw chunks as ``examples/pathogen_detection.py`` makes them: each
    channel a squiggle simulated from a 256-base fragment of ``genome``
    (the port's ``data/nanopore.py``, default pore model), resized to
    ``samples``."""
    import numpy as np

    from repro_torch.data import nanopore
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_chunks):
        rows = []
        for _ in range(channels):
            start = rng.integers(0, len(genome) - 256)
            sig, _ = nanopore.simulate_read(rng, genome[start:start + 256])
            rows.append(np.resize(sig, samples))
        out.append(np.stack(rows).astype(np.float32))
    return out


def known_reads(panel, seed=19):
    """256 reads of 256 bases: a 12-base barcode (one of 24, one
    substitution in every other read), then 244 bases: 192 sampled from
    pathogen-X at error rate 0.05, 64 uniform noise.  Returns (reads,
    barcodes, owners)."""
    import numpy as np

    from repro_torch.data import genome as G
    rng = np.random.default_rng(seed)
    barcodes = rng.integers(1, 5, (24, 12)).astype(np.int32)
    owners = rng.integers(0, 24, 256)
    body, _ = G.sample_reads(rng, panel.genomes[0], n_reads=192,
                             read_len=244, error_rate=0.05)
    body = np.concatenate([body, rng.integers(1, 5, (64, 244))])
    reads = np.concatenate([barcodes[owners], body], axis=1).astype(np.int32)
    where = rng.integers(0, 12, 256)
    for i in range(0, 256, 2):
        reads[i, where[i]] = reads[i, where[i]] % 4 + 1
    return reads, barcodes, owners


def check_levenshtein(torch, peaks, table, q, t, label):
    """The levenshtein launch vs its plain version (the row-scan DP),
    bitwise, with its lane plan, kernel, device and plain ms and bound."""
    from repro_torch.kernels import edit_distance as ke
    from repro_torch.kernels import ref
    fn = ke.levenshtein
    before = (fn.stripe_launches, fn.scratch_launches)
    out = ke.levenshtein(q, t)
    lay = wavefront_plan(fn, q, t, before)
    want = ref.edit_distance(q, t)
    torch.cuda.synchronize()
    diff = int((out != want).sum().item())
    ms = time_ms(torch, lambda: ke.levenshtein(q, t))
    dms = device_ms(torch, lambda: ke.levenshtein(q, t))
    plain = time_ms(torch, lambda: ref.edit_distance(q, t), reps=5)
    cells, bnd, by = dp_bound(torch, peaks, q, t, out,
                              max(q.shape[1], t.shape[1]))
    emit({"phase": "kernel", "kernel": "levenshtein", "shape": label,
          "q": list(q.shape), "t": list(t.shape), "plan": lay,
          "mismatches": diff, "ms": ms, "device_ms": dms, "plain_ms": plain,
          "library_ms": None, "bound_ms": bnd, "bound_by": by,
          "cells": cells})
    table.add("levenshtein", err=float(diff), ms=ms, plain_ms=plain,
              bound=bnd, bound_by=by, library_ms=None)
    table.rows["levenshtein"].update(device_ms=dms, plan=lay)
    require(diff == 0, f"levenshtein {label}: {diff} distances differ")


def phase_kernels_genomics(torch, F, peaks, table, panel, known):
    """Phase 2 at the genomics slice's shapes: levenshtein at the demux
    shape, banded_align at the firehose shape (both genomes of one
    ``detect`` call), the variant caller's two "same" convs."""
    import numpy as np

    from repro_torch.core import pathogen
    from repro_torch.data import genome as G
    from repro_torch.kernels import edit_distance as ke
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    reads, barcodes, _ = known
    r, s = len(reads), len(barcodes)
    prefix = torch.from_numpy(reads[:, :12].copy()).to(dev)
    check_levenshtein(torch, peaks, table,
                      prefix.repeat_interleave(s, 0).contiguous(),
                      torch.from_numpy(barcodes).to(dev).repeat(r, 1),
                      f"demux {r} reads x {s} barcodes, 12 x 12")
    # the firehose: READ_LEN reads against every 512-base window
    rng = np.random.default_rng(29)
    fire, _ = G.sample_reads(rng, panel.genomes[0], n_reads=READ_LEN,
                             read_len=READ_LEN, error_rate=0.05)
    cfg = pathogen.DetectConfig()
    kw = dict(band=cfg.window, match=cfg.match, mismatch=cfg.mismatch,
              gap=cfg.gap, local=True)
    row = {"pairs": 0, "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
           "bound_ms": 0.0, "cells": 0, "mismatches": 0}
    fn = ke.banded_align
    for name, genome in zip(panel.names, panel.genomes):
        q, t = pathogen.read_window_pairs(fire, genome, cfg, device=dev)
        before = (fn.stripe_launches, fn.scratch_launches)
        out = ke.banded_align(q, t, **kw)
        lay = wavefront_plan(fn, q, t, before)
        want = ref.banded_align(q, t, **kw)
        torch.cuda.synchronize()
        diff = int((out != want).sum().item())
        ms = time_ms(torch, lambda: ke.banded_align(q, t, **kw), reps=5,
                     warm=1)
        dms = device_ms(torch, lambda: ke.banded_align(q, t, **kw), reps=5)
        plain = time_ms(torch, lambda: ref.banded_align(q, t, **kw), reps=2,
                        warm=1)
        cells, bnd, by = dp_bound(torch, peaks, q, t, out, cfg.window)
        emit({"phase": "kernel", "kernel": "banded_align",
              "shape": f"firehose {name}", "q": list(q.shape),
              "t": list(t.shape), "band": cfg.window, "local": True,
              "plan": lay, "mismatches": diff, "ms": ms, "device_ms": dms,
              "plain_ms": plain, "library_ms": None, "bound_ms": bnd,
              "bound_by": by, "cells": cells})
        require(diff == 0, f"banded_align firehose {name}: {diff} differ")
        for k, v in (("pairs", q.shape[0]), ("ms", ms), ("device_ms", dms),
                     ("plain_ms", plain), ("bound_ms", bnd),
                     ("cells", cells), ("mismatches", diff)):
            row[k] += v
        row["bound_by"] = by
        row["plan"] = lay
    row["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    emit({"phase": "kernel", "kernel": "banded_align",
          "shape": f"firehose per detect call, {READ_LEN} reads", **row})
    # the variant caller's convs: 256 windows of 33, "same" (T 33 + 4)
    gen = torch.Generator().manual_seed(31)
    cin = 9
    for cout in (48, 96):
        x = torch.rand((256, 37, cin), generator=gen).to(dev)
        w = (torch.randn((5, cin, cout), generator=gen)
             * (2.0 / (5 * cin)) ** 0.5).to(dev)
        b = torch.zeros((cout,), device=dev)
        check_conv1d(torch, F, peaks, table, x, w, b, 1, "relu",
                     f"caller Cin={cin} Cout={cout} T=33 same", "caller")
        cin = cout
    return row


def near_tie_rows(torch, bc, card, cpu_params, chunk, rows):
    """For each row whose tokens differ between card and CPU: the largest
    plain top-2 margin over the frames whose class differs (inf if none)."""
    from repro_torch.core import ctc
    from repro_torch.core.pipeline import normalize_chunk
    sig = torch.from_numpy(normalize_chunk(chunk))
    on_card = bc.apply(card.params, sig.to(card.device), card.cfg).cpu()
    plain = bc.apply(cpu_params, sig, card.cfg)
    out = {}
    for i in rows:
        split = (ctc.argmax_classes(on_card[i])
                 != ctc.argmax_classes(plain[i]))
        out[i] = (float(top2_margin(torch, plain[i])[split].max().item())
                  if bool(split.any()) else float("inf"))
    return out


def drive_pipeline(torch, te, preset, cfg, panel, warm, chunks):
    """One engine through the user's entry points: build, one warm-up chunk
    (drained, then forgotten), the timed chunks, drain, ``detect``.  The
    first ``depth`` submits of the timed run decode nothing, so they run
    under PyTorch's sync debug mode: a host-device synchronization there
    (a ``.cpu()``, ``.item()`` or pageable copy) would warn."""
    import warnings

    from repro_torch.engine.telemetry import Telemetry
    eng = te.build("pathogen_pipeline", preset=preset, cfg=cfg, panel=panel)
    eng.submit(warm)
    eng.drain()
    eng.outputs.clear()
    eng.telemetry = Telemetry(workload=eng.workload)
    torch.cuda.synchronize()
    depth = eng.scheduler.slots
    t_sub, t_done, busy = [], [], []
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for k, chunk in enumerate(chunks):
            if k < depth:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                t_sub.append(time.perf_counter())
                eng.submit(chunk)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if k < depth:
                busy.append(not torch.cuda.current_stream().query())
            while len(t_done) < len(eng.outputs):
                t_done.append(time.perf_counter())
    while eng.step():
        t_done.append(time.perf_counter())
    wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    report = eng.detect(READ_LEN)
    torch.cuda.synchronize()
    detect_s = time.perf_counter() - t1
    syncs = [str(w.message)[:200] for w in caught
             if "called a synchronizing" in str(w.message)]
    lat = [(d - s) * 1e3 for s, d in zip(t_sub, t_done)]
    return {"engine": eng, "report": report, "wall_s": wall,
            "detect_s": detect_s, "latencies_ms": lat, "syncs": syncs,
            "busy_after_submit": busy}


def phase_pipeline(torch, te, bc, cfg, panel, paths, preset, want_kernels):
    """``pathogen_pipeline`` at the paper's widths on the card, against a
    CPU run of the same engine (the card engine's params on the CPU): int8
    tokens equal; an fp32 row may differ only where every frame whose class
    differs has a plain top-2 margin under 1e-4.  Then ``detect(256)`` on
    the engine's own reads: every read x window score equal to the plain
    banded_align on the card, and the assignment of 16 seeded reads equal
    to a CPU run."""
    import numpy as np

    from repro_torch.core import pathogen
    from repro_torch.kernels import edit_distance as ke
    from repro_torch.kernels import ref
    chunks = pathogen_chunks(panel.genomes[0], PIPE_CHUNKS + 1)
    run = paths.drive(f"pathogen_pipeline {preset}", want_kernels,
                      lambda: drive_pipeline(torch, te, preset, cfg, panel,
                                             chunks[0], chunks[1:]))
    eng, report = run["engine"], run["report"]
    rep = eng.summary()
    cpu_params = bc.params_to(eng.params, "cpu")
    cpu = te.build("pathogen_pipeline", preset=preset, cfg=cfg,
                   params=cpu_params, panel=panel, device="cpu")
    for chunk in chunks[1:]:
        cpu.submit(chunk)
    cpu.drain()
    margins = {}
    for k, ((tok, lens), (ctok, clens)) in enumerate(zip(eng.outputs,
                                                         cpu.outputs)):
        rows = [i for i in range(len(tok))
                if lens[i] != clens[i] or not np.array_equal(tok[i], ctok[i])]
        if rows:
            margins.update({f"{k}:{i}": m for i, m in near_tie_rows(
                torch, bc, eng, cpu_params, chunks[1 + k], rows).items()})
    # detect: every pair against the plain version on the card
    reads = eng.reads(READ_LEN)
    cfg_d = pathogen.DetectConfig()
    kw = dict(band=cfg_d.window, match=cfg_d.match,
              mismatch=cfg_d.mismatch, gap=cfg_d.gap, local=True)
    pair_diff, pairs, best = 0, 0, []
    for genome in panel.genomes:
        q, t = pathogen.read_window_pairs(reads, genome, cfg_d,
                                          device=eng.device)
        got = ke.banded_align(q, t, **kw)
        want = ref.banded_align(q, t, **kw)
        pair_diff += int((got != want).sum().item())
        pairs += q.shape[0]
        best.append(want.view(len(reads), -1).amax(dim=1).cpu().numpy())
    best_plain = np.max(np.stack(best), axis=0)
    sub = np.sort(np.random.default_rng(37).choice(len(reads), 16,
                                                   replace=False))
    cpu_rep = pathogen.detect(panel, reads[sub], cfg_d, device="cpu")
    lat = np.asarray(run["latencies_ms"])
    line = {"phase": "pathogen", "part": "engine", "preset": preset,
            "chunks": rep["chunks"], "channels": 32, "chunk_samples": 2048,
            "depth": eng.scheduler.slots, "bases": eng.telemetry.bases,
            "reads": len(reads),
            "dispatch_p50_ms": float(np.percentile(lat, 50)),
            "dispatch_p99_ms": float(np.percentile(lat, 99)),
            "latencies_ms": lat.tolist(),
            "bases_per_s": rep["bases_per_s"], "wall_s": run["wall_s"],
            "stage_s": {k: v for k, v in rep.items()
                        if k.startswith("stage_")},
            "detect_s": run["detect_s"],
            "sync_warnings_in_submit": run["syncs"],
            "device_busy_after_submit": run["busy_after_submit"],
            "soc_energy_precision": rep["soc_energy_precision"],
            "rows_differing_from_cpu": len(margins),
            "differing_split_margins": margins,
            "detect_pairs": pairs, "detect_pairs_differing": pair_diff,
            "detect_counts": report.counts,
            "detect_subset_equal_cpu": bool(
                np.array_equal(cpu_rep.read_assignment,
                               report.read_assignment[sub])
                and np.array_equal(cpu_rep.read_scores,
                                   report.read_scores[sub])),
            "fabric": {k: v for k, v in rep.items()
                       if k.startswith("fabric.")}}
    emit(line)
    require(rep["chunks"] == PIPE_CHUNKS and len(reads) == 32 * PIPE_CHUNKS,
            f"pathogen_pipeline {preset}: {rep['chunks']} chunks, "
            f"{len(reads)} reads")
    require(eng.telemetry.bases > 0, f"pathogen_pipeline {preset}: no bases")
    require(not run["syncs"], f"pathogen_pipeline {preset}: submit "
            f"synchronized with the card: {run['syncs']}")
    require(all(k.endswith(".cuda") for k in line["fabric"]
                if k.startswith("fabric.dispatch.")),
            f"pathogen_pipeline {preset}: a dispatch left the card")
    if preset == "edge_int8":
        require(not margins, f"pathogen_pipeline edge_int8: rows {margins} "
                "differ from the CPU")
    else:
        require(all(m < 1e-4 for m in margins.values()),
                f"pathogen_pipeline default: rows differ away from a near "
                f"tie: {margins}")
    require(pairs == len(reads) * 155 and pair_diff == 0,
            f"pathogen_pipeline {preset}: {pair_diff} of {pairs} firehose "
            "scores differ from the plain version")
    require(np.array_equal(report.read_scores, best_plain),
            f"pathogen_pipeline {preset}: detect's read scores differ from "
            "the plain pairs' best")
    require(line["detect_subset_equal_cpu"],
            f"pathogen_pipeline {preset}: detect differs from the CPU")
    return line


def drive_known(torch, panel, known):
    """The CORE + ED path on known reads: demux on the card, trim the
    barcode, detect with read lengths in ed and fm modes."""
    import numpy as np

    from repro_torch.core import pathogen, pipeline
    reads, barcodes, _ = known
    t0 = time.perf_counter()
    demux = pipeline.demux_reads(reads, barcodes, max_dist=3)
    demux_s = time.perf_counter() - t0
    trimmed, lens = pipeline.trim_primer(reads, np.full(len(reads), 256), 12)
    reps, secs = {}, {}
    for mode in ("ed", "fm"):
        t0 = time.perf_counter()
        reps[mode] = pathogen.detect(panel, trimmed, mode=mode,
                                     read_lens=lens)
        torch.cuda.synchronize()
        secs[mode] = time.perf_counter() - t0
    return demux, demux_s, trimmed, lens, reps, secs


def phase_known_reads(torch, panel, known, paths):
    """Known reads through demux and detect on the card: demux equal to its
    plain version on the card and on the CPU; pathogen-X present and
    pathogen-Y absent in both modes; ed scores equal to the plain
    banded_align on the card, the fm report equal to the CPU run."""
    import numpy as np

    from repro_torch.core import pathogen
    from repro_torch.kernels import ref
    reads, barcodes, owners = known
    demux, demux_s, trimmed, lens, reps, secs = paths.drive(
        "known reads", ("levenshtein", "banded_align"),
        lambda: drive_known(torch, panel, known))
    dev = torch.device("cuda")
    r, s = len(reads), len(barcodes)
    prefix = torch.from_numpy(reads[:, :12].copy())
    q = prefix.repeat_interleave(s, 0)
    t = torch.from_numpy(barcodes).repeat(r, 1)
    plain = {}
    for where in ("cpu", "cuda"):
        d = ref.edit_distance(q.to(where), t.to(where)).cpu().numpy()
        d = d.reshape(r, s)
        best = d.argmin(axis=1)
        plain[where] = np.where(d[np.arange(r), best] <= 3, best, -1)
    cfg = pathogen.DetectConfig()
    sentinel = np.where(np.arange(256)[None, :] < lens[:, None], trimmed, -1)
    best = []
    for genome in panel.genomes:
        q2, t2 = pathogen.read_window_pairs(sentinel, genome, cfg,
                                            device=dev)
        best.append(ref.banded_align(
            q2, t2, band=cfg.window, match=cfg.match, mismatch=cfg.mismatch,
            gap=cfg.gap, local=True).view(r, -1).amax(dim=1).cpu().numpy())
    ed_plain = np.max(np.stack(best), axis=0)
    fm_cpu = pathogen.detect(panel, trimmed, mode="fm", read_lens=lens,
                             device="cpu")
    fm = reps["fm"]
    fm_equal = (fm.counts == fm_cpu.counts
                and np.array_equal(fm.read_assignment,
                                   fm_cpu.read_assignment)
                and np.array_equal(fm.read_scores, fm_cpu.read_scores))
    line = {"phase": "pathogen", "part": "known_reads", "reads": r,
            "barcodes": s, "demux_pairs": r * s, "demux_s": demux_s,
            "demux_equal_plain_card": bool(np.array_equal(demux,
                                                          plain["cuda"])),
            "demux_equal_cpu": bool(np.array_equal(demux, plain["cpu"])),
            "demux_correct": int((demux == owners).sum()),
            "demux_unassigned": int((demux < 0).sum()),
            "detect_s": secs,
            "ed": {"counts": reps["ed"].counts,
                   "present": reps["ed"].present},
            "fm": {"counts": fm.counts, "present": fm.present},
            "ed_scores_equal_plain_card": bool(np.array_equal(
                reps["ed"].read_scores, ed_plain)),
            "fm_equal_cpu": bool(fm_equal)}
    emit(line)
    require(line["demux_equal_plain_card"] and line["demux_equal_cpu"],
            "demux differs from its plain version")
    for mode in ("ed", "fm"):
        pres = reps[mode].present
        require(pres["pathogen-X"] and not pres["pathogen-Y"],
                f"known reads, {mode}: presence {pres}")
    require(line["ed_scores_equal_plain_card"],
            "known reads: ed scores differ from the plain version")
    require(fm_equal, "known reads: the fm report differs from the CPU")
    return line


def plain_caller(torch, params, x, cfg):
    """The variant caller with the plain conv1d ("same" padding, ReLU)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    for i in range(len(cfg.channels)):
        p = params[f"conv{i + 1}"]
        pad = cfg.kernel - 1
        x = ref.conv1d(F.pad(x, (0, 0, pad // 2, pad - pad // 2)), p["w"],
                       p["b"], activation="relu")
    h = F.relu(x.reshape(x.shape[0], -1) @ params["dense"]["w"]
               + params["dense"]["b"])
    return (h @ params["head_gt"]["w"] + params["head_gt"]["b"],
            h @ params["head_alt"]["w"] + params["head_alt"]["b"])


def phase_variant_caller(torch, panel, paths):
    """The variant caller on a pileup of pathogen-X carrying 30 seeded
    SNPs: 256 windows (every candidate site, then seeded positions) through
    ``apply`` on the card, against the plain run on the card within
    2e-5."""
    import numpy as np

    from repro_torch.core import variant_caller as vc
    from repro_torch.data import genome as G
    rng = np.random.default_rng(23)
    genome = panel.genomes[0]
    snps = np.sort(rng.choice(np.arange(200, len(genome) - 200), 30,
                              replace=False))
    mutated = genome.copy()
    mutated[snps] = (genome[snps] - 1 + rng.integers(1, 4, 30)) % 4 + 1
    reads, pos = G.sample_reads(rng, mutated, n_reads=4000, read_len=150,
                                error_rate=0.01)
    pile = vc.build_pileup(genome, reads, pos)
    cands = vc.candidate_sites(pile)
    extra = rng.choice(len(genome), 256, replace=False)
    sites = np.concatenate([cands, extra])[:256]
    cfg = vc.CallerConfig()
    wins = torch.from_numpy(vc.extract_windows(pile, sites, cfg.window))
    dev = torch.device("cuda")
    params = vc.init(torch.Generator().manual_seed(0), cfg, device=dev)
    x = wins.to(dev)

    def run():
        out = vc.apply(params, x, cfg)
        torch.cuda.synchronize()
        return out
    gt, alt = paths.drive("variant caller", ("conv1d",), run)
    pgt, palt = plain_caller(torch, params, x, cfg)
    err = max((gt - pgt).abs().max().item(), (alt - palt).abs().max().item())
    ok = (torch.allclose(gt, pgt, rtol=F32_TOL, atol=F32_TOL)
          and torch.allclose(alt, palt, rtol=F32_TOL, atol=F32_TOL))
    ms = time_ms(torch, lambda: vc.apply(params, x, cfg))
    found = int(np.isin(snps, cands).sum())
    line = {"phase": "pathogen", "part": "variant_caller",
            "genome": len(genome), "snps": 30, "reads": len(reads),
            "candidates": len(cands), "snps_in_candidates": found,
            "windows": list(wins.shape), "max_abs_err": err, "tol": F32_TOL,
            "apply_ms": ms}
    emit(line)
    require(found == 30, f"variant caller: {found} of 30 SNPs are candidates")
    require(ok, f"variant caller: max abs err {err} over {F32_TOL}")
    return line


def phase_pathogen(torch, cfg, panel, known, paths):
    import repro_torch.engine as te
    from repro_torch.core import basecaller as bc
    out = {}
    for preset, want in (("default", ("conv1d", "matmul", "banded_align")),
                         ("edge_int8", ("conv1d_int8", "matmul_int8",
                                        "banded_align"))):
        out[preset] = phase_pipeline(torch, te, bc, cfg, panel, paths,
                                     preset, want)
    out["known"] = phase_known_reads(torch, panel, known, paths)
    out["caller"] = phase_variant_caller(torch, panel, paths)
    return out


# ------------------------------------------------------------- phase LM --
LM_SEQ = 4096               # prefill_32k's 32 x 32768, cut to 1 x 4096
LM_LONG = 32_768            # prefill_32k's length: the kernels alone
LM_ROWS = 512               # rows of the 32k attention checked a band
LM_PARITY_SEQ = 512         # depth-2 card vs CPU: two SSD chunks of 256
LM_PREFILL_LIMIT_MS = 1000  # PERF.md section 2: reported, not gated
FA_RULE = ("|err| <= 2^-7 |ref| + 2^-8 (P|V|), P|V| the plain attention "
           "of |v|")
SSD_TOL = 2e-4              # the JAX suite's SSD bar (f32)
LM_REDUCED = ("prefill_32k (configs/shapes.py: batch 32 x seq 32768) cut "
              "to batch 1 x seq 4096 end to end for the run's time; the "
              "flash_attention and ssd_scan kernels alone run at 32768")
# launches a prefill: one flash_attention a layer, the MLP's GEMMs (three
# a gated layer, two a non-gated one) all on the wgmma kernel, one
# ssd_scan a mamba layer; the three dense configs are phase
# ``dense_prefill``
LM_PATHS = (("qwen3-4b", {"flash_attention": 36, "matmul_bf16": 108,
                          "matmul_bf16_wgmma": 108}),
            ("mamba2-780m", {"ssd_scan": 48}),
            ("nemotron-4-15b", {"flash_attention": 32, "matmul_bf16": 64,
                                "matmul_bf16_wgmma": 64}),
            ("starcoder2-3b", {"flash_attention": 30, "matmul_bf16": 60,
                               "matmul_bf16_wgmma": 60}),
            ("minicpm-2b", {"flash_attention": 40, "matmul_bf16": 120,
                            "matmul_bf16_wgmma": 120}))
DENSE_ARCHS = ("nemotron-4-15b", "starcoder2-3b", "minicpm-2b")


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers at magnitude ``x``."""
    import math
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


def flash_excess(got, want, abs_attn) -> float:
    """The flash bar, as the largest |got - want| / (2^-7 |want| + 2^-8
    abs_attn): at most 1 passes.  ``abs_attn`` is the plain attention of
    |v| on the same q and k.  The kernel rounds P to bf16 before the PV
    product, as Pallas does (the plain version does not): that moves an
    output by at most 2^-9 of sum_j p_j |v_j| / l = abs_attn; the two
    roundings of the output to bf16 add at most 2^-7 |want|.  The bar
    doubles the first term, for the f32 sums' other order."""
    g, w = got.float(), want.float()
    bar = 2.0 ** -7 * w.abs() + 2.0 ** -8 * abs_attn.float() + 1e-30
    return ((g - w).abs() / bar).max().item()


def rms_excess(got, want) -> float:
    """The hidden-state bar, as rms(got - want) / (2^-7 rms(want)): at
    most 1 passes.  2^-7 is two units of bf16 roundoff (u = 2^-8), so the
    typical difference stays within two roundings of the typical value.
    Held per element instead, a sound card-vs-CPU run fails: bf16 rounds
    the residual stream after every layer, and differences upstream flip
    those roundings by up to 4 ulps at a few elements."""
    g, w = got.float(), want.float()
    return ((g - w).square().mean().sqrt()
            / (2.0 ** -7 * w.square().mean().sqrt() + 1e-30)).item()


def attn_pairs(sq: int, skv: int) -> int:
    """(query, key) pairs a causal, last-token-aligned attention scores."""
    offs = skv - sq
    return sq * (offs + 1) + sq * (sq - 1) // 2


def sdpa_ms(torch, F, q, k, v):
    """SDPA with ``enable_gqa`` on the same inputs, on its fused backends
    only (flash, memory-efficient, cuDNN): never the O(S^2) math path."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]
    with sdpa_kernel(fused):
        return time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), reps=5)


def flash_bands(sq: int, skv: int, rows: int):
    """The (row start, row end, key end) bands of a long causal attention
    that are held to the plain version: the first, middle and last
    ``rows`` rows, each against keys [0, key end), aligned to the last
    token (row i sees key j iff j <= i + skv - sq)."""
    offs = skv - sq
    mid = sq // 2 - rows // 2
    return [(a, a + rows, a + rows + offs)
            for a in (0, mid, sq - rows)]


def check_flash(torch, F, peaks, table, q, k, v, label, on_path):
    """The flash kernel against the plain attention: every row at 4096;
    at 32768 the first, middle and last LM_ROWS rows (``flash_bands``:
    each band against the plain version over the keys it can see, aligned
    to the last token)."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    out = kfa.flash_attention(q, k, v, causal=True)
    sq, skv, d = q.shape[2], k.shape[2], q.shape[3]
    if on_path:
        checks = [(out, q, k, v)]
    else:
        checks = [(out[:, :, a:b], q[:, :, a:b], k[:, :, :e], v[:, :, :e])
                  for a, b, e in flash_bands(sq, skv, LM_ROWS)]
    err, excess = 0.0, 0.0
    for o, qq, kk, vv in checks:
        want = ref.attention(qq, kk, vv, causal=True)
        err = max(err, (o.float() - want.float()).abs().max().item())
        excess = max(excess, flash_excess(
            o, want, ref.attention(qq, kk, vv.abs(), causal=True)))
    del checks, want
    ms = time_ms(torch, lambda: kfa.flash_attention(q, k, v, causal=True),
                 reps=5 if on_path else 2, warm=1)
    if on_path:
        plain = time_ms(torch, lambda: ref.attention(q, k, v, causal=True),
                        reps=3, warm=1)
    else:   # the full plain version would need Hq * S^2 * 4 bytes
        plain = time_ms(torch, lambda: ref.attention(
            q[:, :, -LM_ROWS:], k, v, causal=True), reps=2, warm=1)
    lib = sdpa_ms(torch, F, q, k, v)
    ops = 4.0 * d * attn_pairs(sq, skv) * q.shape[0] * q.shape[1]
    bnd, by = bound_ms(peaks, nbytes(q, k, v, out), ops, bf16=True)
    line = {"phase": "kernel", "kernel": "flash_attention", "shape": label,
            "q": list(q.shape), "k": list(k.shape), "causal": True,
            "max_abs_err": err, "err_over_bar": excess, "tol": FA_RULE,
            "ms": ms, "plain_ms": plain,
            "library_ms": lib, "library": "sdpa gqa", "bound_ms": bnd,
            "bound_by": by, "flop": ops}
    if not on_path:
        line.update(checked_rows=[f"first {LM_ROWS}", f"middle {LM_ROWS}",
                                  f"last {LM_ROWS}"],
                    plain_rows=f"last {LM_ROWS}")
    if on_path:
        table.add("flash_attention", err=err, ms=ms, plain_ms=plain,
                  bound=bnd, bound_by=by, library_ms=lib)
    emit(line)
    require(excess <= 1.0, f"flash_attention {label}: error {excess} x "
            f"its bar ({FA_RULE})")
    return line


def ssd_flop(bh: int, t: int, ds: int, dh: int, products=None) -> float:
    """The least FLOP the scan needs: the result is the same for every
    chunk length, so the fewest over lengths L of the chunked form (per
    chunk, (C_t . B_s) and G X for the s <= t pairs, the inter-chunk C S
    and the chunk's state B^T X at L x ds x dh MACs each, and the state's
    decay, ds x dh), and of the recurrence (5 ds dh a step).  The
    minimum lies near L = 9 at ds 128, dh 64, not at the kernels'
    256.  ``products``: TF32 products a FLOP of (C B^T, G X, C S, B^T X),
    as the tensor-core kernel forms them; then the chunked form alone is
    counted, in TF32 products."""
    pc, pg, pi, ps = products or (1, 1, 1, 1)

    def chunked(ln):
        n = -(-t // ln)
        pairs = ln * (ln + 1) // 2
        return 2.0 * n * (pairs * (pc * ds + pg * dh)
                          + (pi + ps) * ln * ds * dh + ds * dh)
    least = min(chunked(ln) for ln in range(1, min(t, 256) + 1))
    if products:
        return bh * least
    return bh * min(least, 5.0 * t * ds * dh)


def ssd_products(bf16: bool):
    """TF32 products a FLOP of (C B^T, G' X, C S_in, (w B)^T X) in the
    kernel: a bf16 operand is exact in TF32, an f32 one is split in two
    (csrc/ssd_scan.cu)."""
    return (1, 2, 2, 2) if bf16 else (3, 3, 3, 3)


def ssd_inputs(torch, F, t, gen, dev, bh=48, ds=128, dh=64):
    """x, log_a <= 0 and B/C as mamba_block passes them at batch 1: B/C
    one (T, ds) row viewed over the 48 heads (stride 0)."""
    x = (torch.randn((bh, t, dh), generator=gen, device=dev) * 0.5)
    la = -F.softplus(torch.randn((bh, t), generator=gen, device=dev))
    b = torch.randn((1, t, ds), generator=gen, device=dev) * 0.3
    c = torch.randn((1, t, ds), generator=gen, device=dev) * 0.3
    return (x.bfloat16(), la, b.bfloat16().expand(bh, t, ds),
            c.bfloat16().expand(bh, t, ds))


SSD_PASSES = {"ssd_chunk_state_kernel": "chunk_state",
              "ssd_state_scan_kernel": "state_scan",
              "ssd_chunk_out_kernel": "chunk_out"}


def check_ssd(torch, peaks, table, x, la, b, c, label, on_path):
    """bf16 y within the f32 bar plus one bf16 ulp of each element (both
    round once from f32 sums formed in different orders); at the path
    shape also float32 inputs within the f32 bar, and each pass's device
    time (``device_ms_by_pass``, the profiler over five calls).
    ``bound_ms`` at the TF32 rate of the products the kernel forms
    (``ssd_products``), ``bound_fp32_ms`` at the CUDA cores' fp32 rate."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as kssd
    out = kssd.ssd_scan(x, la, b, c, chunk=256)
    want = ref.ssd_scan(x, la, b, c)[0]
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    ok = torch.allclose(out.float(), want.float(), rtol=2 ** -7, atol=SSD_TOL)
    del want
    err32 = None
    if on_path:
        f32 = (x.float(), la, b.float(), c.float())
        o32 = kssd.ssd_scan(*f32, chunk=256)
        w32 = ref.ssd_scan(*f32)[0]
        err32 = (o32 - w32).abs().max().item()
        ok = ok and err32 <= SSD_TOL
        del f32, o32, w32
    ms = time_ms(torch, lambda: kssd.ssd_scan(x, la, b, c, chunk=256),
                 reps=5, warm=1)
    plain = time_ms(torch, lambda: ref.ssd_scan(x, la, b, c), reps=1, warm=0)
    bh, t, dh = x.shape
    ds = b.shape[-1]
    ops = ssd_flop(bh, t, ds, dh)
    io = nbytes(x, la, b[:1], c[:1], out)
    products = ssd_flop(bh, t, ds, dh, ssd_products(x.dtype == torch.bfloat16))
    t_ops = products / peaks["tf32_flops"] * 1e3
    t_io = bound_ms(peaks, io, 0)[0]
    bnd, by = max(t_ops, t_io), ("operations" if t_ops >= t_io else "bytes")
    bnd32, _ = bound_ms(peaks, io, ops)
    line = {"phase": "kernel", "kernel": "ssd_scan", "shape": label,
            "x": list(x.shape), "ds": ds, "chunk": 256, "b_c": "one row "
            "over the heads (stride 0)", "max_abs_err": err,
            "tol": f"{SSD_TOL} + 2^-7 |y| (bf16)", "max_abs_err_f32": err32,
            "tol_f32": SSD_TOL, "ms": ms, "plain_ms": plain,
            "library_ms": None, "bound_ms": bnd, "bound_by": by,
            "bound_fp32_ms": bnd32, "flop": ops, "tf32_products": products}
    if on_path:
        per = kernel_device_ms(
            torch, lambda: kssd.ssd_scan(x, la, b, c, chunk=256))
        by_pass = {SSD_PASSES[k]: v for k, v in per.items()
                   if k in SSD_PASSES}
        require(len(by_pass) == 3, f"ssd_scan {label}: the profiler saw "
                f"{sorted(per)}, not the three passes")
        line.update(device_ms=sum(by_pass.values()),
                    device_ms_by_pass=by_pass)
        table.add("ssd_scan", err=err, ms=ms, plain_ms=plain, bound=bnd,
                  bound_by=by, library_ms=None, bound_fp32=bnd32)
        table.rows["ssd_scan"].update(device_ms=line["device_ms"],
                                      device_ms_by_pass=by_pass)
    emit(line)
    require(ok, f"ssd_scan {label}: max abs err {err} (f32 {err32})")
    return line


def check_matmul_bf16(torch, F, peaks, table, a, w, act, label,
                      variant="wgmma"):
    """Within one bf16 ulp of max |out| (f32 sums in another order), on the
    kernel the wrapper picks for the shape, which must be ``variant``:
    ``wgmma`` (TMA-addressable) or ``mma.sync``.  Only the path's wgmma
    shapes count into the kernels line."""
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import ref
    before = km.matmul_bf16.wgmma_launches
    out = km.matmul_bf16(a, w, activation=act)
    ran = "wgmma" if km.matmul_bf16.wgmma_launches > before else "mma.sync"
    want = ref.matmul(a, w, activation=act)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    tol = bf16_ulp(want.float().abs().max().item())
    del want
    ms = time_ms(torch, lambda: km.matmul_bf16(a, w, activation=act), reps=10)
    plain = time_ms(torch, lambda: ref.matmul(a, w, activation=act), reps=3)
    if act == "silu":
        lib = time_ms(torch, lambda: F.silu(torch.matmul(a, w)), reps=10)
    else:
        lib = time_ms(torch, lambda: torch.matmul(a, w), reps=10)
    m, k = a.shape
    ops = 2.0 * m * k * w.shape[1]
    bnd, by = bound_ms(peaks, nbytes(a, w, out), ops, bf16=True)
    emit({"phase": "kernel", "kernel": "matmul_bf16", "shape": label,
          "a": list(a.shape), "b": list(w.shape), "activation": act,
          "variant": ran, "max_abs_err": err, "tol": tol, "ms": ms,
          "plain_ms": plain, "library_ms": lib, "bound_ms": bnd,
          "bound_by": by, "flop": ops, "tflops": ops / ms / 1e9})
    if variant == "wgmma":
        table.add("matmul_bf16", err=err, ms=ms, plain_ms=plain, bound=bnd,
                  bound_by=by, library_ms=lib)
    require(ran == variant, f"matmul_bf16 {label}: ran the {ran} kernel, "
            f"expected {variant}")
    require(err <= tol, f"matmul_bf16 {label}: max abs err {err} over {tol}")


def phase_kernels_lm(torch, F, peaks, table):
    """Phase 2 at the LM prefill's shapes: flash_attention at qwen3-4b's
    1 x 4096 and at 32768, ssd_scan at mamba2-780m's (48, 4096) and
    (48, 32768), the three qwen3-4b MLP GEMMs at M = 4096.  Returns the
    32768 lines (not summed into the kernels line's per-prefill row)."""
    from repro_torch.configs import ARCHS
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(3)
    q3 = ARCHS["qwen3-4b"].config()
    long = {}
    for s_len, on_path in ((LM_SEQ, True), (LM_LONG, False)):
        q = torch.randn((1, q3.num_heads, s_len, q3.head_dim), generator=gen,
                        device=dev).bfloat16()
        k = torch.randn((1, q3.num_kv_heads, s_len, q3.head_dim),
                        generator=gen, device=dev).bfloat16()
        v = torch.randn(k.shape, generator=gen, device=dev).bfloat16()
        line = check_flash(torch, F, peaks, table, q, k, v,
                           f"qwen3-4b 1 x {s_len}", on_path)
        if not on_path:
            long["flash_attention"] = line
        del q, k, v
    m2 = ARCHS["mamba2-780m"].config()
    for s_len, on_path in ((LM_SEQ, True), (LM_LONG, False)):
        args = ssd_inputs(torch, F, s_len, gen, dev, bh=m2.ssm_heads,
                          ds=m2.ssm_state, dh=m2.ssm_head_dim)
        line = check_ssd(torch, peaks, table, *args,
                         f"mamba2-780m 48 heads x {s_len}", on_path)
        if not on_path:
            long["ssd_scan"] = line
        del args
    d, ff = q3.d_model, q3.d_ff
    a = torch.randn((LM_SEQ, d), generator=gen, device=dev).bfloat16()
    wg = (torch.randn((d, ff), generator=gen, device=dev) * d ** -0.5
          ).bfloat16()
    h = (torch.randn((LM_SEQ, ff), generator=gen, device=dev) * 0.5
         ).bfloat16()
    wo = (torch.randn((ff, d), generator=gen, device=dev) * ff ** -0.5
          ).bfloat16()
    check_matmul_bf16(torch, F, peaks, table, a, wg, "silu",
                      "qwen3-4b MLP gate (silu)")
    check_matmul_bf16(torch, F, peaks, table, a, wg, "none", "qwen3-4b MLP up")
    check_matmul_bf16(torch, F, peaks, table, h, wo, "none",
                      "qwen3-4b MLP down")
    # K = 2558 is no multiple of 8: TMA cannot address a's rows, so the
    # general mma.sync kernel runs
    a2, w2 = a[:, :d - 2].contiguous(), wg[:d - 2].contiguous()
    check_matmul_bf16(torch, F, peaks, table, a2, w2, "none",
                      "unaligned K = 2558 (general variant)", "mma.sync")
    return long


def tree_numel(tree) -> int:
    return sum(tree_numel(v) if isinstance(v, dict) else v.numel()
               for v in tree.values())


PARITY_RULE = ("rms of card - CPU over the last token's final-normed "
               "hidden state (the unembedding's input) within 2^-7 of its "
               "rms (2 units of bf16 roundoff)")


def last_hidden_and_logits(torch, params, tokens, cfg, dev):
    """The last token's final-normed hidden state (B, 1, d) and logits
    (B, 1, V) of one prefill, as ``steps.prefill`` runs it, in float32 on
    the CPU."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer
    tok = torch.as_tensor(tokens).to(device=dev, dtype=torch.int64)
    with torch.inference_mode():
        h, _ = transformer.final_hidden(params, tok, cfg, last_only=True)
        logits = L.unembed(params["embedding"], h, cfg)
    return h.float().cpu(), logits.float().cpu()


def parity_line(card_h, cpu_h, card, cpu) -> dict:
    """Card against CPU: the hidden state by ``rms_excess`` (the last
    token's attention or SSD output zeroed moves it by far more), the
    logits by 2 bf16 ulps of max |logit| (the self-match of the tied
    embedding sets that maximum) and top-1 beyond that margin."""
    bar = 2 * bf16_ulp(cpu.abs().max().item())
    top2 = cpu[0, 0].topk(2).values
    return {"hidden_over_bar": rms_excess(card_h, cpu_h),
            "hidden_max_abs_diff": (card_h - cpu_h).abs().max().item(),
            "hidden_rms": cpu_h.square().mean().sqrt().item(),
            "hidden_rule": PARITY_RULE,
            "max_abs_diff": (card - cpu).abs().max().item(), "bar": bar,
            "bar_rule": "2 bf16 ulps of max |logit| (CPU)",
            "max_abs_logit": cpu.abs().max().item(),
            "top2_margin": (top2[0] - top2[1]).item(),
            "top1_equal": int(card[0, 0].argmax()) == int(cpu[0, 0].argmax())}


def phase_lm_prefill(torch, paths):
    """qwen3-4b and mamba2-780m (phase ``lm_prefill``), then nemotron-4-15b,
    starcoder2-3b and minicpm-2b (phase ``dense_prefill``), one at a time
    (each freed before the next is built) at full width and depth, random
    bf16 params from torch.Generator seed 0 on the card: one warm-up and three
    timed ``launch.steps.prefill`` at 1 x 4096 (exact launches a
    prefill), then depth 2 at 1 x 512 on the card and on the CPU with the
    same params: the last token's final hidden state by ``PARITY_RULE``,
    its logits within 2 bf16 ulps of max |logit|, top-1 equal wherever
    the top-2 margin exceeds that."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import ARCHS
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.core import basecaller as bc
    dev = torch.device("cuda")
    for arch, per_prefill in LM_PATHS:
        name = "dense_prefill" if arch in DENSE_ARCHS else "lm_prefill"
        cfg = ARCHS[arch].config()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, _ = transformer.init(torch.Generator(dev).manual_seed(0), cfg,
                                     device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        # ParamBuilder draws each leaf in f32 first: nemotron-4-15b's
        # 32 x 6144 x 24576 MLP leaf is a ~19 GB transient
        init_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        tok = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (1, LM_SEQ))

        def run():
            torch.cuda.reset_peak_memory_stats()
            steps.prefill(params, tok, cfg)              # warm-up
            torch.cuda.synchronize()
            walls = []
            for _ in range(3):
                t1 = time.perf_counter()
                logits = steps.prefill(params, tok, cfg)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t1) * 1e3)
            return logits, walls
        path = f"lm_prefill {arch}"
        logits, walls = paths.drive(path, tuple(per_prefill), run)
        med = float(np.median(walls))
        finite = bool(torch.isfinite(logits).all().item())
        emit({"phase": name, "arch": arch, "params": tree_numel(params),
              "layers": cfg.num_layers, "batch": 1, "seq": LM_SEQ,
              "init_s": init_s, "init_peak_mem_gb": init_peak_gb,
              "wall_ms": walls, "median_ms": med,
              "limit_ms": LM_PREFILL_LIMIT_MS,
              "tokens_per_s": LM_SEQ / (med / 1e3),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
              "logits_shape": list(logits.shape), "finite": finite,
              "max_abs_logit": logits.float().abs().max().item(),
              "launches_per_prefill": {k: v / 4 for k, v in
                                       paths.paths[path].items()},
              "reduced": LM_REDUCED})
        require(finite, f"{arch}: non-finite logits")
        require(paths.paths[path] == {k: 4 * v for k, v in
                                      per_prefill.items()},
                f"{arch}: launches {paths.paths[path]}, expected 4 x "
                f"{per_prefill}")
        del params, logits
        torch.cuda.empty_cache()

        cfg2 = dataclasses.replace(cfg, num_layers=2)
        p2, _ = transformer.init(torch.Generator(dev).manual_seed(0), cfg2,
                                 device=dev)
        tok2 = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                 (1, LM_PARITY_SEQ))
        t0 = time.perf_counter()
        card_h, card = last_hidden_and_logits(torch, p2, tok2, cfg2, dev)
        card_s = time.perf_counter() - t0
        cpu_params = bc.params_to(p2, "cpu")
        t0 = time.perf_counter()
        cpu_h, cpu = last_hidden_and_logits(torch, cpu_params, tok2, cfg2,
                                            torch.device("cpu"))
        cpu_s = time.perf_counter() - t0
        line = parity_line(card_h, cpu_h, card, cpu)
        emit({"phase": "lm_parity", "arch": arch, "layers": 2, "batch": 1,
              "of": name,
              "seq": LM_PARITY_SEQ, **line, "card_s": card_s,
              "cpu_s": cpu_s})
        require(line["hidden_over_bar"] <= 1.0,
                f"{arch} depth-2 parity: last-token hidden state "
                f"{line['hidden_over_bar']} x its bar")
        diff, bar = line["max_abs_diff"], line["bar"]
        margin, same_top1 = line["top2_margin"], line["top1_equal"]
        require(diff <= bar, f"{arch} depth-2 parity: {diff} over {bar}")
        require(same_top1 or margin <= bar,
                f"{arch} depth-2 parity: top-1 differs at margin {margin}")
        del p2, cpu_params
        torch.cuda.empty_cache()


# -------------------------------------------------------- phase lm_decode --
DECODE_ARCHS = ("qwen3-4b", "mamba2-780m") + DENSE_ARCHS
DECODE_REQUESTS = 16        # the serve CLI's drive: 4-token prompts
DECODE_NEW_TOKENS = 32
DECODE_LONG = 32_768        # decode_32k's cache length
DECODE_LONG_SLOTS = 8
DECODE_REDUCED = ("decode_32k (configs/shapes.py: batch 128 x a 32768 "
                  "cache) cut to 8 slots: qwen3-4b's KV cache is ~147 KB a "
                  "token, 38.7 GB at 8 x 32768; one timed step, finiteness "
                  "and time only")
DECODE_F32_TOL = 1e-4       # the port's f32 LM bar
EXACT_TOL = 2e-2            # JAX's tests/test_models.py:70-90
DECODE_MLP = (("gate", "silu"), ("up", "none"), ("down", "none"))


def decode_requests(vocab, n=DECODE_REQUESTS, new=DECODE_NEW_TOKENS,
                    seed=0, empty=False):
    """``n`` requests with 4-token prompts drawn from ``seed`` (the serve
    CLI's), the first with an empty prompt where ``empty``."""
    import numpy as np

    from repro_torch.engine.lm import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=u, prompt=(np.zeros(0, np.int64) if empty and u == 0
                                   else rng.integers(1, vocab, 4)),
                    max_new_tokens=new) for u in range(n)]


def drive_decode(torch, eng, reqs):
    """Submit ``reqs`` and step the engine until it is idle (its
    ``drain``); returns the summary and each step's decode-stage ms."""
    for r in reqs:
        eng.submit(r)
    step_ms = []
    while True:
        before = eng.telemetry.stage_s.get("decode", 0.0)
        if not eng.step():
            break
        step_ms.append((eng.telemetry.stage_s["decode"] - before) * 1e3)
    torch.cuda.synchronize()
    return eng.summary(), step_ms


def numpy_tree(tree):
    """A float32 param tree as numpy arrays (JAX's ``jax.tree.map(
    np.asarray, params)`` form), for ``load_numpy_params``."""
    return {k: numpy_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def recorded_logits(eng):
    """Wrap ``eng._step`` to keep each step's host logits."""
    seen = []
    step = eng._step

    def record(toks):
        out = step(toks)
        seen.append(out.copy())
        return out
    eng._step = record
    return seen


def check_matmul_bf16_decode(torch, F, peaks, table):
    """Row 2d: ``matmul_bf16`` at qwen3-4b's three MLP GEMMs with M = 8
    (the ``full`` preset's slots), and at M = 1 and 16, on the narrow-M
    kernel (``route_bf16``), against its plain version within one bf16
    ulp; the same call twice gives the same bits, and each row of the M =
    8 call equals that row computed alone (M = 1), bit for bit (the K
    split depends on N and K only).  Event and device times beside
    ``torch.matmul``'s on the same bf16 inputs.  The bound is the bytes:
    ~50 MB of weights a GEMM.  The table row sums the three M = 8 GEMMs."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(7)
    q3 = ARCHS["qwen3-4b"].config()
    d, ff = q3.d_model, q3.d_ff
    a = torch.randn((16, d), generator=gen, device=dev).bfloat16()
    h = (torch.randn((16, ff), generator=gen, device=dev) * 0.5).bfloat16()
    wg = (torch.randn((d, ff), generator=gen, device=dev) * d ** -0.5
          ).bfloat16()
    wu = (torch.randn((d, ff), generator=gen, device=dev) * d ** -0.5
          ).bfloat16()
    wo = (torch.randn((ff, d), generator=gen, device=dev) * ff ** -0.5
          ).bfloat16()
    dev_ms = lib_dev_ms = 0.0
    ran = set()
    for m in (1, DECODE_LONG_SLOTS, 16):
        for (name, act), (xs, w) in zip(DECODE_MLP, ((a, wg), (a, wu),
                                                     (h, wo))):
            x = xs[:m].contiguous()
            route = km.route_bf16(m, w.shape[1], x.shape[1], x.data_ptr(),
                                  w.data_ptr())
            before = km.matmul_bf16.narrow_launches
            out = km.matmul_bf16(x, w, activation=act)
            narrow = km.matmul_bf16.narrow_launches - before
            ran.add(route)
            again = km.matmul_bf16(x, w, activation=act)
            rows = km.matmul_bf16(xs[:DECODE_LONG_SLOTS].contiguous(), w,
                                  activation=act)
            want = ref.matmul(x, w, activation=act)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            tol = bf16_ulp(want.float().abs().max().item())
            repeat = bool(torch.equal(out, again))
            k = min(m, DECODE_LONG_SLOTS)
            rows_equal = bool(torch.equal(out[:k], rows[:k]))
            ms = time_ms(torch, lambda: km.matmul_bf16(x, w,
                                                       activation=act))
            dms = device_ms(torch, lambda: km.matmul_bf16(x, w,
                                                          activation=act))
            if act == "silu":
                def lib():
                    return F.silu(torch.matmul(x, w))
            else:
                def lib():
                    return torch.matmul(x, w)
            lib_ms = time_ms(torch, lib)
            lib_dms = device_ms(torch, lib)
            ops = 2.0 * m * x.shape[1] * w.shape[1]
            bnd, by = bound_ms(peaks, nbytes(x, w, out), ops, bf16=True)
            line = {"phase": "kernel", "kernel": "matmul_bf16_decode",
                    "shape": f"qwen3-4b MLP {name} at M = {m}",
                    "a": list(x.shape), "b": list(w.shape),
                    "activation": act, "route": route,
                    "splits": km.narrow_split(w.shape[1], w.shape[0],
                                              km.NARROW_STEP["bf16"]),
                    "max_abs_err": err, "tol": tol,
                    "repeat_bitwise": repeat,
                    "rows_equal_alone_and_in_8": rows_equal, "ms": ms,
                    "device_ms": dms, "library_ms": lib_ms,
                    "library_device_ms": lib_dms, "bound_ms": bnd,
                    "bound_by": by, "bytes": nbytes(x, w, out)}
            require(err <= tol and route == "narrow" and narrow == 1
                    and repeat and rows_equal,
                    f"matmul_bf16_decode {name} M={m}: {line}")
            if m != DECODE_LONG_SLOTS:
                emit(line)
                continue
            plain = time_ms(torch, lambda: ref.matmul(x, w, activation=act),
                            reps=5)
            line["plain_ms"] = plain
            emit(line)
            table.add("matmul_bf16_decode", err=err, ms=ms, plain_ms=plain,
                      bound=bnd, bound_by=by, library_ms=lib_ms)
            dev_ms += dms
            lib_dev_ms += lib_dms
    row = table.rows["matmul_bf16_decode"]
    row.update(device_ms=dev_ms, library_device_ms=lib_dev_ms,
               variant=sorted(ran))


def phase_lm_decode(torch, F, peaks, table, paths):
    """The LM decode server on the card.  (1) ``lm_decode``'s ``full``
    preset (8 slots x 512) for qwen3-4b and mamba2-780m at full width and
    depth, random bf16 params from seed 0: 16 requests with 4-token
    prompts and 32 new tokens each after a one-request warm-up; tokens/s,
    each step's decode-stage ms, request p50/p99, launches and the fabric
    counters.  (2) f32 smoke configs of the five archs, card against CPU
    on the same params (``load_numpy_params``): equal tokens and each
    step's logits within 1e-4; bf16 at full width and depth 2, four
    teacher-forced steps: logits within 2 bf16 ulps of max |logit|.
    (3) JAX's exactness check on the card: the f32 forward equals step by
    step ``serve_step`` within 2e-2.  (4) Two ``lm_decode`` tenants of one
    ``Fleet`` share one ``LMUnit`` and each decodes its solo run's tokens
    (f32).  (5) One timed ``serve_step`` of qwen3-4b at 8 slots with a
    32,768-long cache of seeded values.  Then ``matmul_bf16_decode``.
    Returns the launches of ``matmul_bf16`` on the decode paths."""
    import dataclasses

    import numpy as np

    import repro_torch.engine as te
    from repro_torch.configs import ARCHS
    from repro_torch.engine.telemetry import Telemetry
    from repro_torch.fleet import Fleet, LMUnit
    from repro_torch.models import transformer
    from repro_torch.models.param import load_numpy_params
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    decode_launches = {"matmul_bf16": 0, "matmul_bf16_wgmma": 0,
                       "matmul_bf16_narrow": 0}

    def counted(path, kernels, fn):
        out = paths.drive(path, kernels, fn)
        for k in decode_launches:
            decode_launches[k] += paths.paths[path].get(k, 0)
        return out

    # (1) the full preset at full width and depth
    keep = None
    for arch in ("qwen3-4b", "mamba2-780m"):
        t0 = time.perf_counter()
        eng = te.build("lm_decode", preset="full", arch=arch)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        cfg = eng.cfg
        drive_decode(torch, eng, decode_requests(cfg.vocab_size, n=1, new=2,
                                                 seed=99))
        eng.finished.clear()
        eng.telemetry = Telemetry(workload=eng.workload)
        kernels = ("matmul_bf16",) if cfg.family == "dense" else ()
        rep, step_ms = counted(
            f"lm_decode {arch}", kernels, lambda: drive_decode(
                torch, eng, decode_requests(cfg.vocab_size)))
        got = paths.paths[f"lm_decode {arch}"]
        per_step = 3 * cfg.num_layers if cfg.family == "dense" else 0
        fabric = {k: v for k, v in rep.items() if k.startswith("fabric.")}
        lens = sorted({len(r.tokens_out) for r in eng.finished})
        emit({"phase": "lm_decode", "part": "full_preset", "arch": arch,
              "slots": eng.slots, "max_len": eng.max_len,
              "layers": cfg.num_layers, "init_s": init_s,
              "requests": DECODE_REQUESTS, "prompt_len": 4,
              "new_tokens": DECODE_NEW_TOKENS,
              "completed": rep["completed"], "steps": rep["steps"],
              "dispatches": rep["dispatches"],
              "tokens": eng.telemetry.tokens,
              "tokens_per_s": rep["tokens_per_s"], "wall_s": rep["wall_s"],
              "step_ms_mean": float(np.mean(step_ms)),
              "step_ms_p50": float(np.percentile(step_ms, 50)),
              "step_ms_max": float(np.max(step_ms)),
              "stage_prefill_s": rep.get("stage_prefill_s"),
              "stage_decode_s": rep.get("stage_decode_s"),
              "request_p50_ms": rep["p50_ms"],
              "request_p99_ms": rep["p99_ms"],
              "matmul_bf16_launches": got.get("matmul_bf16", 0),
              "narrow_launches": got.get("matmul_bf16_narrow", 0),
              "wgmma_launches": got.get("matmul_bf16_wgmma", 0),
              "fabric": fabric, "tokens_out_lengths": lens,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
        require(rep["completed"] == DECODE_REQUESTS
                and lens == [DECODE_NEW_TOKENS + 1],
                f"lm_decode {arch}: completed {rep['completed']}, token "
                f"counts {lens}")
        want = per_step * rep["dispatches"]
        require(got.get("matmul_bf16", 0) == want
                and got.get("matmul_bf16_narrow", 0) == want
                and fabric == ({"fabric.dispatch.matmul.cuda": want}
                               if want else {}),
                f"lm_decode {arch}: launches {got}, fabric {fabric}, "
                f"expected {want} on the narrow-M kernel")
        if arch == "qwen3-4b":
            keep = (cfg, eng.params)
        del eng
        torch.cuda.empty_cache()

    # (5) one step at decode_32k's cache length, 8 slots
    cfg, params = keep
    cache = transformer.init_cache(cfg, DECODE_LONG_SLOTS, DECODE_LONG,
                                   device=dev)
    gen = torch.Generator(dev).manual_seed(5)
    for k in ("k", "v"):
        cache[k].normal_(generator=gen)
    tok = torch.randint(1, cfg.vocab_size, (DECODE_LONG_SLOTS, 1),
                        generator=gen, device=dev)
    pos = torch.arange(DECODE_LONG - DECODE_LONG_SLOTS, DECODE_LONG,
                       device=dev)

    def long_step():
        walls = []
        for _ in range(2):                       # a warm-up, then timed
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with torch.inference_mode():
                logits, _ = transformer.serve_step(params, cache, tok, pos,
                                                   cfg)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        return logits, walls
    logits, walls = counted("lm_decode qwen3-4b 32k step", ("matmul_bf16",),
                            long_step)
    finite = bool(torch.isfinite(logits).all().item())
    cache_gb = sum(v.numel() * v.element_size()
                   for v in cache.values()) / 2 ** 30
    emit({"phase": "lm_decode", "part": "decode_32k_step", "arch": "qwen3-4b",
          "slots": DECODE_LONG_SLOTS, "max_len": DECODE_LONG,
          "warm_ms": walls[0], "step_ms": walls[1], "cache_gb": cache_gb,
          "finite": finite, "reduced": DECODE_REDUCED,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    got = paths.paths["lm_decode qwen3-4b 32k step"]
    require(finite and got.get("matmul_bf16_narrow", 0)
            == got.get("matmul_bf16", 0) == 2 * 3 * cfg.num_layers,
            f"decode_32k step: finite {finite}, launches {got}")
    del cache, params, keep, logits
    torch.cuda.empty_cache()

    # (2) card against CPU: f32 smoke engines, tokens and logits
    for arch in DECODE_ARCHS:
        cfg = dataclasses.replace(ARCHS[arch].smoke_config(),
                                  dtype="float32")
        cpu_params, _ = transformer.init(torch.Generator().manual_seed(0),
                                         cfg, device="cpu")
        card_params = load_numpy_params(numpy_tree(cpu_params), dev)
        runs = {}
        for where, p in (("cpu", cpu_params), ("cuda", card_params)):
            eng = te.build("lm_decode", params=p, cfg=cfg, slots=2,
                           max_len=32, device=where)
            seen = recorded_logits(eng)
            for r in decode_requests(cfg.vocab_size, n=5, new=6, empty=True):
                eng.submit(r)
            eng.drain()
            runs[where] = ([(r.uid, r.tokens_out) for r in eng.finished],
                           seen)
        (ct, cl), (gt, gl) = runs["cpu"], runs["cuda"]
        excess = max(float(np.max(np.abs(g - c) / (DECODE_F32_TOL * (
            1 + np.abs(c))))) for g, c in zip(gl, cl))
        emit({"phase": "lm_decode", "part": "f32_card_vs_cpu", "arch": arch,
              "steps": len(cl), "tokens_equal": ct == gt,
              "max_abs_diff": max(float(np.max(np.abs(g - c)))
                                  for g, c in zip(gl, cl)),
              "over_bar": excess,
              "bar": "|card - cpu| <= 1e-4 (1 + |cpu|) each step's logits"})
        require(ct == gt and len(cl) == len(gl) and excess <= 1.0,
                f"lm_decode f32 {arch}: tokens equal {ct == gt}, logits "
                f"{excess} x the bar")

    # (2) bf16, full width at depth 2: four teacher-forced steps
    for arch in DECODE_ARCHS:
        cfg = dataclasses.replace(ARCHS[arch].config(), num_layers=2)
        p2, _ = transformer.init(torch.Generator(dev).manual_seed(0), cfg,
                                 device=dev)
        from repro_torch.core import basecaller as bc
        cpu_p = bc.params_to(p2, "cpu")
        caches = {d: transformer.init_cache(cfg, 2, 16, device=d)
                  for d in ("cpu", "cuda")}
        rng = np.random.default_rng(4)
        pos = np.array([0, 5])
        worst = {"over_bar": 0.0, "top1_differs_beyond_bar": 0}
        for _ in range(4):
            tok = rng.integers(0, cfg.vocab_size, (2, 1))
            out = {}
            for d, p in (("cpu", cpu_p), ("cuda", p2)):
                with torch.inference_mode():
                    lg, caches[d] = transformer.serve_step(
                        p, caches[d], torch.as_tensor(tok, device=d),
                        torch.as_tensor(pos, device=d), cfg)
                out[d] = lg.float().cpu()[:, 0]
            bar = 2 * bf16_ulp(out["cpu"].abs().max().item())
            diff = (out["cuda"] - out["cpu"]).abs().max().item()
            worst["over_bar"] = max(worst["over_bar"], diff / bar)
            top2 = out["cpu"].topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > bar
            worst["top1_differs_beyond_bar"] += int(
                (out["cuda"].argmax(-1) != out["cpu"].argmax(-1))[sure]
                .sum())
            pos += 1
        emit({"phase": "lm_decode", "part": "bf16_depth2_card_vs_cpu",
              "arch": arch, "layers": 2, "steps": 4, **worst,
              "bar": "2 bf16 ulps of max |logit| (CPU) each step"})
        require(worst["over_bar"] <= 1.0
                and worst["top1_differs_beyond_bar"] == 0,
                f"lm_decode bf16 depth-2 {arch}: {worst}")
        del p2, cpu_p, caches
        torch.cuda.empty_cache()

    # (3) JAX's exactness check, on the card
    exact = {}
    for arch in DECODE_ARCHS:
        cfg = dataclasses.replace(ARCHS[arch].smoke_config(),
                                  dtype="float32")
        p, _ = transformer.init(torch.Generator(dev).manual_seed(0), cfg,
                                device=dev)
        toks = torch.as_tensor(np.random.default_rng(7).integers(
            1, cfg.vocab_size, (1, 8)), device=dev)
        with torch.inference_mode():
            full, _ = transformer.apply(p, toks, cfg)
            cache = transformer.init_cache(cfg, 1, 8, device=dev)
            outs = []
            for i in range(8):
                lg, cache = transformer.serve_step(
                    p, cache, toks[:, i: i + 1],
                    torch.full((1,), i, device=dev), cfg)
                outs.append(lg[:, 0])
        dec = torch.stack(outs, dim=1)
        err = (dec - full).abs().max().item()
        rel = ((dec - full).abs() / (EXACT_TOL * (1 + full.abs()))).max()
        exact[arch] = {"max_abs_err": err, "over_bar": rel.item()}
    emit({"phase": "lm_decode", "part": "decode_equals_forward",
          "archs": exact, "bar": "|decode - forward| <= 2e-2 (1 + |forward|)"
                                 " (JAX's tests/test_models.py)"})
    require(all(v["over_bar"] <= 1.0 for v in exact.values()),
            f"decode != forward: {exact}")

    # (4) two tenants of one fleet share one LMUnit; each equals solo
    cfg = dataclasses.replace(ARCHS["starcoder2-3b"].smoke_config(),
                              dtype="float32")

    def fleet_reqs(i):
        return decode_requests(cfg.vocab_size, n=3, new=6, seed=10 + i)
    fleet = Fleet()
    tenants = [fleet.add_tenant(n, "lm_decode", "smoke", cfg=cfg)
               for n in ("lab-a", "lab-b")]
    for i, t in enumerate(tenants):
        for r in fleet_reqs(i):
            t.submit(r)
    fleet.drain()
    equal = {}
    for i, t in enumerate(tenants):
        solo = te.build("lm_decode", "smoke", cfg=cfg)
        for r in fleet_reqs(i):
            solo.submit(r)
        solo.drain()
        want = {r.uid: r.tokens_out for r in solo.finished}
        equal[t.name] = {r.uid: r.tokens_out for r in t.outputs} == want
    shared = (tenants[0].unit is tenants[1].unit
              and isinstance(tenants[0].unit, LMUnit))
    emit({"phase": "lm_decode", "part": "fleet_tenants", "arch": cfg.name,
          "shared_unit": shared, "equal_solo": equal,
          "steps": tenants[0].engine.telemetry.steps})
    require(shared and all(equal.values()),
            f"lm_decode fleet: shared {shared}, equal {equal}")

    check_matmul_bf16_decode(torch, F, peaks, table)
    emit({"phase": "lm_decode", "part": "wall",
          "wall_s": time.perf_counter() - t_phase})
    return decode_launches


# ------------------------------------------------------------ phase lm_tp --
# Row 2l: matmul_int8 at qwen3-4b's decode projections, (K, N) of wq, wk,
# wv, the attention's wo, wi / wi_gate and the MLP's wo; each runs once a
# layer at decode (7 a layer, 252 a step over 36 layers)
LM_INT8_PROJ = (("wq", 2560, 4096), ("wk", 2560, 1024), ("wv", 2560, 1024),
                ("attn wo", 4096, 2560), ("wi", 2560, 9728),
                ("wi_gate", 2560, 9728), ("mlp wo", 9728, 2560))
# a TP 2 rank's slices of them: column-parallel N halved, row-parallel K
LM_INT8_TP2_PROJ = (("wq", 2560, 2048), ("wk", 2560, 512), ("wv", 2560, 512),
                    ("attn wo", 2048, 2560), ("wi", 2560, 4864),
                    ("wi_gate", 2560, 4864), ("mlp wo", 4864, 2560))
# ragged: K and N multiples of 16 but not of the tiles (the tensor-core
# routes), and no multiple of 4 (the dp4a tile)
LM_INT8_RAGGED = (("ragged 16", 2576, 1008), ("ragged", 2561, 1003))
LM_INT8_DECODE_M = 8        # the full preset's slots
LM_INT8_PREFILL_M = 4096    # the prefill's 1 x 4096 tokens
LM_INT8_LIB_M = 32          # torch._int_mm takes M > 16 only
LM_TP = 2                   # two ranks on the one card, over gloo
LM_TP_STEPS = 8             # JAX's parity test's steps (mamba2: 6)
LM_TP_F32_TOL = {"qwen3-4b": 1e-5, "mamba2-780m": 1e-5}  # JAX's TP bar


def check_matmul_int8_lm(torch, peaks, table):
    """Row 2l: ``kernels.matmul.matmul_int8`` at qwen3-4b's seven decode
    projections at M = 1, 8 and 16 (the narrow-M kernel), 32 and 4,096
    (the tiled tensor-core kernel), a TP 2 rank's seven slices at M = 1,
    8 and 16, and two ragged shapes at M = 8 (one on the narrow-M kernel,
    one on the dp4a tile), each bitwise against its plain version, on the
    route ``route_int8`` names; event and device times; ``torch._int_mm``
    (cuBLASLt) at M = 32, the least M it takes, and 4,096 beside the
    kernel.  The table row sums the seven M = 8 shapes (one layer's
    decode projections); ``at_4096`` the prefill's."""
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(11)
    prefill = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
               "bound_ms": 0.0, "library_ms": 0.0, "max_abs_err": 0}
    lib_m = {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    counters = ("launches", "skinny_launches", "narrow_launches",
                "tc_launches")
    cases = ([(f"qwen3-4b {n}", k, nn, (1, LM_INT8_DECODE_M, 16,
                                        LM_INT8_LIB_M, LM_INT8_PREFILL_M))
              for n, k, nn in LM_INT8_PROJ]
             + [(f"qwen3-4b TP 2 rank {n}", k, nn, (1, LM_INT8_DECODE_M, 16))
                for n, k, nn in LM_INT8_TP2_PROJ]
             + [(n, k, nn, (LM_INT8_DECODE_M,))
                for n, k, nn in LM_INT8_RAGGED])
    for label, k, n, ms_ in cases:
        w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        for m in ms_:
            a = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                              dtype=torch.int8)
            route = km.route_int8(m, n, k, a.data_ptr(), w.data_ptr())
            before = {c: getattr(km.matmul_int8, c) for c in counters}
            out = km.matmul_int8(a, w)
            ran = {c: getattr(km.matmul_int8, c) - before[c]
                   for c in counters}
            want = ref.matmul_int8(a, w)
            torch.cuda.synchronize()
            diff = int((out != want).sum().item())
            expect = (("narrow" if m <= 16 else "tc")
                      if k % 16 == 0 and n % 16 == 0 else "dp4a")
            counted = {"narrow": ran["narrow_launches"],
                       "tc": ran["tc_launches"],
                       "dp4a": ran["launches"] - ran["narrow_launches"]
                       - ran["tc_launches"] - ran["skinny_launches"]}
            require(diff == 0 and route == expect and counted[route] == 1
                    and ran["launches"] == 1,
                    f"matmul_int8 {label} M={m}: {diff} outputs differ, "
                    f"route {route} (expected {expect}), launches {ran}")
            ms = time_ms(torch, lambda: km.matmul_int8(a, w))
            bnd, by = bound_ms(peaks, nbytes(a, w, out), 2.0 * m * k * n,
                               int8=True)
            line = {"phase": "kernel", "kernel": "matmul_int8_lm",
                    "shape": f"{label} at M = {m}", "a": [m, k],
                    "b": [k, n], "route": route,
                    "elements_differing": diff, "ms": ms, "bound_ms": bnd,
                    "bound_by": by}
            if m > 16:
                lib_out = torch._int_mm(a, w)
                require(torch.equal(lib_out, want),
                        f"matmul_int8 {label}: torch._int_mm disagrees")
                line["library_ms"] = time_ms(torch,
                                             lambda: torch._int_mm(a, w))
            if m == LM_INT8_LIB_M:
                lib_m["ms"] += ms
                lib_m["library_ms"] += line["library_ms"]
                lib_m["bound_ms"] += bnd
                emit(line)
                continue
            line["device_ms"] = device_ms(torch,
                                          lambda: km.matmul_int8(a, w))
            main = label in {f"qwen3-4b {n}" for n, _, _ in LM_INT8_PROJ}
            if main and m in (LM_INT8_DECODE_M, LM_INT8_PREFILL_M):
                line["plain_ms"] = time_ms(
                    torch, lambda: ref.matmul_int8(a, w), reps=3, warm=1)
            emit(line)
            if main and m == LM_INT8_DECODE_M:
                table.add("matmul_int8_lm", err=diff, ms=ms,
                          plain_ms=line["plain_ms"], bound=bnd, bound_by=by,
                          library_ms=0.0)
                row = table.rows["matmul_int8_lm"]
                row["device_ms"] = row.get("device_ms", 0.0) + line[
                    "device_ms"]
            elif main and m == LM_INT8_PREFILL_M:
                for f in ("ms", "device_ms", "plain_ms", "bound_ms",
                          "library_ms"):
                    prefill[f] += line[f]
                prefill["bound_by"] = by
                prefill["route"] = route
    row = table.rows["matmul_int8_lm"]
    # the library at decode: _int_mm's seven shapes at M = 32, beside the
    # kernel's own and the bound at M = 32
    row["library_ms"] = lib_m["library_ms"]
    row.update(library_m=LM_INT8_LIB_M, kernel_ms_at_library_m=lib_m["ms"],
               bound_ms_at_library_m=lib_m["bound_ms"], at_4096=prefill)


def int8_lm_params(torch, cfg, dev, seed=0):
    """Random bf16 params of ``cfg`` from a generator on ``dev``, quantized
    once by ``quantize_params(stack_dims=1)`` (the float ones freed)."""
    from repro_torch.models import transformer
    from repro_torch.quant.params import quantize_params
    p, _ = transformer.init(torch.Generator(dev).manual_seed(seed), cfg,
                            device=dev)
    q = quantize_params(p, stack_dims=1)
    del p
    torch.cuda.empty_cache()
    return q


def decode_steps(eng, toks, steps):
    """``steps`` steps of every slot from ``toks`` (slots, 1), each feeding
    back its argmax; each step's host logits (JAX's ``decode_logits``)."""
    import numpy as np
    out = []
    for i in range(steps):
        eng.pos[:] = i
        logits = eng._step(toks)
        out.append(logits)
        toks = logits.argmax(-1)[:, None].astype(np.int32)
    return out


def tp_first_tokens(slots, vocab, seed=3):
    import numpy as np
    return np.random.default_rng(seed).integers(
        1, vocab, (slots, 1)).astype(np.int32)


def f32_smoke(arch):
    import dataclasses

    import torch
    from repro_torch.configs import ARCHS
    return dataclasses.replace(ARCHS[arch].smoke_config(),
                               dtype=torch.float32)


def cuda_collectives(torch, dev) -> dict:
    """``tp.psum``, ``tp.pmax`` and ``tp.all_gather_last`` once on a CUDA
    tensor in every rank: each result's device and whether it is right
    (gloo takes CUDA tensors, so no collective stages through host
    memory)."""
    import torch.distributed as dist

    from repro_torch.distributed import tp
    world = dist.get_world_size()
    x = torch.full((3,), float(dist.get_rank() + 1), device=dev)
    with tp.axis_ctx("model", world):
        got = {"all_reduce_sum": (tp.psum(x), world * (world + 1) / 2),
               "all_reduce_max": (tp.pmax(x), world),
               "all_gather": (tp.all_gather_last(x), None)}
    want_gather = torch.arange(1, world + 1, device=dev,
                               dtype=torch.float32).repeat_interleave(3)
    return {k: {"device": v.device.type,
                "right": bool(torch.equal(v, want_gather) if want is None
                              else (v == want).all())}
            for k, (v, want) in got.items()}


def lm_tp_rank(rank, world, spec):
    """One rank of phase ``lm_tp`` (a spawned process; the card is shared):
    the f32 smoke engines, the int8 qwen3-4b at full width, and the
    sharded checkpoint's pre-partitioned load, each at ``mesh=world``; the
    kernels counted from 0 around the full-width run."""
    import torch

    import repro_torch.engine as te
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import fabric
    from repro_torch.kernels import ref
    from repro_torch.models.param import load_numpy_params
    ref.full_fp32()
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    out = {"rank": rank, "collectives": cuda_collectives(torch, dev)}
    for arch, steps in (("qwen3-4b", LM_TP_STEPS), ("mamba2-780m", 6)):
        cfg = f32_smoke(arch)
        eng = te.build("lm_decode", params=load_numpy_params(
            spec["f32"][arch], dev), cfg=cfg, slots=2, max_len=16,
            mesh=world)
        out[arch] = decode_steps(eng, tp_first_tokens(2, cfg.vocab_size),
                                 steps)

    cfg = ARCHS["qwen3-4b"].config()
    q = int8_lm_params(torch, cfg, dev)
    eng = te.build("lm_decode", preset="full", arch="qwen3-4b", params=q,
                   mesh=world)
    del q
    torch.cuda.empty_cache()
    counters = launch_counters()
    for wrapper, attr in counters.values():
        setattr(wrapper, attr, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["int8_full"] = decode_steps(eng, tp_first_tokens(
        eng.slots, cfg.vocab_size), LM_TP_STEPS)
    torch.cuda.synchronize()
    out["int8_full_s"] = time.perf_counter() - t0
    out["launches"] = {k: getattr(w, a) for k, (w, a) in counters.items()}
    out["int8_local_wi_cols"] = int(
        eng.params["blocks"]["l0"]["mlp"]["wi"].q.shape[-1])
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del eng
    torch.cuda.empty_cache()

    base = fabric.counters()
    eng = te.build("lm_decode", preset="smoke", arch="qwen3-4b",
                   ckpt_dir=spec["sharded"], mesh=world)
    out["ckpt_counters"] = {k: v - base.get(k, 0) for k, v in
                            fabric.counters().items()
                            if k.startswith("tp.load.")}
    out["ckpt_local_cols"] = int(
        eng.params["blocks"]["l0"]["mlp"]["wi"].q.shape[-1])
    out["ckpt"] = decode_steps(eng, tp_first_tokens(2, eng.cfg.vocab_size),
                               6)
    return out


def phase_lm_tp(torch, F, peaks, table, paths):
    """int8 LM weights and tensor parallelism on the card.  (1) Row 2l.
    (2) qwen3-4b's ``full`` preset (8 slots x 512) with int8 weights
    (``quantize_params(stack_dims=1)`` of seeded bf16 params): 16 requests,
    tokens/s, step ms, 252 narrow-M int8 launches a step, peak memory; at
    depth 2 card against CPU within phase ``lm_decode``'s bf16 bars.
    (3) Two ranks on the one card over gloo (``distributed.launch.run``):
    the f32 smoke qwen3-4b and mamba2-780m (JAX's 1e-5) against TP 1 on
    the card; the int8 qwen3-4b at full width 8 steps bit for bit and
    token for token against the single-rank card run; the converter's
    sharded checkpoint of an int8 smoke qwen3-4b loaded pre-partitioned
    (counters, local widths) and serving bit for bit; which gloo
    collectives stage CUDA tensors through the host.  (4) ``serve --tp 2
    --ckpt`` in a subprocess.  Returns the narrow-M int8 launches of the
    lm_tp paths."""
    import dataclasses

    import numpy as np

    import repro_torch.engine as te
    from repro_torch.configs import ARCHS
    from repro_torch.core import basecaller as bc
    from repro_torch.distributed import launch
    from repro_torch.engine.telemetry import Telemetry
    from repro_torch.models import transformer
    from repro_torch.models.param import load_numpy_params
    from repro_torch.quant.params import quantize_params
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.checkpoint_converter import convert
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    narrow = {"lm_tp": 0}

    def count_narrow(path):
        """The path's int8 launches on the narrow-M kernel; requires that
        every int8 launch of the path ran there."""
        got = paths.paths[path]
        n = got.get("matmul_int8_narrow", 0)
        require(n == got.get("matmul_int8", 0),
                f"{path}: an int8 GEMM off the narrow-M kernel: {got}")
        narrow["lm_tp"] += n
        return n

    check_matmul_int8_lm(torch, peaks, table)

    # (2) the int8 full preset on one rank
    cfg = ARCHS["qwen3-4b"].config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q = int8_lm_params(torch, cfg, dev)
    eng = te.build("lm_decode", preset="full", arch="qwen3-4b", params=q)
    del q
    init_s = time.perf_counter() - t0
    drive_decode(torch, eng, decode_requests(cfg.vocab_size, n=1, new=2,
                                             seed=99))
    eng.finished.clear()
    eng.telemetry = Telemetry(workload=eng.workload)
    rep, step_ms = paths.drive(
        "lm_tp int8 qwen3-4b full", ("matmul_int8",),
        lambda: drive_decode(torch, eng, decode_requests(cfg.vocab_size)))
    n = count_narrow("lm_tp int8 qwen3-4b full")
    got = paths.paths["lm_tp int8 qwen3-4b full"]
    per_step = 7 * cfg.num_layers
    lens = sorted({len(r.tokens_out) for r in eng.finished})
    emit({"phase": "lm_tp", "part": "int8_full_preset", "arch": "qwen3-4b",
          "slots": eng.slots, "max_len": eng.max_len, "init_s": init_s,
          "requests": DECODE_REQUESTS, "completed": rep["completed"],
          "steps": rep["steps"], "dispatches": rep["dispatches"],
          "tokens": eng.telemetry.tokens,
          "tokens_per_s": rep["tokens_per_s"], "wall_s": rep["wall_s"],
          "step_ms_mean": float(np.mean(step_ms)),
          "step_ms_p50": float(np.percentile(step_ms, 50)),
          "request_p50_ms": rep["p50_ms"], "request_p99_ms": rep["p99_ms"],
          "narrow_int8_launches": n,
          "narrow_int8_per_dispatch": n / rep["dispatches"],
          "launches": got, "tokens_out_lengths": lens,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    require(rep["completed"] == DECODE_REQUESTS
            and lens == [DECODE_NEW_TOKENS + 1],
            f"lm_tp int8: completed {rep['completed']}, lengths {lens}")
    require(n == per_step * rep["dispatches"],
            f"lm_tp int8: {n} narrow-M int8 launches over "
            f"{rep['dispatches']} steps, expected {per_step} a step; {got}")
    solo_full = decode_steps(eng, tp_first_tokens(eng.slots,
                                                  cfg.vocab_size),
                             LM_TP_STEPS)
    del eng
    torch.cuda.empty_cache()

    # (2) depth 2: card against CPU, four teacher-forced steps
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    q_cpu = quantize_params(transformer.init(
        torch.Generator().manual_seed(0), cfg2, device="cpu")[0],
        stack_dims=1)
    q_card = bc.params_to(q_cpu, dev)
    caches = {d: transformer.init_cache(cfg2, 2, 16, device=d)
              for d in ("cpu", "cuda")}
    rng = np.random.default_rng(4)
    pos = np.array([0, 5])
    worst = {"over_bar": 0.0, "top1_differs_beyond_bar": 0}
    for _ in range(4):
        tok = rng.integers(0, cfg2.vocab_size, (2, 1))
        lg = {}
        for d, p in (("cpu", q_cpu), ("cuda", q_card)):
            with torch.inference_mode():
                out, caches[d] = transformer.serve_step(
                    p, caches[d], torch.as_tensor(tok, device=d),
                    torch.as_tensor(pos, device=d), cfg2)
            lg[d] = out.float().cpu()[:, 0]
        bar = 2 * bf16_ulp(lg["cpu"].abs().max().item())
        worst["over_bar"] = max(worst["over_bar"], (
            lg["cuda"] - lg["cpu"]).abs().max().item() / bar)
        top2 = lg["cpu"].topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > bar
        worst["top1_differs_beyond_bar"] += int(
            (lg["cuda"].argmax(-1) != lg["cpu"].argmax(-1))[sure].sum())
        pos += 1
    emit({"phase": "lm_tp", "part": "int8_depth2_card_vs_cpu",
          "arch": "qwen3-4b", "layers": 2, "steps": 4, **worst,
          "bar": "2 bf16 ulps of max |logit| (CPU) each step"})
    require(worst["over_bar"] <= 1.0
            and worst["top1_differs_beyond_bar"] == 0,
            f"lm_tp int8 depth-2: {worst}")
    del q_cpu, q_card, caches
    torch.cuda.empty_cache()

    # (3) the f32 smoke engines at TP 1 on the card, and the checkpoint
    f32 = {}
    solo = {}
    for arch, steps in (("qwen3-4b", LM_TP_STEPS), ("mamba2-780m", 6)):
        scfg = f32_smoke(arch)
        p, _ = transformer.init(torch.Generator().manual_seed(0), scfg,
                                device="cpu")
        f32[arch] = numpy_tree(p)
        eng = te.build("lm_decode", params=load_numpy_params(f32[arch], dev),
                       cfg=scfg, slots=2, max_len=16)
        solo[arch] = decode_steps(eng, tp_first_tokens(2, scfg.vocab_size),
                                  steps)
    ck_dir = os.path.join(ROOT, "build", "lm_tp")
    full_dir, sharded = (os.path.join(ck_dir, d) for d in ("full", "tp2"))
    scfg = ARCHS["qwen3-4b"].smoke_config()
    qs = quantize_params(transformer.init(torch.Generator().manual_seed(1),
                                          scfg, device="cpu")[0],
                         stack_dims=1)
    ck.save(full_dir, qs, step=1)
    convert(full_dir, sharded, tp=LM_TP, arch="qwen3-4b", smoke=True)
    eng = te.build("lm_decode", preset="smoke", arch="qwen3-4b",
                   params=bc.params_to(qs, dev))
    solo_ckpt = decode_steps(eng, tp_first_tokens(2, scfg.vocab_size), 6)
    del eng
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = launch.run(lm_tp_rank, LM_TP,
                       args=({"f32": f32, "sharded": sharded},),
                       timeout_s=600)
    ranks_s = time.perf_counter() - t0
    counts = {}
    for r in ranks:
        for k, v in r["launches"].items():
            counts[k] = counts.get(k, 0) + v
    paths.record("lm_tp int8 qwen3-4b full tp2", counts, ("matmul_int8",))
    n_tp = count_narrow("lm_tp int8 qwen3-4b full tp2")
    f32_lines = {}
    for arch in solo:
        tol = LM_TP_F32_TOL[arch]
        over = max(float(np.max(np.abs(g - c) / (tol * (1 + np.abs(c)))))
                   for r in ranks for g, c in zip(r[arch], solo[arch]))
        over_1e5 = max(float(np.max(np.abs(g - c) / (1e-5 * (
            1 + np.abs(c))))) for r in ranks
            for g, c in zip(r[arch], solo[arch]))
        tokens = all([a.argmax(-1).tolist() for a in r[arch]]
                     == [a.argmax(-1).tolist() for a in solo[arch]]
                     for r in ranks)
        f32_lines[arch] = {"over_bar": over, "bar": tol,
                           "over_1e-5": over_1e5, "tokens_equal": tokens}
        require(over <= 1.0 and tokens, f"lm_tp f32 {arch}: {f32_lines}")
    bitwise = all(np.array_equal(a, b) for r in ranks
                  for a, b in zip(r["int8_full"], solo_full))
    tokens_equal = all([a.argmax(-1).tolist() for a in r["int8_full"]]
                       == [a.argmax(-1).tolist() for a in solo_full]
                       for r in ranks)
    ckpt_bitwise = all(np.array_equal(a, b) for r in ranks
                       for a, b in zip(r["ckpt"], solo_ckpt))
    wi_cols = ARCHS["qwen3-4b"].config().d_ff
    emit({"phase": "lm_tp", "part": "tp2_one_card", "ranks": LM_TP,
          "backend": "gloo",
          "cuda_collectives": [r["collectives"] for r in ranks],
          "f32_smoke_vs_tp1": f32_lines,
          "int8_full_steps": LM_TP_STEPS, "int8_full_bitwise": bitwise,
          "int8_full_tokens_equal": tokens_equal,
          "int8_full_s": [r["int8_full_s"] for r in ranks],
          "narrow_int8_launches": n_tp,
          "narrow_int8_per_rank_step": n_tp / (LM_TP * LM_TP_STEPS),
          "int8_local_wi_cols": [r["int8_local_wi_cols"] for r in ranks],
          "peak_mem_gb": [r["peak_mem_gb"] for r in ranks],
          "ckpt_counters": [r["ckpt_counters"] for r in ranks],
          "ckpt_local_cols": [r["ckpt_local_cols"] for r in ranks],
          "ckpt_serve_bitwise": ckpt_bitwise, "ranks_wall_s": ranks_s})
    require(all(c == {"device": "cuda", "right": True}
                for r in ranks for c in r["collectives"].values()),
            f"lm_tp collectives: {[r['collectives'] for r in ranks]}")
    require(bitwise and tokens_equal,
            f"lm_tp int8 full width: bitwise {bitwise}, tokens "
            f"{tokens_equal}")
    require(n_tp == LM_TP * LM_TP_STEPS * 7 * cfg.num_layers,
            f"lm_tp: {n_tp} narrow-M int8 launches in the ranks")
    require(all(r["int8_local_wi_cols"] == wi_cols // LM_TP for r in ranks),
            "lm_tp: a rank holds the wrong slice of wi")
    require(ckpt_bitwise and all(
        r["ckpt_counters"].get("tp.load.pre_partitioned", 0) > 0
        and r["ckpt_counters"].get("tp.load.replicated_slice", 0) == 0
        and r["ckpt_local_cols"] == scfg.d_ff // LM_TP for r in ranks),
        "lm_tp: sharded checkpoint load")

    # (4) the serve CLI at --tp 2 on the converted checkpoint
    env = dict(os.environ, PYTHONPATH=SRC)
    argv = ["--workload", "lm_decode", "--smoke", "--tp", str(LM_TP),
            "--ckpt", sharded, "--requests", "4", "--json"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *argv], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    out = proc.stdout
    report = json.loads(out[out.index("{"):]) if "{" in out else {}
    emit({"phase": "lm_tp", "part": "serve_cli", "argv": argv,
          "rc": proc.returncode, "wall_s": time.perf_counter() - t0,
          **{k: report.get(k) for k in ("completed", "dispatches",
                                        "tokens_per_s")}})
    require(proc.returncode == 0 and report.get("completed") == 4,
            f"serve --tp {LM_TP} exited {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    emit({"phase": "lm_tp", "part": "wall",
          "wall_s": time.perf_counter() - t_phase})
    return narrow["lm_tp"]



# ------------------------------------------------------------ phase fleet --
# The basecall tenants' traffic is benchmarks/fleet.py's bursty arrivals
# at its full size: 6 bursts a tenant 0.25 s apart, 6 requests (one
# 2048-sample row each, drawn from seed 11) a burst, the second tenant's
# bursts 0.3 of a period into the first's gaps.  The flowcell is fed by
# its pores and the pipeline's 8 chunks are a recorded backlog.
FLEET_BURSTS = 6
FLEET_PER_BURST = 6
FLEET_PERIOD_S = 0.25
FLEET_OFFSETS_S = {"lab-bc1": 0.0, "lab-bc2": 0.3 * FLEET_PERIOD_S}
FLEET_BC_ROWS = FLEET_BURSTS * FLEET_PER_BURST


def fleet_inputs(panel):
    """The basecall tenants' rows (36 x 2048 each, seed 11 as
    benchmarks/fleet.py draws them) and phase 6's 8 pipeline chunks of
    32 x 2048."""
    import numpy as np
    rows = np.random.default_rng(11).normal(
        size=(2 * FLEET_BC_ROWS, 2048)).astype(np.float32)
    return ([rows[:FLEET_BC_ROWS], rows[FLEET_BC_ROWS:]],
            pathogen_chunks(panel.genomes[0], PIPE_CHUNKS + 1)[1:])


def arrivals(rows):
    """[(due s, tenant, row)] in due order: benchmarks/fleet.py's
    schedule for ``lab-bc1`` and ``lab-bc2``."""
    sched = [(FLEET_OFFSETS_S[name] + (i // FLEET_PER_BURST) * FLEET_PERIOD_S,
              name, row)
             for name, tenant_rows in zip(("lab-bc1", "lab-bc2"), rows)
             for i, row in enumerate(tenant_rows)]
    return sorted(sched, key=lambda e: e[0])


def drive_arrivals(schedule, submit, step, finished):
    """benchmarks/fleet.py's arrival loop: submit each request when it is
    due, step while there is work, sleep (2 ms at most) only when idle
    with the next arrival ahead.  Returns (wall s, arrival-to-result ms
    per request by tenant); ``finished(name)`` counts a tenant's results,
    which come back in its submission order."""
    due, latency = {}, {}
    i, t0 = 0, time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        while i < len(schedule) and schedule[i][0] <= now:
            at, name, row = schedule[i]
            submit(name, row)
            due.setdefault(name, []).append(at)
            i += 1
        worked = step()
        now = time.perf_counter() - t0
        for name, ats in due.items():
            done = latency.setdefault(name, [])
            for k in range(len(done), finished(name)):
                done.append((now - ats[k]) * 1e3)
        if not worked:
            if i == len(schedule):
                return time.perf_counter() - t0, latency
            wait = schedule[i][0] - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(min(wait, 0.002))


def build_fleet(torch, panel, trace=False):
    from repro_torch.core import basecaller as bc
    from repro_torch.fleet import Fleet
    cfg = bc.BasecallerConfig()
    params = bc.init(torch.Generator().manual_seed(0), cfg)
    fleet = Fleet(trace=trace)
    return fleet, {"lab-fc": fleet.add_tenant(
        "lab-fc", "adaptive_sampling", "flowcell_512", weight=2.0, cfg=cfg,
        params=params, flowcell=dict(FULL_FLOWCELL), fused=True),
        "lab-bc1": fleet.add_tenant("lab-bc1", "basecall", "default"),
        "lab-bc2": fleet.add_tenant("lab-bc2", "basecall", "default"),
        "lab-pp": fleet.add_tenant("lab-pp", "pathogen_pipeline", "default",
                                   cfg=cfg, panel=panel)}


def run_fleet(torch, panel, rows, chunks, trace=False):
    """The four tenants on one ``Fleet`` on the card, every request queued
    before the first tick (JAX's fleet-vs-solo oracle), drained, then the
    pipeline tenant's ``detect(256)``; returns (fleet, tenants, report,
    detect report, wall s)."""
    fleet, t = build_fleet(torch, panel, trace)
    for name, tenant_rows in zip(("lab-bc1", "lab-bc2"), rows):
        for r in tenant_rows:
            require(t[name].submit(r), f"fleet: {name} refused a row")
    for chunk in chunks:
        require(t["lab-pp"].submit(chunk), "fleet: lab-pp refused a chunk")
    t0 = time.perf_counter()
    rep = fleet.drain()
    det = t["lab-pp"].engine.detect(READ_LEN)
    torch.cuda.synchronize()
    return fleet, t, rep, det, time.perf_counter() - t0


def run_fleet_bursty(torch, panel, rows, chunks):
    """The same fleet with the basecall rows arriving on
    benchmarks/fleet.py's schedule, then ``detect(256)`` (outside the
    wall); returns (tenants, report, detect report, wall s,
    arrival-to-result ms by basecall tenant)."""
    fleet, t = build_fleet(torch, panel)
    for chunk in chunks:
        require(t["lab-pp"].submit(chunk), "fleet: lab-pp refused a chunk")

    def submit(name, row):
        require(fleet.submit(name, row), f"fleet: {name} refused a row")
    wall, latency = drive_arrivals(arrivals(rows), submit, fleet.step,
                                   lambda name: len(t[name].outputs))
    torch.cuda.synchronize()
    return t, fleet.summary(), t["lab-pp"].engine.detect(READ_LEN), wall, \
        latency


def solo_runs(torch, panel, rows, chunks):
    """Each tenant's engine alone on the card: the flowcell (phase 4's
    fused engine) and the pipeline (the same chunks, then ``detect(256)``)
    drained, each timed; one basecall engine fed both tenants' rows at
    once, and one fed them on the bursty schedule.  Returns the engines,
    the detect report, the walls and the bursty latencies."""
    import repro_torch.engine as te
    from repro_torch.core import basecaller as bc
    walls = {}
    t0 = time.perf_counter()
    fc = full_engine(True)
    fc.drain()
    torch.cuda.synchronize()
    walls["lab-fc"] = time.perf_counter() - t0
    bce = te.build("basecall", "default")
    for tenant_rows in rows:
        for r in tenant_rows:
            bce.submit(r)
    bce.drain()
    t0 = time.perf_counter()
    pp = te.build("pathogen_pipeline", "default", cfg=bc.BasecallerConfig(),
                  panel=panel)
    for chunk in chunks:
        pp.submit(chunk)
    pp.drain()
    torch.cuda.synchronize()
    walls["lab-pp"] = time.perf_counter() - t0
    burst = te.build("basecall", "default")
    walls["basecall"], latency = drive_arrivals(
        [(at, "basecall", r) for at, _, r in arrivals(rows)],
        lambda _, r: burst.submit(r), burst.step,
        lambda _: len(burst.reads))
    return (fc, bce, pp, pp.detect(READ_LEN)), burst, walls, latency


def same_report(a, b) -> bool:
    import numpy as np
    return (a.counts == b.counts and a.present == b.present
            and a.abundance == b.abundance
            and np.array_equal(a.read_assignment, b.read_assignment)
            and np.array_equal(a.read_scores, b.read_scores))


def same_reads(got, want) -> bool:
    import numpy as np
    return len(got) == len(want) and all(
        np.array_equal(a, b) for a, b in zip(got, want))


def fleet_equal_solo(t, det, solo, basecall_fabric=True) -> dict:
    """Bit for bit: goldens, reads, tokens and detect reports, and each
    engine's fabric counters, fleet against solo.  ``basecall_fabric``
    False skips the shared basecall engine's counters: they count
    dispatches, and arrival times decide how many there are."""
    fc, bce, pp, sdet = solo
    solo_reads = {"lab-bc1": bce.reads[:FLEET_BC_ROWS],
                  "lab-bc2": bce.reads[FLEET_BC_ROWS:]}
    eq = {"lab-fc goldens": golden(t["lab-fc"].engine) == golden(fc),
          "lab-pp tokens": len(pp.outputs) == len(
              t["lab-pp"].engine.outputs) and all(
              same_reads(a, b)
              for a, b in zip(t["lab-pp"].engine.outputs, pp.outputs)),
          "lab-pp detect": same_report(det, sdet)}
    for name in ("lab-bc1", "lab-bc2"):
        eq[f"{name} reads"] = same_reads(t[name].outputs, solo_reads[name])
    pairs = [("lab-fc", fc), ("lab-pp", pp)]
    if basecall_fabric:
        pairs.append(("lab-bc", bce))
    for name, engine in pairs:
        mine = t["lab-bc1" if name == "lab-bc" else name].engine
        eq[f"{name} fabric"] = (mine.telemetry.fabric_counters()
                                == engine.telemetry.fabric_counters())
    return eq


def tenant_lines(rep) -> dict:
    fl = rep["fleet"]
    return {n: {"workload": s["workload"], "weight": s["weight"],
                "ticks": s["ticks"], "tick_share": s["tick_share"],
                "weight_share": s["weight"] / sum(fl["weights"].values()),
                "p50_ms": s["p50_ms"], "p99_ms": s["p99_ms"],
                "completed": s["completed"],
                "shared_engine": s["shared_engine"]}
            for n, s in rep["tenants"].items()}


def percentiles(ms) -> dict:
    import numpy as np
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)), "max_ms": max(ms),
            "n": len(ms)}


def phase_fleet_bursty(torch, panel, rows, chunks, solo, burst, walls,
                       solo_latency):
    """The fleet under benchmarks/fleet.py's bursty basecall arrivals,
    against the solo runs: the same results, the per-tenant
    latencies, shares and fairness, and the fleet's wall against the sum
    of the solo walls (one card running the tenants one after another)."""
    t, rep, det, wall, latency = run_fleet_bursty(torch, panel, rows, chunks)
    equal = fleet_equal_solo(t, det, solo, basecall_fabric=False)
    bce = solo[1]
    want = {"lab-bc1": iter(bce.reads[:FLEET_BC_ROWS]),
            "lab-bc2": iter(bce.reads[FLEET_BC_ROWS:])}
    equal["solo bursty reads"] = same_reads(
        burst.reads, [next(want[name]) for _, name, _ in arrivals(rows)])
    fl = rep["fleet"]
    serial = sum(walls.values())
    emit({"phase": "fleet", "part": "bursty", "wall_s": wall,
          "ticks": fl["ticks"], "fairness_ratio": fl["fairness_ratio"],
          "schedule": {"source": "benchmarks/fleet.py",
                       "bursts": FLEET_BURSTS, "per_burst": FLEET_PER_BURST,
                       "period_s": FLEET_PERIOD_S,
                       "offsets_s": FLEET_OFFSETS_S},
          "tenants": tenant_lines(rep),
          "arrival_to_result": {n: percentiles(ms)
                                for n, ms in latency.items()},
          "basecall_dispatches": t["lab-bc1"].engine.telemetry.dispatches,
          "solo_wall_s": walls, "solo_serial_s": serial,
          "speedup_vs_serial_solos": serial / wall,
          "solo_basecall_arrival_to_result": percentiles(
              solo_latency["basecall"]),
          "solo_basecall_dispatches": burst.telemetry.dispatches,
          "equal_solo": equal})
    require(all(equal.values()),
            f"bursty fleet differs from solo runs: {equal}")
    require(all(len(ms) == FLEET_BC_ROWS for ms in latency.values())
            and len(latency) == 2, "bursty fleet: a basecall row is missing")


class GCClock:
    """Wall time the garbage collector spends, by generation
    (``gc.callbacks``)."""

    def __init__(self):
        self.reset()
        self._t0 = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            gen = info["generation"]
            self.seconds[gen] += time.perf_counter() - self._t0
            self.collections[gen] += 1
            self._t0 = None

    def reset(self):
        self.seconds = [0.0, 0.0, 0.0]
        self.collections = [0, 0, 0]


def flowcell_tick(torch, trace, clock, freeze) -> dict:
    """Drain flowcell_512 (phase 4's fused engine) after its warm-up,
    with the collector's time by generation; ``freeze`` moves every
    object alive after set-up out of the collector's reach
    (``gc.freeze``) for the drain."""
    import gc
    eng = full_engine(True, trace=trace)
    eng.runtime.warmup()
    torch.cuda.synchronize()
    if freeze:
        gc.freeze()
    clock.reset()
    try:
        rep = eng.drain()
        torch.cuda.synchronize()
    finally:
        if freeze:
            gc.unfreeze()
    ticks = max(rep["steps"], 1)
    return {"trace": trace, "ticks": rep["steps"],
            "mean_tick_ms": rep["wall_s"] / ticks * 1e3,
            "gc_ms_per_tick": sum(clock.seconds) / ticks * 1e3,
            "bases_per_s": rep["bases_per_s"],
            "events": len(eng.telemetry.tracer.events),
            "gc_ms": [s * 1e3 for s in clock.seconds],
            "gc_collections": list(clock.collections)}


def tracer_us_per_event() -> float:
    """The tracer's own cost: host us to record one X span with args."""
    from repro_torch.obs import Tracer
    tr, n = Tracer(), 20_000
    t0 = time.perf_counter()
    for i in range(n):
        tr.complete("map", t0, 1e-6, pid=1, tid=1, args={"lanes": i})
    return (time.perf_counter() - t0) / n * 1e6


def phase_trace_overhead(torch):
    """flowcell_512 untraced, traced, traced, untraced; then the same four
    with the collector frozen after set-up.  Reports each set's mean tick
    and ``overhead_pct``, also net of the collector's time, and the
    tracer's own cost an event (reported, not gated: the host spreads one
    run from the next by 15-50%)."""
    import gc
    clock = GCClock()
    gc.callbacks.append(clock)
    try:
        line = {"phase": "fleet", "part": "trace_overhead",
                "path": "flowcell_512", "gc_objects": len(gc.get_objects()),
                "gc_thresholds": gc.get_threshold(),
                "tracer_us_per_event": tracer_us_per_event()}
        for freeze in (False, True):
            runs = [flowcell_tick(torch, trace, clock, freeze)
                    for trace in (False, True, True, False)]

            def mean(key, traced, runs=runs):
                return sum(r[key] for r in runs if r["trace"] == traced) / 2
            plain, traced = mean("mean_tick_ms", False), mean(
                "mean_tick_ms", True)
            net_plain = plain - mean("gc_ms_per_tick", False)
            net_traced = traced - mean("gc_ms_per_tick", True)
            line["gc_frozen" if freeze else "gc_live"] = {
                "runs": runs, "mean_tick_ms_untraced": plain,
                "mean_tick_ms_traced": traced,
                "overhead_pct": (traced / plain - 1.0) * 100.0,
                "overhead_pct_without_gc": (net_traced / net_plain - 1.0)
                * 100.0}
    finally:
        gc.callbacks.remove(clock)
    emit(line)


def phase_fleet(torch, panel, paths):
    """Four tenants on one ``Fleet(device="cuda")``: ``lab-fc``
    (flowcell_512, phase 4's CNN, pore encoder, 1,024 reads, depth 2,
    fused; weight 2), ``lab-bc1`` and ``lab-bc2`` (``basecall`` default,
    16 x 2048, sharing one engine, 36 rows each) and ``lab-pp``
    (``pathogen_pipeline`` default, phase 6's 8 chunks, then
    ``detect(256)``).  With every request queued at once, each tenant's
    results and every engine's fabric counters equal its engine drained
    solo on the card; a traced run validates, with a read span per
    ``lab-fc`` read and a process track per tenant.  Then the basecall
    rows arrive on benchmarks/fleet.py's bursts (results again equal
    solo) for the latencies, shares and the wall against the solo runs'
    sum; last, tracing's cost on the flowcell_512 tick."""
    import tempfile

    from repro_torch.obs import read_spans, validate_chrome_trace
    rows, chunks = fleet_inputs(panel)
    fleet, t, rep, det, wall = paths.drive(
        "fleet", ("conv1d", "matmul", "fused_stream", "banded_align"),
        lambda: run_fleet(torch, panel, rows, chunks))
    solo, burst, walls, solo_latency = solo_runs(torch, panel, rows, chunks)
    equal = fleet_equal_solo(t, det, solo)
    fl = rep["fleet"]
    yields = t["lab-fc"].engine.telemetry.counters.get(
        "mesh_yields_inflight", 0)
    emit({"phase": "fleet", "part": "tenants", "wall_s": wall,
          "fleet_wall_s": fl["wall_s"], "ticks": fl["ticks"],
          "fairness_ratio": fl["fairness_ratio"],
          "mesh_yields_inflight": yields, "tenants": tenant_lines(rep),
          "lab_fc_reads": len(t["lab-fc"].engine.records),
          "lab_pp_present": det.present, "equal_solo": equal})
    require(all(equal.values()), f"fleet differs from solo runs: {equal}")
    require(len(t["lab-fc"].engine.records) == FULL_FLOWCELL["n_reads"],
            "fleet: lab-fc resolved too few reads")
    require(yields > 0, "fleet: lab-fc never yielded with a tick in flight")
    require(t["lab-bc1"].unit is t["lab-bc2"].unit,
            "fleet: the basecall tenants do not share an engine")

    tfleet, tt, trep, tdet, twall = run_fleet(torch, panel, rows, chunks,
                                              trace=True)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace_fleet.json")
        tfleet.export_trace(path)
        with open(path) as f:
            doc = json.load(f)
    errors = validate_chrome_trace(doc)
    spans = read_spans(doc)
    tracks = [e["args"]["name"] for e in doc["traceEvents"]
              if e.get("ph") == "M" and e.get("name") == "process_name"]
    untracked = [n for n in tt if not any(n in label for label in tracks)]
    traced_equal = golden(tt["lab-fc"].engine) == golden(t["lab-fc"].engine)
    emit({"phase": "fleet", "part": "trace", "events": len(
        doc["traceEvents"]), "errors": errors[:5], "read_spans": len(spans),
        "lab_fc_reads": len(tt["lab-fc"].engine.records), "tracks": tracks,
        "wall_s": twall, "goldens_equal_untraced": traced_equal})
    require(not errors, f"fleet trace invalid: {errors[:5]}")
    require(len(spans) == len(tt["lab-fc"].engine.records)
            == FULL_FLOWCELL["n_reads"], "fleet trace: read spans "
            f"{len(spans)} for {len(tt['lab-fc'].engine.records)} reads")
    require(not untracked, f"fleet trace: no track for {untracked}")
    require(traced_equal, "fleet: the traced lab-fc decided otherwise")

    phase_fleet_bursty(torch, panel, rows, chunks, solo, burst, walls,
                       solo_latency)
    phase_trace_overhead(torch)
    return rep


# ------------------------------------------------------------ phase field --
FIELD_BAR = 20      # JAX's bytes-on-wire bar (benchmarks/field.py)


def field_compared(res) -> dict:
    return {"outbreak": res["outbreak"], "conservation": res["conservation"],
            "variants": res["variants"],
            "accepted_reads": [d["accepted_reads"]
                               for d in res["per_device"]],
            "read_frame_bytes": res["wire"]["read_frame_bytes"]}


def phase_field(torch, paths):
    """``run_field_scenario(FieldSpec())`` (8 edge devices on ``edge_int8``,
    2 infected, 8 channels x chunk 128, 32 molecules each; the aggregator a
    fleet tenant) on the card and on the CPU: outbreak, conservation,
    variants, accepted reads and read-frame bytes equal; then a traced
    card run whose trace validates with device and aggregator tracks."""
    import tempfile

    from repro_torch.field import FieldSpec, run_field_scenario
    from repro_torch.obs import validate_chrome_trace
    spec = FieldSpec()

    def card_run():
        t0 = time.perf_counter()
        res = run_field_scenario(spec)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0
    card, wall = paths.drive(
        "field", ("conv1d_int8", "matmul_int8", "fused_stream_int8",
                  "banded_align"), card_run)
    t0 = time.perf_counter()
    cpu = run_field_scenario(spec, device="cpu")
    cpu_wall = time.perf_counter() - t0
    got, want = field_compared(card), field_compared(cpu)
    equal = {k: got[k] == want[k] for k in got}
    wire = card["wire"]
    emit({"phase": "field", "part": "scenario", "devices": spec.n_devices,
          "infected": spec.n_infected, "channels": spec.channels,
          "chunk": spec.chunk, "molecules": spec.n_reads, "wall_s": wall,
          "cpu_wall_s": cpu_wall, "ticks": card["ticks"],
          "cpu_ticks": cpu["ticks"], **got,
          "bytes_on_wire": wire["bytes_on_wire"],
          "telemetry_frame_bytes": wire["telemetry_frame_bytes"],
          "reduction_vs_sequenced": wire["reduction_vs_sequenced"],
          "reduction_bar": FIELD_BAR,
          "reduction_vs_accepted": wire["reduction_vs_accepted"],
          "read_path_reduction": wire["read_path_reduction"],
          "equal_cpu": equal})
    require(all(equal.values()), f"field: card differs from CPU: {equal}")
    require(card["conservation"]["per_device_exact"],
            "field: reads not conserved per device")
    require(card["outbreak"]["detected"], "field: outbreak not detected")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace_field.json")
        traced = run_field_scenario(spec, trace_path=path)
        with open(path) as f:
            doc = json.load(f)
    errors = validate_chrome_trace(doc)
    tracks = [e["args"]["name"] for e in doc["traceEvents"]
              if e.get("ph") == "M" and e.get("name") == "process_name"]
    devices = sum(1 for n in tracks if n.startswith("adaptive_sampling"))
    emit({"phase": "field", "part": "trace", "events": traced["trace"][
        "events"], "errors": errors[:5], "device_tracks": devices,
        "tracks": tracks,
        "equal_untraced": field_compared(traced) == got})
    require(not errors, f"field trace invalid: {errors[:5]}")
    require(devices == spec.n_devices and any(
        "aggregator" in n for n in tracks),
        f"field trace: tracks {tracks}")
    return card


# ------------------------------------------------- phase kernels_generic --
# the sweep's head dims (the 3xTF32 route's, padded to 16-256, and the
# qwen3-4b smoke's 16) and one past its reach (the CUDA-core kernel)
GENERIC_FLASH_DIMS = (8, 16, 20, 48, 80, 96, 100, 256)
GENERIC_FLASH_PAST = 300
GENERIC_FLASH_CASES = ((1, 4, 2, 100, 100, True),     # ragged, GQA 2
                       (2, 4, 1, 37, 70, False),      # Sq < Skv, GQA 4
                       (1, 8, 2, 33, 130, True))      # last-token causal
# (ds, dh) pairs outside DIMS, on the padded tensor-core passes, and one
# past (128, 128), on the recurrence kernel
GENERIC_SSD_DIMS = ((64, 32), (16, 64), (128, 128), (24, 40))
GENERIC_SSD_PAST = (300, 33)
F32_FLASH_RULE = ("|err| <= 2^-17 (|ref| + P|V|): ~64 f32 ulps, for an "
                  "online softmax summed in another order")
F16_FLASH_RULE = ("|err| <= 2^-10 |ref| + 2^-11 P|V|: the bf16 bar scaled "
                  "by f16's three more mantissa bits")


def flash_bar_excess(got, want, abs_attn, dtype_name) -> float:
    """The flash bar of the working type (FA_RULE for bf16, F32_FLASH_RULE,
    F16_FLASH_RULE), as the largest |err| / bar: at most 1 passes."""
    if dtype_name == "bfloat16":
        return flash_excess(got, want, abs_attn)
    g, w, a = got.float(), want.float(), abs_attn.float()
    if dtype_name == "float32":
        bar = 2.0 ** -17 * (w.abs() + a) + 1e-30
    else:
        bar = 2.0 ** -10 * w.abs() + 2.0 ** -11 * a + 1e-30
    return ((g - w).abs() / bar).max().item()


def sdpa_f32_ms(torch, F, q, k, v, causal=True):
    """SDPA in float32 on its fused backends (memory-efficient takes f32;
    flash and cuDNN do not), with K/V expanded to the query heads outside
    the timed call, since those backends take f32 only as MHA."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    group = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        return time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, kk, vv, is_causal=causal), reps=3, warm=1)


def flash_counts(kfa):
    """The flash wrapper's counters: all, the 3xTF32 mma.sync kernel's,
    the 3xTF32 wgmma kernel's, and the CUDA-core kernel's."""
    f = kfa.flash_attention
    return (f.launches, f.tf32x3_launches, f.tf32x3_wgmma_launches,
            f.generic_launches)


def phase_kernels_generic(torch, F, peaks, table):
    """The routes past the bf16 wgmma flash kernel and the SSD passes'
    ``DIMS`` pairs: every dtype and head dim on the 3xTF32 flash route and
    one head dim past it on the CUDA-core kernel, every swept (ds, dh) on
    the padded tensor-core passes and one pair past them on the recurrence
    kernel, each held against its plain version and each case's kernel
    asserted by its launch counter; the 3xTF32 and CUDA-core flash kernels
    against the bf16 wgmma one on the same inputs; rows 5g and 6g of the
    kernels line timed at qwen3-4b's attention in f32 (1 x 4096) and at
    mamba2-780m's inner width with 128-wide heads (24 heads x 4096, ds
    128), each beside the CUDA-core kernel it replaced on the same inputs;
    and the recurrence kernel beside the tensor-core passes at
    mamba2-780m's own shape."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as kssd
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(11)

    def rand(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            dtype)

    # the sweep: three dtypes x the head dims each sends to the 3xTF32
    # kernels, and one past them (the CUDA-core kernel), x three shapes
    sweep = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        name = str(dtype).split(".")[-1]
        dims = [d for d in GENERIC_FLASH_DIMS
                if kfa.route(dtype, d) == "tf32x3"] + [GENERIC_FLASH_PAST]
        worst, err, n, wgmma = {}, 0.0, 0, 0
        for d in dims:
            path = kfa.route(dtype, d)
            require(path == ("generic" if d == GENERIC_FLASH_PAST
                             else "tf32x3"), f"flash route {name} D={d}")
            for b, hq, hkv, sq, skv, causal in GENERIC_FLASH_CASES:
                q, k, v = (rand(s, dtype) for s in (
                    (b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
                before = flash_counts(kfa)
                out = kfa.flash_attention(q, k, v, causal=causal)
                after = flash_counts(kfa)
                on_wgmma = kfa.tf32x3_wgmma(q, k, v)
                tc = path == "tf32x3"
                want_counts = (before[0] + 1,
                               before[1] + int(tc and not on_wgmma),
                               before[2] + int(tc and on_wgmma),
                               before[3] + int(path == "generic"))
                require(after == want_counts, f"flash {name} D={d}: counters "
                        f"{before} -> {after}, expected {want_counts}")
                wgmma += after[2] - before[2]
                want = ref.attention(q, k, v, causal=causal)
                pv = ref.attention(q, k, v.abs(), causal=causal)
                worst[path] = max(worst.get(path, 0.0),
                                  flash_bar_excess(out, want, pv, name))
                err = max(err, (out.float() - want.float()).abs().max()
                          .item())
                n += 1
        sweep[name] = worst
        emit({"phase": "kernels_generic", "kernel": "flash_attention",
              "routes": {"tf32x3": [d for d in dims
                                    if d != GENERIC_FLASH_PAST],
                         "generic": [GENERIC_FLASH_PAST]},
              "dtype": name, "cases": [list(c) for c in GENERIC_FLASH_CASES],
              "checks": n, "tf32x3_wgmma_launches": wgmma,
              "max_abs_err": err, "err_over_bar": worst,
              "tol": {"float32": F32_FLASH_RULE, "bfloat16": FA_RULE,
                      "float16": F16_FLASH_RULE}[name]})
        require(max(worst.values()) <= 1.0,
                f"flash {name}: {worst} x its bar")

    # the 3xTF32 and CUDA-core kernels against the wgmma one on the same
    # bf16 inputs, D = 64
    q = rand((1, 8, 1000, 64), torch.bfloat16)
    k, v = rand((1, 2, 1000, 64), torch.bfloat16), rand((1, 2, 1000, 64),
                                                        torch.bfloat16)
    wg = kfa.flash_attention(q, k, v)
    tc = kfa.tf32x3(q, k, v)
    gn = kfa.generic(q, k, v)
    pv = ref.attention(q, k, v.abs())
    want = ref.attention(q, k, v)
    agree = {"tf32x3": flash_excess(tc, wg, pv),
             "generic": flash_excess(gn, wg, pv)}
    emit({"phase": "kernels_generic", "kernel": "flash_attention",
          "check": "tf32x3 and generic vs wgmma, same bf16 inputs",
          "q": list(q.shape), "err_over_bar": agree, "tol": FA_RULE +
          ", the wgmma output as the reference",
          "tf32x3_vs_plain": flash_excess(tc, want, pv),
          "generic_vs_plain": flash_excess(gn, want, pv),
          "wgmma_vs_plain": flash_excess(wg, want, pv),
          "wgmma_ms": time_ms(torch, lambda: kfa.flash_attention(q, k, v)),
          "tf32x3_ms": time_ms(torch, lambda: kfa.tf32x3(q, k, v)),
          "generic_ms": time_ms(torch, lambda: kfa.generic(q, k, v))})
    for kernel, x in agree.items():
        require(x <= 1.0, f"{kernel} vs wgmma flash: {x} x the bar")

    # row 5g: qwen3-4b's attention in f32 at 1 x 4096, on the route's
    # kernel there (the 3xTF32 wgmma one), beside the CUDA-core kernel it
    # replaced and the mma.sync 3xTF32 kernel (row 5m's), same inputs
    from repro_torch.configs import ARCHS
    q3 = ARCHS["qwen3-4b"].config()
    q = rand((1, q3.num_heads, LM_SEQ, q3.head_dim), torch.float32)
    k = rand((1, q3.num_kv_heads, LM_SEQ, q3.head_dim), torch.float32)
    v = rand((1, q3.num_kv_heads, LM_SEQ, q3.head_dim), torch.float32)
    require(kfa.route(q.dtype, q3.head_dim) == "tf32x3"
            and kfa.tf32x3_wgmma(q, k, v), "row 5g off the 3xTF32 wgmma")
    out = kfa.flash_attention(q, k, v)
    mma = kfa._tf32x3(q, k, v, True, None, False)
    was = kfa.generic(q, k, v)
    want = ref.attention(q, k, v)
    pv = ref.attention(q, k, v.abs())
    excess = {name: flash_bar_excess(x, want, pv, "float32")
              for name, x in (("tf32x3_wgmma", out), ("mma_sync", mma),
                              ("generic", was))}
    err = (out - want).abs().max().item()
    mma_err = (mma - want).abs().max().item()
    del want, pv, mma, was
    ms = time_ms(torch, lambda: kfa.flash_attention(q, k, v), reps=5,
                 warm=1)
    mma_ms = time_ms(torch, lambda: kfa._tf32x3(q, k, v, True, None, False),
                     reps=5, warm=1)
    was_ms = time_ms(torch, lambda: kfa.generic(q, k, v), reps=2, warm=1)
    plain = time_ms(torch, lambda: ref.attention(q, k, v), reps=3, warm=1)
    lib = sdpa_f32_ms(torch, F, q, k, v)
    # the library's own kernels by name (the profiler; its device times
    # are not used: a window can drop events), K/V expanded beforehand as
    # sdpa_f32_ms does
    from torch.nn.attention import SDPBackend, sdpa_kernel
    kk, vv = (t.repeat_interleave(q3.num_heads // q3.num_kv_heads, dim=1)
              for t in (k, v))

    def sdpa_once():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q, kk, vv, is_causal=True)
    lib_kernels = []
    for _ in range(3):      # a profiler window can come back empty
        lib_kernels = sorted(kernel_device_ms(torch, sdpa_once, reps=2))
        if lib_kernels:
            break
    del kk, vv
    ops = 4.0 * q3.head_dim * attn_pairs(LM_SEQ, LM_SEQ) * q3.num_heads
    io = nbytes(q, k, v, out)
    bnd, by = bound_ms(peaks, io, ops, tf32x3=True)
    bnd32 = bound_ms(peaks, io, ops)[0]
    emit({"phase": "kernel", "kernel": "flash_attention_tf32x3_wgmma",
          "shape": f"qwen3-4b 1 x {LM_SEQ}, float32", "q": list(q.shape),
          "k": list(k.shape), "causal": True, "max_abs_err": err,
          "err_over_bar": excess, "tol": F32_FLASH_RULE, "ms": ms,
          "was_ms": was_ms,
          "was": "flash_attention_generic_kernel (CUDA cores)",
          "plain_ms": plain, "library_ms": lib,
          "library": "sdpa f32 (memory-efficient, K/V expanded)",
          "library_kernels": lib_kernels, "bound_ms": bnd, "bound_by": by,
          "bound_fp32_ms": bnd32, "flop": ops})
    require(max(excess.values()) <= 1.0,
            f"flash qwen3-4b f32: {excess} x the bar")
    table.add("flash_attention_tf32x3_wgmma", err=err, ms=ms,
              plain_ms=plain, bound=bnd, bound_by=by, library_ms=lib,
              bound_fp32=bnd32)
    table.rows["flash_attention_tf32x3_wgmma"].update(
        was_ms=was_ms, library_kernels=lib_kernels)
    # the mma.sync kernel at row 5g's inputs, for row 5m
    d128 = {"shape": f"qwen3-4b 1 x {LM_SEQ}, float32", "ms": mma_ms,
            "max_abs_err": mma_err, "bound_ms": bnd, "bound_fp32_ms": bnd32,
            "library_ms": lib}
    del q, k, v, out
    torch.cuda.empty_cache()

    # row 5m: the mma.sync 3xTF32 kernel at the shape its main path gives
    # it (lm_parity_f32's qwen3-4b smoke in f32, D 16), beside the
    # CUDA-core kernel on the same inputs, and its time at row 5g's inputs
    q3s = ARCHS["qwen3-4b"].smoke_config()
    shape = (2, q3s.num_heads, F32_PARITY_SEQ, q3s.head_dim)
    q = rand(shape, torch.float32)
    k, v = (rand((2, q3s.num_kv_heads, F32_PARITY_SEQ, q3s.head_dim),
                 torch.float32) for _ in range(2))
    require(kfa.route(q.dtype, q3s.head_dim) == "tf32x3"
            and not kfa.tf32x3_wgmma(q, k, v), "row 5m off the mma.sync "
            "3xTF32 kernel")
    before = flash_counts(kfa)
    out = kfa.flash_attention(q, k, v)
    require(flash_counts(kfa)[1] == before[1] + 1,
            "row 5m: the mma.sync counter did not move")
    was = kfa.generic(q, k, v)
    want = ref.attention(q, k, v)
    pv = ref.attention(q, k, v.abs())
    excess = {name: flash_bar_excess(x, want, pv, "float32")
              for name, x in (("tf32x3", out), ("generic", was))}
    err = (out - want).abs().max().item()
    ms = time_ms(torch, lambda: kfa.flash_attention(q, k, v))
    was_ms = time_ms(torch, lambda: kfa.generic(q, k, v))
    plain = time_ms(torch, lambda: ref.attention(q, k, v))
    lib = sdpa_f32_ms(torch, F, q, k, v)
    ops = 4.0 * q3s.head_dim * attn_pairs(F32_PARITY_SEQ, F32_PARITY_SEQ) \
        * q3s.num_heads * shape[0]
    io = nbytes(q, k, v, out)
    bnd, by = bound_ms(peaks, io, ops, tf32x3=True)
    bnd32 = bound_ms(peaks, io, ops)[0]
    emit({"phase": "kernel", "kernel": "flash_attention_tf32x3",
          "shape": f"qwen3-4b smoke 2 x {F32_PARITY_SEQ}, float32 "
          "(lm_parity_f32's)", "q": list(q.shape), "k": list(k.shape),
          "causal": True, "max_abs_err": err, "err_over_bar": excess,
          "tol": F32_FLASH_RULE, "ms": ms, "was_ms": was_ms,
          "was": "flash_attention_generic_kernel (CUDA cores)",
          "plain_ms": plain, "library_ms": lib,
          "library": "sdpa f32 (memory-efficient, K/V expanded)",
          "bound_ms": bnd, "bound_by": by, "bound_fp32_ms": bnd32,
          "flop": ops, "qwen3_4b_d128": d128})
    require(max(excess.values()) <= 1.0,
            f"flash qwen3-4b smoke f32: {excess} x the bar")
    table.add("flash_attention_tf32x3", err=err, ms=ms, plain_ms=plain,
              bound=bnd, bound_by=by, library_ms=lib, bound_fp32=bnd32)
    table.rows["flash_attention_tf32x3"].update(
        was_ms=was_ms, qwen3_4b_d128_ms=mma_ms,
        qwen3_4b_d128_bound_ms=d128["bound_ms"])
    del q, k, v, out, was, want, pv

    # the SSD sweep: four pairs on the padded passes and one past them x
    # two dtypes, B/C per head and broadcast
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        rtol = 2 ** -7 if dtype == torch.bfloat16 else SSD_TOL
        err, ok = {}, True
        for ds, dh in GENERIC_SSD_DIMS + (GENERIC_SSD_PAST,):
            past = (ds, dh) == GENERIC_SSD_PAST
            require(kssd.route(ds, dh) == ("generic" if past
                                           else "tensor_cores")
                    and (ds, dh) not in kssd.DIMS, f"ssd route {ds, dh}")
            x = rand((5, 150, dh), dtype, 0.5)
            la = -F.softplus(torch.randn((5, 150), generator=gen,
                                         device=dev))
            b, c = rand((5, 150, ds), dtype, 0.3), rand((5, 150, ds), dtype,
                                                        0.3)
            for bb, cc in ((b, c), (b[:1].expand(5, 150, ds),
                                    c[:1].expand(5, 150, ds))):
                f = kssd.ssd_scan
                before = (f.launches, f.padded_launches, f.generic_launches)
                out = kssd.ssd_scan(x, la, bb, cc)
                after = (f.launches, f.padded_launches, f.generic_launches)
                expect = (before[0] + 1, before[1] + int(not past),
                          before[2] + int(past))
                require(after == expect, f"ssd {name} {ds, dh}: counters "
                        f"{before} -> {after}, expected {expect}")
                want = ref.ssd_scan(x, la, bb, cc)[0]
                key = "generic" if past else "padded"
                err[key] = max(err.get(key, 0.0), (
                    out.float() - want.float()).abs().max().item())
                ok = ok and torch.allclose(out.float(), want.float(),
                                           rtol=rtol, atol=SSD_TOL)
        emit({"phase": "kernels_generic", "kernel": "ssd_scan",
              "routes": {"padded": {f"{p}": list(kssd.padded(*p))
                                    for p in GENERIC_SSD_DIMS},
                         "generic": [list(GENERIC_SSD_PAST)]},
              "dtype": name, "bh": 5, "t": 150,
              "b_c": "per head and one row over the heads", "max_abs_err": err,
              "tol": f"{SSD_TOL} + {rtol} |y|"})
        require(ok, f"ssd sweep {name}: max abs err {err}")

    # row 6g: mamba2-780m's inner width (3,072) in 24 heads of 128, ds 128,
    # on the (128, 128) passes, beside the recurrence kernel on the same
    # inputs
    x, la, b, c = ssd_inputs(torch, F, LM_SEQ, gen, dev, bh=24, ds=128,
                             dh=128)
    args = (x.float(), la, b[:1].float().expand(b.shape),
            c[:1].float().expand(c.shape))
    before = kssd.ssd_scan.padded_launches
    out = kssd.ssd_scan(*args)
    require(kssd.ssd_scan.padded_launches == before + 1,
            "row 6g off the padded passes")
    was = kssd.generic(*args)
    want = ref.ssd_scan(*args)[0]
    err = (out - want).abs().max().item()
    ok = torch.allclose(out, want, rtol=SSD_TOL, atol=SSD_TOL)
    was_err = (was - want).abs().max().item()
    require(torch.allclose(was, want, rtol=SSD_TOL, atol=SSD_TOL),
            f"ssd recurrence kernel at 24 x 4096 (128, 128): max abs err "
            f"{was_err}")
    del want, was
    ms = time_ms(torch, lambda: kssd.ssd_scan(*args), reps=5, warm=1)
    was_ms = time_ms(torch, lambda: kssd.generic(*args), reps=3, warm=1)
    by_pass = {SSD_PASSES.get(k, k): v for k, v in kernel_device_ms(
        torch, lambda: kssd.ssd_scan(*args)).items()}
    plain = time_ms(torch, lambda: ref.ssd_scan(*args), reps=1, warm=0)
    bh, t, dh = args[0].shape
    ops = ssd_flop(bh, t, 128, dh)
    io = nbytes(args[0], args[1], args[2][:1], args[3][:1], out)
    bnd, by = bound_ms(peaks, io, ops, tf32x3=True)
    bnd32 = bound_ms(peaks, io, ops)[0]
    emit({"phase": "kernel", "kernel": "ssd_scan_padded",
          "shape": f"24 heads x {LM_SEQ}, ds 128, dh 128, float32",
          "x": list(args[0].shape), "b_c": "one row over the heads "
          "(stride 0)", "max_abs_err": err, "tol": SSD_TOL, "ms": ms,
          "device_ms_by_pass": by_pass, "was_ms": was_ms,
          "was": "ssd_scan_generic_kernel (the recurrence, CUDA cores)",
          "was_max_abs_err": was_err, "plain_ms": plain, "library_ms": None,
          "bound_ms": bnd, "bound_by": by, "bound_fp32_ms": bnd32,
          "flop": ops})
    require(ok, f"ssd 24 x 4096 (128, 128): max abs err {err}")
    table.add("ssd_scan_padded", err=err, ms=ms, plain_ms=plain, bound=bnd,
              bound_by=by, library_ms=None, bound_fp32=bnd32)
    table.rows["ssd_scan_padded"].update(was_ms=was_ms,
                                         device_ms_by_pass=by_pass)
    del args, out

    # the recurrence kernel beside the tensor-core passes at mamba2-780m's
    # own shape (48 heads x 4096, ds 128, dh 64, bf16): same inputs
    m2 = ARCHS["mamba2-780m"].config()
    args = ssd_inputs(torch, F, LM_SEQ, gen, dev, bh=m2.ssm_heads,
                      ds=m2.ssm_state, dh=m2.ssm_head_dim)
    tc = kssd.ssd_scan(*args)
    gn = kssd.generic(*args)
    diff = (tc.float() - gn.float()).abs().max().item()
    emit({"phase": "kernels_generic", "kernel": "ssd_scan",
          "check": "generic vs tensor cores, same bf16 inputs",
          "shape": f"mamba2-780m 48 heads x {LM_SEQ}", "max_abs_diff": diff,
          "tol": f"{SSD_TOL} + 2^-7 |y|",
          "tensor_cores_ms": time_ms(torch, lambda: kssd.ssd_scan(*args),
                                     reps=5, warm=1),
          "generic_ms": time_ms(torch, lambda: kssd.generic(*args), reps=5,
                                warm=1)})
    require(torch.allclose(gn.float(), tc.float(), rtol=2 ** -7,
                           atol=SSD_TOL),
            f"generic vs tensor-core ssd: max abs diff {diff}")
    del args, tc, gn
    torch.cuda.empty_cache()


# ------------------------------------------------------ phase lm_parity_f32 --
F32_PARITY_TOL = 1e-4   # tests/test_torch_lm_prefill.py F32_TOL
F32_PARITY_SEQ = 128    # four SSD chunks of the smoke configs' 32


def f32_parity_configs():
    """The f32 smoke configs: qwen3-4b (the 3xTF32 flash route at head dim
    16, its mma.sync kernel), the same at qwen3-4b's own head dim 128 (the
    3xTF32 wgmma kernel), mamba2-780m ((ds, dh) = (16, 16): the SSD
    passes' own DIMS pair), and mamba2-780m's smoke at (ds, dh) = (64, 32),
    a pair outside DIMS (zero-padded to the (128, 64) passes)."""
    import dataclasses

    from repro_torch.configs import ARCHS
    out = []
    for arch in ("qwen3-4b", "mamba2-780m"):
        out.append((f"{arch} smoke",
                    dataclasses.replace(ARCHS[arch].smoke_config(),
                                        dtype="float32")))
    out.insert(1, ("qwen3-4b smoke at head dim 128", dataclasses.replace(
        ARCHS["qwen3-4b"].smoke_config(), dtype="float32",
        head_dim=ARCHS["qwen3-4b"].config().head_dim)))
    out.append(("mamba2-780m smoke (ds, dh) = (64, 32)", dataclasses.replace(
        ARCHS["mamba2-780m"].smoke_config(), dtype="float32", ssm_state=64,
        ssm_head_dim=32)))
    return out


def recorded_calls(torch, ops, names):
    """Wrap ``ops.<name>`` for each name so that a card call keeps its
    arguments, once for each distinct shape, stride, dtype and keyword
    set; returns ``(calls, restore)``, calls by name."""
    calls = {n: {} for n in names}
    originals = {n: getattr(ops, n) for n in names}

    def recorder(name):
        fn = originals[name]

        def wrapped(*args, **kw):
            ts = [a for a in args if isinstance(a, torch.Tensor)]
            if ts[0].is_cuda:
                sig = (tuple((tuple(t.shape), t.stride(), t.dtype)
                             for t in ts), tuple(sorted(kw.items())))
                calls[name].setdefault(sig, (args, kw))
            return fn(*args, **kw)
        return wrapped
    for n in names:
        setattr(ops, n, recorder(n))

    def restore():
        for n, fn in originals.items():
            setattr(ops, n, fn)
    return calls, restore


def check_path_calls(torch, calls) -> dict:
    """Each recorded flash_attention and ssd_scan call of the f32 path run
    again through its wrapper and held against its plain version on the
    same inputs: flash by F32_FLASH_RULE, ssd_scan within SSD_TOL."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as kssd
    out = {}
    for (args, kw) in calls["flash_attention"].values():
        q, k, v = args
        got = kfa.flash_attention(q, k, v, **kw)
        want = ref.attention(q, k, v, **kw)
        pv = ref.attention(q, k, v.abs(), **kw)
        out.setdefault("flash_attention", []).append({
            "q": list(q.shape), "k": list(k.shape),
            "q_stride": list(q.stride()), "route": kfa.route(q.dtype,
                                                             q.shape[-1]),
            "tf32x3_kernel": "wgmma" if kfa.tf32x3_wgmma(q, k, v)
            else "mma_sync",
            "causal": kw.get("causal", True),
            "max_abs_err": (got - want).abs().max().item(),
            "err_over_bar": flash_bar_excess(got, want, pv, "float32")})
    for (args, kw) in calls["ssd_scan"].values():
        x, la, b, c = args
        got = kssd.ssd_scan(x, la, b, c, **kw)
        want = ref.ssd_scan(x, la, b, c)[0]
        out.setdefault("ssd_scan", []).append({
            "x": list(x.shape), "b": list(b.shape),
            "b_stride": list(b.stride()), "c_stride": list(c.stride()),
            "route": kssd.route(b.shape[-1], x.shape[-1]),
            "instantiation": kssd.padded(b.shape[-1], x.shape[-1]),
            "padded": (b.shape[-1], x.shape[-1]) not in kssd.DIMS, **kw,
            "max_abs_err": (got - want).abs().max().item(),
            "within_tol": bool(torch.allclose(got, want, rtol=SSD_TOL,
                                              atol=SSD_TOL))})
    return out


def phase_lm_parity_f32(torch, paths):
    """The f32 smoke prefills on the card against the CPU, the same params
    and tokens, within ``F32_PARITY_TOL`` (rtol and atol) of the logits:
    JAX's decode-vs-forward check runs these configs in f32.  Each
    flash_attention and ssd_scan call of the card's prefill is kept, and
    after the path its wrapper runs again on those inputs against the
    plain version (flash by F32_FLASH_RULE, ssd_scan within SSD_TOL)."""
    import numpy as np

    from repro_torch.core import basecaller as bc
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    dev = torch.device("cuda")

    def run():
        lines = []
        for label, cfg in f32_parity_configs():
            params, _ = transformer.init(torch.Generator().manual_seed(0),
                                         cfg, device="cpu")
            tok = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                    (2, F32_PARITY_SEQ))
            want = steps.prefill(params, tok, cfg, device="cpu")
            got = steps.prefill(bc.params_to(params, dev), tok, cfg,
                                device=dev).cpu()
            ok = bool(torch.allclose(got, want, rtol=F32_PARITY_TOL,
                                     atol=F32_PARITY_TOL))
            lines.append({"phase": "lm_parity_f32", "config": label,
                          "dtype": str(got.dtype), "batch": 2,
                          "seq": F32_PARITY_SEQ,
                          "max_abs_diff": (got - want).abs().max().item(),
                          "max_abs_logit": want.abs().max().item(),
                          "tol": f"rtol = atol = {F32_PARITY_TOL}",
                          "equal_within_tol": ok})
        return lines
    calls, restore = recorded_calls(torch, ops,
                                    ("flash_attention", "ssd_scan"))
    try:
        lines = paths.drive("lm_parity_f32", (
            "flash_attention_tf32x3", "flash_attention_tf32x3_wgmma",
            "matmul", "ssd_scan", "ssd_scan_padded"), run)
    finally:
        restore()
    for line in lines:
        emit(line)
        require(line["equal_within_tol"], f"f32 {line['config']} prefill: "
                f"card vs CPU {line['max_abs_diff']} over {F32_PARITY_TOL}")
    checked = check_path_calls(torch, calls)
    emit({"phase": "lm_parity_f32", "check": "the path's own calls, each "
          "against its plain version", "tol": {
              "flash_attention": F32_FLASH_RULE,
              "ssd_scan": f"rtol = atol = {SSD_TOL}"}, **checked})
    for name in ("flash_attention", "ssd_scan"):
        require(checked.get(name), f"lm_parity_f32 recorded no {name} call")
    for c in checked["flash_attention"]:
        require(c["err_over_bar"] <= 1.0, f"flash at the f32 path's "
                f"{c['q']} x {c['k']}: {c['err_over_bar']} x its bar")
        require(c["route"] == "tf32x3", f"f32 flash at {c['q']} on the "
                f"{c['route']} route, not tf32x3")
    for kernel, d in (("mma_sync", 16), ("wgmma", 128)):
        require(any(c["tf32x3_kernel"] == kernel and c["q"][-1] == d
                    for c in checked["flash_attention"]),
                f"lm_parity_f32: no D {d} flash call on the {kernel} kernel")
    require(any(c["padded"] and c["x"][-1] == 32 and c["b"][-1] == 64
                and c["route"] == "tensor_cores"
                for c in checked["ssd_scan"]),
            "lm_parity_f32: no (64, 32) SSD call on the padded passes")
    for c in checked["ssd_scan"]:
        require(c["within_tol"], f"ssd_scan at the f32 path's {c['x']}: "
                f"max abs err {c['max_abs_err']}")


# -------------------------------------------------------------- phase train --
TRAIN_STEPS = 220       # tests/test_system.py's fixture
TRAIN_SEQ = 30
QAT_STEPS = 120         # the goldens compare card with CPU on the same
                        # params: the QAT run needs no accuracy bar
GRAD_RULE = ("loss within 1e-5 relative, every gradient within 1e-4 of its "
             "largest entry: the card's kernels sum in another order")


def read_accuracy(torch, cfg, params, rng, n=16, seq_len=TRAIN_SEQ):
    """tests/test_system.py::read_accuracy on the port: ``n`` reads of
    ``seq_len`` bases on DEMO_PORE, basecalled on the params' device,
    greedy-decoded, scored by edit distance."""
    import numpy as np

    from repro_torch.core import basecaller as bc
    from repro_torch.core import ctc
    from repro_torch.data import nanopore
    from repro_torch.kernels import ref
    from repro_torch.train.micro_basecaller import DEMO_PORE
    dev = params["conv1"]["w"].device
    correct = total = 0
    for _ in range(n):
        seq = rng.integers(1, 5, seq_len).astype(np.int32)
        sig, _ = nanopore.simulate_read(rng, seq, DEMO_PORE)
        sig = nanopore.normalize(sig)
        with torch.no_grad():
            logits = bc.apply(params, torch.as_tensor(sig[None]).to(dev), cfg)
        toks, lens = ctc.greedy_decode(logits.cpu())
        called = toks[0][:int(lens[0])].numpy()
        padded = np.pad(called, (0, max(seq_len - len(called), 0)))
        d = int(ref.edit_distance(torch.as_tensor(padded[None, :seq_len]),
                                  torch.as_tensor(seq[None]))[0])
        correct += seq_len - min(d, seq_len)
        total += seq_len
    return correct / total


def qat_engine(cfg, qparams, device):
    """An ``edge_int8`` flowcell on the QAT micro basecaller: 16 channels
    x chunk 256 of pore-encoded reads on DEMO_PORE, depth 2, fused."""
    import numpy as np

    import repro_torch.engine as te
    from repro_torch.core import basecaller as bc
    from repro_torch.data import genome as G
    from repro_torch.train.micro_basecaller import DEMO_PORE
    ref_genome = G.random_genome(np.random.default_rng(7), 6_000)
    return te.build(
        "adaptive_sampling", "edge_int8", cfg=cfg,
        params=bc.params_to(qparams, device), reference=ref_genome,
        targets=[(0, 3_000)], channels=16, chunk=256, pipeline_depth=2,
        flowcell={"encoder": "pore", "n_reads": 48, "read_len": (150, 300),
                  "pm": DEMO_PORE, "seed": 3}, device=device)


def phase_train(torch, paths):
    """Training the paper's micro basecaller on the card: one step against
    the CPU (loss and gradients by GRAD_RULE, the forward on the hand
    conv1d kernels: DEMO_CFG's three layers are convolutions, with no k=1
    head for matmul), JAX's learns bar after 220 steps, a QAT run
    quantized and served as ``edge_int8`` with goldens equal to the CPU's
    bit for bit, and a checkpoint round trip."""
    import numpy as np

    from repro_torch.core import basecaller as bc
    from repro_torch.data import nanopore
    from repro_torch.engine.base import quantize_edge_params
    from repro_torch.train import checkpoint
    from repro_torch.train import micro_basecaller as mb
    from repro_torch.train import optimizer as opt
    from repro_torch.utils.tree import leaves
    dev = torch.device("cuda")
    cfg = mb.DEMO_CFG
    params = bc.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = nanopore.make_ctc_batch(np.random.default_rng(0), batch=8,
                                    seq_len=TRAIN_SEQ, pm=mb.DEMO_PORE)
    ocfg = opt.OptimizerConfig(lr=3e-3, warmup_steps=20,
                               total_steps=TRAIN_STEPS, weight_decay=0.0)

    # 1. one step, card against CPU, float and QAT
    for qat in (False, True):
        want_l, want_g = mb.loss_and_grads(params, mb.batch_to(batch, "cpu"),
                                           cfg, qat=qat)

        def step():
            card = bc.params_to(params, dev)
            loss, grads = mb.loss_and_grads(card, mb.batch_to(batch, dev),
                                            cfg, qat=qat)
            new, state, _ = mb.train_step(card, opt.init_opt_state(card, ocfg),
                                          mb.batch_to(batch, dev), cfg=cfg,
                                          ocfg=ocfg, qat=qat)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                new, state, _ = mb.train_step(new, state,
                                              mb.batch_to(batch, dev),
                                              cfg=cfg, ocfg=ocfg, qat=qat)
            torch.cuda.synchronize()
            return loss, grads, (time.perf_counter() - t0) * 1e2
        got_l, got_g, step_ms = paths.drive(
            f"train_step qat={qat}", ("conv1d",), step)
        worst = 0.0
        for layer in want_g:
            for k in want_g[layer]:
                w = want_g[layer][k]
                g = got_g[layer][k].cpu()
                worst = max(worst, ((g - w).abs().max()
                                    / (w.abs().max() + 1e-30)).item())
        rel = abs(float(got_l) - float(want_l)) / abs(float(want_l))
        emit({"phase": "train", "part": "step_vs_cpu", "qat": qat,
              "loss_card": float(got_l), "loss_cpu": float(want_l),
              "loss_rel_diff": rel, "grad_max_diff_over_max": worst,
              "tol": GRAD_RULE, "step_ms": step_ms,
              "launches": paths.paths[f"train_step qat={qat}"]})
        require(rel <= 1e-5 and worst <= 1e-4,
                f"train step qat={qat}: loss {rel}, gradients {worst}")

    # 2. JAX's learns bar, trained on the card: test_system.py's loop of
    # train_step, every step's loss kept
    losses = []

    def learn():
        p = bc.params_to(params, dev)
        state = opt.init_opt_state(p, ocfg)
        rng = np.random.default_rng(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            b = mb.batch_to(nanopore.make_ctc_batch(
                rng, batch=8, seq_len=TRAIN_SEQ, pm=mb.DEMO_PORE), dev)
            p, state, loss = mb.train_step(p, state, b, cfg=cfg, ocfg=ocfg)
            losses.append(float(loss))
        torch.cuda.synchronize()
        return p, time.perf_counter() - t0
    trained, wall = paths.drive(f"train_step x {TRAIN_STEPS}", ("conv1d",),
                                learn)
    acc = read_accuracy(torch, cfg, trained, np.random.default_rng(77))
    emit({"phase": "train", "part": "learns", "steps": TRAIN_STEPS,
          "seq_len": TRAIN_SEQ, "batch": 8, "wall_s": wall,
          "ms_per_step": wall / TRAIN_STEPS * 1e3, "first_loss": losses[0],
          "last_loss": losses[-1], "accuracy": acc,
          "bar": "last loss < first / 2, accuracy > 0.55 "
                 "(tests/test_system.py)"})
    require(losses[-1] < 0.5 * losses[0],
            f"micro basecaller: loss {losses[0]} -> {losses[-1]}")
    require(acc > 0.55, f"micro basecaller accuracy {acc}")

    # 3. QAT on the card, quantized once, served as edge_int8 on both
    qat_losses = {}
    qcfg, qat_params = paths.drive(
        "train_micro_basecaller qat", ("conv1d",),
        lambda: mb.train_micro_basecaller(
            QAT_STEPS, qat=True, device=dev,
            log=lambda i, v: qat_losses.__setitem__(i, v)))
    qparams = quantize_edge_params(bc.params_to(qat_params, "cpu"), qcfg,
                                   chunk=512)
    runs = {}
    for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        def serve(device=device):
            eng = qat_engine(qcfg, qparams, device)
            eng.drain(max_steps=20_000)
            return eng
        eng = (paths.drive("qat edge_int8", ("fused_stream_int8",
                                             "banded_align"), serve)
               if name == "cuda" else serve())
        runs[name] = golden(eng)
    decisions = sorted({g[1] for g in runs["cpu"]})
    emit({"phase": "train", "part": "qat_edge_int8",
          "qat_loss_by_step": qat_losses,
          "reads": len(runs["cpu"]), "decisions": decisions,
          "goldens_equal_cpu": runs["cuda"] == runs["cpu"],
          "act_scales": {k: float(v["w"].act_scale)
                         for k, v in qparams.items()}})
    require(len(runs["cpu"]) > 0 and runs["cuda"] == runs["cpu"],
            "QAT edge_int8 goldens differ between card and CPU")

    # 4. the trained params through a checkpoint, bit for bit
    ckpt = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    path = checkpoint.save(ckpt, trained, TRAIN_STEPS)
    back, step = checkpoint.load_params(ckpt, device=dev)
    same = all(torch.equal(a, b) for a, b in zip(leaves(trained),
                                                  leaves(back)))
    emit({"phase": "train", "part": "checkpoint", "path": os.path.relpath(
        path, ROOT), "step": step, "leaves": len(leaves(trained)),
          "bitwise": same})
    require(step == TRAIN_STEPS and same, "checkpoint round trip differs")


# ----------------------------------------------------------- phase lm_train --
LM_TRAIN_BATCH = 8          # launch/train.py's --global-batch and --seq-len
LM_TRAIN_SEQ = 128
LM_TRAIN_STEPS = 5          # timed, after one warm-up step
LM_TRAIN_SMOKE_BATCH = 4
# lr 1e-4 from step 1, as tests/test_torch_lm_train.py's steps against JAX
LM_TRAIN_OPT = dict(lr=1e-4, warmup_steps=0, total_steps=10)
LM_TRAIN_RULE = ("loss within 1e-5 relative and every gradient within 1e-4 "
                 "of its leaf's largest entry of the CPU's; every updated "
                 "param and moment within 1e-6 of its leaf's largest entry "
                 "of the CPU's AdamW on the card's own gradients")
# AdamW's first step moves an entry by lr g / (|g| + eps), which the
# gradient's last bits decide where it is near eps (a zero-initialised
# leaf's entries): so the card's gradients are held against the CPU's, and
# the card's optimizer writes against the CPU's AdamW on those gradients
LM_OPT_TOL = 1e-6
LM_GRAD_TOL = 1e-5          # a kernel call's gradients vs the plain
#                             version's (the same plain backward, same
#                             inputs): of each gradient's largest entry
# kernels a full-width step launches: remat runs each block's forward
# again in the backward, so each kernel twice a layer
LM_TRAIN_PATHS = (("qwen3-4b", {"flash_attention": 72, "matmul_bf16": 216}),
                  ("mamba2-780m", {"ssd_scan": 96}))
# the profiled step's depth where full depth would take the profiler
# minutes (the plain backward's share is a layer's; the step's fixed work,
# embedding, unembedding and AdamW, weighs more at the cut)
LM_PROFILE_LAYERS = {"mamba2-780m": 6}
LM_RECOVERY = {"steps": 20, "fail_at": 7, "ckpt_every": 5}
# a step of the smoke configs (no remat): qwen3-4b 4 attention layers and
# 12 MLP GEMMs, mamba2-780m 4 SSD layers; the run with the failure
# replays steps 5 and 6 after restoring step 5
LM_RECOVERY_PATHS = (("qwen3-4b", {"flash_attention": 4, "matmul_bf16": 12}),
                     ("mamba2-780m", {"ssd_scan": 4}))


def grad_cases(torch, dev):
    """Each training kernel's card path by route, at the shapes its
    training path gives it (generic routes at a small shape past the
    tensor-core kernels' reach): ``(name, kind, call, plain, inputs,
    counter)``, ``kind`` the kernel (flash, ssd, gemm), the counter the
    call must move by one."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as kssd
    g = torch.Generator().manual_seed(7)

    def rnd(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev, dtype)

    def flash(label, b, hq, hkv, s, d, dtype, counter):
        path = kfa.route(dtype, d)
        return (label, "flash", lambda q, k, v: kfa.flash_attention(q, k, v),
                lambda q, k, v: kfa._plain(q, k, v, True, None, path),
                [rnd((b, hq, s, d), dtype), rnd((b, hkv, s, d), dtype),
                 rnd((b, hkv, s, d), dtype)], counter)

    def ssd(label, bh, t, ds, dh, dtype, counter):
        la = -torch.rand((bh, t), generator=g).to(dev) * 0.5
        return (label, "ssd", lambda x, la, b, c: kssd.ssd_scan(x, la, b, c),
                kssd._plain, [rnd((bh, t, dh), dtype), la,
                              rnd((bh, t, ds), dtype, ds ** -0.5),
                              rnd((bh, t, ds), dtype, ds ** -0.5)], counter)

    def gemm(label, m, k, n, act, counter):
        return (label, "gemm",
                lambda a, b: km.matmul_bf16(a, b, activation=act),
                lambda a, b: ref.matmul(a, b, activation=act),
                [rnd((m, k), torch.bfloat16),
                 rnd((k, n), torch.bfloat16, k ** -0.5)], counter)
    bf = torch.bfloat16
    return [
        flash("flash_attention wgmma (qwen3-4b, 8 x 128)", 8, 32, 8, 128,
              128, bf, (kfa.flash_attention, "launches")),
        flash("flash_attention tf32x3 mma.sync (f32 smoke, D 16)", 4, 4, 2,
              128, 16, torch.float32,
              (kfa.flash_attention, "tf32x3_launches")),
        flash("flash_attention tf32x3 wgmma (f32 smoke, D 128)", 4, 4, 2,
              128, 128, torch.float32,
              (kfa.flash_attention, "tf32x3_wgmma_launches")),
        flash("flash_attention generic (D 300)", 1, 2, 1, 64, 300,
              torch.float32, (kfa.flash_attention, "generic_launches")),
        ssd("ssd_scan tensor cores (mamba2-780m, 8 x 128, bf16)", 384, 128,
            128, 64, bf, (kssd.ssd_scan, "launches")),
        ssd("ssd_scan tensor cores (f32 smoke, (16, 16))", 32, 128, 16, 16,
            torch.float32, (kssd.ssd_scan, "launches")),
        ssd("ssd_scan padded (f32 smoke, (64, 32))", 16, 128, 64, 32,
            torch.float32, (kssd.ssd_scan, "padded_launches")),
        ssd("ssd_scan generic ((300, 33))", 2, 64, 300, 33, torch.float32,
            (kssd.ssd_scan, "generic_launches")),
        gemm("matmul_bf16 wgmma (qwen3-4b gate, 1024 x 2560 x 9728)", 1024,
             2560, 9728, "silu", (km.matmul_bf16, "wgmma_launches")),
        gemm("matmul_bf16 mma.sync (K = 2558)", 1024, 2558, 256, "none",
             (km.matmul_bf16, "launches")),
    ]


def forward_excess(torch, kind, out, want, ins):
    """A training kernel's output against its plain version's on the same
    inputs, as the largest |out - want| over the kernel's forward bar (at
    most 1 passes): flash by the working type's bar (FA_RULE,
    F32_FLASH_RULE) against the plain attention, ``ssd_scan`` within
    SSD_TOL + 2^-7 |y| (bf16) or SSD_TOL (1 + |y|) (f32), ``matmul_bf16``
    one bf16 ulp of max |out|.  Returns ``(excess, rule)``."""
    from repro_torch.kernels import ref
    out = out.detach()
    with torch.no_grad():
        if kind == "flash":
            q, k, v = ins
            name = str(q.dtype).split(".")[-1]
            return flash_bar_excess(
                out, ref.attention(q, k, v, causal=True),
                ref.attention(q, k, v.abs(), causal=True), name), (
                    FA_RULE if name == "bfloat16" else F32_FLASH_RULE)
        w = want.detach().float()
        err = (out.float() - w).abs()
        if kind == "ssd":
            rtol = 2 ** -7 if out.dtype == torch.bfloat16 else SSD_TOL
            return (err / (SSD_TOL + rtol * w.abs())).max().item(), (
                f"{SSD_TOL} + {rtol} |y|")
        return (err.max().item() / bf16_ulp(w.abs().max().item()),
                "one bf16 ulp of max |out|")


def check_kernel_grads(torch, dev) -> list:
    """Each case of ``grad_cases``: the kernel call with operands that
    require grad (counted by its wrapper, outside any path), its output's
    ``grad_fn``, its output against the plain version's by the kernel's
    forward bar (``forward_excess``), and every gradient against plain
    autograd of the plain version on the same card inputs, within
    LM_GRAD_TOL of the largest entry (the backward is that plain
    version's, so equal bits are expected: ``bitwise``)."""
    lines = []
    for name, kind, call, plain, ins, (wrapper, attr) in grad_cases(torch,
                                                                     dev):
        a = [t.clone().requires_grad_(t.is_floating_point()) for t in ins]
        b = [t.clone().requires_grad_(t.is_floating_point()) for t in ins]
        before = getattr(wrapper, attr)
        out = call(*a)
        moved = getattr(wrapper, attr) - before
        want = plain(*b)
        fwd, fwd_rule = forward_excess(torch, kind, out, want, ins)
        gout = torch.randn(want.shape, generator=torch.Generator(
            ).manual_seed(8)).to(dev, want.dtype)
        out.backward(gout)
        want.backward(gout)
        worst, bitwise = 0.0, True
        for ta, tb in zip(a, b):
            d = (ta.grad.float() - tb.grad.float()).abs().max().item()
            worst = max(worst, d / max(tb.grad.float().abs().max().item(),
                                       1e-30))
            bitwise = bitwise and torch.equal(ta.grad, tb.grad)
        line = {"phase": "lm_train", "part": "kernel_gradient",
                "case": name, "shapes": [list(t.shape) for t in ins],
                "dtype": str(ins[0].dtype), "grad_fn":
                type(out.grad_fn).__name__, "launched": moved,
                "forward_over_bar": fwd, "forward_tol": fwd_rule,
                "grad_dtypes": sorted({str(t.grad.dtype) for t in a}),
                "max_diff_over_max": worst, "bitwise": bitwise,
                "tol": LM_GRAD_TOL}
        emit(line)
        lines.append(line)
        require(moved == 1 and line["grad_fn"] == "PlainGradBackward",
                f"{name}: launched {moved}, grad_fn {line['grad_fn']}")
        require(fwd <= 1.0, f"{name}: the forward {fwd} x its bar "
                f"({fwd_rule}) from the plain version's")
        require(worst <= LM_GRAD_TOL, f"{name}: gradients {worst} of their "
                "largest entry from the plain version's")
        require(all(ta.grad.dtype == ta.dtype for ta in a),
                f"{name}: a gradient not in its operand's dtype")
        del a, b, out, want
    torch.cuda.empty_cache()
    return lines


def lm_train_state(torch, cfg, params, accum=1):
    """``(state, step)``: AdamW at LM_TRAIN_OPT over ``params`` and the
    trainer's step for ``cfg`` (which updates the state in place)."""
    from repro_torch.models.registry import get_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer
    ocfg = opt.OptimizerConfig(**LM_TRAIN_OPT)
    state = {"params": params, "opt": opt.init_opt_state(params, ocfg)}
    step = trainer.make_train_step(
        get_model(cfg).loss, cfg, ocfg,
        trainer.TrainerConfig(grad_accum=accum))
    return state, step


def train_step_excess(torch, params, card, cpu) -> dict:
    """Card against CPU for one train step from ``params`` (on the CPU),
    each ``(loss, gradients, new state)`` (trees of CPU tensors), by
    LM_TRAIN_RULE: the loss's relative difference; the gradients' largest
    difference over 1e-4 of their leaf's largest entry; the card's new
    params and moments' largest difference from the CPU's AdamW on the
    card's gradients over LM_OPT_TOL of their leaf's largest entry (at
    most 1 passes), and whether those are equal bit for bit."""
    from repro_torch.train import optimizer as opt
    from repro_torch.utils.tree import leaves

    def over(got, want, tol):
        w = want.float()
        return ((got.float() - w).abs().max()
                / (tol * w.abs().max()).clamp_min(1e-30)).item()
    grad_over = max(over(g, w, 1e-4)
                    for g, w in zip(leaves(card[1]), leaves(cpu[1])))
    ocfg = opt.OptimizerConfig(**LM_TRAIN_OPT)
    new_p, new_opt, _ = opt.apply_update(
        params, card[1], opt.init_opt_state(params, ocfg), ocfg)
    want = leaves({"params": new_p, "opt": new_opt})
    got = leaves(card[2])
    require(len(got) == len(want), "train step: state trees differ")
    return {"loss_rel_diff": abs(card[0] - cpu[0]) / abs(cpu[0]),
            "grad_over_bar": grad_over,
            "state_over_bar": max(over(g, w, LM_OPT_TOL)
                                  for g, w in zip(got, want)),
            "state_bitwise": all(torch.equal(g, w)
                                 for g, w in zip(got, want))}


def plain_backward_share(torch, step, state, batch) -> dict:
    """One step under ``torch.profiler``: the ``PlainGrad.plain_backward``
    spans' host and device time (inclusive) against the step's wall and
    the device time of all its kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cpu = torch.autograd.DeviceType.CPU
    # the host-side spans; their device time is the kernels launched
    # inside them (and in the ops they hold)
    spans = [e for e in prof.key_averages() if e.key == _build.PLAIN_BACKWARD
             and getattr(e, "device_type", cpu) == cpu]
    host = sum(e.cpu_time_total for e in spans) / 1e3
    dev = sum(getattr(e, "device_time_total", None)
              or getattr(e, "cuda_time_total", 0.0) for e in spans) / 1e3
    # kernels only: a record_function span also has a device-side record
    dev_all = sum(ev.time_range.elapsed_us() for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(ev, "is_user_annotation", False)
                  and ev.name != _build.PLAIN_BACKWARD) / 1e3
    return state, {"profiled_step_ms": wall, "plain_backward_calls":
                   sum(e.count for e in spans),
                   "plain_backward_host_ms": host,
                   "plain_backward_device_ms": dev,
                   "step_device_ms": dev_all,
                   "plain_backward_host_share": host / wall if wall else None,
                   "plain_backward_device_share": dev / dev_all if dev_all
                   else None}


def phase_lm_train(torch, paths):
    """LM training on the card (``train/trainer.py`` -> ``models/``):
    each training kernel's gradient by route; one f32 smoke step card
    against CPU (the ``lm_parity_f32`` configs, LM_TRAIN_RULE); recovery
    after an injected failure equal bit for bit to an uninterrupted run
    (``launch.train.main`` in process, both smoke configs); qwen3-4b and
    mamba2-780m at full width and depth, 8 x 128, one warm-up and
    LM_TRAIN_STEPS timed steps with the launcher's AdamW and remat (each
    freed before the next), then one profiled step (at LM_PROFILE_LAYERS'
    depth where given); ``python -m repro_torch.launch.train`` in a
    subprocess."""
    import dataclasses
    import shutil

    import numpy as np

    from repro_torch.configs import ARCHS
    from repro_torch.core import basecaller as bc
    from repro_torch.data import tokens
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer
    from repro_torch.utils.tree import leaves, tree_bytes, tree_map
    dev = torch.device("cuda")
    part_s = {}
    t_part = time.perf_counter()
    check_kernel_grads(torch, dev)
    part_s["kernel_gradients"] = time.perf_counter() - t_part

    # 1. one f32 smoke step, card against CPU
    def smoke_steps():
        lines = []
        for label, cfg in f32_parity_configs():
            params, _ = transformer.init(torch.Generator().manual_seed(0),
                                         cfg, device="cpu")
            pipe = tokens.TokenPipelineConfig(
                vocab_size=cfg.vocab_size, seq_len=LM_TRAIN_SEQ,
                global_batch=LM_TRAIN_SMOKE_BATCH)
            out = {}
            for name, device in (("cpu", torch.device("cpu")), ("cuda", dev)):
                # a copy: the step updates the state in place
                p = tree_map(torch.clone, bc.params_to(params, device))
                batch = tokens.batch_at_step(pipe, 0, device=device)
                _, grads = trainer.loss_and_grads(get_model(cfg).loss, p,
                                                  batch, cfg)
                state, step = lm_train_state(torch, cfg, p)
                new, m = step(state, batch)
                out[name] = (float(m["loss"]),
                             tree_map(lambda t: t.cpu(), grads),
                             tree_map(lambda t: t.cpu(), new))
            line = train_step_excess(torch, params, out["cuda"], out["cpu"])
            lines.append({"phase": "lm_train", "part": "f32_smoke_vs_cpu",
                          "config": label, "batch": LM_TRAIN_SMOKE_BATCH,
                          "seq": LM_TRAIN_SEQ, "loss_card": out["cuda"][0],
                          "loss_cpu": out["cpu"][0], **line,
                          "tol": LM_TRAIN_RULE})
        return lines
    t_part = time.perf_counter()
    lines = paths.drive("lm_train f32 smoke", (
        "flash_attention_tf32x3", "flash_attention_tf32x3_wgmma", "matmul",
        "ssd_scan", "ssd_scan_padded"), smoke_steps, train=True)
    part_s["f32_smoke_vs_cpu"] = time.perf_counter() - t_part
    for line in lines:
        emit(line)
        require(line["loss_rel_diff"] <= 1e-5
                and line["grad_over_bar"] <= 1.0
                and line["state_over_bar"] <= 1.0,
                f"f32 train step {line['config']}: {line}")

    # 2. recovery after an injected failure, bit for bit
    rec = LM_RECOVERY
    t_part = time.perf_counter()
    for arch, per_step in LM_RECOVERY_PATHS:
        root = os.path.join(ROOT, "build", "lm_train_recovery", arch)
        shutil.rmtree(root, ignore_errors=True)
        argv = ["--arch", arch, "--smoke", "--steps", str(rec["steps"]),
                "--ckpt-every", str(rec["ckpt_every"])]

        def runs():
            clean = launch_train.main(argv + ["--ckpt-dir",
                                              os.path.join(root, "clean")])
            faulty = launch_train.main(argv + [
                "--ckpt-dir", os.path.join(root, "faulty"), "--fail-at",
                str(rec["fail_at"])])
            return clean, faulty
        path = f"lm_train recovery {arch}"
        clean, faulty = paths.drive(path, tuple(per_step), runs, train=True)
        same_state = all(torch.equal(a, b) for a, b in zip(
            leaves(clean["state"]), leaves(faulty["state"])))
        ran = 2 * rec["steps"] + rec["fail_at"] - (rec["fail_at"]
                                                   // rec["ckpt_every"]
                                                   * rec["ckpt_every"])
        want = {k: ran * v for k, v in per_step.items()}
        got = {k: paths.paths[path].get(k, 0) for k in per_step}
        line = {"phase": "lm_train", "part": "recovery", "arch": arch,
                **rec, "restarts": faulty["restarts"],
                "steps_run": ran, "losses_equal":
                clean["history"] == faulty["history"],
                "state_equal": same_state,
                "first_loss": clean["history"][0],
                "last_loss": clean["history"][rec["steps"] - 1],
                "launches": got, "expected_launches": want}
        emit(line)
        require(faulty["restarts"] == 1 and line["losses_equal"]
                and same_state, f"{arch} recovery differs from the "
                f"uninterrupted run: {line}")
        require(got == want, f"{arch} recovery launches {got}, expected "
                f"{want}")
        del clean, faulty
        torch.cuda.empty_cache()

    part_s["recovery"] = time.perf_counter() - t_part

    # 3. full width and depth, bf16, the launcher's optimizer and remat
    for arch, per_step in LM_TRAIN_PATHS:
        t_part = time.perf_counter()
        spec = ARCHS[arch]
        cfg = spec.config()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, _ = transformer.init(torch.Generator(dev).manual_seed(0), cfg,
                                     device=dev)
        ocfg = opt.OptimizerConfig(total_steps=1 + LM_TRAIN_STEPS,
                                   state_dtype=spec.optimizer_state_dtype)
        state = {"params": params, "opt": opt.init_opt_state(params, ocfg)}
        step = trainer.make_train_step(
            get_model(cfg).loss, cfg, ocfg, trainer.TrainerConfig(
                accum_dtype=spec.grad_accum_dtype))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        pipe = tokens.TokenPipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=LM_TRAIN_SEQ,
            global_batch=LM_TRAIN_BATCH)
        sizes = {"params": tree_numel(params),
                 "params_gb": tree_bytes(state["params"]) / 2 ** 30,
                 "moments_gb": (tree_bytes(state["opt"]["m"])
                                + tree_bytes(state["opt"]["v"])) / 2 ** 30}

        def run():
            losses, walls = [], []
            st = state
            for i in range(1 + LM_TRAIN_STEPS):
                batch = tokens.batch_at_step(pipe, i, device=dev)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                st, m = step(st, batch)
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t1) * 1e3)
            return st, losses, walls
        path = f"lm_train {arch}"
        state, losses, walls = paths.drive(path, tuple(per_step), run,
                                           train=True)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        depth = LM_PROFILE_LAYERS.get(arch, cfg.num_layers)
        if depth != cfg.num_layers:
            # the profiler's ~10^5 events a layer of the SSD recurrence's
            # plain backward take minutes to process at full depth
            cut = dataclasses.replace(cfg, num_layers=depth)
            params = state = step = None
            torch.cuda.empty_cache()
            p_cut, _ = transformer.init(torch.Generator(dev).manual_seed(0),
                                        cut, device=dev)
            state = {"params": p_cut, "opt": opt.init_opt_state(p_cut, ocfg)}
            step = trainer.make_train_step(get_model(cut).loss, cut, ocfg)
            step(state, tokens.batch_at_step(pipe, 0, device=dev))
        state, share = plain_backward_share(
            torch, step, state, tokens.batch_at_step(pipe, 1 + LM_TRAIN_STEPS,
                                                     device=dev))
        share["profiled_layers"] = depth
        timed = walls[1:]
        med = float(np.median(timed))
        counts = paths.paths[path]
        steps_run = 1 + LM_TRAIN_STEPS
        emit({"phase": "lm_train", "part": "full_width", "arch": arch,
              "layers": cfg.num_layers, "remat": cfg.remat, "batch": LM_TRAIN_BATCH,
              "seq": LM_TRAIN_SEQ, "init_s": init_s,
              "warmup_ms": walls[0], "step_ms": timed, "median_step_ms": med,
              "tokens_per_s": LM_TRAIN_BATCH * LM_TRAIN_SEQ / (med / 1e3),
              "losses": losses, "first_loss": losses[0],
              "last_loss": losses[-1],
              "finite": bool(np.isfinite(losses).all()),
              "peak_mem_gb": peak, **sizes,
              "launches_per_step": {k: v / steps_run
                                    for k, v in counts.items()},
              **share})
        require(np.isfinite(losses).all(), f"{arch}: non-finite loss "
                f"{losses}")
        for k, v in per_step.items():
            require(counts.get(k, 0) == steps_run * v,
                    f"{arch} training: {k} launched {counts.get(k, 0)}, "
                    f"expected {steps_run} x {v}")
        if "matmul_bf16" in per_step:
            require(counts.get("matmul_bf16_wgmma", 0)
                    == counts.get("matmul_bf16", 0),
                    f"{arch} training: a bf16 MLP GEMM off the wgmma kernel")
        del state, params, step
        p_cut = None
        torch.cuda.empty_cache()
        part_s[f"full_width {arch}"] = time.perf_counter() - t_part

    # 4. the CLI
    ckpt = os.path.join(ROOT, "build", "lm_train_cli")
    shutil.rmtree(ckpt, ignore_errors=True)
    # JAX's --ckpt-every 10 would leave a failure at step 7 no checkpoint
    # to restore (run_resilient then raises, in either package)
    argv = ["--smoke", "--steps", "20", "--fail-at", "7", "--ckpt-every",
            "5", "--ckpt-dir", ckpt]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *argv], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True,
        timeout=300)
    out = proc.stdout.strip().splitlines()
    emit({"phase": "lm_train", "part": "cli", "argv": argv,
          "rc": proc.returncode, "wall_s": time.perf_counter() - t0,
          "summary": out[-2:]})
    require(proc.returncode == 0 and "restarts=1" in proc.stdout,
            f"launch.train exited {proc.returncode}: {proc.stderr[-2000:]}")
    part_s["cli"] = time.perf_counter() - t0
    emit({"phase": "lm_train", "part": "seconds", **part_s})


# ---------------------------------------------------------- phase serve_cli --
SERVE_FIELD = {"n_devices": 2, "n_infected": 1, "host_len": 2000,
               "pathogen_len": 1000, "n_reads": 10, "min_reads": 2,
               "min_abundance": 0.01, "detect_window": 192,
               "max_delay_ticks": 2, "dup_prob": 0.1, "seed": 3}
SERVE_FLEET = {"tenants": [
    {"name": "lab-fc", "workload": "adaptive_sampling",
     "preset": "flowcell_smoke", "weight": 2},
    {"name": "lab-bc", "workload": "basecall", "requests": 32},
    {"name": "lab-pp", "workload": "pathogen_pipeline", "requests": 4},
    {"name": "lab-lm", "workload": "lm_decode", "preset": "smoke",
     "requests": 6}]}


def phase_serve_cli():
    """``python -m repro_torch.launch.serve`` in subprocesses on the card:
    the three SoC workloads (one with --trace and --timeseries, both
    through the port's validators), --fleet on a spec file (an
    ``lm_decode`` tenant among them), --field on a small spec, and
    ``lm_decode`` on its ``smoke`` and ``full`` presets (qwen3-4b at full
    size: no ``--smoke``).  Each must exit 0; its wall is printed."""
    from repro_torch.obs.export import validate_timeseries
    from repro_torch.obs.trace import validate_chrome_trace
    out_dir = os.path.join(ROOT, "build", "serve_cli")
    os.makedirs(out_dir, exist_ok=True)
    fleet_spec = os.path.join(out_dir, "fleet.json")
    field_spec = os.path.join(out_dir, "field.json")
    with open(fleet_spec, "w") as f:
        json.dump(SERVE_FLEET, f)
    with open(field_spec, "w") as f:
        json.dump(SERVE_FIELD, f)
    trace = os.path.join(out_dir, "trace.json")
    ts = os.path.join(out_dir, "ts.jsonl")
    runs = {
        "basecall": ["--workload", "basecall", "--requests", "32"],
        "adaptive_sampling": ["--workload", "adaptive_sampling",
                              "--requests", "16", "--trace", trace,
                              "--timeseries", ts, "--interval", "0.05"],
        "pathogen_pipeline": ["--workload", "pathogen_pipeline",
                              "--requests", "4"],
        "fleet": ["--fleet", fleet_spec],
        "field": ["--field", field_spec],
        # JAX's rule: lm_decode builds the full-size arch unless --smoke
        "lm_decode smoke": ["--workload", "lm_decode", "--preset", "smoke"],
        "lm_decode full": ["--workload", "lm_decode", "--preset", "full",
                           "--requests", "8", "--new-tokens", "16"],
    }
    env = dict(os.environ, PYTHONPATH=SRC)
    for name, argv in runs.items():
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", *argv,
             "--json"], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=300)
        wall = time.perf_counter() - t0
        out = proc.stdout
        report = json.loads(out[out.index("{"):]) if "{" in out else {}
        line = {"phase": "serve_cli", "run": name, "argv": argv,
                "rc": proc.returncode, "wall_s": wall}
        if name == "fleet":
            line["tenants"] = {k: v.get("completed") for k, v in
                               report.get("tenants", {}).items()}
        elif name == "field":
            line.update(outbreak=report.get("outbreak"),
                        conservation=report.get("conservation"))
        else:
            line.update({k: report.get(k) for k in (
                "completed", "dispatches", "p50_ms", "p99_ms",
                "bases_per_s", "tokens_per_s")})
        emit(line)
        require(proc.returncode == 0, f"serve {name} exited "
                f"{proc.returncode}: {proc.stderr[-2000:]}")
        if name == "field":
            require(report["outbreak"]["detected"]
                    and report["conservation"]["per_device_exact"],
                    f"serve --field: {report['outbreak']}")
        elif name == "fleet":
            require(all(v for v in line["tenants"].values()),
                    f"serve --fleet: {line['tenants']}")
        else:
            require(report.get("completed", 0) > 0,
                    f"serve {name}: nothing completed")
    with open(trace) as f:
        errors = validate_chrome_trace(json.load(f))
    ts_errors = validate_timeseries(ts)
    emit({"phase": "serve_cli", "run": "validate", "trace_errors": errors,
          "timeseries_errors": ts_errors})
    require(not errors and not ts_errors,
            f"serve trace/timeseries invalid: {errors[:3]} {ts_errors[:3]}")


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
    "conv1d_int8": ("src/repro_torch/kernels/csrc/conv1d.cu",
                    "src/repro/kernels/conv1d.py:122"),
    "matmul_int8": ("src/repro_torch/kernels/csrc/matmul.cu",
                    "src/repro/kernels/matmul.py:120"),
    "fused_stream_int8": ("src/repro_torch/kernels/csrc/fused_stream.cu",
                          "src/repro/kernels/fused_stream.py:376"),
    "levenshtein": ("src/repro_torch/kernels/csrc/banded_align.cu",
                    "src/repro/kernels/edit_distance.py:139"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:111"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:88"),
    "matmul_bf16": ("src/repro_torch/kernels/csrc/matmul.cu",
                    "src/repro/kernels/matmul.py:120"),
    # rows 5g and 6g: the f32 (f16, odd-D bf16) flash route on 3xTF32
    # tensor cores, and the SSD pairs outside DIMS on the padded passes
    "flash_attention_tf32x3": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:111"),
    "flash_attention_tf32x3_wgmma": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:111"),
    "ssd_scan_padded": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                        "src/repro/kernels/ssd_scan.py:88"),
    # row 2d: matmul_bf16 at decode's M = the slot count (8), the LM
    # decode server's MLP; its launches are the lm_decode paths'
    "matmul_bf16_decode": ("src/repro_torch/kernels/csrc/matmul.cu",
                           "src/repro/kernels/matmul.py:120"),
    # row 2l: matmul_int8 at the int8 LM's projections (its narrow-M
    # kernel at decode); its launches are the lm_tp paths' (one rank and
    # two)
    "matmul_int8_lm": ("src/repro_torch/kernels/csrc/matmul.cu",
                       "src/repro/kernels/matmul.py:120"),
}


def launch_counters():
    """Each kernel's launch count: (wrapper, attribute)."""
    from repro_torch.kernels import conv1d, edit_distance, fused_stream, matmul
    from repro_torch.kernels import flash_attention, ssd_scan
    fs = fused_stream.fused_stream_cuda
    return {"conv1d": (conv1d.conv1d, "launches"),
            "matmul": (matmul.matmul, "launches"),
            "fused_stream": (fs, "launches"),
            "banded_align": (edit_distance.banded_align, "launches"),
            "conv1d_int8": (conv1d.conv1d_int8, "launches"),
            "matmul_int8": (matmul.matmul_int8, "launches"),
            "fused_stream_int8": (fs, "launches_int8"),
            "levenshtein": (edit_distance.levenshtein, "launches"),
            "flash_attention": (flash_attention.flash_attention, "launches"),
            "ssd_scan": (ssd_scan.ssd_scan, "launches"),
            "matmul_bf16": (matmul.matmul_bf16, "launches"),
            "flash_attention_tf32x3": (flash_attention.flash_attention,
                                       "tf32x3_launches"),
            "ssd_scan_padded": (ssd_scan.ssd_scan, "padded_launches"),
            # the CUDA-core kernels, kept as the routes past those
            "flash_attention_generic": (flash_attention.flash_attention,
                                        "generic_launches"),
            "ssd_scan_generic": (ssd_scan.ssd_scan, "generic_launches"),
            "flash_attention_tf32x3_wgmma": (flash_attention.flash_attention,
                                             "tf32x3_wgmma_launches"),
            # the launches of matmul_bf16 that ran its wgmma kernel, of
            # conv1d and conv1d_int8 their tensor-core kernels, of matmul and
            # matmul_int8 their
            # skinny-N kernels, of fused_stream (fp32 and int8) conv layers
            # on the tensor cores, and those layers
            "matmul_bf16_wgmma": (matmul.matmul_bf16, "wgmma_launches"),
            "conv1d_tc": (conv1d.conv1d, "tc_launches"),
            "conv1d_int8_tc": (conv1d.conv1d_int8, "tc_launches"),
            "matmul_skinny": (matmul.matmul, "skinny_launches"),
            "matmul_int8_skinny": (matmul.matmul_int8, "skinny_launches"),
            # the decode routes (M <= 16) of matmul_int8 and matmul_bf16,
            # and matmul_int8's tiled tensor-core kernel
            "matmul_int8_narrow": (matmul.matmul_int8, "narrow_launches"),
            "matmul_int8_tc": (matmul.matmul_int8, "tc_launches"),
            "matmul_bf16_narrow": (matmul.matmul_bf16, "narrow_launches"),
            "fused_stream_tc": (fs, "tc_launches"),
            "fused_stream_tc_layers": (fs, "tc_layers"),
            "fused_stream_int8_tc": (fs, "tc_launches_int8"),
            "fused_stream_int8_tc_layers": (fs, "tc_layers_int8")}


class PathLaunches:
    """Counts every kernel from 0 just before one main path and reads the
    counts just after it; fails if a kernel of the path never launched."""

    def __init__(self):
        self.counters = launch_counters()
        self.total = {k: 0 for k in self.counters}
        self.train = {k: 0 for k in self.counters}     # the lm_train paths
        self.paths = {}

    def drive(self, path, kernels, fn, train=False):
        for wrapper, attr in self.counters.values():
            setattr(wrapper, attr, 0)
        result = fn()
        counts = {k: getattr(w, a) for k, (w, a) in self.counters.items()}
        self.paths[path] = {k: v for k, v in counts.items() if v}
        for k, v in counts.items():
            self.total[k] += v
            self.train[k] += v if train else 0
        emit({"phase": "launches", "path": path, "launches":
              self.paths[path]})
        for k in kernels:
            require(counts[k] > 0, f"kernel {k} never launched on the "
                    f"{path} path")
        return result

    def record(self, path, counts, kernels):
        """A path driven in other processes (tensor-parallel ranks, each
        counting from 0 around it): their summed counts."""
        self.paths[path] = {k: v for k, v in counts.items() if v}
        for k in self.total:
            self.total[k] += counts.get(k, 0)
        emit({"phase": "launches", "path": path, "launches":
              self.paths[path]})
        for k in kernels:
            require(counts.get(k, 0) > 0, f"kernel {k} never launched on "
                    f"the {path} path")


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

    from repro_torch.core import basecaller as bc
    from repro_torch.engine.base import quantize_edge_params
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
          "ptxas": {k: _build.ptxas_summary(v)
                    for k, v in _build.PTXAS_LOG.items()}})

    # the paper's CNN, seed 0, and its edge_int8 form, calibrated once
    # (chunk max(256, 512), as the adaptive builder calibrates)
    cfg = bc.BasecallerConfig()
    params = bc.init(torch.Generator().manual_seed(0), cfg)
    t0 = time.perf_counter()
    qparams = quantize_edge_params(params, cfg, chunk=512)
    emit({"phase": "calibrate", "act_scales": {
        k: float(v["w"].act_scale) for k, v in qparams.items()},
        "calibrate_s": time.perf_counter() - t0})

    table = phase_kernels(torch, F, peaks)
    phase_kernels_int8(torch, peaks, table, cfg, qparams,
                       torch.Generator().manual_seed(2))
    phase_kernels_limits(torch, F, peaks, table,
                         torch.Generator().manual_seed(3))
    panel = pathogen_panel()
    known = known_reads(panel)
    firehose = phase_kernels_genomics(torch, F, peaks, table, panel, known)
    long_lm = phase_kernels_lm(torch, F, peaks, table)
    phase_kernels_generic(torch, F, peaks, table)
    phase_step_goldens()
    scfg, sparams = quantize_step_codec()
    phase_step_goldens("int8", scfg, sparams)

    paths = PathLaunches()
    full = paths.drive("flowcell_512 fp32",
                       ("conv1d", "matmul", "fused_stream", "banded_align"),
                       lambda: phase_full_width(torch))
    unfused_launches(paths.paths["flowcell_512 fp32"], full[False]["ticks"])
    paths.drive("edge_int8 full width",
                ("conv1d_int8", "matmul_int8", "fused_stream_int8",
                 "banded_align"),
                lambda: phase_full_width_int8(torch, cfg, qparams))
    int8_launches(paths.paths["edge_int8 full width"])
    int8_ticks_vs_cpu(torch, cfg, qparams)

    import repro_torch.engine as te

    def run_card(preset, p, sig):
        def serve():
            eng = te.build("basecall", preset=preset, cfg=cfg, params=p)
            eng.serve(sig[:eng.batch])                 # warm-up dispatch
            eng.telemetry = type(eng.telemetry)(workload=eng.workload)
            t0 = time.perf_counter()
            reads = eng.serve(sig)
            torch.cuda.synchronize()
            return eng, reads, time.perf_counter() - t0
        want = (("conv1d_int8", "matmul_int8") if preset == "edge_int8"
                else ("conv1d", "matmul"))
        return paths.drive(f"basecall {preset}", want, serve)
    phase_basecall(torch, cfg, params, run_card)
    emit({"phase": "basecall_launches", "preset": "edge_int8",
          **int8_conv_on_tensor_cores(paths.paths["basecall edge_int8"],
                                      "basecall edge_int8")})
    phase_pathogen(torch, cfg, panel, known, paths)
    phase_lm_prefill(torch, paths)
    phase_lm_parity_f32(torch, paths)
    decode_launches = phase_lm_decode(torch, F, peaks, table, paths)
    lm_tp_narrow = phase_lm_tp(torch, F, peaks, table, paths)
    phase_fleet(torch, panel, paths)
    phase_field(torch, paths)
    phase_train(torch, paths)
    phase_lm_train(torch, paths)
    phase_serve_cli()

    def row_launches(k, counts):
        """The launches of row ``k`` among ``counts``: the flash and SSD
        wrappers count all their kernels, and the 3xTF32 and padded ones
        have rows of their own (the CUDA-core ones run on no main
        path)."""
        n = counts[k]
        if k == "flash_attention":
            n -= (counts["flash_attention_tf32x3"]
                  + counts["flash_attention_tf32x3_wgmma"]
                  + counts["flash_attention_generic"])
        if k == "ssd_scan":
            n -= counts["ssd_scan_padded"] + counts["ssd_scan_generic"]
        return n

    kernels = []
    for k, (src, replaces) in KERNELS.items():
        r = table.rows[k]
        decode = k in ("matmul_bf16_decode", "matmul_int8_lm")
        launches = (decode_launches["matmul_bf16"]
                    if k == "matmul_bf16_decode" else lm_tp_narrow
                    if k == "matmul_int8_lm" else row_launches(k,
                                                                paths.total))
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
        if not decode:
            # of those, the lm_train paths' (forward and remat recompute;
            # the backward is each plain version's); no training path
            # runs row 2d's M = 8 or row 2l's int8 LM
            kernels[-1]["train_launches"] = row_launches(k, paths.train)
        if k == "matmul_int8_lm":
            # the narrow-M kernel at one decode layer's seven projections
            # (M = 8) summed, device time, _int_mm at M = 32 (the least it
            # takes) beside the tiled kernel and the bound there, and the
            # prefill's M = 4096; the lm_tp paths' launches by route
            kernels[-1].update(
                variant="narrow", device_ms=r["device_ms"],
                narrow_launches=lm_tp_narrow,
                tc_launches=sum(c.get("matmul_int8_tc", 0) for p, c in
                                paths.paths.items() if p.startswith("lm_tp")),
                library_m=r["library_m"],
                kernel_ms_at_library_m=r["kernel_ms_at_library_m"],
                bound_ms_at_library_m=r["bound_ms_at_library_m"],
                at_4096=r["at_4096"])
        if k == "matmul_bf16":
            kernels[-1].update(
                wgmma_launches=paths.total["matmul_bf16_wgmma"],
                narrow_launches=paths.total["matmul_bf16_narrow"])
        if k == "matmul_bf16_decode":
            # the lm_decode paths' launches by route (all narrow-M), the
            # route the three GEMMs ran, and device times beside
            # torch.matmul's
            kernels[-1].update(
                narrow_launches=decode_launches["matmul_bf16_narrow"],
                wgmma_launches=decode_launches["matmul_bf16_wgmma"],
                variant=r["variant"], device_ms=r["device_ms"],
                library_device_ms=r["library_device_ms"])
        if k == "conv1d":
            kernels[-1]["tc_launches"] = paths.total["conv1d_tc"]
            # the tick's bound at the CUDA cores' fp32 rate, beside
            # bound_ms at the rate of the kernels that ran
            kernels[-1]["bound_fp32_ms"] = r["bound_fp32_ms"]
        if k == "matmul":
            kernels[-1]["skinny_launches"] = paths.total["matmul_skinny"]
        if k in ("flash_attention_tf32x3", "flash_attention_tf32x3_wgmma",
                 "ssd_scan_padded"):
            # bound_ms at the 3xTF32 rate, the card's f32-accurate peak,
            # bound_fp32_ms at the CUDA cores' fp32 rate; was_ms the
            # CUDA-core kernel this row ran on before, same inputs, and
            # its launches on the main paths (none: past the new reach)
            generic = ("ssd_scan_generic" if k.startswith("ssd")
                       else "flash_attention_generic")
            kernels[-1].update(bound_fp32_ms=r["bound_fp32_ms"],
                               was_ms=r["was_ms"],
                               generic_launches=paths.total[generic])
        if k == "flash_attention_tf32x3":
            # the mma.sync kernel at row 5g's inputs (qwen3-4b f32, D 128)
            kernels[-1].update(
                qwen3_4b_d128_ms=r["qwen3_4b_d128_ms"],
                qwen3_4b_d128_bound_ms=r["qwen3_4b_d128_bound_ms"])
        if k == "flash_attention_tf32x3_wgmma":
            kernels[-1]["library_kernels"] = r["library_kernels"]
        if k == "ssd_scan_padded":
            kernels[-1]["device_ms_by_pass"] = r["device_ms_by_pass"]
        if k == "matmul_int8":
            routes = {r: paths.total[f"matmul_int8_{r}"]
                      for r in ("skinny", "narrow", "tc")}
            kernels[-1].update(
                skinny_launches=routes["skinny"],
                narrow_launches=routes["narrow"], tc_launches=routes["tc"],
                dp4a_launches=paths.total["matmul_int8"]
                - sum(routes.values()),
                device_ms=r["device_ms"],
                library_device_ms=r["library_device_ms"])
        if k == "fused_stream":
            # launches with conv layers on the tensor cores, their device
            # time, the unfused chain's kernels on the same inputs, and the
            # bound at the CUDA cores' fp32 rate
            kernels[-1].update(
                tc_launches=paths.total["fused_stream_tc"],
                tc_layers=paths.total["fused_stream_tc_layers"],
                device_ms=r["device_ms"], unfused_ms=r["unfused_ms"],
                unfused_device_ms=r["unfused_device_ms"],
                bound_fp32_ms=r["bound_fp32_ms"])
        if k == "fused_stream_int8":
            # launches with conv layers on the tensor cores, those layers,
            # and the device time
            kernels[-1].update(
                tc_launches=paths.total["fused_stream_int8_tc"],
                tc_layers=paths.total["fused_stream_int8_tc_layers"],
                device_ms=r["device_ms"])
        if k == "ssd_scan":
            # device time by pass (the profiler), and the bound at the CUDA
            # cores' fp32 rate beside bound_ms at the TF32 rate
            kernels[-1].update(device_ms=r["device_ms"],
                               device_ms_by_pass=r["device_ms_by_pass"],
                               bound_fp32_ms=r["bound_fp32_ms"])
        if k == "conv1d_int8":
            # launches on the tensor-core kernel, and the tick's five
            # layers' device time
            kernels[-1].update(tc_launches=paths.total["conv1d_int8_tc"],
                               device_ms=r["device_ms"])
        if k in ("banded_align", "levenshtein"):
            # the lane plan and device time at the mapper's (the demux's)
            # shape
            kernels[-1].update(device_ms=r["device_ms"], plan=r["plan"])
        if k == "banded_align":
            # the pathogen panel compare's shape, beside the mapper's
            kernels[-1]["firehose"] = firehose
        if k in long_lm:
            # prefill_32k's length, beside the 1 x 4096 path shape
            kernels[-1]["at_32768"] = {
                f: long_lm[k][f] for f in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms", "plain_rows")
                if f in long_lm[k]}
    for k in kernels:
        require(k["launches"] > 0, f"kernel {k['name']} never launched")
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
