#!/usr/bin/env python3
"""Design alternatives of the port's redesigned kernels, timed against the
sound kernels on one card: the two wgmma kernels at the LM prefill's
shapes, the tensor-core conv1d and the fused fp32 tick at the flowcell
tick's.

    python3 scripts/kernel_variants.py [--reps 3]
        [--only gemm|flash|conv|fused] [--variants NAME,...]

Each variant is a patched copy of ``src/repro_torch/kernels/csrc`` built
under ``build/variants/<name>/`` (the checkout's sources are not touched)
and run through the port's own wrappers.  ``matmul_bf16`` variants run the
three qwen3-4b MLP GEMMs at 4,096 tokens (gate + silu, up, down):

  no_epilogue       the consumers store nothing (the mainloop alone)
  act_per_element   the activation chosen per element at run time, not a
                    template argument
  four_byte_stores  each thread stores its two columns as 4 bytes, with no
                    exchange across the quad
  tile_128x128      128 x 128 tiles, 6 stages (twice the tiles)
  stages_3          a 3-stage ring
  group_16          16 tile rows a group in the persistent order

``flash_attention`` variants run qwen3-4b's 1 x 32/8 x 4096 x 128 causal:

  libm_exp2         exp2f instead of ex2.approx.ftz
  pingpong          named barriers make the two consumer warpgroups take
                    turns to issue their wgmma
  flat_1d           every block on the grid's x, decoded as tile * heads +
                    head by a division and a remainder
  grid_3d           one launch, tiles on y continued on z, the tail's
                    blocks returning at once
  grid_2d           one launch, tiles on y alone (at most 65,535 tiles)

``conv1d`` variants run the tick's conv2-conv5 (512 lanes x chunk 256,
the paper's CNN, stream carries):

  tf32x1            hi x hi only: one TF32 pass (its max_abs_err shows why
                    the kernel takes three)
  split_x_at_staging  x split into hi and lo planes as each slice lands,
                    not as fragments load
  stages_3          a 3-stage cp.async ring (one block an SM, not two)
  one_sum           every product summed on the tensor cores into one
                    accumulator, with no per-slice partial sums

``fused_stream`` variants run the whole tick (512 lanes x chunk 256, the
paper's CNN: fp32, conv2-conv5 on the tensor cores, and its edge_int8
form, whose kernel the patches below leave as it is):

  ring_2            B through a two-stage cp.async ring of raw weight
                    slices in shared memory (placed past the plan's
                    regions by the launcher: one lane an SM), not from L2
  ring_1            the same ring with one stage
  cvt_split         the 3xTF32 split by cvt.rna.tf32 (mma.cuh split_tf32),
                    not by integer adds and masks
  warps_16          sixteen warps a block (at most 3 n-tiles a warp), one
                    block an SM
  nt_3              at most 3 n-tiles of 8 channels a warp, not 4

and, for timing what each part of the work costs (their results are
wrong, and say so in ``lanes_differing_above_margin``):

  tf32x1            hi x hi only, one product a k-step
  no_split          operands fed whole as hi and lo, no split
  b_smem            B read from shared memory, not L2
  tc_only           the CUDA-core layers (conv1, the head) and the
                    collapse skipped
  a_once            A loaded (and so split) at each slice's first tap only

Every variant but ``no_epilogue`` is also held to the plain version
(``max_abs_err``).  Rounds of all variants repeat ``--reps`` times, the
sound kernel first in each and again last (``sound_last``: what a place in
the round alone moves).  Prints one JSON line per variant and round,
then the library calls (cuBLAS, SDPA, cuDNN with TF32 off).  Needs a CUDA card; exits 2
without one.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "variants")
EPILOGUE_ROW = "      const int row = tm * MW_BM + wg * 64 + wl * 16 + g;\n"
QUAD_STORES = EPILOGUE_ROW + """#pragma unroll
      for (int j = 0; j < MW_BN / 32; ++j) {"""
FOUR_BYTE_STORES = EPILOGUE_ROW + """#pragma unroll
      for (int i = 0; i < MW_BN / 8; ++i) {
        const int col = tn * MW_BN + i * 8 + 2 * t4;
        if (col >= N) continue;
        float b0 = 0.f, b1 = 0.f;
        if (bias != nullptr) {
          b0 = __bfloat162float(bias[col]);
          b1 = __bfloat162float(bias[col + 1]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row + 8 * h;
          const float v0 = acc[4 * i + 2 * h] + b0;
          const float v1 = acc[4 * i + 2 * h + 1] + b1;
          if (r < M)
            *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(r) * N +
                                         col) =
                pack_bf16(activate(v0, ACT), activate(v1, ACT));
        }
      }
      for (int j = 0; j < 0; ++j) {"""
KT = "      const uint8_t* kt = ks + s * S::KV_BYTES;\n"
PP_SYNC = 'asm volatile("bar.sync %0, 256;" :: "r"(1 + wg) : "memory");\n'
PP_ARRIVE = ('asm volatile("bar.arrive %0, 256;" :: "r"(2 - wg) : '
             '"memory");\n')
GEMM = {
    "no_epilogue": [(EPILOGUE_ROW, "      if (K > 0) continue;\n"
                     + EPILOGUE_ROW)],
    "act_per_element": [
        (EPILOGUE_ROW, EPILOGUE_ROW
         + "      const int act_rt = M >= 0 ? ACT : 0;\n"),
        ("activate(v0, ACT), activate(v1, ACT)",
         "activate(v0, act_rt), activate(v1, act_rt)")],
    "four_byte_stores": [(QUAD_STORES, FOUR_BYTE_STORES)],
    "tile_128x128": [("constexpr int MW_BN = 256;",
                      "constexpr int MW_BN = 128;"),
                     ("constexpr int MW_STAGES = 4;",
                      "constexpr int MW_STAGES = 6;")],
    "stages_3": [("constexpr int MW_STAGES = 4;",
                  "constexpr int MW_STAGES = 3;")],
    "group_16": [("constexpr int MW_GROUP_M = 8;",
                  "constexpr int MW_GROUP_M = 16;")],
}
FA_DECODE = """\
  // top: this launch's first query tile, counted from the start
  const int q0 = (top - static_cast<int>(blockIdx.y)) * FA_BQ;
"""
FA_GRID = """\
  const int tiles = (sq + FA_BQ - 1) / FA_BQ;
  for (int y0 = 0; y0 < tiles; y0 += 65535) {
    const dim3 grid(b * hq, tiles - y0 < 65535 ? tiles - y0 : 65535);
    flash_attention_kernel<D><<<grid, FA_THREADS, FaShape<D>::SMEM,
                                stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(out), hq, hkv, sq, skv,
        scale, causal, tiles - 1 - y0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;"""
FA_PARAMS = "int sq, int skv, float scale, int causal, int top) {"
FA_BH = "  const int bh = blockIdx.x;"
FA_END = "  return static_cast<int>(cudaGetLastError());"
FLASH = {
    "flat_1d": [
        (FA_PARAMS, "int sq, int skv, float scale, int causal, int nbh) {"),
        (FA_BH, "  const int bh = static_cast<int>(blockIdx.x % nbh);"),
        (FA_DECODE, """\
  const int tiles = (sq + FA_BQ - 1) / FA_BQ;
  const int q0 = (tiles - 1 - static_cast<int>(blockIdx.x / nbh)) * FA_BQ;
"""),
        (FA_GRID, """\
  const long long blocks =
      static_cast<long long>(b) * hq * ((sq + FA_BQ - 1) / FA_BQ);
  flash_attention_kernel<D><<<static_cast<unsigned>(blocks), FA_THREADS,
                              FaShape<D>::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), hq, hkv, sq, skv, scale,
      causal, b * hq);
""" + FA_END)],
    "grid_3d": [
        (FA_PARAMS, "int sq, int skv, float scale, int causal) {"),
        (FA_DECODE, """\
  const int tiles = (sq + FA_BQ - 1) / FA_BQ;
  const int tile = blockIdx.z * gridDim.y + blockIdx.y;
  if (tile >= tiles) return;  // the last z slice's tail
  const int q0 = (tiles - 1 - tile) * FA_BQ;
"""),
        (FA_GRID, """\
  const int tiles = (sq + FA_BQ - 1) / FA_BQ;
  const int ty = tiles < 65535 ? tiles : 65535;
  const dim3 grid(b * hq, ty, (tiles + ty - 1) / ty);
  flash_attention_kernel<D><<<grid, FA_THREADS, FaShape<D>::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), hq, hkv, sq, skv, scale,
      causal);
""" + FA_END)],
    "grid_2d": [
        (FA_PARAMS, "int sq, int skv, float scale, int causal) {"),
        (FA_DECODE, """\
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FA_BQ;
"""),
        (FA_GRID, """\
  const dim3 grid(b * hq, (sq + FA_BQ - 1) / FA_BQ);
  flash_attention_kernel<D><<<grid, FA_THREADS, FaShape<D>::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), hq, hkv, sq, skv, scale,
      causal);
""" + FA_END)],
    "libm_exp2": [(
        '  float y;\n'
        '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n'
        "  return y;", "  return exp2f(x);")],
    "pingpong": [
        ("    mbar_wait(&q_full, 0);\n", "    mbar_wait(&q_full, 0);\n"
         '    if (wg == 1) asm volatile("bar.arrive 1, 256;" ::: '
         '"memory");\n'),
        (KT + "      wgmma_fence();",
         KT + "      " + PP_SYNC + "      wgmma_fence();"),
        ("      wgmma_commit();\n      fence_regs(s_acc);",
         "      wgmma_commit();\n      " + PP_ARRIVE
         + "      fence_regs(s_acc);"),
        ("      fence_regs(o);\n      wgmma_fence();",
         "      " + PP_SYNC + "      fence_regs(o);\n      wgmma_fence();"),
        ("      wgmma_commit();\n      fence_regs(o);",
         "      wgmma_commit();\n      if (wg == 0 || kb < last_k) "
         + PP_ARRIVE + "      fence_regs(o);")],
}
# the fused tick's tensor-core layer, patched (csrc/fused_stream.cu)
FS_B_FROM_L2 = """\
      const float* bb = w + static_cast<size_t>(sl * 8 + t4) * cout + n0 + g;
      const int tap_step = cin * cout, half = 4 * cout;
"""
FS_B_LOADS = """\
          wv[nt][0] = __ldg(wb + nt * 8);
          wv[nt][1] = __ldg(wb + half + nt * 8);
"""
FS_ITEMS = "  for (int it = warp; it < items; it += FS_WARPS) {\n"
FS_EPILOGUE = "    // bias and activation, stored in the next layer's layout\n"
FS_SMEM = "  const size_t smem = static_cast<size_t>(smem_bytes);\n"
FS_NT4 = "        default: tc_layer<4>(L, in, o, t_out, tid); return;\n"
FS_PICK = "  for (int nt : {1, 2, 3, 4}) {\n"
FS_A_SPLIT = "split_tf32_int(xa[mt][e], ah[mt][e], al[mt][e]);"
FS_B_SPLIT = ("          split_tf32_int(wk[nt][0], bh0, bl0);\n"
              "          split_tf32_int(wk[nt][1], bh1, bl1);\n")


def fs_ring(stages: int):
    """B through a cp.async ring of ``stages`` raw weight slices (K taps x 8
    input channels x Cout, rows padded by 8 floats), which the launcher
    places past the plan's regions; every warp of the block stages each
    slice, so the idle warps of a pass keep to the block's barriers."""
    ring = f"""\
  extern __shared__ __align__(16) float fs_ring_smem[];
  float* ring = fs_ring_smem + L.scratch_off;  // the launcher's ring offset
  const int WP = cout + 8, stage_f = K * 8 * WP;
  auto stage = [&](int sl) {{
    float* dst = ring + (sl % {stages}) * stage_f;
    for (int row = warp; row < K * 8; row += FS_WARPS) {{
      const float* src =
          w + (static_cast<size_t>(row >> 3) * cin + sl * 8 + (row & 7)) * cout;
      for (int c = lane; c < cout / 4; c += 32)
        cp_async16(dst + row * WP + 4 * c, src + 4 * c, true);
    }}
  }};
  for (int it0 = 0; it0 < items; it0 += FS_WARPS) {{
    const int it = it0 + warp;
    const bool active = it < items;
    __syncthreads();  // the ring's previous pass is consumed
    if ({stages} > 1) stage(0);
    cp_async_commit();
"""
    slice_ = f"""\
      if ({stages} == 1) {{
        if (sl > 0) __syncthreads();  // slice sl - 1 is consumed
        stage(sl);
        cp_async_commit();
      }}
      cp_async_wait<0>();
      __syncthreads();  // slice sl landed; slice sl - 1 is consumed
      if ({stages} > 1) {{
        if (sl + 1 < slices) stage(sl + 1);
        cp_async_commit();
      }}
      const float* bb = ring + (sl % {stages}) * stage_f + t4 * WP + n0 + g;
      const int tap_step = 8 * WP, half = 4 * WP;
      if (!active) continue;
"""
    launch = f"""\
  // the ring past the plan's regions, in each tensor-core layer's scratch
  const int ring_off = (smem_bytes / 4 + 3) / 4 * 4;
  int ring_f = 0;
  for (int l = 0; l < n_layers; ++l) {{
    FsLayer& L = p.layers[l];
    if (!L.tc) continue;
    if (reinterpret_cast<uintptr_t>(L.w) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    L.scratch_off = ring_off;
    ring_f = std::max(ring_f, {stages} * L.K * 8 * (L.cout + 8));
  }}
  const size_t smem = static_cast<size_t>(ring_off + ring_f) * 4;
"""
    return [(FS_ITEMS, ring), (FS_B_FROM_L2, slice_),
            (FS_B_LOADS, "          wv[nt][0] = wb[nt * 8];\n"
                         "          wv[nt][1] = wb[half + nt * 8];\n"),
            (FS_EPILOGUE, "    if (!active) continue;\n" + FS_EPILOGUE),
            (FS_SMEM, launch)]


NT_3 = [(FS_PICK, "  for (int nt : {1, 2, 3}) {\n"),
        (FS_NT4, "        default: return;\n")]
FUSED = {
    "ring_2": fs_ring(2),
    "ring_1": fs_ring(1),
    "cvt_split": [(FS_A_SPLIT, "split_tf32(xa[mt][e], ah[mt][e], al[mt][e]);"),
                  (FS_B_SPLIT, FS_B_SPLIT.replace("split_tf32_int",
                                                  "split_tf32"))],
    "warps_16": [("constexpr int FS_WARPS = 8;",
                  "constexpr int FS_WARPS = 16;"),
                 ("constexpr int FS_BLOCKS = 2;",
                  "constexpr int FS_BLOCKS = 1;")] + NT_3,
    "nt_3": NT_3,
    "tf32x1": [("mma_tf32_1688(part[mt][nt], al[mt], bh0, bh1);", ";"),
               ("mma_tf32_1688(part[mt][nt], ah[mt], bl0, bl1);", ";")],
    "no_split": [(FS_A_SPLIT, "ah[mt][e] = al[mt][e] = "
                              "__float_as_uint(xa[mt][e]);"),
                 (FS_B_SPLIT, "          bh0 = bl0 = __float_as_uint("
                              "wk[nt][0]);\n          bh1 = bl1 = "
                              "__float_as_uint(wk[nt][1]);\n")],
    "b_smem": [(FS_B_LOADS,
                "          wv[nt][0] = in[(k * 64 + nt * 8 + lane) & 1023];\n"
                "          wv[nt][1] = in[(k * 64 + nt * 8 + lane + 32) & "
                "1023];\n")],
    "tc_only": [
        ("  if (L.cout % 4 == 0 && reinterpret_cast<uintptr_t>(L.w) % 16 == 0)"
         "\n    conv_layer<4, 4>(L, in, o, t_out, tid, nt);",
         "  if constexpr (!INT8) return;\n"
         "  if (L.cout % 4 == 0 && reinterpret_cast<uintptr_t>(L.w) % 16 == 0)"
         "\n    conv_layer<4, 4>(L, in, o, t_out, tid, nt);"),
        ("  if (tid == 0) {\n    int prev", "  if (tid == 0 && INT8) {\n"
                                           "    int prev")],
    "a_once": [("          load_a(k + 1, nq, xa);\n", "")],
}
CONV = {
    "tf32x1": [("constexpr int TC_PASSES = 3;", "constexpr int TC_PASSES = 1;")],
    "split_x_at_staging": [
        ("constexpr bool TC_SPLIT_X_AT_STAGING = false;",
         "constexpr bool TC_SPLIT_X_AT_STAGING = true;")],
    "stages_3": [("constexpr int TC_STAGES = 2;",
                  "constexpr int TC_STAGES = 3;")],
    "one_sum": [
        ("mma_tf32_1688(part[mt][nt], al[mt], bh0, bh1);",
         "mma_tf32_1688(acc[mt][nt], al[mt], bh0, bh1);"),
        ("mma_tf32_1688(part[mt][nt], ah[mt], bl0, bl1);",
         "mma_tf32_1688(acc[mt][nt], ah[mt], bl0, bl1);"),
        ("mma_tf32_1688(part[mt][nt], ah[mt], bh0, bh1);",
         "mma_tf32_1688(acc[mt][nt], ah[mt], bh0, bh1);"),
        ("for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];",
         "for (int e = 0; e < 4; ++e) (void)part[mt][nt][e];")],
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def patch(text: str, name: str, patches) -> str:
    """``text`` with ``patches`` (old, new) applied; each old string must
    occur exactly once."""
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old[:60]!r} found "
                               f"{text.count(old)} times in the source")
        text = text.replace(old, new)
    return text


def variant_csrc(src: str, name: str, file: str, patches) -> str:
    """A copy of the kernel sources with ``patches`` applied to ``file``."""
    dst = os.path.join(OUT, name, "csrc")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    path = os.path.join(dst, file)
    with open(path) as f:
        text = patch(f.read(), name, patches)
    with open(path, "w") as f:
        f.write(text)
    return dst


def use(build, name: str, csrc: str) -> None:
    """Point the kernel builder at ``csrc`` and its own library folder."""
    from pathlib import Path
    build._CSRC = Path(csrc)
    build.BUILD_DIR = Path(OUT) / name / "lib"
    build._LIBS.clear()


def gemm_round(torch, cs, build, variants, data):
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import ref
    for name, csrc in variants:
        use(build, name, csrc)
        line = {"phase": "variant", "kernel": "matmul_bf16", "variant": name}
        for label, a, w, act in data:
            out = km.matmul_bf16(a, w, activation=act)
            if name != "no_epilogue":
                want = ref.matmul(a, w, activation=act)
                line[f"{label}_max_abs_err"] = (
                    out.float() - want.float()).abs().max().item()
                del want
            line[f"{label}_ms"] = cs.time_ms(
                torch, lambda: km.matmul_bf16(a, w, activation=act), reps=10)
        emit(line)


def flash_round(torch, cs, build, variants, q, k, v, want, abs_attn):
    from repro_torch.kernels import flash_attention as kfa
    for name, csrc in variants:
        use(build, name, csrc)
        out = kfa.flash_attention(q, k, v, causal=True)
        emit({"phase": "variant", "kernel": "flash_attention",
              "variant": name, "err_over_bar": cs.flash_excess(
                  out, want, abs_attn), "ms": cs.time_ms(
                  torch, lambda: kfa.flash_attention(q, k, v, causal=True),
                  reps=10)})


def conv_layers(torch, dev):
    """The tick's conv2-conv5 inputs (``[carry | chunk]`` rows, relu'd
    like a layer's input) and He-scaled weights, seeded."""
    from repro_torch.core import basecaller as bc
    gen = torch.Generator(dev).manual_seed(5)
    out, t = [], 256
    for sp in bc.stream_layer_specs(bc.BasecallerConfig()):
        if sp.name != "conv1" and not sp.is_head:
            x = torch.randn((512, t + sp.carry_rows, sp.cin), generator=gen,
                            device=dev).abs()
            w = torch.randn((sp.ksize, sp.cin, sp.cout), generator=gen,
                            device=dev) * (2.0 / (sp.ksize * sp.cin)) ** 0.5
            b = torch.randn((sp.cout,), generator=gen, device=dev) * 0.1
            out.append((sp.name, x, w, b, sp.stride))
        t //= sp.stride
    return out


def conv_round(torch, cs, build, variants, layers):
    from repro_torch.kernels import conv1d as kc
    from repro_torch.kernels import ref
    for name, csrc in variants:
        use(build, name, csrc)
        line = {"phase": "variant", "kernel": "conv1d", "variant": name}
        for label, x, w, b, s in layers:
            before = kc.conv1d.tc_launches
            out = kc.conv1d(x, w, b, stride=s, activation="relu")
            assert kc.conv1d.tc_launches == before + 1, name
            want = ref.conv1d(x, w, b, stride=s, activation="relu")
            line[f"{label}_max_abs_err"] = (out - want).abs().max().item()
            line[f"{label}_ms"] = cs.time_ms(
                torch, lambda: kc.conv1d(x, w, b, stride=s,
                                         activation="relu"), reps=10)
        emit(line)


def fused_round(torch, cs, build, variants, cfg, params, qparams, inputs):
    """The fused tick on each variant: fp32 tokens against the plain
    version away from near ties (as chip_smoke.check_fused), carries' max
    abs error, event and device ms; the int8 tick's ms."""
    from repro_torch.core import basecaller as bc
    from repro_torch.kernels import fused_stream as fs
    rows, pads, reset, prev, bases, ticks, conv = inputs
    args = (rows, pads, reset, prev, bases, ticks, conv, params)
    qargs = (*args[:-1], qparams)
    tok_p, lens_p, lane_p = fs._fused_reference(*args, cfg=cfg)
    logits = cs.plain_logits(torch, bc, params, cfg, rows, reset, conv)
    tie = ((cs.top2_margin(torch, logits) < 1e-4) & (pads <= 0)).any(dim=1)
    for name, csrc in variants:
        use(build, name, csrc)
        tok, lens, lane = fs.fused_stream_cuda(*args, cfg=cfg)
        differ = (tok != tok_p).any(dim=1) | (lens != lens_p)
        emit({"phase": "variant", "kernel": "fused_stream", "variant": name,
              "lanes_differing_above_margin": int((differ & ~tie).sum()),
              "carry_max_abs_err": max(
                  (a - b).abs().max().item()
                  for a, b in zip(lane["conv"], lane_p["conv"]) if a.numel()),
              "ms": cs.time_ms(
                  torch, lambda: fs.fused_stream_cuda(*args, cfg=cfg)),
              "device_ms": cs.device_ms(
                  torch, lambda: fs.fused_stream_cuda(*args, cfg=cfg)),
              "int8_ms": cs.time_ms(
                  torch, lambda: fs.fused_stream_cuda(*qargs, cfg=cfg))})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", default="",
                    help="comma-separated variant names to run (all if "
                         "empty); the sound kernel always runs")
    ap.add_argument("--only", choices=("gemm", "flash", "conv", "fused"))
    args = ap.parse_args()
    runs = ({args.only} if args.only
            else {"gemm", "flash", "conv", "fused"})
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import _build
    from repro_torch.kernels import ref
    ref.full_fp32()
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    emit({"phase": "card", "nvidia_smi": smi})
    sound = str(_build._CSRC)
    pick = set(filter(None, args.variants.split(",")))

    def variants(table, prefix, file):
        return [("sound", sound)] + [
            (n, variant_csrc(sound, prefix + n, file, p))
            for n, p in table.items() if not pick or n in pick] + [
            ("sound_last", sound)]

    gemm = variants(GEMM, "", "matmul.cu")
    flash = variants(FLASH, "", "flash_attention.cu")
    conv = variants(CONV, "conv1d_", "conv1d.cu")
    fused = variants(FUSED, "fused_", "fused_stream.cu")
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(3)
    cfg = ARCHS["qwen3-4b"].config()
    d, ff, s_len = cfg.d_model, cfg.d_ff, cs.LM_SEQ
    a = torch.randn((s_len, d), generator=gen, device=dev).bfloat16()
    wg = (torch.randn((d, ff), generator=gen, device=dev) * d ** -0.5
          ).bfloat16()
    h = (torch.randn((s_len, ff), generator=gen, device=dev) * 0.5
         ).bfloat16()
    wo = (torch.randn((ff, d), generator=gen, device=dev) * ff ** -0.5
          ).bfloat16()
    data = [("gate", a, wg, "silu"), ("up", a, wg, "none"),
            ("down", h, wo, "none")]
    q = torch.randn((1, cfg.num_heads, s_len, cfg.head_dim), generator=gen,
                    device=dev).bfloat16()
    k, v = (torch.randn((1, cfg.num_kv_heads, s_len, cfg.head_dim),
                        generator=gen, device=dev).bfloat16()
            for _ in range(2))
    want = ref.attention(q, k, v, causal=True)
    abs_attn = ref.attention(q, k, v.abs(), causal=True)
    layers = conv_layers(torch, dev)
    from repro_torch.core import basecaller as bc
    fcfg = bc.BasecallerConfig()
    from repro_torch.engine.base import quantize_edge_params
    fparams = bc.init(torch.Generator().manual_seed(0), fcfg, device="cpu")
    fqparams = bc.params_to(quantize_edge_params(fparams, fcfg, chunk=512),
                            dev)
    fparams = bc.params_to(fparams, dev)
    finputs = cs.fused_inputs(torch, bc, fcfg, 512, 256,
                              torch.Generator().manual_seed(1), dev)
    for rnd in range(args.reps):
        emit({"phase": "round", "round": rnd})
        if "gemm" in runs:
            gemm_round(torch, cs, _build, gemm, data)
        if "flash" in runs:
            flash_round(torch, cs, _build, flash, q, k, v, want, abs_attn)
        if "conv" in runs:
            conv_round(torch, cs, _build, conv, layers)
        if "fused" in runs:
            fused_round(torch, cs, _build, fused, fcfg, fparams, fqparams,
                        finputs)
    use(_build, "sound", sound)
    F = torch.nn.functional
    lib = {}
    if "gemm" in runs:
        lib["cublas_ms"] = {
            label: cs.time_ms(torch, (lambda a=a, w=w, act=act: F.silu(
                torch.matmul(a, w)) if act == "silu" else torch.matmul(a, w)),
                reps=10)
            for label, a, w, act in data}
    if "flash" in runs:
        lib["sdpa_ms"] = cs.sdpa_ms(torch, F, q, k, v)
    if "conv" in runs:
        # cuDNN in PyTorch's layout, TF32 off (ref.full_fp32), as phase 2
        lib["cudnn_ms"] = {
            label: cs.time_ms(torch, (lambda xt=x.permute(0, 2, 1).contiguous(),
                                      wt=w.permute(2, 1, 0).contiguous(), b=b,
                                      s=s: F.relu(F.conv1d(xt, wt, b,
                                                           stride=s))),
                              reps=10)
            for label, x, w, b, s in layers}
    emit({"phase": "library", **lib})
    return 0


if __name__ == "__main__":
    sys.exit(main())
