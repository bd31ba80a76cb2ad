#!/usr/bin/env python3
"""Design alternatives of the port's redesigned kernels, timed against the
sound kernels on one card: the two wgmma kernels at the LM prefill's
shapes, the tensor-core conv1d at the flowcell tick's.

    python3 scripts/kernel_variants.py [--reps 3] [--only gemm|flash|conv]

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

``conv1d`` variants run the tick's conv2-conv5 (512 lanes x chunk 256,
the paper's CNN, stream carries):

  tf32x1            hi x hi only: one TF32 pass (its max_abs_err shows why
                    the kernel takes three)
  split_x_at_staging  x split into hi and lo planes as each slice lands,
                    not as fragments load
  stages_3          a 3-stage cp.async ring (one block an SM, not two)
  one_sum           every product summed on the tensor cores into one
                    accumulator, with no per-slice partial sums

Every variant but ``no_epilogue`` is also held to the plain version
(``max_abs_err``).  Rounds of all variants repeat ``--reps`` times, the
sound kernel first in each.  Prints one JSON line per variant and round,
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
FLASH = {
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", choices=("gemm", "flash", "conv"))
    args = ap.parse_args()
    runs = {args.only} if args.only else {"gemm", "flash", "conv"}
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
    gemm = [("sound", sound)] + [
        (n, variant_csrc(sound, n, "matmul.cu", p)) for n, p in GEMM.items()]
    flash = [("sound", sound)] + [
        (n, variant_csrc(sound, n, "flash_attention.cu", p))
        for n, p in FLASH.items()]
    conv = [("sound", sound)] + [
        (n, variant_csrc(sound, f"conv1d_{n}", "conv1d.cu", p))
        for n, p in CONV.items()]
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
    for rnd in range(args.reps):
        emit({"phase": "round", "round": rnd})
        if "gemm" in runs:
            gemm_round(torch, cs, _build, gemm, data)
        if "flash" in runs:
            flash_round(torch, cs, _build, flash, q, k, v, want, abs_attn)
        if "conv" in runs:
            conv_round(torch, cs, _build, conv, layers)
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
