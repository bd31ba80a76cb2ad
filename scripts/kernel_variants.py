#!/usr/bin/env python3
"""Design alternatives of the port's redesigned kernels, timed against the
sound kernels on one card: the two wgmma kernels and ssd_scan at the LM
prefill's shapes, the tensor-core conv1d (fp32 and int8) and the fused
fp32 and int8 ticks at the flowcell tick's, the wavefront DP at the
mapper's, the pathogen firehose's and the demux's.

    python3 scripts/kernel_variants.py [--reps 3]
        [--only gemm|flash|flash_f32|conv|fused|ssd|banded|narrow]
        [--variants NAME,...]

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

``flash_attention_tf32x3`` variants (``--only flash_f32``) run qwen3-4b's
attention in f32 (1 x 32/8 x 4096 x 128, causal), the route of row 5g;
the CUDA-core kernel and SDPA f32 beside them:

  wgmma_one_acc_s   the wgmma .tf32 kernel (the route's here) with S's
                    small terms in hi x hi's accumulator
  wgmma_one_acc_o   the wgmma kernel with each tile's P V summed into O
                    in the tensor cores' accumulator, no fresh one
  split_per_warp    the mma.sync kernel's first design: every warp splits
                    the K and V values it reads as their fragments load
                    (64-key raw tiles through a two-stage cp.async ring),
                    S and P V each summed in one accumulator
  tf32x1            the mma.sync kernel with hi x hi only: one TF32
                    product a k-step (its error shows why it takes three)
  one_acc_s         the mma.sync kernel with S's small terms summed into
                    hi x hi's accumulator
  one_acc_o         the mma.sync kernel with each tile's P V summed into
                    O, not a fresh accumulator
  bk_32             the mma.sync kernel with 32-key K/V tiles, not 48

``conv1d`` variants run the tick's conv2-conv5 (512 lanes x chunk 256,
the paper's CNN, stream carries):

  tf32x1            hi x hi only: one TF32 pass (its max_abs_err shows why
                    the kernel takes three)
  split_x_at_staging  x split into hi and lo planes as each slice lands,
                    not as fragments load
  stages_3          a 3-stage cp.async ring (one block an SM, not two)
  one_sum           every product summed on the tensor cores into one
                    accumulator, with no per-slice partial sums

``conv1d_int8`` variants run the tick's conv2-conv5 (512 lanes x chunk
256, int8, seeded), each held to the plain version bit for bit:

  dp4a              the layers on the CUDA cores (__dp4a), as the parent
                    ran them: the predicate turned off in Python, the
                    kernel the sound one
  b_l2              B fragments read from L2 at each k-step, not staged
                    per slice in shared memory
  ldmatrix          A fragments by ldmatrix.x4, not four 4-byte loads
  bn_32             32 output channels a block where the sound kernel
                    takes 64

``banded_align`` variants run the mapper's call (2,048 pairs, 48 vs 80,
band 32, local), the pathogen firehose (39,680 pairs, 256 vs 512, local)
and the demux (6,144 pairs of 12 vs 12, levenshtein), bitwise:

  thread_per_pair   the parent's kernel: one thread a pair, the row-scan
                    DP with its row and query in shared memory (kept only
                    here)
  dpx_off           each cell's add-max as a plain add and max, not the
                    DPX __viaddmax_s32
  warps_4, warps_8  4 or 8 warps a block, not 2
  rows_target_2, rows_target_8  lanes aiming at 2 or 8 rows each (the
                    plan set in Python; the mapper 32 x 2 or 8 x 6)
  rows_max_4        stripes of at most 32 x 4 rows (the firehose's 256 in
                    two)

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

``fused_stream_int8`` variants run the edge_int8 tick (the same CNN,
calibrated by ``quantize_edge_params``), held to the plain version bit for
bit (``equal_to_plain_bitwise``):

  dp4a              conv2-conv5 on the CUDA cores (__dp4a), as the parent
                    ran them: the predicate turned off in Python, the
                    kernel the sound one
  prefetch          the k-steps flattened, A loaded one step ahead and B
                    two
  threads_256       256 threads a lane, not 512
  threads_1024      1,024 threads a lane
  unroll_k2         the tensor-core layers' tap loop unrolled by two
  unroll_ci4        the CUDA-core int8 layers' channel loop unrolled by
                    four

and, timing only (wrong results): ``cuda_layers_off`` (conv1 and the head
skipped), ``mma_off`` (the MMAs replaced by an XOR of the fragments),
``b_smem`` (B read from shared memory, not L2), ``quant_off`` (the
tensor-core layers' quantization skipped).

``ssd_scan`` variants run mamba2-780m's 48 heads x 4096 (B/C one row over
the heads), bf16 and f32, each pass's device time by the profiler:

  cuda_cores        the parent's passes 1 and 3: f32 fmaf register tiles
                    fed from shared memory (the kernel this design
                    replaced, kept only here)
  g_registers       pass 3 with G kept in registers: its accumulator
                    re-laid as G' X's A fragment (k order permuted), each
                    warp's part of y over its 32 columns of s added at the
                    end, no trip through shared memory
  bf16_mma          pass 3 on bf16 m16n8k16 (twice TF32's rate a
                    product): an f32 operand split in three bf16 parts, the
                    products of parts (i, j) with i + j <= 2
  heads_2           pass 3 with two heads a block and C B^T formed once
                    for both (valid where B/C are one row over the heads
                    and B * H is even, as at the path's shape)

``narrow`` variants run the decode (narrow-M) kernels at M = 8, the
``full`` preset's slots: ``matmul_int8`` at qwen3-4b's seven decode
projections (bitwise) and ``matmul_bf16`` at its three MLP GEMMs (one
ulp), device ms of each set:

  int8_no_l1        the int8 weights read with L1::no_allocate (the bf16
                    kernel's load), not through L1
  bf16_l1           the bf16 weights read through L1 (the int8 kernel's
                    load)
  depth_2           each warp's loads two steps ahead of its products
  wk_4              blocks of 4 warps splitting K, not 2
  wn_2              blocks of 2 x 2 warps, 256 columns each, not 1 x 2
  splits_8          at most 8 K splits a column tile (the Python split;
                    the kernels as sound), not 16
  blocks_792, blocks_1056  up to 792 or 1,056 blocks (6 or 8 an SM) in
                    the Python split, not 528
  bf16_prefetch_0, bf16_prefetch_2  the bf16 kernel asking L2 for its
                    rows never or two steps ahead, not one
  bf16_prefetch_half  the bf16 kernel prefetching the first 128 bytes of
                    each row's 256 only
  int8_prefetch_1, int8_prefetch_2  the int8 kernel asking L2 for its
                    rows one or two steps ahead, not never

and, timing only (wrong results): ``no_split_sum``, the cluster's K
splits not added (rank 0 stores its own partial), and ``no_epilogue``
for the decode kernels, ``narrow_no_epilogue``: no partial leaves the
registers.

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
# the 3xTF32 flash kernel (csrc/flash_attention.cu), patched
TF_SHAPE = "template <int DP>\nstruct TfShape {"
TF_LAUNCH = "template <typename T, int DP>\nstatic int launch_tf32x3("
TF_S2 = ("          if constexpr (!EXACT) {\n"
         "            mma_tf32_1688(s2[n], al, bh0, bh1);\n"
         "            mma_tf32_1688(s2[n], ah,")
TF_PV = "      mma_split<false, EXACT>(acc[n], ah, al, bh0, bh1, bl0, bl1);"
TF_FRESH = "  static constexpr bool FRESH = DP <= 128;"
TF_BK = "  static constexpr int BK = DP <= 64 ? 64 : DP <= 128 ? 48 : 24;"
# the kernel's first design: every warp split the K and V values it read
# as their fragments loaded (a two-stage cp.async ring of raw 64-key
# tiles), and S and P V summed into one accumulator each
TF_SPLIT_PER_WARP = r"""template <int DP>
struct TfShape {
  static constexpr int BQ = DP <= 128 ? 128 : 64;  // query rows a block
  static constexpr int BK = DP <= 128 ? 64 : 32;   // keys a K / V tile
  static constexpr int THREADS = BQ / 16 * 32;     // a warp per 16 rows
  static constexpr int LD = DP + 4;                // floats a staged row
  static constexpr int Q_FLOATS = BQ * LD;
  static constexpr int KV_FLOATS = BK * LD;
  static constexpr int SMEM = 4 * (Q_FLOATS + 4 * KV_FLOATS);  // Q; K, V x 2
};

// Rows [r0, r0 + ROWS) of a (len, d) head into dst[ROWS][DP + 4] as f32,
// rows past len and columns d .. DP as zeros: f32 by cp.async (16-byte
// granules when `vec`, else 4-byte), 16-bit values (f16 when `f16`, else
// bf16) by loads widened as they are stored (eight in flight a thread).
template <typename T, int DP, int ROWS, int NT>
__device__ __forceinline__ void tf_stage(float* dst, const T* __restrict__ src,
                                         int r0, int len, int d, bool vec,
                                         int f16) {
  constexpr int LD = DP + 4;
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      constexpr int C4 = DP / 4;
      for (int i = threadIdx.x; i < ROWS * C4; i += NT) {
        const int r = i / C4, c = (i % C4) * 4;
        const bool ok = r0 + r < len && c < d;
        cp_async16(dst + r * LD + c,
                   ok ? src + static_cast<size_t>(r0 + r) * d + c : src, ok);
      }
    } else {
      for (int i = threadIdx.x; i < ROWS * DP; i += NT) {
        const int r = i / DP, c = i % DP;
        const bool ok = r0 + r < len && c < d;
        cp_async4(dst + r * LD + c,
                  ok ? src + static_cast<size_t>(r0 + r) * d + c : src, ok);
      }
    }
  } else {
    constexpr int N = ROWS * DP;
    for (int i0 = 0; i0 < N; i0 += 8 * NT) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = i0 + j * NT + static_cast<int>(threadIdx.x);
        const int r = i / DP, c = i % DP;
        v[j] = i < N && r0 + r < len && c < d
                   ? tf_load(src + static_cast<size_t>(r0 + r) * d + c, f16)
                   : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = i0 + j * NT + static_cast<int>(threadIdx.x);
        if (i < N) dst[(i / DP) * LD + i % DP] = v[j];
      }
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(TfShape<DP>::THREADS, 1)
flash_attention_tf32x3_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ out,
                              int bhs, int hq, int hkv, int sq, int skv, int d,
                              float scale, int causal, int vec, int f16,
                              long long block0, int tiles) {
  using S = TfShape<DP>;
  constexpr bool EXACT = !std::is_same<T, float>::value;
  constexpr int LD = S::LD, BK = S::BK, NT = S::THREADS;
  extern __shared__ __align__(16) float tf_smem[];
  float* qs = tf_smem;                   // [BQ][LD]
  float* ks = qs + S::Q_FLOATS;          // [2][BK][LD]
  float* vs = ks + 2 * S::KV_FLOATS;     // [2][BK][LD]

  const long long blk = block0 + blockIdx.x;
  const int bh = static_cast<int>(blk % bhs);
  // query tiles longest first: the block's tile counted from the last
  const int q0 = (tiles - 1 - static_cast<int>(blk / bhs)) * S::BQ;
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int offs = skv - sq;
  const int kend = causal ? min(skv, min(q0 + S::BQ, sq) + offs) : skv;
  const int nkt = (kend + BK - 1) / BK;
  const T* qh = q + static_cast<size_t>(bh) * sq * d;
  const T* kh = k + static_cast<size_t>(kvh) * skv * d;
  const T* vh = v + static_cast<size_t>(kvh) * skv * d;

  tf_stage<T, DP, S::BQ, NT>(qs, qh, q0, sq, d, vec, f16);
  tf_stage<T, DP, BK, NT>(ks, kh, 0, skv, d, vec, f16);
  tf_stage<T, DP, BK, NT>(vs, vh, 0, skv, d, vec, f16);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr0 = warp * 16;           // the warp's first row in the tile
  const int rw = q0 + wr0;             // ... in the head
  const int ra = rw + g;               // this thread's rows ra, ra + 8
  const int csteps = (d + 7) / 8;      // k-steps (and O's n-tiles) below D
  const float sl2 = scale * FA_LOG2E;  // logit to the exp2 domain

  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, exp2 domain
  float l[2] = {0.f, 0.f};

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    if (kt + 1 < nkt) {
      const int st = (kt + 1) & 1;
      tf_stage<T, DP, BK, NT>(ks + st * S::KV_FLOATS, kh, k0 + BK, skv, d, vec, f16);
      tf_stage<T, DP, BK, NT>(vs + st * S::KV_FLOATS, vh, k0 + BK, skv, d, vec, f16);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kb = ks + (kt & 1) * S::KV_FLOATS;
    const float* vb = vs + (kt & 1) * S::KV_FLOATS;
    // a warp whose 16 rows see no key of this tile (causal) skips it; key 0
    // is seen by every row, so the first tile makes every m finite
    if (!causal || k0 <= rw + 15 + offs) {
      // S = Q K^T on the warp's 16 rows x BK keys
      float s[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        if (kk >= csteps) break;
        uint32_t ah[4], al[4];
        load_a<!EXACT>(qs + (wr0 + g) * LD + 8 * kk + t4, LD, ah, al);
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          // B = K^T: element (k, n) at K row n, column k
          const float* pb = kb + (8 * n + g) * LD + 8 * kk + t4;
          uint32_t bh0, bl0, bh1, bl1;
          tf32_parts<!EXACT>(pb[0], bh0, bl0);
          tf32_parts<!EXACT>(pb[4], bh1, bl1);
          mma_split<EXACT, EXACT>(s[n], ah, al, bh0, bh1, bl0, bl1);
        }
      }
      // scaled logits in the exp2 domain; the mask where the tile needs it
      // (rows ra: e = 0, 1; ra + 8: e = 2, 3)
      const bool masked =
          k0 + BK > skv || (causal && k0 + BK - 1 > rw + offs);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float t = s[n][e] * sl2;
          if (masked) {
            const int row = ra + (e < 2 ? 0 : 8);
            const int col = k0 + 8 * n + 2 * t4 + (e & 1);
            const bool ok = col < skv && (!causal || col <= row + offs);
            s[n][e] = ok ? t : -INFINITY;
          } else {
            s[n][e] = t;
          }
        }
      // online softmax
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mx[r] = fmaxf(m[r], mx[r]);
        alpha[r] = ex2_ftz(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = ex2_ftz(s[n][e] - mx[e >> 1]);
          rs[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[r] = alpha[r] * l[r] + rs[r];
      }
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      // O += P V: k-step kk is S's n-tile kk, thread t holding keys 2t and
      // 2t + 1 as A's columns t and t + 4, so V's rows 2t and 2t + 1 are
      // the B fragment's
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        uint32_t ah[4], al[4];
        split_tf32_int(s[kk][0], ah[0], al[0]);  // (g,     key 2t)
        split_tf32_int(s[kk][2], ah[1], al[1]);  // (g + 8, key 2t)
        split_tf32_int(s[kk][1], ah[2], al[2]);  // (g,     key 2t + 1)
        split_tf32_int(s[kk][3], ah[3], al[3]);  // (g + 8, key 2t + 1)
        const float* pv = vb + (8 * kk + 2 * t4) * LD + g;
#pragma unroll
        for (int n = 0; n < DP / 8; ++n) {
          if (n >= csteps) break;
          uint32_t bh0, bl0, bh1, bl1;
          tf32_parts<!EXACT>(pv[8 * n], bh0, bl0);
          tf32_parts<!EXACT>(pv[LD + 8 * n], bh1, bl1);
          mma_split<false, EXACT>(o[n], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
    __syncthreads();  // this stage is consumed: the next loads may land
  }

  T* oh = out + static_cast<size_t>(bh) * sq * d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    if (r >= sq) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      if (n >= csteps) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * n + 2 * t4 + e;
        if (c < d)
          tf_store(oh + static_cast<size_t>(r) * d + c, o[n][2 * h + e] / l[h],
                   f16);
      }
    }
  }
}

"""
TW_S2 = "        wgmma_tf32_ss<TW_BK>(s2, dqh, dkl, 1);\n"
TW_PV = """\
        wgmma_tf32_rs<TW_D>(ot, pl[kk], dvh, kk != 0);
        wgmma_tf32_rs<TW_D>(ot, ph[kk], dvl, 1);
        wgmma_tf32_rs<TW_D>(ot, ph[kk], dvh, 1);
"""
TW_OT = """\
      float ot[TW_D / 2];
#pragma unroll
      for (int i = 0; i < TW_D / 2; ++i) ot[i] = 0.f;
      fence_regs(ot);
"""
TW_O = """\
      fence_regs(ot);
      wgmma_wait<0>();
      fence_regs(ot);
#pragma unroll
      for (int i = 0; i < TW_D / 2; ++i)
        o[i] = o[i] * alpha[(i >> 1) & 1] + ot[i];
"""
FLASH_F32 = {
    # the wgmma .tf32 kernel (the route's at row 5g's shape): S's small
    # terms in hi x hi's accumulator, each k-step's three wgmma in one
    "wgmma_one_acc_s": [
        (TW_S2, TW_S2.replace("(s2, dqh", "(s, dqh")),
        ("        wgmma_tf32_ss<TW_BK>(s2, dql, dkh, kk != 0);\n",
         "        wgmma_tf32_ss<TW_BK>(s, dql, dkh, kk != 0);\n"),
        ("        wgmma_tf32_ss<TW_BK>(s, dqh, dkh, kk != 0);\n",
         "        wgmma_tf32_ss<TW_BK>(s, dqh, dkh, 1);\n")],
    # the wgmma kernel with each tile's P V summed into O (rescaled first)
    # in the tensor cores' accumulator, no fresh one
    "wgmma_one_acc_o": [
        (TW_OT, """\
#pragma unroll
      for (int i = 0; i < TW_D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      fence_regs(o);
"""),
        (TW_PV, TW_PV.replace("(ot,", "(o,").replace("kk != 0);", "1);")),
        ("      wgmma_commit();\n" + TW_O, """\
      wgmma_commit();
      fence_regs(o);
      wgmma_wait<0>();
      fence_regs(o);
""")],
    "split_per_warp": lambda text: [
        (between(text, TF_SHAPE, TF_LAUNCH), TF_SPLIT_PER_WARP)],
    # hi x hi only, one product a k-step (Q, K, V and P rounded to TF32):
    # its error shows why the kernel takes three
    "tf32x1": [(TF_S2, TF_S2.replace("(!EXACT)", "(false)")),
               (TF_PV, TF_PV.replace("<false, EXACT>", "<true, true>"))],
    # S's small terms summed into hi hi's accumulator, not their own
    "one_acc_s": [(TF_S2, TF_S2.replace("(s2[n]", "(s[n]"))],
    # each tile's P V summed into O, not into a fresh accumulator
    "one_acc_o": [(TF_FRESH, "  static constexpr bool FRESH = false;")],
    "bk_32": [(TF_BK, "  static constexpr int BK = DP <= 64 ? 64 : 32;")],
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

CONV_INT8 = {
    # conv2-conv5 on the CUDA cores (__dp4a), as the parent ran them: the
    # predicate is turned off in Python, the kernel is the sound one
    "dp4a": None,
    # B fragments read from L2 at each k-step, not staged per slice
    "b_l2": [
        ("  return TC_SUBS * stride * prow * I8_XP * 4 + K * bn * I8_CS;",
         "  return TC_SUBS * stride * prow * I8_XP * 4;"),
        ("  const int stage_words = x_words + K * BN * 8;",
         "  const int stage_words = x_words;"),
        ("    for (int i = tid; i < K * 2 * BN; i += TC_THREADS) {",
         "    for (int i = tid; i < 0; i += TC_THREADS) {"),
        ("        b[nt] = ws[(k * (BN / 8) + wn * NT + nt) * 32 + lane];",
         "        b[nt] = j0 + wn * NT + nt < n8\n"
         "                    ? __ldg(w_tile(k, sl, j0 + wn * NT + nt) + lane)\n"
         "                    : make_uint2(0u, 0u);")],
    # A fragments by one ldmatrix.x4 a m-tile, not four 4-byte loads
    "ldmatrix": [(
        """        const uint32_t* xm = xa + mt * 16 * I8_XP;
        a[mt][0] = xm[0];
        a[mt][1] = xm[8 * I8_XP];
        a[mt][2] = xm[4];
        a[mt][3] = xm[8 * I8_XP + 4];""",
        """        const uint32_t* xm = xa - g * I8_XP - t4 + mt * 16 * I8_XP +
                             ((lane & 7) + (lane & 8)) * I8_XP +
                             4 * (lane >> 4);
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
            : "=r"(a[mt][0]), "=r"(a[mt][1]), "=r"(a[mt][2]),
              "=r"(a[mt][3])
            : "r"(smem_u32(xm)));""")],
    # 32 output channels a block where the sound kernel takes 64
    "bn_32": [("    case 64:\n      return launch_int8_tc<4>",
               "    case 64:\n      return launch_int8_tc<2>")],
}

# the parent's wavefront: one thread a pair, the row-scan DP with its row
# and query in shared memory (up to m = 907), behind the new entry point
BANDED_THREAD_PER_PAIR = r"""#include "common.cuh"

constexpr int BA_THREADS = 32;
constexpr int BA_NEG = -(1 << 20);

__global__ void __launch_bounds__(BA_THREADS)
banded_align_kernel(const int* __restrict__ q, const int* __restrict__ t,
                    int* __restrict__ out, int P, int m, int n, int band,
                    int match, int mismatch, int gap, int local) {
  extern __shared__ int smem[];
  const int S = blockDim.x;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  int* row = smem + threadIdx.x;
  int* qs = row + (m + 1) * S;
  const int* qp = q + static_cast<size_t>(p) * m;
  const int* tp = t + static_cast<size_t>(p) * n;
  const int agap = abs(gap);
  for (int i = 0; i < m; ++i) qs[i * S] = qp[i];
  for (int i = 0; i <= m; ++i)
    row[i * S] = local ? 0 : (i * agap <= band * agap ? i * gap : BA_NEG);
  const int floor_v = local ? 0 : BA_NEG;
  int best = 0;
  for (int j = 0; j < n; ++j) {
    const int tj = tp[j];
    const int first = (j + 1 <= band) ? (local ? 0 : gap * (j + 1)) : floor_v;
    int diag = row[0];
    row[0] = first;
    int left = first;
    int rmax = first;
    for (int i = 0; i < m; ++i) {
      const int up = row[(i + 1) * S];
      const int sub = (qs[i * S] == tj) ? match : mismatch;
      int v = max(max(left + gap, up + gap), diag + sub);
      if (local) v = max(v, 0);
      if (abs(i - j) > band) v = floor_v;
      row[(i + 1) * S] = v;
      diag = up;
      left = v;
      rmax = max(rmax, v);
    }
    if (local) best = max(best, rmax);
  }
  out[p] = local ? best : row[m * S];
}

extern "C" int launch_banded_align(const void* q, const void* t, void* out,
                                   void* scratch, int P, int m, int n,
                                   int band, int match, int mismatch, int gap,
                                   int local, int G, int R, void* stream) {
  const size_t smem = (2 * m + 1) * BA_THREADS * sizeof(int);
  cudaError_t err = allow_smem(banded_align_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  banded_align_kernel<<<(P + BA_THREADS - 1) / BA_THREADS, BA_THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q), static_cast<const int*>(t),
      static_cast<int*>(out), P, m, n, band, match, mismatch, gap, local);
  return static_cast<int>(cudaGetLastError());
}
"""

BANDED = {
    # the parent's kernel: one thread a pair, rows in shared memory
    "thread_per_pair": lambda text: [(text, BANDED_THREAD_PER_PAIR)],
    # each cell's add-max as a plain add and max, not DPX
    "dpx_off": [("  if constexpr (RELU) return __viaddmax_s32_relu(a, b, c);\n"
                 "  return __viaddmax_s32(a, b, c);",
                 "  const int v = max(a + b, c);\n"
                 "  return RELU ? max(v, 0) : v;")],
    # 4 or 8 warps a block, not 2
    "warps_4": [("constexpr int BA_WARPS = 2;", "constexpr int BA_WARPS = 4;")],
    "warps_8": [("constexpr int BA_WARPS = 2;", "constexpr int BA_WARPS = 8;")],
    # other lane plans (edit_distance.plan, set in Python; the kernel is
    # the sound one): lanes aiming at 2 or 8 rows each, and stripes of at
    # most 32 x 4 rows (the firehose's 256 in two)
    "rows_target_2": None,
    "rows_target_8": None,
    "rows_max_4": None,
}
BANDED_PLANS = {"rows_target_2": ("ROWS_TARGET", 2),
                "rows_target_8": ("ROWS_TARGET", 8),
                "rows_max_4": ("ROWS_MAX", 4)}

# the parent's f32 CUDA-core passes 1 and 3 of csrc/ssd_scan.cu (fmaf
# register tiles fed from shared memory), with their cumsum and store
SSD_CUDA_CORES_P1 = r"""__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the cumsum of the CUDA-core passes: warp 0, 32 values a step
__device__ void chunk_cumsum_warp0(const float* __restrict__ la, int c0,
                                   int n, int T, float* cum) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float carry = 0.f;
    for (int p0 = 0; p0 < n; p0 += 32) {
      const int t = c0 + p0 + lane;
      float v = (p0 + lane < n && t < T) ? la[t] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      v += carry;
      if (p0 + lane < n) cum[p0 + lane] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
}

// ---- pass 1: each chunk's own state and log decay ------------------------
template <typename T, int DS, int DH>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ la,
                       const T* __restrict__ b, float* __restrict__ states,
                       float* __restrict__ totals, int Tn, int chunk,
                       long long b_head_stride) {
  extern __shared__ __align__(16) float smem[];
  float* cum = smem;                          // [chunk]
  float* bw = cum + SSD_MAX_CHUNK;            // [TILE][DS]: w_s B_s
  float* xs = bw + SSD_TILE * DS;             // [TILE][DH]
  const int nc = (Tn + chunk - 1) / chunk;  // blocks: head * nc + chunk
  const int c = static_cast<int>(blockIdx.x % nc);
  const int h = static_cast<int>(blockIdx.x / nc);
  const int c0 = c * chunk;
  const float* lah = la + static_cast<size_t>(h) * Tn;
  const T* xh = x + static_cast<size_t>(h) * Tn * DH;
  const T* bh = b + h * b_head_stride;
  chunk_cumsum_warp0(lah, c0, chunk, Tn, cum);
  const float total = cum[chunk - 1];

  constexpr int NI = DS / 16, NJ = DH / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[NI][NJ];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int s0 = 0; s0 < chunk; s0 += SSD_TILE) {
    for (int i = threadIdx.x; i < SSD_TILE * DS; i += SSD_THREADS) {
      const int s = i / DS, k = i % DS;
      const int t = c0 + s0 + s;
      bw[i] = t < Tn ? expf(total - cum[s0 + s]) *
                           to_f32(bh[static_cast<size_t>(t) * DS + k])
                     : 0.f;
    }
    for (int i = threadIdx.x; i < SSD_TILE * DH; i += SSD_THREADS) {
      const int t = c0 + s0 + i / DH;
      xs[i] = t < Tn ? to_f32(xh[static_cast<size_t>(t) * DH + i % DH]) : 0.f;
    }
    __syncthreads();
    for (int s = 0; s < SSD_TILE; ++s) {
      float av[NI], xv[NJ];
#pragma unroll
      for (int i = 0; i < NI; ++i) av[i] = bw[s * DS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) xv[j] = xs[s * DH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* st = states + (static_cast<size_t>(h) * nc + c) * DS * DH;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) st[(ty + 16 * i) * DH + tx + 16 * j] = acc[i][j];
  if (threadIdx.x == 0) totals[static_cast<size_t>(h) * nc + c] = total;
}

"""
SSD_CUDA_CORES_P3 = r"""// ---- pass 3: the outputs of one 64-row tile of a chunk -------------------
template <typename T, int DS, int DH>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_chunk_out_kernel(const T* __restrict__ x, const float* __restrict__ la,
                     const T* __restrict__ b, const T* __restrict__ c,
                     const float* __restrict__ states, T* __restrict__ y,
                     int Tn, int chunk, long long b_head_stride,
                     long long c_head_stride) {
  constexpr int LT = SSD_TILE + 1;            // padded transposed rows
  extern __shared__ __align__(16) float smem[];
  float* cum = smem;                          // [chunk]
  float* cs = cum + SSD_MAX_CHUNK;            // [DS][LT]: C_t transposed
  float* bs = cs + DS * LT;                   // [DS][LT]: B_s transposed, or S_in [DS][DH]
  float* xs = bs + DS * LT;                   // [TILE][DH]
  float* gs = xs + SSD_TILE * DH;             // [TILE][LT]: decayed G
  const int tiles = chunk / SSD_TILE;
  const int nc = (Tn + chunk - 1) / chunk;  // blocks: head * nc * tiles + ...
  const int ci = static_cast<int>(blockIdx.x % (nc * tiles)) / tiles;
  const int ti = static_cast<int>(blockIdx.x % tiles);
  const int h = static_cast<int>(blockIdx.x / (nc * tiles));
  const int c0 = ci * chunk, t0 = c0 + ti * SSD_TILE;
  const float* lah = la + static_cast<size_t>(h) * Tn;
  const T* xh = x + static_cast<size_t>(h) * Tn * DH;
  const T* bh = b + h * b_head_stride;
  const T* ch = c + h * c_head_stride;
  chunk_cumsum_warp0(lah, c0, (ti + 1) * SSD_TILE, Tn, cum);

  constexpr int NJ = DH / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // C tile transposed, and S_in in the B buffer
  for (int i = threadIdx.x; i < SSD_TILE * DS; i += SSD_THREADS) {
    const int r = i / DS, k = i % DS;
    const int t = t0 + r;
    cs[k * LT + r] = t < Tn ? to_f32(ch[static_cast<size_t>(t) * DS + k]) : 0.f;
  }
  const float* sin = states + (static_cast<size_t>(h) * nc + ci) * DS * DH;
  for (int i = threadIdx.x; i < DS * DH; i += SSD_THREADS) bs[i] = sin[i];
  __syncthreads();

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < DS; ++k) {
    float cv[4], sv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) cv[i] = cs[k * LT + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) sv[j] = bs[k * DH + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float w = expf(cum[ti * SSD_TILE + ty + 16 * i]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] *= w;
  }

  for (int st = 0; st <= ti; ++st) {
    const int s0 = c0 + st * SSD_TILE;
    __syncthreads();  // the previous step is done with bs, xs and gs
    for (int i = threadIdx.x; i < SSD_TILE * DS; i += SSD_THREADS) {
      const int r = i / DS, k = i % DS;
      const int t = s0 + r;
      bs[k * LT + r] = t < Tn ? to_f32(bh[static_cast<size_t>(t) * DS + k]) : 0.f;
    }
    for (int i = threadIdx.x; i < SSD_TILE * DH; i += SSD_THREADS) {
      const int t = s0 + i / DH;
      xs[i] = t < Tn ? to_f32(xh[static_cast<size_t>(t) * DH + i % DH]) : 0.f;
    }
    __syncthreads();
    // G[t][s] = C_t . B_s (t = ty + 16 i, s = tx + 16 j)
    float gv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) gv[i][j] = 0.f;
    for (int k = 0; k < DS; ++k) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = cs[k * LT + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[k * LT + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) gv[i][j] = fmaf(cv[i], bv[j], gv[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tl = ti * SSD_TILE + ty + 16 * i;   // chunk-local t
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int sl = st * SSD_TILE + tx + 16 * j; // chunk-local s
        gs[(ty + 16 * i) * LT + tx + 16 * j] =
            sl <= tl ? gv[i][j] * expf(cum[tl] - cum[sl]) : 0.f;
      }
    }
    __syncthreads();
    // y += G X_s
    for (int s = 0; s < SSD_TILE; ++s) {
      float gv2[4], xv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv2[i] = gs[(ty + 16 * i) * LT + s];
#pragma unroll
      for (int j = 0; j < NJ; ++j) xv[j] = xs[s * DH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(gv2[i], xv[j], acc[i][j]);
    }
  }

  T* yh = y + static_cast<size_t>(h) * Tn * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= Tn) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      store_as(yh + static_cast<size_t>(t) * DH + tx + 16 * j, acc[i][j]);
  }
}

"""

# pass 3 with each warp's G kept in registers (csrc/ssd_scan.cu)
SSD_G_REGISTERS = r"""template <typename T, int DS, int DH>
__global__ void __launch_bounds__(SSD_THREADS, 2)
ssd_chunk_out_kernel(const T* __restrict__ x, const float* __restrict__ la,
                     const T* __restrict__ b, const T* __restrict__ c,
                     const float* __restrict__ states, T* __restrict__ y,
                     int Tn, int chunk, long long b_head_stride,
                     long long c_head_stride) {
  // G kept in registers: warp w owns rows 16 (w / 2) .. + 15 and G's
  // columns s in (w % 2) 32 .. + 31, and sums its part of y over those s
  // (and over half of ds for the inter term) for every column of y; the
  // two warps of a row block add their parts at the end.  G's accumulator
  // is its A fragment with the k order permuted: slot t4 is s = 2 t4,
  // slot t4 + 4 is s = 2 t4 + 1.
  constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
  constexpr int LC = DS + 4;
  constexpr int LX = DH + 8;          // S_in rows
  constexpr int LXS = DH + 4;         // X_s rows: (2 t4, g) at 2 t4 LXS + g
  constexpr int LG = SSD_TILE + 4;
  constexpr int NY = DH / 8;
  constexpr int BUF = SSD_TILE * LC > DS * LX ? SSD_TILE * LC : DS * LX;
  extern __shared__ __align__(16) float smem[];
  __shared__ float part[SSD_THREADS / 32];
  float* cum = smem;
  float* cs = cum + chunk;
  float* bs = cs + SSD_TILE * LC;
  float* xs = bs + BUF;
  float* gs = xs + SSD_TILE * LX;     // the other warp's part of y
  const int tiles = chunk / SSD_TILE;
  const int nc = (Tn + chunk - 1) / chunk;
  const int ci = static_cast<int>(blockIdx.x % (nc * tiles)) / tiles;
  const int ti = static_cast<int>(blockIdx.x % tiles);
  const int h = static_cast<int>(blockIdx.x / (nc * tiles));
  const int c0 = ci * chunk, t0 = c0 + ti * SSD_TILE;
  const float* lah = la + static_cast<size_t>(h) * Tn;
  const T* xh = x + static_cast<size_t>(h) * Tn * DH;
  const T* bhd = b + h * b_head_stride;
  const T* chd = c + h * c_head_stride;
  chunk_cumsum(lah, c0, (ti + 1) * SSD_TILE, Tn, cum, part);

  stage_rows<DS, LC>(chd, t0, Tn, cs);
  {
    constexpr int N = DS * DH / SSD_THREADS, ROWS = SSD_THREADS / DH;
    const float* p = states + (static_cast<size_t>(h) * nc + ci) * DS * DH +
                     threadIdx.x;
    float v[N];
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = p[j * SSD_THREADS];
    float* d = bs + (threadIdx.x / DH) * LX + threadIdx.x % DH;
#pragma unroll
    for (int j = 0; j < N; ++j) d[j * ROWS * LX] = v[j];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = 16 * (warp / 2), wn = warp % 2, sc0 = 32 * wn;
  const int tl0 = ti * SSD_TILE + r0 + g;
  float acc[NY][4];
#pragma unroll
  for (int j = 0; j < NY; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int k0 = wn * (DS / 2); k0 < (wn + 1) * (DS / 2); k0 += 8) {
    uint32_t ah[4], al[4];
    load_a<!EXACT>(cs + (r0 + g) * LC + k0 + t4, LC, ah, al);
#pragma unroll
    for (int j = 0; j < NY; ++j) {
      const float* pb = bs + (k0 + t4) * LX + 8 * j + g;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32_int(pb[0], bh0, bl0);
      split_tf32_int(pb[4 * LX], bh1, bl1);
      mma_split<EXACT, false>(acc[j], ah, al, bh0, bh1, bl0, bl1);
    }
  }
  {
    const float w0 = expf(cum[tl0]), w1 = expf(cum[tl0 + 8]);
#pragma unroll
    for (int j = 0; j < NY; ++j) {
      acc[j][0] *= w0;
      acc[j][1] *= w0;
      acc[j][2] *= w1;
      acc[j][3] *= w1;
    }
  }

  for (int st = 0; st <= ti; ++st) {
    const int s0 = c0 + st * SSD_TILE;
    const bool diag = st == ti;
    __syncthreads();
    stage_rows<DS, LC>(bhd, s0, Tn, bs);
    stage_rows<DH, LXS>(xh, s0, Tn, xs);
    __syncthreads();
    if (diag && sc0 > r0 + 15) continue;
    float gv[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) gv[jj][e] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < DS; k0 += 8) {
      uint32_t ah[4], al[4];
      load_a<!EXACT>(cs + (r0 + g) * LC + k0 + t4, LC, ah, al);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* pb = bs + (sc0 + 8 * jj + g) * LC + k0 + t4;
        uint32_t bh0, bl0, bh1, bl1;
        tf32_parts<!EXACT>(pb[0], bh0, bl0);
        tf32_parts<!EXACT>(pb[4], bh1, bl1);
        mma_split<EXACT, EXACT>(gv[jj], ah, al, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int sl = st * SSD_TILE + sc0 + 8 * jj + 2 * t4;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int tl = tl0 + 8 * hh;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          gv[jj][2 * hh + e] = sl + e <= tl
              ? gv[jj][2 * hh + e] * expf(cum[tl] - cum[sl + e]) : 0.f;
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (diag && sc0 + 8 * jj > r0 + 15) continue;
      uint32_t ah[4], al[4];
      split_tf32_int(gv[jj][0], ah[0], al[0]);   // (g,     s = 2 t4)
      split_tf32_int(gv[jj][2], ah[1], al[1]);   // (g + 8, s = 2 t4)
      split_tf32_int(gv[jj][1], ah[2], al[2]);   // (g,     s = 2 t4 + 1)
      split_tf32_int(gv[jj][3], ah[3], al[3]);   // (g + 8, s = 2 t4 + 1)
      const float* px = xs + (sc0 + 8 * jj + 2 * t4) * LXS + g;
#pragma unroll
      for (int j = 0; j < NY; ++j) {
        uint32_t bh0, bl0, bh1, bl1;
        tf32_parts<!EXACT>(px[8 * j], bh0, bl0);
        tf32_parts<!EXACT>(px[LXS + 8 * j], bh1, bl1);
        mma_split<false, EXACT>(acc[j], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }

  __syncthreads();
  if (wn == 1) {
#pragma unroll
    for (int j = 0; j < NY; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        store2(gs + (r0 + g + 8 * hh) * LG + 8 * j + 2 * t4, acc[j][2 * hh],
               acc[j][2 * hh + 1]);
  }
  __syncthreads();
  if (wn == 1) return;
  T* yh = y + static_cast<size_t>(h) * Tn * DH;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = t0 + r0 + g + 8 * hh;
    if (t >= Tn) continue;
#pragma unroll
    for (int j = 0; j < NY; ++j) {
      const float* o = gs + (r0 + g + 8 * hh) * LG + 8 * j + 2 * t4;
      store2(yh + static_cast<size_t>(t) * DH + 8 * j + 2 * t4,
             acc[j][2 * hh] + o[0], acc[j][2 * hh + 1] + o[1]);
    }
  }
}

"""
# pass 3 on bf16 mma.sync m16n8k16 with bf16x3 splits (csrc/ssd_scan.cu)
SSD_BF16_MMA = r"""// v = h + m + l, three bf16 values (8 significant bits each), each the
// rounding of what the ones before leave: v to ~2^-24 |v|
__device__ __forceinline__ void split_bf16x3(float v, float& h, float& m,
                                             float& l) {
  h = __bfloat162float(__float2bfloat16_rn(v));
  const float r = v - h;
  m = __bfloat162float(__float2bfloat16_rn(r));
  l = r - m;
}

// a pair of values (lower k first) as N bf16x2 registers: the value itself
// (N = 1, exact in bf16) or its three parts
template <int N>
__device__ __forceinline__ void bf16_pair(float v0, float v1,
                                          uint32_t (&r)[3]) {
  if constexpr (N == 1) {
    r[0] = pack_bf16(v0, v1);
  } else {
    float h0, m0, l0, h1, m1, l1;
    split_bf16x3(v0, h0, m0, l0);
    split_bf16x3(v1, h1, m1, l1);
    r[0] = pack_bf16(h0, h1);
    r[1] = pack_bf16(m0, m1);
    r[2] = pack_bf16(l0, l1);
  }
}

// d += A B over the parts (i, j) with i + j <= 2, small ones first
template <int NA, int NB>
__device__ __forceinline__ void mma_bf16_parts(float (&d)[4],
                                               const uint32_t (&a)[4][3],
                                               const uint32_t (&b)[2][3]) {
#pragma unroll
  for (int sum = 2; sum >= 0; --sum)
#pragma unroll
    for (int i = 0; i <= sum; ++i) {
      const int j = sum - i;
      if (i < NA && j < NB) {
        const uint32_t ai[4] = {a[0][i], a[1][i], a[2][i], a[3][i]};
        mma_bf16_16816(d, ai, b[0][j], b[1][j]);
      }
    }
}

// A (16 x 16, row-major, leading dimension ld, f32) whose element (g, 2 t4)
// is at p, as N parts
template <int N>
__device__ __forceinline__ void bf16_a(const float* p, int ld,
                                       uint32_t (&a)[4][3]) {
  const float2 v0 = *reinterpret_cast<const float2*>(p);
  const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * ld);
  const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
  const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * ld + 8);
  bf16_pair<N>(v0.x, v0.y, a[0]);
  bf16_pair<N>(v1.x, v1.y, a[1]);
  bf16_pair<N>(v2.x, v2.y, a[2]);
  bf16_pair<N>(v3.x, v3.y, a[3]);
}

// B (16 x 8) whose element (k, n) is at p[k * ldk + n * ldn], thread
// element (2 t4, g) at p, as N parts
template <int N>
__device__ __forceinline__ void bf16_b(const float* p, int ldk,
                                       uint32_t (&b)[2][3]) {
  bf16_pair<N>(p[0], p[ldk], b[0]);
  bf16_pair<N>(p[8 * ldk], p[9 * ldk], b[1]);
}

template <typename T, int DS, int DH>
__global__ void __launch_bounds__(SSD_THREADS, 2)
ssd_chunk_out_kernel(const T* __restrict__ x, const float* __restrict__ la,
                     const T* __restrict__ b, const T* __restrict__ c,
                     const float* __restrict__ states, T* __restrict__ y,
                     int Tn, int chunk, long long b_head_stride,
                     long long c_head_stride) {
  // pass 3 on bf16 mma.sync m16n8k16: an f32 operand split in three bf16
  // parts, a bf16 one whole; the products (i, j) of parts with i + j <= 2
  constexpr int NE = std::is_same<T, __nv_bfloat16>::value ? 1 : 3;
  constexpr int LC = DS + 4;
  constexpr int LX = DH + 8;
  constexpr int LG = SSD_TILE + 4;
  constexpr int NJ = DH / 16;
  constexpr int BUF = SSD_TILE * LC > DS * LX ? SSD_TILE * LC : DS * LX;
  extern __shared__ __align__(16) float smem[];
  __shared__ float part[SSD_THREADS / 32];
  float* cum = smem;
  float* cs = cum + chunk;
  float* bs = cs + SSD_TILE * LC;
  float* xs = bs + BUF;
  float* gs = xs + SSD_TILE * LX;
  const int tiles = chunk / SSD_TILE;
  const int nc = (Tn + chunk - 1) / chunk;
  const int ci = static_cast<int>(blockIdx.x % (nc * tiles)) / tiles;
  const int ti = static_cast<int>(blockIdx.x % tiles);
  const int h = static_cast<int>(blockIdx.x / (nc * tiles));
  const int c0 = ci * chunk, t0 = c0 + ti * SSD_TILE;
  const float* lah = la + static_cast<size_t>(h) * Tn;
  const T* xh = x + static_cast<size_t>(h) * Tn * DH;
  const T* bhd = b + h * b_head_stride;
  const T* chd = c + h * c_head_stride;
  chunk_cumsum(lah, c0, (ti + 1) * SSD_TILE, Tn, cum, part);

  stage_rows<DS, LC>(chd, t0, Tn, cs);
  {
    constexpr int N = DS * DH / SSD_THREADS, ROWS = SSD_THREADS / DH;
    const float* p = states + (static_cast<size_t>(h) * nc + ci) * DS * DH +
                     threadIdx.x;
    float v[N];
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = p[j * SSD_THREADS];
    float* d = bs + (threadIdx.x / DH) * LX + threadIdx.x % DH;
#pragma unroll
    for (int j = 0; j < N; ++j) d[j * ROWS * LX] = v[j];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = 16 * (warp / 2), n0 = (warp % 2) * (DH / 2);
  const int sc0 = 32 * (warp % 2);
  const int tl0 = ti * SSD_TILE + r0 + g;
  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int k0 = 0; k0 < DS; k0 += 16) {
    uint32_t a[4][3];
    bf16_a<NE>(cs + (r0 + g) * LC + k0 + 2 * t4, LC, a);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t bb[2][3];
      bf16_b<3>(bs + (k0 + 2 * t4) * LX + n0 + 8 * j + g, LX, bb);
      mma_bf16_parts<NE, 3>(acc[j], a, bb);
    }
  }
  {
    const float w0 = expf(cum[tl0]), w1 = expf(cum[tl0 + 8]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc[j][0] *= w0;
      acc[j][1] *= w0;
      acc[j][2] *= w1;
      acc[j][3] *= w1;
    }
  }

  for (int st = 0; st <= ti; ++st) {
    const int s0 = c0 + st * SSD_TILE;
    const bool diag = st == ti;
    __syncthreads();
    stage_rows<DS, LC>(bhd, s0, Tn, bs);
    stage_rows<DH, LX>(xh, s0, Tn, xs);
    __syncthreads();
    if (diag && sc0 > r0 + 15) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          store2(gs + (r0 + g + 8 * hh) * LG + sc0 + 8 * jj + 2 * t4, 0.f, 0.f);
    } else {
      float gv[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) gv[jj][e] = 0.f;
      for (int k0 = 0; k0 < DS; k0 += 16) {
        uint32_t a[4][3];
        bf16_a<NE>(cs + (r0 + g) * LC + k0 + 2 * t4, LC, a);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          // B = B_s^T: element (k, n) at bs[n][k]
          uint32_t bb[2][3];
          bf16_b<NE>(bs + (sc0 + 8 * jj + g) * LC + k0 + 2 * t4, 1, bb);
          mma_bf16_parts<NE, NE>(gv[jj], a, bb);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int tl = tl0 + 8 * hh;
          const int sl = st * SSD_TILE + sc0 + 8 * jj + 2 * t4;
          const float v0 =
              sl <= tl ? gv[jj][2 * hh] * expf(cum[tl] - cum[sl]) : 0.f;
          const float v1 = sl + 1 <= tl
                               ? gv[jj][2 * hh + 1] * expf(cum[tl] - cum[sl + 1])
                               : 0.f;
          store2(gs + (r0 + g + 8 * hh) * LG + sc0 + 8 * jj + 2 * t4, v0, v1);
        }
      }
    }
    __syncthreads();
    const int kend = diag ? r0 + 16 : SSD_TILE;
    for (int k0 = 0; k0 < kend; k0 += 16) {
      uint32_t a[4][3];
      bf16_a<3>(gs + (r0 + g) * LG + k0 + 2 * t4, LG, a);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t bb[2][3];
        bf16_b<NE>(xs + (k0 + 2 * t4) * LX + n0 + 8 * j + g, LX, bb);
        mma_bf16_parts<3, NE>(acc[j], a, bb);
      }
    }
  }

  T* yh = y + static_cast<size_t>(h) * Tn * DH;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = t0 + r0 + g + 8 * hh;
    if (t >= Tn) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      store2(yh + static_cast<size_t>(t) * DH + n0 + 8 * j + 2 * t4,
             acc[j][2 * hh], acc[j][2 * hh + 1]);
  }
}

"""
# pass 3 with two heads a block and C B^T formed once for both
SSD_HEADS_2 = r"""template <typename T, int DS, int DH>
__global__ void __launch_bounds__(SSD_THREADS, 2)
ssd_chunk_out_kernel(const T* __restrict__ x, const float* __restrict__ la,
                     const T* __restrict__ b, const T* __restrict__ c,
                     const float* __restrict__ states, T* __restrict__ y,
                     int Tn, int chunk, long long b_head_stride,
                     long long c_head_stride) {
  // Two heads a block, B/C shared by both (head stride 0, as on the path at
  // batch 1; timing only elsewhere): C_t B_s^T formed once an s-tile and
  // decayed for each head in registers (the k order of g_registers), each
  // warp's part of both heads' y summed over its 32 columns of s and half
  // of ds, the two warps of a row block adding their parts at the end.
  constexpr int HG = 2;
  constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
  constexpr int LC = DS + 4;
  constexpr int LX = DH + 8;
  constexpr int LXS = DH + 4;
  constexpr int NY = DH / 8;
  constexpr int BUF = SSD_TILE * LC > DS * LX ? SSD_TILE * LC : DS * LX;
  extern __shared__ __align__(16) float smem[];
  __shared__ float part[SSD_THREADS / 32];
  float* cum = smem;                  // [HG][chunk]
  float* cs = cum + HG * chunk;
  float* bs = cs + SSD_TILE * LC;     // B_s, S_in; then with xs parts of y
  float* xs = bs + BUF;               // [HG][TILE][LXS]
  const int tiles = chunk / SSD_TILE;
  const int nc = (Tn + chunk - 1) / chunk;
  const int ci = static_cast<int>(blockIdx.x % (nc * tiles)) / tiles;
  const int ti = static_cast<int>(blockIdx.x % tiles);
  const int h0 = HG * static_cast<int>(blockIdx.x / (nc * tiles));
  const int c0 = ci * chunk, t0 = c0 + ti * SSD_TILE;
  const T* bhd = b + h0 * b_head_stride;
  const T* chd = c + h0 * c_head_stride;
#pragma unroll
  for (int hh = 0; hh < HG; ++hh)
    chunk_cumsum(la + static_cast<size_t>(h0 + hh) * Tn, c0,
                 (ti + 1) * SSD_TILE, Tn, cum + hh * chunk, part);
  stage_rows<DS, LC>(chd, t0, Tn, cs);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = 16 * (warp / 2), wn = warp % 2, sc0 = 32 * wn;
  const int tl0 = ti * SSD_TILE + r0 + g;
  float acc[HG][NY][4];
#pragma unroll
  for (int hh = 0; hh < HG; ++hh)
#pragma unroll
    for (int j = 0; j < NY; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[hh][j][e] = 0.f;

#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    __syncthreads();
    {
      constexpr int N = DS * DH / SSD_THREADS, ROWS = SSD_THREADS / DH;
      const float* p = states +
                       (static_cast<size_t>(h0 + hh) * nc + ci) * DS * DH +
                       threadIdx.x;
      float v[N];
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = p[j * SSD_THREADS];
      float* d = bs + (threadIdx.x / DH) * LX + threadIdx.x % DH;
#pragma unroll
      for (int j = 0; j < N; ++j) d[j * ROWS * LX] = v[j];
    }
    __syncthreads();
    for (int k0 = wn * (DS / 2); k0 < (wn + 1) * (DS / 2); k0 += 8) {
      uint32_t ah[4], al[4];
      load_a<!EXACT>(cs + (r0 + g) * LC + k0 + t4, LC, ah, al);
#pragma unroll
      for (int j = 0; j < NY; ++j) {
        const float* pb = bs + (k0 + t4) * LX + 8 * j + g;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32_int(pb[0], bh0, bl0);
        split_tf32_int(pb[4 * LX], bh1, bl1);
        mma_split<EXACT, false>(acc[hh][j], ah, al, bh0, bh1, bl0, bl1);
      }
    }
    const float* ch = cum + hh * chunk;
    const float w0 = expf(ch[tl0]), w1 = expf(ch[tl0 + 8]);
#pragma unroll
    for (int j = 0; j < NY; ++j) {
      acc[hh][j][0] *= w0;
      acc[hh][j][1] *= w0;
      acc[hh][j][2] *= w1;
      acc[hh][j][3] *= w1;
    }
  }

  for (int st = 0; st <= ti; ++st) {
    const int s0 = c0 + st * SSD_TILE;
    const bool diag = st == ti;
    __syncthreads();
    stage_rows<DS, LC>(bhd, s0, Tn, bs);
#pragma unroll
    for (int hh = 0; hh < HG; ++hh)
      stage_rows<DH, LXS>(x + static_cast<size_t>(h0 + hh) * Tn * DH, s0, Tn,
                          xs + hh * SSD_TILE * LXS);
    __syncthreads();
    if (diag && sc0 > r0 + 15) continue;
    float gv[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) gv[jj][e] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < DS; k0 += 8) {
      uint32_t ah[4], al[4];
      load_a<!EXACT>(cs + (r0 + g) * LC + k0 + t4, LC, ah, al);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* pb = bs + (sc0 + 8 * jj + g) * LC + k0 + t4;
        uint32_t bh0, bl0, bh1, bl1;
        tf32_parts<!EXACT>(pb[0], bh0, bl0);
        tf32_parts<!EXACT>(pb[4], bh1, bl1);
        mma_split<EXACT, EXACT>(gv[jj], ah, al, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      const float* ch = cum + hh * chunk;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (diag && sc0 + 8 * jj > r0 + 15) continue;
        const int sl = st * SSD_TILE + sc0 + 8 * jj + 2 * t4;
        float gd[4];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int tl = tl0 + 8 * hr;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            gd[2 * hr + e] = sl + e <= tl
                ? gv[jj][2 * hr + e] * expf(ch[tl] - ch[sl + e]) : 0.f;
        }
        uint32_t ah[4], al[4];
        split_tf32_int(gd[0], ah[0], al[0]);
        split_tf32_int(gd[2], ah[1], al[1]);
        split_tf32_int(gd[1], ah[2], al[2]);
        split_tf32_int(gd[3], ah[3], al[3]);
        const float* px =
            xs + hh * SSD_TILE * LXS + (sc0 + 8 * jj + 2 * t4) * LXS + g;
#pragma unroll
        for (int j = 0; j < NY; ++j) {
          uint32_t bh0, bl0, bh1, bl1;
          tf32_parts<!EXACT>(px[8 * j], bh0, bl0);
          tf32_parts<!EXACT>(px[LXS + 8 * j], bh1, bl1);
          mma_split<false, EXACT>(acc[hh][j], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
  }

  __syncthreads();
  if (wn == 1) {
#pragma unroll
    for (int hh = 0; hh < HG; ++hh)
#pragma unroll
      for (int j = 0; j < NY; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          store2(bs + hh * SSD_TILE * LXS + (r0 + g + 8 * hr) * LXS + 8 * j +
                     2 * t4,
                 acc[hh][j][2 * hr], acc[hh][j][2 * hr + 1]);
  }
  __syncthreads();
  if (wn == 1) return;
#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    T* yh = y + static_cast<size_t>(h0 + hh) * Tn * DH;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = t0 + r0 + g + 8 * hr;
      if (t >= Tn) continue;
#pragma unroll
      for (int j = 0; j < NY; ++j) {
        const float* o =
            bs + hh * SSD_TILE * LXS + (r0 + g + 8 * hr) * LXS + 8 * j + 2 * t4;
        store2(yh + static_cast<size_t>(t) * DH + 8 * j + 2 * t4,
               acc[hh][j][2 * hr] + o[0], acc[hh][j][2 * hr + 1] + o[1]);
      }
    }
  }
}

"""
SSD_P1 = "// ---- pass 1: each chunk's own state and log decay"
SSD_P2 = "// ---- pass 2: the scan over chunks"
SSD_OUT = ("template <typename T, int DS, int DH>\n__global__ void "
           "__launch_bounds__(SSD_THREADS, (ssd_out_blocks<DS, DH>()))\n"
           "ssd_chunk_out_kernel")
SSD_LAUNCH = ("template <typename T, int DS, int DH>\n"
              "static cudaError_t launch_typed")
SSD = {
    # the parent's passes 1 and 3 (f32 fmaf on the CUDA cores)
    "cuda_cores": lambda text: [
        (between(text, SSD_P1, SSD_P2), SSD_CUDA_CORES_P1),
        (between(text, SSD_OUT, SSD_LAUNCH), SSD_CUDA_CORES_P3)],
    # pass 3 with G in registers, re-laid as G' X's A fragment, and each
    # warp's part of y over its 32 columns of s added at the end
    "g_registers": lambda text: [
        (between(text, SSD_OUT, SSD_LAUNCH), SSD_G_REGISTERS)],
    # pass 3 on bf16 m16n8k16 (twice TF32's rate a product): an f32
    # operand split in three bf16 parts, products (i, j) with i + j <= 2
    "bf16_mma": lambda text: [
        (between(text, SSD_OUT, SSD_LAUNCH), SSD_BF16_MMA)],
    # two heads a block (B/C one row over the heads, an even B * H: the
    # path's shape), C B^T formed once for both
    "heads_2": lambda text: [
        (between(text, SSD_OUT, SSD_LAUNCH), SSD_HEADS_2),
        ("  const size_t smem3 = ssd_out_floats<DS, DH>(chunk) * sizeof(float);",
         "  const size_t smem3 = (ssd_out_floats<DS, DH>(chunk) + chunk +\n"
         "                        SSD_TILE * DH) * sizeof(float);"),
        ("  const long long blocks3 = blocks1 * (chunk / SSD_TILE);",
         "  const long long blocks3 = blocks1 * (chunk / SSD_TILE) / 2;")],
}
# the fused int8 tick's tensor-core layer, patched (csrc/fused_stream.cu)
I8_STEPS = "    // k-steps in (32-channel slice, tap) order"
I8_EPILOGUE = "    // the unfused epilogue, stored in the next layer's layout"
I8_PREFETCH = """\
    // k-steps q = (slice, tap) in that order; A one step ahead, B (from
    // L2) two
    auto load_a = [&](int sl, int k, uint32_t (&a)[2][4]) {
      // word (row of frame tb + g at tap k, channels 32 sl + 4 t4 ..)
      const int r0 = ((tb + g) * s + k) * words + sl * 8 + t4;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = r0 + 16 * mt * s * words;   // frame + 16 mt
        const int r8 = r + 8 * s * words;          // frame + 8
        a[mt][0] = q[fs_qword(r, m)];
        a[mt][1] = q[fs_qword(r8, m)];
        a[mt][2] = q[fs_qword(r + 4, m)];
        a[mt][3] = q[fs_qword(r8 + 4, m)];
      }
    };
    auto load_b = [&](int sl, int k, uint2 (&b)[NT]) {
      const uint2* wb =
          wf + ((static_cast<size_t>(k) * slices + sl) * n8 + j0) * 32 + lane;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) b[nt] = __ldg(wb + nt * 32);
    };
    const int steps = slices * K;
    uint32_t a[2][4];
    uint2 b[NT], b1[NT];
    int sl1 = 0, k1 = 0;   // step q + 1
    int sl2 = 0, k2 = 0;   // step q + 2
    auto next = [&](int& sl_, int& k_) {
      if (++k_ == K) {
        k_ = 0;
        ++sl_;
      }
    };
    load_a(0, 0, a);
    load_b(0, 0, b);
    next(sl1, k1);
    next(sl2, k2);
    next(sl2, k2);
    if (steps > 1) load_b(sl1, k1, b1);
    for (int qs = 0; qs < steps; ++qs) {
      uint32_t ac[2][4];
      uint2 bc[NT];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) ac[mt][e] = a[mt][e];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        bc[nt] = b[nt];
        b[nt] = b1[nt];
      }
      if (qs + 2 < steps) load_b(sl2, k2, b1);
      if (qs + 1 < steps) load_a(sl1, k1, a);
      next(sl1, k1);
      next(sl2, k2);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_s8_16832(acc[mt][nt], ac[mt], bc[nt].x, bc[nt].y);
    }
"""
INT8 = {
    # the int8 layers on the CUDA cores (__dp4a), as the parent ran them:
    # the predicate is turned off in Python, the kernel is the sound one
    "dp4a": None,
    # the k-steps flattened, A loaded one step ahead and B two
    "prefetch": lambda text: [
        (between(text, I8_STEPS, I8_EPILOGUE), I8_PREFETCH)],
    # 256 or 1,024 threads a lane, not 512 (one lane an SM either way)
    "threads_256": [("constexpr int FS_INT8_THREADS = 512;",
                     "constexpr int FS_INT8_THREADS = 256;")],
    "threads_1024": [("constexpr int FS_INT8_THREADS = 512;",
                      "constexpr int FS_INT8_THREADS = 1024;")],
    # timing only (wrong results): the int8 layers left on the CUDA cores
    # (conv1, the head) skipped, quantization included
    "cuda_layers_off": [("    if (L.quantized) {\n      int8_t* qbuf",
                         "    if (L.quantized) {\n      return;\n"
                         "      int8_t* qbuf")],
    # the tensor-core layers' tap loop unrolled by two, the CUDA-core int8
    # layers' channel loop by four (more loads in flight)
    "unroll_k2": [("      for (int k = 0; k < K; ++k) {\n        const int r0",
                   "#pragma unroll 2\n      for (int k = 0; k < K; ++k) {\n"
                   "        const int r0")],
    "unroll_ci4": [("    for (int ci = 0; ci < cw; ++ci) {",
                    "#pragma unroll 4\n    for (int ci = 0; ci < cw; ++ci) {")],
    # timing only: B read from shared memory (garbage), not L2
    "b_smem": [("        for (int nt = 0; nt < NT; ++nt) b[nt] = __ldg(wb + nt * 32);",
                "        for (int nt = 0; nt < NT; ++nt)\n"
                "          b[nt] = make_uint2(q[(lane + nt * 32) & 255], "
                "q[(lane + nt * 32 + 64) & 255]);\n"
                "        (void)wb;")],
    # timing only: the tensor-core layers' quantization skipped
    "quant_off": [("      quantize_rows_tc(in, qw, (L.K - L.stride + t_in) * "
                   "L.cin / 4, L.q_m,",
                   "      if (t_in < 0) quantize_rows_tc(in, qw, (L.K - "
                   "L.stride + t_in) * L.cin / 4, L.q_m,")],
    # timing only: the tensor-core layers' MMAs replaced by an XOR of the
    # loaded fragments (the loads stay)
    "mma_off": [("            mma_s8_16832(acc[mt][nt], a[mt], b[nt].x, "
                 "b[nt].y);",
                 "            acc[mt][nt][0] ^= a[mt][0] ^ a[mt][1] ^ a[mt][2]"
                 " ^ a[mt][3] ^ b[nt].x ^ b[nt].y;")],
}


NR_I8_LOAD = """                      ? __ldg(reinterpret_cast<const uint4*>(
                            b + static_cast<size_t>(k) * N + n))"""
NR_BF16_LOAD = """                           ? ld_stream16(b + static_cast<size_t>(k) * N + c)"""
NR_ITEMS = "  const int items = M * GROUPS;  // rows >= M are never stored\n"
NR_STREAM = """  Step s0, s1;
  if (st0 < st1) load(s0, st0);
  for (int st = st0; st < st1; st += 2 * NR_WK) {
    const bool second = st + NR_WK < st1;
    if (second) load(s1, st + NR_WK);
    mma(s0);
    if (st + 2 * NR_WK < st1) load(s0, st + 2 * NR_WK);
    if (second) mma(s1);
  }
"""
NR_STREAM_2 = """  Step s0, s1;
  if (st0 < st1) load(s0, st0);
  if (st0 + NR_WK < st1) load(s1, st0 + NR_WK);
  for (int st = st0; st < st1; st += NR_WK) {
    Step s2;
    const bool more = st + 2 * NR_WK < st1;
    if (more) load(s2, st + 2 * NR_WK);
    mma(s0);
    s0 = s1;
    if (more) s1 = s2;
  }
"""
NR_I8_LOAD_CALL = "        narrow_i8_load<MT>(x, a, b, M, N, K, st, n, g, t);\n"
NR_I8_PREFETCH = """        if (st + %d * NR_WK < st1 && n < N)
          for (int q = 0; q < 2; ++q)
            for (int i = 0; i < 4; ++i) {
              const int k = (st + %d * NR_WK) * 32 + 4 * (t + 4 * q) + i;
              if (k < K) prefetch_l2(b + static_cast<size_t>(k) * N + n);
            }
"""
NARROW = {
    "int8_no_l1": [(NR_I8_LOAD, "                      ? ld_stream16("
                                "b + static_cast<size_t>(k) * N + n)")],
    "bf16_l1": [(NR_BF16_LOAD, "                           ? __ldg("
                               "reinterpret_cast<const uint4*>(b + "
                               "static_cast<size_t>(k) * N + c))")],
    "depth_2": [(NR_STREAM, NR_STREAM_2)],
    "wk_4": [("constexpr int NR_WK = 2;", "constexpr int NR_WK = 4;")],
    "wn_2": [("constexpr int NR_WN = 1;", "constexpr int NR_WN = 2;")],
    "splits_8": None,
    "blocks_792": None,
    "blocks_1056": None,
    "bf16_prefetch_0": [("        if (st + NR_PREFETCH_BF16 * NR_WK < st1)\n",
                         "        if (false)\n")],
    "bf16_prefetch_2": [("constexpr int NR_PREFETCH_BF16 = 1;",
                         "constexpr int NR_PREFETCH_BF16 = 2;")],
    "bf16_prefetch_half": [("        if (k < K && n + 64 * h < N)\n",
                            "        if (k < K && n + 64 * h < N && h == 0)\n")],
    "int8_prefetch_1": [(NR_I8_LOAD_CALL,
                         NR_I8_LOAD_CALL + NR_I8_PREFETCH % (1, 1))],
    "int8_prefetch_2": [(NR_I8_LOAD_CALL,
                         NR_I8_LOAD_CALL + NR_I8_PREFETCH % (2, 2))],
    "no_split_sum": [(NR_ITEMS, "  if (s > 0) {\n    cluster.sync();\n"
                                "    return;\n  }\n  splits = 1;\n" + NR_ITEMS)],
    "narrow_no_epilogue": [
        ("  // d0 / d2: columns 2 j and 2 j + 1 of row 8 mt + 2 t; d1 / d3 row + 1\n",
         "  if (acc[0][0][0] != 12345) return;\n"),
        ("  // mma j's rows g and g + 8 are the thread's columns 2 j and 2 j + 1:\n",
         "  if (acc[0][0][0] != 12345.f) return;\n")],
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


def between(text: str, start: str, end: str) -> str:
    """The part of ``text`` from ``start`` up to (not including) ``end``."""
    i = text.index(start)
    return text[i:text.index(end, i)]


def variant_csrc(src: str, name: str, file: str, patches) -> str:
    """A copy of the kernel sources with ``patches`` applied to ``file``
    (a list of (old, new), or a function of the source text giving one)."""
    dst = os.path.join(OUT, name, "csrc")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    path = os.path.join(dst, file)
    with open(path) as f:
        text = f.read()
        if callable(patches):
            patches = patches(text)
        text = patch(text, name, patches)
    with open(path, "w") as f:
        f.write(text)
    return dst


def use(build, name: str, csrc: str) -> None:
    """Point the kernel builder at ``csrc`` and its own library folder."""
    from pathlib import Path
    build._CSRC = Path(csrc)
    build.BUILD_DIR = Path(OUT) / name / "lib"
    build._LIBS.clear()


def prebuild(build, variants, lib: str) -> None:
    """Compile ``lib`` for every variant at once (one nvcc each), where
    ``use`` will look for it."""
    import subprocess
    procs = []
    for name, csrc in variants:
        use(build, name, csrc)
        out = build._lib_path(lib)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        procs.append((name, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-o", str(out),
             os.path.join(csrc, f"{lib}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")


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


def narrow_data(torch, dev):
    """The decode kernels' inputs at M = 8: qwen3-4b's seven int8
    projections and its three bf16 MLP GEMMs, seeded."""
    gen = torch.Generator(dev).manual_seed(12)
    i8 = dict(generator=gen, device=dev, dtype=torch.int8)
    a8 = torch.randint(-127, 128, (8, 9728), **i8)
    int8 = [(name, a8[:, :k].contiguous(), torch.randint(-127, 128, (k, n),
                                                          **i8))
            for name, k, n in (("wq", 2560, 4096), ("wk", 2560, 1024),
                               ("wv", 2560, 1024), ("attn_wo", 4096, 2560),
                               ("wi", 2560, 9728), ("wi_gate", 2560, 9728),
                               ("mlp_wo", 9728, 2560))]
    d, ff = 2560, 9728
    x = (torch.randn((8, ff), generator=gen, device=dev) * 0.5).bfloat16()
    bf16 = [(name, x[:, :k].contiguous(),
             (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
              ).bfloat16(), act)
            for name, k, n, act in (("gate", d, ff, "silu"),
                                    ("up", d, ff, "none"),
                                    ("down", ff, d, "none"))]
    return int8, bf16


def narrow_round(torch, cs, build, variants, data):
    """The decode kernels on each variant through the port's wrappers:
    the int8 set bitwise and the bf16 set within one ulp of their plain
    versions, the device ms of each set (``splits_8`` lowers the Python
    split cap for its run)."""
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import ref
    int8, bf16 = data
    cap, blocks = km.NARROW_SPLITS, km.NARROW_BLOCKS
    for name, csrc in variants:
        use(build, name, csrc)
        km.NARROW_SPLITS = 8 if name == "splits_8" else cap
        km.NARROW_BLOCKS = (int(name.split("_")[1]) if
                            name.startswith("blocks_") else blocks)
        km.narrow_split.cache_clear()
        line = {"phase": "variant", "kernel": "matmul_narrow",
                "variant": name, "int8_device_ms": 0.0,
                "bf16_device_ms": 0.0, "int8_bitwise": True,
                "bf16_over_ulp": 0.0}
        for label, a, w in int8:
            before = km.matmul_int8.narrow_launches
            out = km.matmul_int8(a, w)
            assert km.matmul_int8.narrow_launches == before + 1, name
            line["int8_bitwise"] &= bool(torch.equal(
                out, ref.matmul_int8(a, w)))
            line[f"{label}_device_ms"] = cs.device_ms(
                torch, lambda: km.matmul_int8(a, w))
            line["int8_device_ms"] += line[f"{label}_device_ms"]
        for label, a, w, act in bf16:
            out = km.matmul_bf16(a, w, activation=act)
            want = ref.matmul(a, w, activation=act)
            line["bf16_over_ulp"] = max(line["bf16_over_ulp"], (
                out.float() - want.float()).abs().max().item() / cs.bf16_ulp(
                    want.float().abs().max().item()))
            line[f"{label}_device_ms"] = cs.device_ms(
                torch, lambda: km.matmul_bf16(a, w, activation=act))
            line["bf16_device_ms"] += line[f"{label}_device_ms"]
        emit(line)
    km.NARROW_SPLITS, km.NARROW_BLOCKS = cap, blocks
    km.narrow_split.cache_clear()


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


def flash_f32_round(torch, cs, build, variants, q, k, v, want, abs_attn):
    """The f32 route (qwen3-4b's attention in f32, 1 x 4096) on each
    variant of the 3xTF32 kernels (``wgmma_*`` the wgmma .tf32 one, the
    route's at this shape; the rest its mma.sync one, which the sound
    source runs too): its error over F32_FLASH_RULE's bar and its event
    ms; the CUDA-core kernel once, the sound source's."""
    from repro_torch.kernels import flash_attention as kfa
    for name, csrc in variants:
        use(build, name, csrc)
        kernels = ([("wgmma", True)] if name.startswith("wgmma_") else
                   [("mma_sync", False)] + ([("wgmma", True)]
                                            if name.startswith("sound")
                                            else []))
        for kernel, wgmma in kernels:
            out = kfa._tf32x3(q, k, v, True, None, wgmma)
            emit({"phase": "variant", "kernel": "flash_attention_tf32x3",
                  "tf32x3_kernel": kernel, "variant": name,
                  "err_over_bar": cs.flash_bar_excess(
                      out, want, abs_attn, "float32"),
                  "ms": cs.time_ms(torch, lambda: kfa._tf32x3(
                      q, k, v, True, None, wgmma), reps=5, warm=1)})
        if name == "sound":
            emit({"phase": "variant", "kernel": "flash_attention_generic",
                  "variant": "sound", "err_over_bar": cs.flash_bar_excess(
                      kfa.generic(q, k, v), want, abs_attn, "float32"),
                  "ms": cs.time_ms(torch, lambda: kfa.generic(q, k, v),
                                   reps=2, warm=1)})


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


def conv_int8_layers(torch, dev):
    """The tick's conv2-conv5 as the unfused int8 chain gives them: int8
    ``[carry | chunk]`` rows and weights, seeded, with each layer's B
    fragments."""
    from repro_torch.core import basecaller as bc
    from repro_torch.quant.core import pack_fragments
    gen = torch.Generator(dev).manual_seed(6)
    out, t = [], 256
    for sp in bc.stream_layer_specs(bc.BasecallerConfig()):
        if sp.name != "conv1" and not sp.is_head:
            i8 = dict(generator=gen, device=dev, dtype=torch.int8)
            x = torch.randint(-127, 128, (512, t + sp.carry_rows, sp.cin),
                              **i8)
            w = torch.randint(-127, 128, (sp.ksize, sp.cin, sp.cout), **i8)
            out.append((sp.name, x, w, pack_fragments(w), sp.stride))
        t //= sp.stride
    return out


def conv_int8_round(torch, cs, build, variants, layers):
    """The int8 conv on each variant at the tick's conv2-conv5: bitwise
    against the plain version, event and device ms a layer."""
    from repro_torch.kernels import conv1d as kc
    from repro_torch.kernels import ref
    sound_predicate = kc.int8_tensor_core_shape
    for name, csrc in variants:
        use(build, name, csrc)
        if name == "dp4a":
            kc.int8_tensor_core_shape = lambda *a: False
        try:
            line = {"phase": "variant", "kernel": "conv1d_int8",
                    "variant": name}
            for label, x, w, frags, s in layers:
                before = kc.conv1d_int8.tc_launches
                fn = (lambda x=x, w=w, s=s, frags=frags: kc.conv1d_int8(
                    x, w, stride=s, w_fragments=frags))
                out = fn()
                assert kc.conv1d_int8.tc_launches == before + (
                    name != "dp4a"), name
                line[f"{label}_equal_to_plain_bitwise"] = torch.equal(
                    out, ref.conv1d_int8(x, w, stride=s))
                line[f"{label}_ms"] = cs.time_ms(torch, fn, reps=10)
                line[f"{label}_device_ms"] = cs.device_ms(torch, fn)
            line["device_ms"] = sum(v for k, v in line.items()
                                    if k.endswith("_device_ms"))
            emit(line)
        finally:
            kc.int8_tensor_core_shape = sound_predicate


def banded_data(torch, dev):
    """The wavefront's three path shapes, seeded: the mapper's call (2,048
    pairs, 48 vs 80, band 32, local), the pathogen firehose (39,680 pairs,
    reads of 256 against 512-base windows, local, half of them holding
    their read) and the demux (6,144 pairs of 12 vs 12, levenshtein), each
    with its plain result."""
    from repro_torch.kernels import ref
    gen = torch.Generator(dev).manual_seed(7)
    tok = dict(generator=gen, device=dev, dtype=torch.int32)
    out = []
    for label, p, m, n, band in (("mapper", 2048, 48, 80, 32),
                                 ("firehose", 39_680, 256, 512, 512)):
        q = torch.randint(1, 5, (p, m), **tok)
        t = torch.randint(0, 5, (p, n), **tok)
        t[::2, (n - m) // 2:(n + m) // 2] = q[::2]
        kw = dict(band=band, match=2, mismatch=-4, gap=-2, local=True)
        out.append((label, q, t, kw, ref.banded_align(q, t, **kw)))
    q = torch.randint(1, 5, (6144, 12), **tok)
    t = torch.where(torch.rand((6144, 12), generator=gen, device=dev) < 0.2,
                    torch.randint(1, 5, (6144, 12), **tok), q)
    out.append(("demux", q, t, None, ref.edit_distance(q, t)))
    return out


def banded_round(torch, cs, build, variants, data):
    """The wavefront on each variant at the three path shapes: bitwise
    against the plain version, event and device ms."""
    from repro_torch.kernels import edit_distance as ke
    for name, csrc in variants:
        use(build, name, csrc)
        attr, value = BANDED_PLANS.get(name, (None, None))
        sound_value = getattr(ke, attr) if attr else None
        if attr:
            setattr(ke, attr, value)
        try:
            line = {"phase": "variant", "kernel": "banded_align",
                    "variant": name}
            for label, q, t, kw, want in data:
                fn = ((lambda q=q, t=t: ke.levenshtein(q, t)) if kw is None
                      else (lambda q=q, t=t, kw=kw: ke.banded_align(q, t,
                                                                    **kw)))
                line[f"{label}_plan"] = ke.plan(q.shape[1],
                                                t.shape[1])._asdict()
                line[f"{label}_equal_to_plain_bitwise"] = torch.equal(
                    fn(), want)
                line[f"{label}_ms"] = cs.time_ms(torch, fn, reps=10)
                line[f"{label}_device_ms"] = cs.device_ms(torch, fn, reps=10)
            emit(line)
        finally:
            if attr:
                setattr(ke, attr, sound_value)


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


def ssd_round(torch, cs, build, variants, data):
    """ssd_scan on each variant at mamba2-780m's 48 heads x 4096 (B/C one
    row over the heads): max abs error against the plain recurrence for
    bf16 and f32 inputs, event ms and each pass's device ms."""
    from repro_torch.kernels import ssd_scan as kssd
    for name, csrc in variants:
        use(build, name, csrc)
        line = {"phase": "variant", "kernel": "ssd_scan", "variant": name}
        for label, args, want in data:
            out = kssd.ssd_scan(*args, chunk=256)
            line[f"{label}_max_abs_err"] = (
                out.float() - want.float()).abs().max().item()
            line[f"{label}_ms"] = cs.time_ms(
                torch, lambda: kssd.ssd_scan(*args, chunk=256), reps=10)
            per = cs.kernel_device_ms(
                torch, lambda: kssd.ssd_scan(*args, chunk=256))
            line[f"{label}_device_ms_by_pass"] = {
                cs.SSD_PASSES.get(k, k): v for k, v in per.items()}
            line[f"{label}_device_ms"] = sum(per.values())
        emit(line)


def int8_round(torch, cs, build, variants, cfg, qparams, inputs):
    """The int8 fused tick on each variant: tokens, lens, counters and
    carries against the plain version bit for bit, device ms (queued
    launches) and the kernel's own (the profiler)."""
    from repro_torch.kernels import fused_stream as fs
    args = (*inputs, qparams)
    tok_p, lens_p, lane_p = fs._fused_reference(*args, cfg=cfg)
    sound_predicate = fs.on_tensor_cores
    for name, csrc in variants:
        use(build, name, csrc)
        if name == "dp4a":
            fs.on_tensor_cores = (lambda sp, quantized=False:
                                  not quantized and sound_predicate(sp))
        fs._launch_meta.cache_clear()
        try:
            tok, lens, lane = fs.fused_stream_cuda(*args, cfg=cfg)
            equal = (torch.equal(tok, tok_p) and torch.equal(lens, lens_p)
                     and all(torch.equal(lane[k], lane_p[k]) for k in
                             ("prev_class", "bases", "ticks"))
                     and all(torch.equal(a, b) for a, b in
                             zip(lane["conv"], lane_p["conv"])))
            fn = lambda: fs.fused_stream_cuda(*args, cfg=cfg)  # noqa: E731
            emit({"phase": "variant", "kernel": "fused_stream_int8",
                  "variant": name, "equal_to_plain_bitwise": equal,
                  "ms": cs.time_ms(torch, fn),
                  "device_ms": cs.device_ms(torch, fn),
                  "kernel_device_ms": sum(
                      cs.kernel_device_ms(torch, fn).values())})
        finally:
            fs.on_tensor_cores = sound_predicate
            fs._launch_meta.cache_clear()


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
    ap.add_argument("--only", choices=("gemm", "flash", "flash_f32", "conv",
                                       "fused", "ssd", "banded", "narrow"))
    args = ap.parse_args()
    runs = ({args.only} if args.only
            else {"gemm", "flash", "flash_f32", "conv", "fused", "ssd",
                  "banded", "narrow"})
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
            (n, sound if p is None else variant_csrc(sound, prefix + n, file,
                                                     p))
            for n, p in table.items() if not pick or n in pick] + [
            ("sound_last", sound)]

    gemm = variants(GEMM, "", "matmul.cu")
    flash = variants(FLASH, "", "flash_attention.cu")
    flash_f32 = variants(FLASH_F32, "tf_", "flash_attention.cu")
    conv = variants(CONV, "conv1d_", "conv1d.cu")
    conv_int8 = variants(CONV_INT8, "conv1d_int8_", "conv1d.cu")
    banded = variants(BANDED, "banded_", "banded_align.cu")
    fused = variants(FUSED, "fused_", "fused_stream.cu")
    int8 = variants(INT8, "int8_", "fused_stream.cu")
    ssd = variants(SSD, "ssd_", "ssd_scan.cu")
    narrow = variants(NARROW, "narrow_", "matmul.cu")
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
    if "flash_f32" in runs:
        q32 = torch.randn((1, cfg.num_heads, s_len, cfg.head_dim),
                          generator=gen, device=dev)
        k32, v32 = (torch.randn((1, cfg.num_kv_heads, s_len, cfg.head_dim),
                                generator=gen, device=dev) for _ in range(2))
        want32 = ref.attention(q32, k32, v32, causal=True)
        abs32 = ref.attention(q32, k32, v32.abs(), causal=True)
    layers = conv_layers(torch, dev)
    int8_layers = conv_int8_layers(torch, dev) if "conv" in runs else []
    banded_dp = banded_data(torch, dev) if "banded" in runs else []
    from repro_torch.core import basecaller as bc
    fcfg = bc.BasecallerConfig()
    from repro_torch.engine.base import quantize_edge_params
    fparams = bc.init(torch.Generator().manual_seed(0), fcfg, device="cpu")
    fqparams = bc.params_to(quantize_edge_params(fparams, fcfg, chunk=512),
                            dev)
    fparams = bc.params_to(fparams, dev)
    finputs = cs.fused_inputs(torch, bc, fcfg, 512, 256,
                              torch.Generator().manual_seed(1), dev)
    ssd_data = []
    if "ssd" in runs:
        m2 = ARCHS["mamba2-780m"].config()
        xb = cs.ssd_inputs(torch, torch.nn.functional, cs.LM_SEQ, gen, dev,
                           bh=m2.ssm_heads, ds=m2.ssm_state,
                           dh=m2.ssm_head_dim)
        x32 = (xb[0].float(), xb[1], xb[2].float(), xb[3].float())
        ssd_data = [("bf16", xb, ref.ssd_scan(*xb)[0]),
                    ("f32", x32, ref.ssd_scan(*x32)[0])]
    narrow_dp = None
    if "narrow" in runs:
        prebuild(_build, narrow, "matmul")
        narrow_dp = narrow_data(torch, dev)
    for rnd in range(args.reps):
        emit({"phase": "round", "round": rnd})
        if "narrow" in runs:
            narrow_round(torch, cs, _build, narrow, narrow_dp)
        if "gemm" in runs:
            gemm_round(torch, cs, _build, gemm, data)
        if "flash" in runs:
            flash_round(torch, cs, _build, flash, q, k, v, want, abs_attn)
        if "flash_f32" in runs:
            flash_f32_round(torch, cs, _build, flash_f32, q32, k32, v32,
                            want32, abs32)
        if "conv" in runs:
            conv_round(torch, cs, _build, conv, layers)
            conv_int8_round(torch, cs, _build, conv_int8, int8_layers)
        if "banded" in runs:
            banded_round(torch, cs, _build, banded, banded_dp)
        if "fused" in runs:
            fused_round(torch, cs, _build, fused, fcfg, fparams, fqparams,
                        finputs)
            int8_round(torch, cs, _build, int8, fcfg, fqparams, finputs)
        if "ssd" in runs:
            ssd_round(torch, cs, _build, ssd, ssd_data)
    use(_build, "sound", sound)
    F = torch.nn.functional
    lib = {}
    if "narrow" in runs:
        lib["cublas_decode_device_ms"] = {
            label: cs.device_ms(torch, (lambda a=a, w=w, act=act: F.silu(
                torch.matmul(a, w)) if act == "silu" else torch.matmul(a, w)))
            for label, a, w, act in narrow_dp[1]}
    if "gemm" in runs:
        lib["cublas_ms"] = {
            label: cs.time_ms(torch, (lambda a=a, w=w, act=act: F.silu(
                torch.matmul(a, w)) if act == "silu" else torch.matmul(a, w)),
                reps=10)
            for label, a, w, act in data}
    if "flash" in runs:
        lib["sdpa_ms"] = cs.sdpa_ms(torch, F, q, k, v)
    if "flash_f32" in runs:
        lib["sdpa_f32_ms"] = cs.sdpa_f32_ms(torch, F, q32, k32, v32)
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
