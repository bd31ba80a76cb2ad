// Blocked online-softmax (flash) attention, bf16 in, f32 statistics, bf16 out.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (Pallas
// body _flash_kernel): grid (B*Hq, Sq/bq, Skv/bk) with the KV axis the
// sequential one, carrying m, l and acc in scratch; causal blocks past the
// diagonal skipped; GQA by pointing the K/V index at q_head // group.
//
// q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), out (B, Hq, Sq, D), all bf16,
// contiguous; D in {16, 32, 64, 128}.
//
// Semantics kept from the Pallas body: logits q.k in f32 times `scale`;
// causal rows aligned to the last token (key j is seen by row i iff
// j <= i + Skv - Sq); masked logits set to -1e30, not -inf; p = exp(s - m)
// in f32 (computed as 2^(s log2(e) - m log2(e)), the row max taken on the
// raw logits, which a scale > 0 keeps), l summed from the f32 p, but p
// rounded to bf16 before the PV product; one division by l at the end.
// Ragged Sq and Skv are handled here (TMA zero-fills rows past either,
// rows past Sq are not written, keys past Skv get -1e30), so every length
// is taken.
//
// Bound on this card: on the path (qwen3-4b, 32 x 8 heads, S = 4096,
// D = 128) operations, 1.4e11 bf16 FLOP a call against 80 MB of q, k, v
// and out.  Design: both products on wgmma, fed by TMA.  A block takes 128
// query rows of one head: two consumer warpgroups of 64 rows (setmaxnreg
// 232) and a producer warpgroup (setmaxnreg 40) one thread of which loads
// the Q tile once and then 128-key tiles of K and of V, each through a
// two-stage ring with full and empty mbarriers.  S = Q K^T is an
// m64n128k16 wgmma with Q and K from shared memory (both K-major: D is
// contiguous); the online softmax runs on the S accumulator in registers
// (row max and sum across the 4 threads of a row by shuffles); P, rounded
// to bf16, is the register A operand of O += P V (m64nDk16, V MN-major
// through the transpose bit), its fragments read in place from the S
// accumulator.  The mask runs only on tiles that cross the causal diagonal
// or the last key; tiles wholly below it skip it.  Tiles are stored with
// the swizzle of their row (128 bytes, or 64 / 32 at D = 32 / 16); at
// D = 128 a tile is two boxes of 64 columns.  Query tiles are issued
// longest first across all heads (grid x = heads: neighbouring blocks are
// the q heads that share a KV head in L2; y = tiles reversed, at most
// 65,535 a launch, so a longer Sq takes more launches), and the causal
// diagonal's short blocks fill the last wave.
//
// Every other case (kernels/flash_attention.py route()) runs a kernel below,
// each with its own note: f32, f16, and bf16 at another head dim up to
// D = 256 on 3xTF32 tensor cores (flash_attention_tf32x3_wgmma_kernel for
// f32 at 64 < D <= 128, flash_attention_tf32x3_kernel for the rest), and
// past D = 256 flash_attention_generic_kernel on the CUDA cores, kept only
// as the route past the tensor-core kernels' reach.
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

constexpr int FA_BQ = 128;      // query rows per block: 2 warpgroups x 64
constexpr int FA_BK = 128;      // keys per K / V tile
constexpr int FA_STAGES = 2;    // ring depth of K and of V
constexpr int FA_THREADS = 384;
constexpr float FA_NEG = -1e30f;
constexpr float FA_LOG2E = 1.4426950408889634f;

// 2^x in one MUFU op (subnormal results flush to 0: p < 2^-126 of the
// row's largest, far below what bf16 P and the f32 sum l can hold).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
struct FaShape {
  static constexpr int RB = D * 2 < 128 ? D * 2 : 128;  // bytes of a tile row
  static constexpr int BOXES = D * 2 / RB;             // column boxes a tile
  static constexpr int KPB = RB / 32;                  // 16-wide k-steps a box
  static constexpr int Q_BYTES = FA_BQ * D * 2;
  static constexpr int KV_BYTES = FA_BK * D * 2;
  static constexpr int SMEM = Q_BYTES + 2 * FA_STAGES * KV_BYTES + 1024;
};

template <int D>
__global__ void __launch_bounds__(FA_THREADS, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ out, int hq, int hkv,
                       int sq, int skv, float scale, int causal, int top) {
  using S = FaShape<D>;
  extern __shared__ uint8_t fa_smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t k_full[FA_STAGES], k_empty[FA_STAGES];
  __shared__ __align__(8) uint64_t v_full[FA_STAGES], v_empty[FA_STAGES];
  uint8_t* qs = align1024(fa_smem_raw);
  uint8_t* ks = qs + S::Q_BYTES;
  uint8_t* vs = ks + FA_STAGES * S::KV_BYTES;

  const int bh = blockIdx.x;                         // b * hq + query head
  // top: this launch's first query tile, counted from the start
  const int q0 = (top - static_cast<int>(blockIdx.y)) * FA_BQ;
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int offs = skv - sq;
  const int q_end = min(q0 + FA_BQ, sq);
  int last_k = (skv + FA_BK - 1) / FA_BK - 1;
  if (causal) last_k = min(last_k, (q_end - 1 + offs) / FA_BK);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < FA_STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);  // one arrival per consumer warp
      mbar_init(&v_empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(&q_full, S::Q_BYTES);
#pragma unroll
      for (int b = 0; b < S::BOXES; ++b)
        tma_load_3d(qs + b * FA_BQ * S::RB, &tq, &q_full, b * 64, q0, bh);
      int s = 0;
      uint32_t ph = 0;
      for (int kb = 0; kb <= last_k; ++kb) {
        mbar_wait(&k_empty[s], ph ^ 1);
        mbar_expect_tx(&k_full[s], S::KV_BYTES);
#pragma unroll
        for (int b = 0; b < S::BOXES; ++b)
          tma_load_3d(ks + s * S::KV_BYTES + b * FA_BK * S::RB, &tk, &k_full[s],
                      b * 64, kb * FA_BK, kvh);
        mbar_wait(&v_empty[s], ph ^ 1);
        mbar_expect_tx(&v_full[s], S::KV_BYTES);
#pragma unroll
        for (int b = 0; b < S::BOXES; ++b)
          tma_load_3d(vs + s * S::KV_BYTES + b * FA_BK * S::RB, &tv, &v_full[s],
                      b * 64, kb * FA_BK, kvh);
        if (++s == FA_STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {  // consumers: warpgroup wg owns query rows q0 + 64 wg ..
    regs_alloc<232>();
    const int lane = threadIdx.x % 32;
    const int wl = (threadIdx.x % 128) / 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int rw0 = q0 + wg * 64;          // the warpgroup's first row
    const int r0 = rw0 + wl * 16 + g;      // this thread's rows r0, r0 + 8
    const float sl2 = scale * FA_LOG2E;    // logit to the exp2 domain

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float s_acc[FA_BK / 2];
    float m[2] = {FA_NEG, FA_NEG};  // running max, exp2 domain
    float l[2] = {0.f, 0.f};

    mbar_wait(&q_full, 0);
    int s = 0;
    uint32_t ph = 0;
    for (int kb = 0; kb <= last_k; ++kb) {
      const int k0 = kb * FA_BK;
      // S = Q K^T
      mbar_wait(&k_full[s], ph);
      const uint8_t* kt = ks + s * S::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int box = kk / S::KPB, in_row = (kk % S::KPB) * 32;
        const uint64_t dq = wgmma_desc(
            qs + box * FA_BQ * S::RB + wg * 64 * S::RB + in_row, 0, 8 * S::RB, S::RB);
        const uint64_t dk =
            wgmma_desc(kt + box * FA_BK * S::RB + in_row, 0, 8 * S::RB, S::RB);
        wgmma_ss<FA_BK, 0>(s_acc, dq, dk, kk != 0);
      }
      wgmma_commit();
      fence_regs(s_acc);
      wgmma_wait<0>();
      fence_regs(s_acc);
      if (lane == 0) mbar_arrive(&k_empty[s]);

      // mask where the tile needs it (raw logits: scale > 0 keeps the max)
      const bool masked = k0 + FA_BK > skv || (causal && k0 + FA_BK - 1 > rw0 + offs);
      if (masked) {
#pragma unroll
        for (int i = 0; i < FA_BK / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r0 + (e < 2 ? 0 : 8);
            const int col = k0 + i * 8 + 2 * t4 + (e & 1);
            const bool ok = col < skv && (!causal || col <= row + offs);
            s_acc[4 * i + e] = ok ? s_acc[4 * i + e] : FA_NEG;
          }
        }
      }

      // online softmax in the exp2 domain (rows r0: e = 0, 1; r0 + 8:
      // e = 2, 3): m is the running max of logit * scale * log2(e), and
      // p = 2^(logit * sl2 - m) in one fma and one ex2
      float mx[2] = {FA_NEG, FA_NEG};
#pragma unroll
      for (int i = 0; i < FA_BK / 8; ++i) {
        mx[0] = fmaxf(mx[0], fmaxf(s_acc[4 * i], s_acc[4 * i + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s_acc[4 * i + 2], s_acc[4 * i + 3]));
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mx[r] = fmaxf(m[r], mx[r] * sl2);
        alpha[r] = ex2_ftz(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < FA_BK / 2; ++i) {
        s_acc[i] = ex2_ftz(fmaf(s_acc[i], sl2, -mx[(i >> 1) & 1]));
        rs[(i >> 1) & 1] += s_acc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[r] = alpha[r] * l[r] + rs[r];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      // O += bf16(P) V: S chunks 2kk, 2kk + 1 form the A fragment of k-step kk
      uint32_t pa[FA_BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < FA_BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s_acc[8 * kk + 0], s_acc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s_acc[8 * kk + 2], s_acc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s_acc[8 * kk + 4], s_acc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s_acc[8 * kk + 6], s_acc[8 * kk + 7]);
      }
      mbar_wait(&v_full[s], ph);
      const uint8_t* vt = vs + s * S::KV_BYTES;
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < FA_BK / 16; ++kk) {
        const uint64_t dv =
            wgmma_desc(vt + kk * 16 * S::RB, FA_BK * S::RB, 8 * S::RB, S::RB);
        wgmma_rs<D, 1>(o, pa[kk], dv, 1);
      }
      wgmma_commit();
      fence_regs(o);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&v_empty[s]);
      if (++s == FA_STAGES) {
        s = 0;
        ph ^= 1;
      }
    }

    __nv_bfloat16* op = out + static_cast<size_t>(bh) * sq * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int c = i * 8 + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r < sq)
          *reinterpret_cast<uint32_t*>(op + static_cast<size_t>(r) * D + c) =
              pack_bf16(o[4 * i + 2 * h] / l[h], o[4 * i + 2 * h + 1] / l[h]);
      }
    }
  }
}

// A (B * H, S, D) view of one bf16 operand as a 3-d tensor map with boxes
// of `rows` x min(D, 64) columns.
template <int D>
static int encode_heads(CUtensorMap* map, const void* base, int bh, int len,
                        int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(len) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(FaShape<D>::RB / 2),
                             static_cast<cuuint32_t>(rows), 1};
  return encode_tmap_bf16(map, base, 3, dims, strides, box, FaShape<D>::RB);
}

template <int D>
static int launch_d(const void* q, const void* k, const void* v, void* out,
                    int b, int hq, int hkv, int sq, int skv, float scale,
                    int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int rc = encode_heads<D>(&tq, q, b * hq, sq, FA_BQ);
  if (rc == 0) rc = encode_heads<D>(&tk, k, b * hkv, skv, FA_BK);
  if (rc == 0) rc = encode_heads<D>(&tv, v, b * hkv, skv, FA_BK);
  if (rc != 0) return rc;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = allow_smem(flash_attention_kernel<D>, FaShape<D>::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  // query tiles longest first, at most 65,535 (the grid's y) a launch
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
  return 0;
}

extern "C" int launch_flash_attention(const void* q, const void* k,
                                      const void* v, void* out, int b, int hq,
                                      int hkv, int sq, int skv, int d,
                                      float scale, int causal, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch_d<16>(q, k, v, out, b, hq, hkv, sq, skv, scale, causal, s);
    case 32:
      return launch_d<32>(q, k, v, out, b, hq, hkv, sq, skv, scale, causal, s);
    case 64:
      return launch_d<64>(q, k, v, out, b, hq, hkv, sq, skv, scale, causal, s);
    case 128:
      return launch_d<128>(q, k, v, out, b, hq, hkv, sq, skv, scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- the generic kernel: any element type, any head dim --------------------
//
// The same function (f32 logits times scale, the causal mask aligned to the
// last token, GQA, ragged Sq and Skv), for f32, bf16 or f16 q/k/v and any
// head dim D >= 1 whose rows fit shared memory.  It remains only as the
// route past the 3xTF32 kernels' reach, D > 256 (kernels/flash_attention.py
// route() "generic"), which no config of the repo has; every f32 LM runs
// the tensor-core kernels.  Everything is f32 on the CUDA cores: the online
// softmax keeps m, l and the output row in f32, P is never rounded, and the
// output is rounded once to the element type after the division by l.
// JAX's kernel is the same arithmetic in f32 (preferred_element_type,
// repro/kernels/flash_attention.py:29-73).
//
// A block takes `rows` query rows of one head, a warp each, and walks the
// keys in tiles of 32, one key a lane: lane j sums q . k_j over the columns,
// the warp takes the tile's max and sum by shuffles, then each lane owns
// the output columns lane, lane + 32, ... and adds sum_j p_j v_j.  K and V
// tiles are staged in shared memory 64 columns at a time (K rows padded to
// 65 floats, so lane j's reads of row j hit 32 banks) and serve all the
// block's rows; each row's q and output accumulator live in shared memory,
// so D is not bounded by registers.  Bound on this card: operations, 4 D
// FLOP a kept (row, key) pair at the fp32 rate, 2.05 ms at qwen3-4b f32 1 x
// 4096; it takes ~23 ms there (chip_smoke.py row 5g's was_ms), every key
// re-staged by each 8-row block, two shared-memory loads an FMA.
constexpr int FG_KEYS = 32;   // keys a tile: one a lane
constexpr int FG_COLS = 64;   // columns of K and V staged at once

__device__ __forceinline__ float fg_load(const float* p) { return *p; }
__device__ __forceinline__ float fg_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float fg_load(const __half* p) {
  return __half2float(*p);
}
__device__ __forceinline__ void fg_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void fg_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void fg_store(__half* p, float v) {
  *p = __float2half_rn(v);
}

// The 3xTF32 kernel takes f32 as float and both 16-bit types as their
// bits (uint16_t), f16 or bf16 by a flag: each is exact in TF32, so one
// instantiation serves the two.
__device__ __forceinline__ float tf_load(const uint16_t* p, int f16) {
  return f16 ? __half2float(__ushort_as_half(*p))
             : __bfloat162float(__ushort_as_bfloat16(*p));
}
__device__ __forceinline__ void tf_store(float* p, float v, int) { *p = v; }
__device__ __forceinline__ void tf_store(uint16_t* p, float v, int f16) {
  *p = f16 ? __half_as_ushort(__float2half_rn(v))
           : __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(256)
flash_attention_generic_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ out,
                               int hq, int hkv, int sq, int skv, int d,
                               float scale, int causal, int rows,
                               long long block0, int tiles) {
  extern __shared__ float fg_smem[];
  float* ks = fg_smem;                      // [FG_KEYS][FG_COLS + 1]
  float* vs = ks + FG_KEYS * (FG_COLS + 1);  // [FG_KEYS][FG_COLS]
  float* qs = vs + FG_KEYS * FG_COLS;        // [rows][d]
  float* os = qs + rows * d;                 // [rows][d]
  float* ps = os + rows * d;                 // [rows][FG_KEYS]

  const long long blk = block0 + blockIdx.x;
  const int bh = static_cast<int>(blk / tiles);
  const int r0 = static_cast<int>(blk % tiles) * rows;
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int offs = skv - sq;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = r0 + w;
  const bool active = w < rows && r < sq;
  const int nthreads = blockDim.x;

  const T* qh = q + static_cast<size_t>(bh) * sq * d;
  const T* kh = k + static_cast<size_t>(kvh) * skv * d;
  const T* vh = v + static_cast<size_t>(kvh) * skv * d;
  for (int i = threadIdx.x; i < rows * d; i += nthreads) {
    const int row = r0 + i / d;
    qs[i] = row < sq ? fg_load(qh + static_cast<size_t>(row) * d + i % d) : 0.f;
    os[i] = 0.f;
  }
  // keys past the block's last row's diagonal are masked for every row
  int kend = skv;
  if (causal) kend = min(skv, min(r0 + rows, sq) - 1 + offs + 1);
  float m = -INFINITY, l = 0.f;
  float* qw = qs + w * d;
  float* ow = os + w * d;
  float* pw = ps + w * FG_KEYS;
  __syncthreads();

  for (int kt = 0; kt < kend; kt += FG_KEYS) {
    const int nk = min(FG_KEYS, kend - kt);
    float s = 0.f;
    for (int c0 = 0; c0 < d; c0 += FG_COLS) {
      const int nc = min(FG_COLS, d - c0);
      for (int i = threadIdx.x; i < FG_KEYS * FG_COLS; i += nthreads) {
        const int j = i / FG_COLS, c = i % FG_COLS;
        ks[j * (FG_COLS + 1) + c] =
            j < nk && c < nc
                ? fg_load(kh + static_cast<size_t>(kt + j) * d + c0 + c)
                : 0.f;
      }
      __syncthreads();
      if (active) {
        const float* kr = ks + lane * (FG_COLS + 1);
        for (int c = 0; c < nc; ++c) s = fmaf(qw[c0 + c], kr[c], s);
      }
      __syncthreads();
    }
    float alpha = 1.f;
    if (active) {
      const int key = kt + lane;
      const bool ok = lane < nk && (!causal || key <= r + offs);
      const float sc = ok ? s * scale : -INFINITY;
      float mx = sc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m, mx);  // finite: key 0 is in every row's
                                          // first tile
      alpha = expf(m - m_new);
      const float p = ok ? expf(sc - m_new) : 0.f;
      float ps_sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ps_sum += __shfl_xor_sync(0xffffffffu, ps_sum, o);
      l = l * alpha + ps_sum;
      m = m_new;
      pw[lane] = p;
      __syncwarp();
    }
    for (int c0 = 0; c0 < d; c0 += FG_COLS) {
      const int nc = min(FG_COLS, d - c0);
      for (int i = threadIdx.x; i < FG_KEYS * FG_COLS; i += nthreads) {
        const int j = i / FG_COLS, c = i % FG_COLS;
        vs[i] = j < nk && c < nc
                    ? fg_load(vh + static_cast<size_t>(kt + j) * d + c0 + c)
                    : 0.f;
      }
      __syncthreads();
      if (active) {
        for (int c = lane; c < nc; c += 32) {
          float acc = ow[c0 + c] * alpha;
          for (int j = 0; j < nk; ++j) acc = fmaf(pw[j], vs[j * FG_COLS + c], acc);
          ow[c0 + c] = acc;
        }
      }
      __syncthreads();
    }
  }
  if (active) {
    T* orow = out + (static_cast<size_t>(bh) * sq + r) * d;
    for (int c = lane; c < d; c += 32) fg_store(orow + c, ow[c] / l);
  }
}

// Shared memory of the generic kernel for `rows` rows of head dim d
// (kernels/flash_attention.py generic_smem_bytes).
static size_t fg_smem_bytes(int rows, int d) {
  return sizeof(float) * (static_cast<size_t>(FG_KEYS) * (FG_COLS + 1) +
                          FG_KEYS * FG_COLS +
                          static_cast<size_t>(rows) * (2 * d + FG_KEYS));
}

template <typename T>
static int launch_generic(const void* q, const void* k, const void* v,
                          void* out, int b, int hq, int hkv, int sq, int skv,
                          int d, float scale, int causal, int rows,
                          cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err =
        allow_smem(flash_attention_generic_kernel<T>, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const size_t smem = fg_smem_bytes(rows, d);
  if (smem > static_cast<size_t>(SMEM_BYTES))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (sq + rows - 1) / rows;
  const long long total = static_cast<long long>(b) * hq * tiles;
  for (long long b0 = 0; b0 < total; b0 += 0x7fffffffLL) {
    const long long n = total - b0 < 0x7fffffffLL ? total - b0 : 0x7fffffffLL;
    flash_attention_generic_kernel<T>
        <<<static_cast<unsigned>(n), rows * 32, smem, stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, sq, skv,
            d, scale, causal, rows, b0, tiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// dtype: 0 f32, 1 bf16, 2 f16; rows: query rows a block (1..8, a warp each)
extern "C" int launch_flash_attention_generic(
    const void* q, const void* k, const void* v, void* out, int b, int hq,
    int hkv, int sq, int skv, int d, float scale, int causal, int dtype,
    int rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || rows > 8 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch_generic<float>(q, k, v, out, b, hq, hkv, sq, skv, d, scale,
                                   causal, rows, s);
    case 1:
      return launch_generic<__nv_bfloat16>(q, k, v, out, b, hq, hkv, sq, skv,
                                           d, scale, causal, rows, s);
    case 2:
      return launch_generic<__half>(q, k, v, out, b, hq, hkv, sq, skv, d,
                                    scale, causal, rows, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- the 3xTF32 tensor-core kernel: f32, f16, bf16 off the wgmma route ----
//
// The generic kernel's function and arithmetic (f32 logits times scale, the
// causal mask aligned to the last token, GQA, ragged Sq and Skv, the online
// softmax in f32 with P never rounded to 16 bits, one division by l, one
// rounding to the element type at the store) for f32, f16, and bf16 at a
// head dim the bf16 wgmma kernel is not built for, up to D = 256
// (kernels/flash_attention.py route() "tf32x3"), except f32 at 64 < D <=
// 128, which the wgmma form below takes.  On the path: the f32 LMs
// (qwen3-4b's smoke at D 16 in lm_parity_f32).
//
// Bound on this card: operations, 4 D FLOP a kept (row, key) pair, each
// f32-accurate product three TF32 MMAs.  Both products run as mma.sync
// m16n8k8 TF32: each f32 operand is split hi + lo (split_tf32_int) and a
// product takes lo·hi + hi·lo + hi·hi (mma_split); a bf16 or f16 operand is
// exact in TF32 and has no lo term; P, f32, is always split.  A block takes
// BQ query rows of one (batch, q-head), a warp per 16 rows, and walks the
// keys in tiles of BK: each tile lands raw by cp.async (16-byte granules
// where every f32 row allows, else 4-byte) while the previous one computes,
// then the block splits it once into hi and lo planes that all its warps
// read (a 16-bit tile is widened into the hi planes by loads).  Rows are
// padded to DP + 4 floats, so every fragment's 32 loads hit 32 banks; the
// head dim is zero-padded to DP (16, 32, 64, 128, 256), which adds exact
// zeros, and k-steps and output columns wholly past D are skipped.  S stays
// in registers, its small terms in an accumulator of their own; the row max
// and sum are taken across the 4 threads of a row by shuffles; P's A
// fragments are read in place from the S accumulator, the keys of each
// k-step permuted (thread t holds keys 2t and 2t + 1, so V's B fragment
// reads those two rows); each tile's P V goes to a fresh accumulator added
// to O in f32 (up to DP 128), so no long sum runs in the tensor cores'
// accumulator.  Tiles wholly below the causal diagonal skip the mask, a
// warp whose rows see no key of a tile skips it, and query tiles are issued
// longest first.  Ten instantiations, five head dims x f32 and 16-bit: f16
// and bf16 share one, read and written by their bits with a flag (each is
// exact in TF32), which keeps this source's build time down (PERF.md).
//
// What was tried (scripts/kernel_variants.py --only flash_f32, qwen3-4b f32
// 1 x 4096): the first design, every warp splitting the K and V values it
// read as their fragments loaded, ran 3.88-3.91 ms at 0.80 of the f32 bar;
// splitting once for the block, 3.82-3.88 ms at 0.16 (each tile's P V
// summed into O reads 0.80, S's small terms in hi x hi's accumulator 0.36,
// in the same time); hi x hi alone ran 2.42 ms, 96x the bar.  mma.sync TF32
// reaches ~190 TFLOP/s on this card (two more products cost 1.43 ms), so
// three products cannot go below ~2.2 ms here: the wgmma form below takes
// row 5g's shape.
template <int DP>
struct TfShape {
  static constexpr int BQ = DP <= 128 ? 128 : 64;  // query rows a block
  // keys a K / V tile
  static constexpr int BK = DP <= 64 ? 64 : DP <= 128 ? 48 : 24;
  static constexpr int THREADS = BQ / 16 * 32;     // a warp per 16 rows
  static constexpr int LD = DP + 4;                // floats a staged row
  static constexpr int Q_FLOATS = BQ * LD;
  static constexpr int KV_FLOATS = BK * LD;
  // Q; the next K and V tiles raw; the current ones' hi and lo planes
  static constexpr int SMEM = 4 * (Q_FLOATS + 6 * KV_FLOATS);
  // each tile's P V in a fresh accumulator (at DP 256 its registers do not
  // fit beside O's, and P V goes into O)
  static constexpr bool FRESH = DP <= 128;
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

// A raw f32 tile (ROWS x DP, rows of LD) split once for the whole block
// into its hi and lo planes, four values a thread at a time.
template <int DP, int ROWS, int NT>
__device__ __forceinline__ void tf_split(const float* raw, float* hi,
                                         float* lo) {
  constexpr int LD = DP + 4, C4 = DP / 4;
  for (int i = threadIdx.x; i < ROWS * C4; i += NT) {
    const int at = (i / C4) * LD + (i % C4) * 4;
    const float4 v = *reinterpret_cast<const float4*>(raw + at);
    uint32_t h[4], l[4];
    split_tf32_int(v.x, h[0], l[0]);
    split_tf32_int(v.y, h[1], l[1]);
    split_tf32_int(v.z, h[2], l[2]);
    split_tf32_int(v.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// acc += P V over one tile: k-step kk is S's n-tile kk, thread t holding
// keys 2t and 2t + 1 as A's columns t and t + 4, so V's rows 2t and 2t + 1
// give the B fragment; P is always split, V's planes are read as they are.
template <bool EXACT, int DP, int BK>
__device__ __forceinline__ void tf_pv(float (&acc)[DP / 8][4],
                                      const float (&p)[BK / 8][4],
                                      const float* vh, const float* vl,
                                      int csteps, int g, int t4) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    uint32_t ah[4], al[4];
    split_tf32_int(p[kk][0], ah[0], al[0]);  // (g,     key 2t)
    split_tf32_int(p[kk][2], ah[1], al[1]);  // (g + 8, key 2t)
    split_tf32_int(p[kk][1], ah[2], al[2]);  // (g,     key 2t + 1)
    split_tf32_int(p[kk][3], ah[3], al[3]);  // (g + 8, key 2t + 1)
    const int at = (8 * kk + 2 * t4) * LD + g;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      if (n >= csteps) break;
      const uint32_t bh0 = __float_as_uint(vh[at + 8 * n]);
      const uint32_t bh1 = __float_as_uint(vh[at + LD + 8 * n]);
      uint32_t bl0 = 0u, bl1 = 0u;
      if constexpr (!EXACT) {
        bl0 = __float_as_uint(vl[at + 8 * n]);
        bl1 = __float_as_uint(vl[at + LD + 8 * n]);
      }
      mma_split<false, EXACT>(acc[n], ah, al, bh0, bh1, bl0, bl1);
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
  float* qs = tf_smem;                // [BQ][LD]
  float* kr = qs + S::Q_FLOATS;       // [BK][LD] each: the next tile raw,
  float* vr = kr + S::KV_FLOATS;      // then the current one's planes
  float* kh = vr + S::KV_FLOATS;
  float* kl = kh + S::KV_FLOATS;
  float* vh = kl + S::KV_FLOATS;
  float* vl = vh + S::KV_FLOATS;

  const long long blk = block0 + blockIdx.x;
  const int bh = static_cast<int>(blk % bhs);
  // query tiles longest first: the block's tile counted from the last
  const int q0 = (tiles - 1 - static_cast<int>(blk / bhs)) * S::BQ;
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int offs = skv - sq;
  const int kend = causal ? min(skv, min(q0 + S::BQ, sq) + offs) : skv;
  const int nkt = (kend + BK - 1) / BK;
  const T* qh = q + static_cast<size_t>(bh) * sq * d;
  const T* kg = k + static_cast<size_t>(kvh) * skv * d;
  const T* vg = v + static_cast<size_t>(kvh) * skv * d;

  // the next tile: f32 lands raw by cp.async (split by the block once it
  // has); a 16-bit one is widened into the hi planes, exact in TF32
  const auto fetch = [&](int k0) {
    if constexpr (!EXACT) {
      tf_stage<T, DP, BK, NT>(kr, kg, k0, skv, d, vec, f16);
      tf_stage<T, DP, BK, NT>(vr, vg, k0, skv, d, vec, f16);
      cp_async_commit();
    }
  };
  const auto planes = [&](int k0) {
    if constexpr (EXACT) {
      tf_stage<T, DP, BK, NT>(kh, kg, k0, skv, d, vec, f16);
      tf_stage<T, DP, BK, NT>(vh, vg, k0, skv, d, vec, f16);
    } else {
      tf_split<DP, BK, NT>(kr, kh, kl);
      tf_split<DP, BK, NT>(vr, vh, vl);
    }
  };
  tf_stage<T, DP, S::BQ, NT>(qs, qh, q0, sq, d, vec, f16);
  fetch(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  planes(0);
  __syncthreads();
  if (nkt > 1) fetch(BK);

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
    // a warp whose 16 rows see no key of this tile (causal) skips it; key 0
    // is seen by every row, so the first tile makes every m finite
    if (!causal || k0 <= rw + 15 + offs) {
      // S = Q K^T on the warp's 16 rows x BK keys: hi hi in s, the small
      // terms (lo hi, hi lo) in s2, added once the k-steps are done
      float s[BK / 8][4], s2[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = s2[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        if (kk >= csteps) break;
        uint32_t ah[4], al[4];
        load_a<!EXACT>(qs + (wr0 + g) * LD + 8 * kk + t4, LD, ah, al);
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          // B = K^T: element (k, n) at K row n, column k
          const int at = (8 * n + g) * LD + 8 * kk + t4;
          const uint32_t bh0 = __float_as_uint(kh[at]);
          const uint32_t bh1 = __float_as_uint(kh[at + 4]);
          if constexpr (!EXACT) {
            mma_tf32_1688(s2[n], al, bh0, bh1);
            mma_tf32_1688(s2[n], ah, __float_as_uint(kl[at]),
                          __float_as_uint(kl[at + 4]));
          }
          mma_tf32_1688(s[n], ah, bh0, bh1);
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
          const float t = (s[n][e] + s2[n][e]) * sl2;
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
      if constexpr (S::FRESH) {
        float ot[DP / 8][4];
#pragma unroll
        for (int n = 0; n < DP / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) ot[n][e] = 0.f;
        tf_pv<EXACT, DP, BK>(ot, s, vh, vl, csteps, g, t4);
#pragma unroll
        for (int n = 0; n < DP / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][e] += ot[n][e];
      } else {
        tf_pv<EXACT, DP, BK>(o, s, vh, vl, csteps, g, t4);
      }
    }
    if (kt + 1 < nkt) {
      cp_async_wait<0>();
      __syncthreads();  // the next tile has landed; this one is consumed
      planes(k0 + BK);
      __syncthreads();  // its planes are written; the raw tiles are free
      if (kt + 2 < nkt) fetch(k0 + 2 * BK);
    }
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

template <typename T, int DP>
static int launch_tf32x3(const void* q, const void* k, const void* v,
                         void* out, int b, int hq, int hkv, int sq, int skv,
                         int d, float scale, int causal, int f16,
                         cudaStream_t stream) {
  using S = TfShape<DP>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err =
        allow_smem(flash_attention_tf32x3_kernel<T, DP>, S::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = std::is_same<T, float>::value && d % 4 == 0 && a16(q) &&
                  a16(k) && a16(v);
  const int bhs = b * hq;
  const int tiles = (sq + S::BQ - 1) / S::BQ;
  const long long total = static_cast<long long>(bhs) * tiles;
  for (long long b0 = 0; b0 < total; b0 += 0x7fffffffLL) {
    const long long n = total - b0 < 0x7fffffffLL ? total - b0 : 0x7fffffffLL;
    flash_attention_tf32x3_kernel<T, DP>
        <<<static_cast<unsigned>(n), S::THREADS, S::SMEM, stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<T*>(out), bhs, hq, hkv, sq,
            skv, d, scale, causal, vec, f16, b0, tiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename T>
static int launch_tf32x3_d(const void* q, const void* k, const void* v,
                           void* out, int b, int hq, int hkv, int sq, int skv,
                           int d, float scale, int causal, int f16,
                           cudaStream_t s) {
  if (d <= 16)
    return launch_tf32x3<T, 16>(q, k, v, out, b, hq, hkv, sq, skv, d, scale, causal, f16, s);
  if (d <= 32)
    return launch_tf32x3<T, 32>(q, k, v, out, b, hq, hkv, sq, skv, d, scale, causal, f16, s);
  if (d <= 64)
    return launch_tf32x3<T, 64>(q, k, v, out, b, hq, hkv, sq, skv, d, scale, causal, f16, s);
  if (d <= 128)
    return launch_tf32x3<T, 128>(q, k, v, out, b, hq, hkv, sq, skv, d, scale, causal, f16, s);
  if (d <= 256)
    return launch_tf32x3<T, 256>(q, k, v, out, b, hq, hkv, sq, skv, d, scale, causal, f16, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 f32, 1 bf16, 2 f16 (the two 16-bit types on one instantiation);
// d: 1 .. 256 (padded to 16, 32, 64, 128, 256)
extern "C" int launch_flash_attention_tf32x3(
    const void* q, const void* k, const void* v, void* out, int b, int hq,
    int hkv, int sq, int skv, int d, float scale, int causal, int dtype,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch_tf32x3_d<float>(q, k, v, out, b, hq, hkv, sq, skv, d,
                                    scale, causal, 0, s);
    case 1:
    case 2:
      return launch_tf32x3_d<uint16_t>(q, k, v, out, b, hq, hkv, sq, skv, d,
                                       scale, causal, dtype == 2, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- the 3xTF32 wgmma kernel: f32 at 64 < D <= 128 ------------------------
//
// The same function and arithmetic as flash_attention_tf32x3_kernel, for
// f32 q/k/v with 64 < D <= 128, D % 4 == 0 and 16-byte aligned operands
// (kernels/flash_attention.py tf32x3_wgmma(); row 5g, qwen3-4b at D 128),
// with both products on wgmma .tf32, the card's full TF32 rate, where
// mma.sync reaches about two fifths of it (scripts/kernel_variants.py
// --only flash_f32: two more TF32 products on mma.sync cost 1.43 ms, ~190
// TFLOP/s).  wgmma takes .tf32 operands from shared memory only K-major,
// so every operand is split hi + lo once for the block and stored as a
// K-major plane with the 128-byte swizzle: Q (128 rows, two warpgroups of
// 64, each its A) once; K (32 keys) and V transposed (D rows of 32 keys,
// each key group of 8 permuted so that position t holds key 2t and t + 4
// key 2t + 1: P's register A fragment is read in place from the S
// accumulator, thread t holding keys 2t and 2t + 1) per tile, from raw
// tiles that land by cp.async while the previous tile computes.  S takes
// Q lo K hi + Q hi K lo into one m64n32 accumulator and Q hi K hi into
// another, added once the k-steps are done; each tile's P V (P split in
// registers, V's planes from shared memory) goes to a fresh m64n128
// accumulator added to O in f32, so no long sum runs inside the tensor
// cores' accumulator.  ~226 KB of shared memory, one block an SM.
constexpr int TW_BQ = 128;               // query rows a block
constexpr int TW_BK = 32;                // keys a K / V tile
constexpr int TW_D = 128;                // the padded head dim
constexpr int TW_THREADS = 256;          // two warpgroups
constexpr int TW_RAW_LD = TW_D + 4;      // floats a raw staged row
constexpr int TW_Q = TW_BQ * TW_D * 4;   // bytes of a Q plane
constexpr int TW_K = TW_BK * TW_D * 4;   // of a K plane
constexpr int TW_V = TW_D * TW_BK * 4;   // of a V^T plane
constexpr int TW_RAW = TW_BK * TW_RAW_LD * 4;
constexpr int TW_SMEM = 2 * TW_Q + 2 * TW_K + 2 * TW_V + 2 * TW_RAW + 1024;

// The float index of (row r, column c < 32) in a plane of 128-byte rows
// with the 128-byte swizzle (16-byte chunk c / 4 XOR r % 8).
__device__ __forceinline__ int tw_swz(int r, int c) {
  return r * 32 + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

__device__ __forceinline__ void tw_split4(float4 v, uint4& h, uint4& l) {
  split_tf32_int(v.x, h.x, l.x);
  split_tf32_int(v.y, h.y, l.y);
  split_tf32_int(v.z, h.z, l.z);
  split_tf32_int(v.w, h.w, l.w);
}

__global__ void __launch_bounds__(TW_THREADS, 1)
flash_attention_tf32x3_wgmma_kernel(const float* __restrict__ q,
                                    const float* __restrict__ k,
                                    const float* __restrict__ v,
                                    float* __restrict__ out, int bhs, int hq,
                                    int hkv, int sq, int skv, int d,
                                    float scale, int causal, long long block0,
                                    int tiles) {
  extern __shared__ uint8_t tw_smem_raw[];
  uint8_t* base = align1024(tw_smem_raw);
  float* qh_s = reinterpret_cast<float*>(base);        // 4 boxes [128][32]
  float* ql_s = qh_s + TW_Q / 4;
  float* kh_s = ql_s + TW_Q / 4;                        // 4 boxes [32][32]
  float* kl_s = kh_s + TW_K / 4;
  float* vh_s = kl_s + TW_K / 4;                        // [128][32]
  float* vl_s = vh_s + TW_V / 4;
  float* kr = vl_s + TW_V / 4;                          // [32][132] raw
  float* vr = kr + TW_RAW / 4;

  const long long blk = block0 + blockIdx.x;
  const int bh = static_cast<int>(blk % bhs);
  const int q0 = (tiles - 1 - static_cast<int>(blk / bhs)) * TW_BQ;
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int offs = skv - sq;
  const int kend = causal ? min(skv, min(q0 + TW_BQ, sq) + offs) : skv;
  const int nkt = (kend + TW_BK - 1) / TW_BK;
  const float* qg = q + static_cast<size_t>(bh) * sq * d;
  const float* kg = k + static_cast<size_t>(kvh) * skv * d;
  const float* vg = v + static_cast<size_t>(kvh) * skv * d;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const auto fetch = [&](int k0) {
    for (int i = tid; i < TW_BK * (TW_D / 4); i += TW_THREADS) {
      const int r = i / (TW_D / 4), c = (i % (TW_D / 4)) * 4;
      const bool ok = k0 + r < skv && c < d;
      const size_t at = static_cast<size_t>(k0 + r) * d + c;
      cp_async16(kr + r * TW_RAW_LD + c, ok ? kg + at : kg, ok);
      cp_async16(vr + r * TW_RAW_LD + c, ok ? vg + at : vg, ok);
    }
    cp_async_commit();
  };
  // the landed raw tile into its planes: lane j takes key j, warp w the
  // columns 4w.., 4w + 32.., ...
  const auto planes = [&]() {
    const int j = lane;
    const int p = 8 * (j >> 3) + ((j & 7) >> 1) + 4 * (j & 1);  // V^T column
#pragma unroll
    for (int c4 = warp; c4 < TW_D / 4; c4 += TW_THREADS / 32) {
      const int c = 4 * c4;
      uint4 h, l;
      tw_split4(*reinterpret_cast<const float4*>(kr + j * TW_RAW_LD + c), h, l);
      const int at = (c / 32) * (TW_BK * 32) + tw_swz(j, c % 32);
      *reinterpret_cast<uint4*>(kh_s + at) = h;
      *reinterpret_cast<uint4*>(kl_s + at) = l;
      tw_split4(*reinterpret_cast<const float4*>(vr + j * TW_RAW_LD + c), h, l);
      const uint32_t hv[4] = {h.x, h.y, h.z, h.w}, lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        vh_s[tw_swz(c + e, p)] = __uint_as_float(hv[e]);
        vl_s[tw_swz(c + e, p)] = __uint_as_float(lv[e]);
      }
    }
    fence_proxy_async();
  };

  // Q's planes, once
  for (int i = tid; i < TW_BQ * (TW_D / 4); i += TW_THREADS) {
    const int r = i / (TW_D / 4), c = (i % (TW_D / 4)) * 4;
    const float4 x = q0 + r < sq && c < d
                         ? *reinterpret_cast<const float4*>(
                               qg + static_cast<size_t>(q0 + r) * d + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    uint4 h, l;
    tw_split4(x, h, l);
    const int at = (c / 32) * (TW_BQ * 32) + tw_swz(r, c % 32);
    *reinterpret_cast<uint4*>(qh_s + at) = h;
    *reinterpret_cast<uint4*>(ql_s + at) = l;
  }
  fetch(0);
  cp_async_wait<0>();
  __syncthreads();
  planes();
  __syncthreads();
  if (nkt > 1) fetch(TW_BK);

  const int wg = warp / 4, wl = warp % 4;
  const int g = lane >> 2, t4 = lane & 3;
  const int rw = q0 + 64 * wg;              // the warpgroup's first row
  const int ra = rw + 16 * wl + g;          // this thread's rows ra, ra + 8
  const int csteps = (d + 7) / 8;
  const float sl2 = scale * FA_LOG2E;
  float o[TW_D / 2];
#pragma unroll
  for (int i = 0; i < TW_D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * TW_BK;
    if (!causal || k0 <= rw + 63 + offs) {
      float s[TW_BK / 2], s2[TW_BK / 2];
#pragma unroll
      for (int i = 0; i < TW_BK / 2; ++i) s[i] = s2[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TW_D / 8; ++kk) {
        if (kk >= csteps) break;
        const int box = kk / 4, in_row = (kk % 4) * 32;
        const uint8_t* qa = reinterpret_cast<const uint8_t*>(qh_s) +
                            box * TW_BQ * 128 + wg * 64 * 128 + in_row;
        const uint8_t* kb = reinterpret_cast<const uint8_t*>(kh_s) +
                            box * TW_BK * 128 + in_row;
        const uint64_t dqh = wgmma_desc(qa, 0, 1024, 128);
        const uint64_t dql = wgmma_desc(qa + TW_Q, 0, 1024, 128);
        const uint64_t dkh = wgmma_desc(kb, 0, 1024, 128);
        const uint64_t dkl = wgmma_desc(kb + TW_K, 0, 1024, 128);
        wgmma_tf32_ss<TW_BK>(s2, dql, dkh, kk != 0);
        wgmma_tf32_ss<TW_BK>(s2, dqh, dkl, 1);
        wgmma_tf32_ss<TW_BK>(s, dqh, dkh, kk != 0);
      }
      wgmma_commit();
      fence_regs(s);
      fence_regs(s2);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(s2);

      const bool masked =
          k0 + TW_BK > skv || (causal && k0 + TW_BK - 1 > rw + offs);
#pragma unroll
      for (int i = 0; i < TW_BK / 2; ++i) {
        const float t = (s[i] + s2[i]) * sl2;
        if (masked) {
          const int row = ra + ((i & 2) ? 8 : 0);
          const int col = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
          const bool ok = col < skv && (!causal || col <= row + offs);
          s[i] = ok ? t : -INFINITY;
        } else {
          s[i] = t;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < TW_BK / 8; ++i) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * i], s[4 * i + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * i + 2], s[4 * i + 3]));
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
      for (int i = 0; i < TW_BK / 2; ++i) {
        s[i] = ex2_ftz(s[i] - mx[(i >> 1) & 1]);
        rs[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[r] = alpha[r] * l[r] + rs[r];
      }

      // P's A fragments, k-step kk = S's n8 block kk (keys 2t, 2t + 1 as
      // columns t, t + 4), split
      uint32_t ph[TW_BK / 8][4], pl[TW_BK / 8][4];
#pragma unroll
      for (int kk = 0; kk < TW_BK / 8; ++kk) {
        split_tf32_int(s[4 * kk + 0], ph[kk][0], pl[kk][0]);
        split_tf32_int(s[4 * kk + 2], ph[kk][1], pl[kk][1]);
        split_tf32_int(s[4 * kk + 1], ph[kk][2], pl[kk][2]);
        split_tf32_int(s[4 * kk + 3], ph[kk][3], pl[kk][3]);
      }
      float ot[TW_D / 2];
#pragma unroll
      for (int i = 0; i < TW_D / 2; ++i) ot[i] = 0.f;
      fence_regs(ot);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TW_BK / 8; ++kk) {
        const uint8_t* vb = reinterpret_cast<const uint8_t*>(vh_s) + kk * 32;
        const uint64_t dvh = wgmma_desc(vb, 0, 1024, 128);
        const uint64_t dvl = wgmma_desc(vb + TW_V, 0, 1024, 128);
        wgmma_tf32_rs<TW_D>(ot, pl[kk], dvh, kk != 0);
        wgmma_tf32_rs<TW_D>(ot, ph[kk], dvl, 1);
        wgmma_tf32_rs<TW_D>(ot, ph[kk], dvh, 1);
      }
      wgmma_commit();
      fence_regs(ot);
      wgmma_wait<0>();
      fence_regs(ot);
#pragma unroll
      for (int i = 0; i < TW_D / 2; ++i)
        o[i] = o[i] * alpha[(i >> 1) & 1] + ot[i];
    }
    if (kt + 1 < nkt) {
      cp_async_wait<0>();
      __syncthreads();  // the next tile has landed; this one is consumed
      planes();
      __syncthreads();  // its planes are written; the raw tiles are free
      if (kt + 2 < nkt) fetch(k0 + 2 * TW_BK);
    }
  }

  float* og = out + static_cast<size_t>(bh) * sq * d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    if (r >= sq) continue;
#pragma unroll
    for (int i = 0; i < TW_D / 8; ++i) {
      const int c = 8 * i + 2 * t4;
      if (c < d)
        *reinterpret_cast<float2*>(og + static_cast<size_t>(r) * d + c) =
            make_float2(o[4 * i + 2 * h] / l[h], o[4 * i + 2 * h + 1] / l[h]);
    }
  }
}

// q, k, v, out f32, 16-byte aligned; 64 < d <= 128, d % 4 == 0
extern "C" int launch_flash_attention_tf32x3_wgmma(
    const void* q, const void* k, const void* v, void* out, int b, int hq,
    int hkv, int sq, int skv, int d, float scale, int causal, void* stream) {
  if (d <= 64 || d > TW_D || d % 4) return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err =
        allow_smem(flash_attention_tf32x3_wgmma_kernel, TW_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int bhs = b * hq;
  const int tiles = (sq + TW_BQ - 1) / TW_BQ;
  const long long total = static_cast<long long>(bhs) * tiles;
  for (long long b0 = 0; b0 < total; b0 += 0x7fffffffLL) {
    const long long n = total - b0 < 0x7fffffffLL ? total - b0 : 0x7fffffffLL;
    flash_attention_tf32x3_wgmma_kernel<<<static_cast<unsigned>(n),
                                          TW_THREADS, TW_SMEM,
                                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), bhs, hq, hkv,
        sq, skv, d, scale, causal, b0, tiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
