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
// flash_attention_generic_kernel, below, takes every other case: f32, bf16
// or f16 q/k/v and any head dim (see its note).
#include <cstdint>

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
// head dim D >= 1 whose rows fit shared memory; the route the wgmma kernel
// does not take (kernels/flash_attention.py route()).  Everything is f32 on
// the CUDA cores: the online softmax keeps m, l and the output row in f32,
// P is never rounded, and the output is rounded once to the element type
// after the division by l.  JAX's kernel is the same arithmetic in f32
// (preferred_element_type, repro/kernels/flash_attention.py:29-73).
//
// A block takes `rows` query rows of one head, a warp each, and walks the
// keys in tiles of 32, one key a lane: lane j sums q . k_j over the columns,
// the warp takes the tile's max and sum by shuffles, then each lane owns
// the output columns lane, lane + 32, ... and adds sum_j p_j v_j.  K and V
// tiles are staged in shared memory 64 columns at a time (K rows padded to
// 65 floats, so lane j's reads of row j hit 32 banks) and serve all the
// block's rows; each row's q and output accumulator live in shared memory,
// so D is not bounded by registers.  Bound on this card: operations, 4 D
// FLOP a kept (row, key) pair at the fp32 rate; this kernel is the simple,
// right one (the f32 smoke LMs and odd head dims), not yet a fast one.
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
