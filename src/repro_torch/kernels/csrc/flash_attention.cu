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
// in f32, l summed from the f32 p, but p rounded to bf16 before the PV
// product; one division by l at the end.  Ragged Sq and Skv are masked
// here (rows past Sq are not written, keys past Skv get -1e30), so every
// length is taken.
//
// Bound on this card: on the path (qwen3-4b, 32 x 8 heads, S = 4096,
// D = 128) operations, 1.4e11 bf16 FLOP a call against 80 MB of q, k, v
// and out.  Design: the products run on the tensor cores as warp-wide
// mma.sync m16n8k16 (bf16 -> f32).  One block of 4 warps takes 64 query
// rows of one head (16 a warp, its Q fragments in registers for the whole
// loop); the Pallas sequential KV axis becomes a loop inside the block
// over 64-key tiles of K and V staged in shared memory (2 x 17 KB with a
// padded row), stopping at the last tile a causal row can see.  S = Q K^T
// stays in registers, is turned into the P fragments of the PV product
// in place (the accumulator layout of m16n8 is the A layout of m16n8k16),
// and m, l and the 16 x D accumulator stay in f32 registers.  Blocks of a
// head are issued longest first, so the causal diagonal's short blocks
// fill the last wave.  No TMA, wgmma or software pipelining yet.
#include <cstdint>

#include <cuda_bf16.h>

#include "common.cuh"
#include "mma.cuh"

constexpr int FA_BQ = 64;       // query rows per block: 4 warps x 16
constexpr int FA_BK = 64;       // keys per K/V tile
constexpr int FA_THREADS = 128;
constexpr float FA_NEG = -1e30f;

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out, int hq, int hkv,
                       int sq, int skv, float scale, int causal) {
  static_assert(D % 16 == 0 && D <= 128, "head dim");
  constexpr int LD = D + 8;          // padded row: conflict-free fragments
  constexpr int KSTEPS = D / 16;     // k-steps of Q K^T
  constexpr int DTILES = D / 8;      // n-tiles of the output
  constexpr int STILES = FA_BK / 8;  // n-tiles of S
  constexpr int CHUNKS = D / 8;      // 16-byte chunks in a row
  __shared__ __align__(16) __nv_bfloat16 ks[FA_BK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[FA_BK * LD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;                       // b * hq + query head
  const int qt = gridDim.x - 1 - blockIdx.x;       // longest tiles first
  const int group = hq / hkv;
  const int kvh = (bh / hq) * hkv + (bh % hq) / group;
  const __nv_bfloat16* qp = q + static_cast<size_t>(bh) * sq * D;
  const __nv_bfloat16* kp = k + static_cast<size_t>(kvh) * skv * D;
  const __nv_bfloat16* vp = v + static_cast<size_t>(kvh) * skv * D;
  const int q0 = qt * FA_BQ;
  const int r0 = q0 + warp * 16 + g;               // rows r0 and r0 + 8
  const int r1 = r0 + 8;
  const int offs = skv - sq;

  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r0 < sq ? load_pair(qp + static_cast<size_t>(r0) * D + c) : 0u;
    qa[kk][1] = r1 < sq ? load_pair(qp + static_cast<size_t>(r1) * D + c) : 0u;
    qa[kk][2] = r0 < sq ? load_pair(qp + static_cast<size_t>(r0) * D + c + 8) : 0u;
    qa[kk][3] = r1 < sq ? load_pair(qp + static_cast<size_t>(r1) * D + c + 8) : 0u;
  }

  float m[2] = {FA_NEG, FA_NEG};
  float l[2] = {0.f, 0.f};
  float acc[DTILES][4];
#pragma unroll
  for (int j = 0; j < DTILES; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int q_end = min(q0 + FA_BQ, sq);
  int last_k = (skv + FA_BK - 1) / FA_BK - 1;
  if (causal) last_k = min(last_k, (q_end - 1 + offs) / FA_BK);

  for (int kb = 0; kb <= last_k; ++kb) {
    const int k0 = kb * FA_BK;
    for (int i = threadIdx.x; i < FA_BK * CHUNKS; i += FA_THREADS) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
      uint4 kw = make_uint4(0u, 0u, 0u, 0u), vw = kw;
      if (k0 + r < skv) {
        kw = *reinterpret_cast<const uint4*>(kp + static_cast<size_t>(k0 + r) * D + c);
        vw = *reinterpret_cast<const uint4*>(vp + static_cast<size_t>(k0 + r) * D + c);
      }
      *reinterpret_cast<uint4*>(ks + r * LD + c) = kw;
      *reinterpret_cast<uint4*>(vs + r * LD + c) = vw;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[STILES][4];
#pragma unroll
    for (int j = 0; j < STILES; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int j = 0; j < STILES; ++j) {
        const __nv_bfloat16* kr = ks + (j * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16_16816(s[j], qa[kk], load_pair(kr), load_pair(kr + 8));
      }
    }

    // scale, mask, online softmax (rows r0: e = 0, 1; r1: e = 2, 3)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < STILES; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const bool ok = col < skv && (!causal || col <= row + offs);
        s[j][e] = ok ? s[j][e] * scale : FA_NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float rs[2] = {0.f, 0.f};
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
    }
#pragma unroll
    for (int j = 0; j < STILES; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - mx[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = alpha[r] * l[r] + rs[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < DTILES; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // acc += bf16(P) V: S tiles 2kk, 2kk+1 form the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < FA_BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < DTILES; ++j) {
        const __nv_bfloat16* vr = vs + (kk * 16 + 2 * t) * LD + j * 8 + g;
        mma_bf16_16816(acc[j], pa, pack_bf16_bits(vr[0], vr[LD]),
                       pack_bf16_bits(vr[8 * LD], vr[9 * LD]));
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* op = out + static_cast<size_t>(bh) * sq * D;
#pragma unroll
  for (int j = 0; j < DTILES; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(op + static_cast<size_t>(r0) * D + c) =
          pack_bf16(acc[j][0] / l[0], acc[j][1] / l[0]);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(op + static_cast<size_t>(r1) * D + c) =
          pack_bf16(acc[j][2] / l[1], acc[j][3] / l[1]);
  }
}

template <int D>
static cudaError_t launch_d(const void* q, const void* k, const void* v,
                            void* out, int b, int hq, int hkv, int sq, int skv,
                            float scale, int causal, cudaStream_t stream) {
  dim3 grid((sq + FA_BQ - 1) / FA_BQ, b * hq);
  flash_attention_kernel<D><<<grid, FA_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      hq, hkv, sq, skv, scale, causal);
  return cudaGetLastError();
}

extern "C" int launch_flash_attention(const void* q, const void* k,
                                      const void* v, void* out, int b, int hq,
                                      int hkv, int sq, int skv, int d,
                                      float scale, int causal, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 16:
      err = launch_d<16>(q, k, v, out, b, hq, hkv, sq, skv, scale, causal, s);
      break;
    case 32:
      err = launch_d<32>(q, k, v, out, b, hq, hkv, sq, skv, scale, causal, s);
      break;
    case 64:
      err = launch_d<64>(q, k, v, out, b, hq, hkv, sq, skv, scale, causal, s);
      break;
    case 128:
      err = launch_d<128>(q, k, v, out, b, hq, hkv, sq, skv, scale, causal, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
