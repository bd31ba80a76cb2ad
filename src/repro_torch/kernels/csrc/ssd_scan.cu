// Mamba-2 SSD (state-space duality) chunked scan, computed in f32.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan (Pallas body
// _ssd_kernel): grid (BH, T / chunk), the chunk axis sequential, carrying
// the (ds, dh) f32 state in scratch.  Per chunk, with cum = cumsum(log_a)
// inside the chunk:
//
//   y_t   = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) X_s     (intra)
//         + exp(cum_t) C_t S_in                                 (inter)
//   S_out = exp(cum_last) S_in + sum_s exp(cum_last - cum_s) B_s^T X_s
//
// x (BH, T, dh), b/c (BH, T, ds) in f32 or bf16 (b and c may broadcast over
// heads: their head stride is an argument, 0 when one batch row's B/C serve
// all its heads), log_a (BH, T) f32 <= 0; y (BH, T, dh) in x's type.
// (ds, dh) in {(128, 64), (32, 16), (16, 16)}.
//
// Why not the TPU layout: the Pallas body keeps the whole (chunk, chunk)
// decay matrix and the state on chip and walks the chunks of a head in
// order.  At chunk 256 the f32 decay matrix alone is 256 KB, over the 227 KB
// a block may use, and one block per head gives 48 blocks at batch 1 for
// 132 SMs.  So the chunk recurrence is split in three launches:
//
//   1. ssd_chunk_state_kernel, one block per (head, chunk): the chunk's own
//      state sum_s exp(cum_last - cum_s) B_s^T X_s, (ds x chunk) x
//      (chunk x dh), and its log decay cum_last;
//   2. ssd_state_scan_kernel, one thread per (head, state element): the
//      short scan over chunks, S_in[c + 1] = exp(cum_last[c]) S_in[c] +
//      S_own[c], written over S_own;
//   3. ssd_chunk_out_kernel, one block per (head, chunk, 64-row tile of t):
//      the inter term from S_in, then for each 64-row tile of s <= t the
//      product G = C_t B_s^T, scaled by exp(cum_t - cum_s) where s <= t and
//      set to 0 elsewhere (exp is never taken above the diagonal, where it
//      could overflow and turn into inf * 0 = NaN), then y += G X_s.
//
// Padding: positions past T read x = b = c = log_a = 0, which is what the
// JAX wrapper's zero padding of T to a multiple of the chunk gives, and
// are not written.
//
// Bound on this card: on the path (mamba2-780m, BH = 48, T = 4096, ds 128,
// dh 64, chunk 256) operations, ~1.7e10 f32 FLOP (pass 3 ~80%) against
// ~0.2 GB of traffic; f32 FMAs on the CUDA cores, since TF32 would break
// the 2e-4 bar.  Each block of 256 threads keeps a 4 x 4 (pass 1: 8 x 4)
// register tile and streams its operands through shared memory, 2 blocks
// an SM in pass 3 (~100 KB each).  At T = 4096 pass 1 runs 768 blocks and
// pass 3 3,072, so the card is full.  Each pass numbers its blocks along
// the grid's x only (head * blocks a head + block, the order of the 2-D
// grid it replaced), so no B * H is too large.
#include <cstdint>

#include <cuda_bf16.h>

#include "common.cuh"

constexpr int SSD_TILE = 64;       // rows of t (and of s) per tile
constexpr int SSD_THREADS = 256;
constexpr int SSD_MAX_CHUNK = 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Inclusive cumsum of log_a over the chunk starting at c0 (length n, zeros
// past T) into cum[0, n), by warp 0 in steps of 32.  Both passes that read
// cum call this, so they see the same values.
__device__ void chunk_cumsum(const float* __restrict__ la, int c0, int n,
                             int T, float* cum) {
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
  chunk_cumsum(lah, c0, chunk, Tn, cum);
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

// ---- pass 2: the scan over chunks, S_own -> S_in in place ----------------
__global__ void ssd_state_scan_kernel(float* __restrict__ states,
                                      const float* __restrict__ totals,
                                      int nc, int n_elem) {
  const int nx = (n_elem + blockDim.x - 1) / blockDim.x;  // blocks a head
  const int e = static_cast<int>(blockIdx.x % nx) * blockDim.x + threadIdx.x;
  const int h = static_cast<int>(blockIdx.x / nx);
  if (e >= n_elem) return;
  float run = 0.f;
  for (int c = 0; c < nc; ++c) {
    float* p = states + (static_cast<size_t>(h) * nc + c) * n_elem + e;
    const float own = *p;
    *p = run;
    run = expf(totals[static_cast<size_t>(h) * nc + c]) * run + own;
  }
}

// ---- pass 3: the outputs of one 64-row tile of a chunk -------------------
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
  chunk_cumsum(lah, c0, (ti + 1) * SSD_TILE, Tn, cum);

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

template <typename T, int DS, int DH>
static cudaError_t launch_typed(const void* x, const void* la, const void* b,
                                const void* c, void* states, void* totals,
                                void* y, int bh, int Tn, int chunk,
                                long long bstride, long long cstride,
                                cudaStream_t stream) {
  const int nc = (Tn + chunk - 1) / chunk;
  const size_t smem1 = (SSD_MAX_CHUNK + SSD_TILE * DS + SSD_TILE * DH) * sizeof(float);
  const size_t smem3 = (SSD_MAX_CHUNK + 2 * DS * (SSD_TILE + 1) + SSD_TILE * DH +
                        SSD_TILE * (SSD_TILE + 1)) * sizeof(float);
  cudaError_t err = allow_smem(ssd_chunk_state_kernel<T, DS, DH>, smem1);
  if (err != cudaSuccess) return err;
  err = allow_smem(ssd_chunk_out_kernel<T, DS, DH>, smem3);
  if (err != cudaSuccess) return err;
  const long long blocks1 = static_cast<long long>(nc) * bh;
  const long long blocks2 = static_cast<long long>((DS * DH + 255) / 256) * bh;
  const long long blocks3 = blocks1 * (chunk / SSD_TILE);
  if (blocks2 > 0x7fffffffLL || blocks3 > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  ssd_chunk_state_kernel<T, DS, DH>
      <<<static_cast<unsigned>(blocks1), SSD_THREADS, smem1, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(la),
      static_cast<const T*>(b), static_cast<float*>(states),
      static_cast<float*>(totals), Tn, chunk, bstride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_elem = DS * DH;
  ssd_state_scan_kernel<<<static_cast<unsigned>(blocks2), 256, 0, stream>>>(
      static_cast<float*>(states), static_cast<const float*>(totals), nc, n_elem);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_chunk_out_kernel<T, DS, DH>
      <<<static_cast<unsigned>(blocks3), SSD_THREADS, smem3, stream>>>(
          static_cast<const T*>(x), static_cast<const float*>(la),
          static_cast<const T*>(b), static_cast<const T*>(c),
          static_cast<const float*>(states), static_cast<T*>(y), Tn, chunk,
          bstride, cstride);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_dims(int ds, int dh, const void* x, const void* la,
                               const void* b, const void* c, void* states,
                               void* totals, void* y, int bh, int Tn, int chunk,
                               long long bstride, long long cstride,
                               cudaStream_t s) {
  if (ds == 128 && dh == 64)
    return launch_typed<T, 128, 64>(x, la, b, c, states, totals, y, bh, Tn, chunk, bstride, cstride, s);
  if (ds == 32 && dh == 16)
    return launch_typed<T, 32, 16>(x, la, b, c, states, totals, y, bh, Tn, chunk, bstride, cstride, s);
  if (ds == 16 && dh == 16)
    return launch_typed<T, 16, 16>(x, la, b, c, states, totals, y, bh, Tn, chunk, bstride, cstride, s);
  return cudaErrorInvalidValue;
}

// states: (BH, n_chunks, ds, dh) f32 scratch; totals: (BH, n_chunks) f32
// scratch.  bf16: 1 for bf16 x/b/c/y, 0 for f32.
extern "C" int launch_ssd_scan(const void* x, const void* la, const void* b,
                               const void* c, void* states, void* totals,
                               void* y, int bh, int Tn, int ds, int dh,
                               int chunk, long long bstride, long long cstride,
                               int bf16, void* stream) {
  if (chunk % SSD_TILE != 0 || chunk > SSD_MAX_CHUNK || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_dims<__nv_bfloat16>(ds, dh, x, la, b, c, states, totals, y,
                                        bh, Tn, chunk, bstride, cstride, s)
           : launch_dims<float>(ds, dh, x, la, b, c, states, totals, y, bh, Tn,
                                chunk, bstride, cstride, s);
  return static_cast<int>(err);
}
