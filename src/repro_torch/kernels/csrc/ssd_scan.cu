// Mamba-2 SSD (state-space duality) chunked scan, computed to f32 accuracy
// on the tensor cores.
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
//
// Which pairs: the passes are built for four (ds, dh) pairs
// (kernels/ssd_scan.py INSTANCES): the three of DIMS, built as before
// (mamba2-780m's (128, 64), its smoke config's (16, 16), and (32, 16), the
// card tests'), and (128, 128), row 6g's 24 heads of 128 (where the
// recurrence kernel took 3.2 ms) and the widest pair whose pass-3 block
// fits.  Every other pair up to (128, 128) runs at the smallest of them
// that holds it (kernels/ssd_scan.py padded()): the wrapper zero-pads x to
// the wider dh and B and C to the wider ds, and crops y.  Zero B and C
// columns give zero state rows and add exact zeros to C B^T and C S_in;
// zero x columns give y columns that are dropped.  On the path:
// mamba2-780m's smoke at (64, 32) in lm_parity_f32, padded to (128, 64).
// Only a pair past (128, 128) runs ssd_scan_generic_kernel (below, with its
// own note), kept as the route past the passes' reach.  Eight
// instantiations (four pairs x f32 and bf16) where there were six; the
// source's build time is in PERF.md.
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
// Bound on this card: on the path (mamba2-780m, BH = 48, T = 4096, ds 128, dh
// 64, chunk 256, bf16) operations, ~1.9e10 FLOP of products (pass 3 ~80%)
// against ~0.2 GB of traffic.  Every product runs as mma.sync m16n8k8 TF32
// (mma.cuh).  One TF32 product misses the 2e-4 bar, so each f32 operand is
// split hi + lo (split_tf32_int) and a product takes the terms the split needs,
// the small ones first: a bf16 value is exact in TF32 and has no lo term, so on
// the path C B^T is one product, and G' X, C S_in and (w B)^T X (G', S_in, w B
// in f32) two; with f32 inputs every product is 3xTF32 (conv1d.cu
// conv1d_tc_kernel).  Operands stay f32 in shared memory (bf16 widened as they
// land), rows padded so that each fragment's 32 loads hit 32 banks.  Pass 3:
// eight warps, each 16 rows of t; G goes through shared memory between its two
// products, and on the diagonal tile a warp skips the columns above its rows.
// Two blocks an SM (~107 KB each at (128, 64)); one at (128, 128) (~157 KB),
// whose register hint is then 1 (ssd_out_blocks).  Latency, not throughput,
// paced the first version: a thread now issues all its loads of a tile before
// its stores, the cumsum takes the whole block in one round of loads, and pass
// 2 loads eight chunks ahead.  Pass 3 is three quarters of the time; keeping G
// in registers, bf16 MMAs with three-way splits and two heads a block (C B^T
// once) all measured slower or no faster (scripts/kernel_variants.py --only
// ssd).  At T = 4096 pass 1 runs 768 blocks and pass 3 3,072, so the card is
// full.  Each pass numbers its blocks along the grid's x only (head * blocks a
// head + block, the order of the 2-D grid it replaced), so no B * H is too
// large.
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>

#include "common.cuh"
#include "mma.cuh"

constexpr int SSD_TILE = 64;       // rows of t (and of s) per tile
constexpr int SSD_THREADS = 256;
constexpr int SSD_MAX_CHUNK = 1024;
static_assert(4 * SSD_THREADS >= SSD_MAX_CHUNK, "chunk_cumsum: 4 a thread");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Inclusive cumsum of log_a over the chunk starting at c0 (length n <=
// SSD_MAX_CHUNK, zeros past T) into cum[0, n), by the whole block: each
// thread sums four consecutive values, the warps scan their threads' sums
// by shuffles and the block the warps' (in `part`, SSD_THREADS / 32
// floats).  Every load is issued at once.  Both passes that read cum call
// this, so they see the same values.
__device__ void chunk_cumsum(const float* __restrict__ la, int c0, int n,
                             int T, float* cum, float* part) {
  const int i0 = 4 * threadIdx.x, lane = threadIdx.x % 32;
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = (i0 + j < n && c0 + i0 + j < T) ? la[c0 + i0 + j] : 0.f;
  v[1] += v[0];
  v[2] += v[1];
  v[3] += v[2];
  float run = v[3];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, run, o);
    if (lane >= o) run += u;
  }
  if (lane == 31) part[threadIdx.x / 32] = run;
  __syncthreads();
  float base = run - v[3];  // the sum of this warp's earlier threads
  for (int w = 0; w < static_cast<int>(threadIdx.x) / 32; ++w) base += part[w];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (i0 + j < n) cum[i0 + j] = base + v[j];
  __syncthreads();
}

// rows [t0, t0 + TILE) of a (T, COLS) head into dst[TILE][LD] as f32,
// zeros past T.  The rows are contiguous, so thread i takes elements i +
// j SSD_THREADS from one pointer; every load is issued before the stores.
template <int COLS, int LD, typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int t0,
                                           int Tn, float* dst) {
  static_assert(SSD_THREADS % COLS == 0, "whole rows a step");
  constexpr int N = SSD_TILE * COLS / SSD_THREADS;
  constexpr int ROWS = SSD_THREADS / COLS;   // rows a step
  const T* p = src + static_cast<size_t>(t0) * COLS + threadIdx.x;
  const int n = min(Tn - t0, SSD_TILE) * COLS - static_cast<int>(threadIdx.x);
  T v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = j * SSD_THREADS < n ? p[j * SSD_THREADS] : zero<T>();
  float* d = dst + (threadIdx.x / COLS) * LD + threadIdx.x % COLS;
#pragma unroll
  for (int j = 0; j < N; ++j) d[j * ROWS * LD] = to_f32(v[j]);
}

// ---- pass 1: each chunk's own state and log decay ------------------------
// The state (DS x DH) = (w B)^T X over the chunk's s: warp w owns state rows
// 16 w .. 16 w + 15 (DS / 16 warps busy) and every column.
template <typename T, int DS, int DH>
__global__ void __launch_bounds__(SSD_THREADS, 2)
ssd_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ la,
                       const T* __restrict__ b, float* __restrict__ states,
                       float* __restrict__ totals, int Tn, int chunk,
                       long long b_head_stride) {
  constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
  constexpr int LW = DS + 8;   // B rows (s): A reads (m = g, k = t4) at t4 * LW + g
  constexpr int LX = DH + 8;   // X rows (s): B reads (k = t4, n = g) at t4 * LX + g
  constexpr int NB = DH / 8;
  extern __shared__ __align__(16) float smem[];
  __shared__ float part[SSD_THREADS / 32];
  float* wd = smem;                   // [chunk]: cum, then exp(total - cum)
  float* bw = wd + chunk;             // [TILE][LW]: B_s
  float* xs = bw + SSD_TILE * LW;     // [TILE][LX]
  const int nc = (Tn + chunk - 1) / chunk;  // blocks: head * nc + chunk
  const int c = static_cast<int>(blockIdx.x % nc);
  const int h = static_cast<int>(blockIdx.x / nc);
  const int c0 = c * chunk;
  const float* lah = la + static_cast<size_t>(h) * Tn;
  const T* xh = x + static_cast<size_t>(h) * Tn * DH;
  const T* bhd = b + h * b_head_stride;
  chunk_cumsum(lah, c0, chunk, Tn, wd, part);
  const float total = wd[chunk - 1];
  __syncthreads();
  for (int i = threadIdx.x; i < chunk; i += SSD_THREADS)
    wd[i] = expf(total - wd[i]);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4, m0 = 16 * warp;
  float acc[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int s0 = 0; s0 < chunk; s0 += SSD_TILE) {
    __syncthreads();  // wd is written; the previous tile is consumed
    stage_rows<DS, LW>(bhd, c0 + s0, Tn, bw);
    stage_rows<DH, LX>(xh, c0 + s0, Tn, xs);
    __syncthreads();
    if (m0 < DS) {
#pragma unroll 2
      for (int k0 = 0; k0 < SSD_TILE; k0 += 8) {
        // A = (w B)^T: element (m, k) is w_k B[k][m]
        const float* pa = bw + (k0 + t4) * LW + m0 + g;
        const float w0 = wd[s0 + k0 + t4], w1 = wd[s0 + k0 + t4 + 4];
        uint32_t ah[4], al[4];
        split_tf32_int(w0 * pa[0], ah[0], al[0]);            // (g,     t4)
        split_tf32_int(w0 * pa[8], ah[1], al[1]);            // (g + 8, t4)
        split_tf32_int(w1 * pa[4 * LW], ah[2], al[2]);       // (g,     t4 + 4)
        split_tf32_int(w1 * pa[4 * LW + 8], ah[3], al[3]);   // (g + 8, t4 + 4)
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const float* pb = xs + (k0 + t4) * LX + 8 * j + g;
          uint32_t bh0, bl0, bh1, bl1;
          tf32_parts<!EXACT>(pb[0], bh0, bl0);
          tf32_parts<!EXACT>(pb[4 * LX], bh1, bl1);
          mma_split<false, EXACT>(acc[j], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
  }
  if (m0 < DS) {
    float* st = states + (static_cast<size_t>(h) * nc + c) * DS * DH;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        store2(st + (m0 + g + 8 * hh) * DH + 8 * j + 2 * t4, acc[j][2 * hh],
               acc[j][2 * hh + 1]);
  }
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
  // eight chunks' loads at a time, then their dependent updates
  constexpr int G = 8;
  float run = 0.f;
  for (int c0 = 0; c0 < nc; c0 += G) {
    float own[G], dec[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int c = c0 + j;
      own[j] = c < nc ? states[(static_cast<size_t>(h) * nc + c) * n_elem + e]
                      : 0.f;
      dec[j] = c < nc ? totals[static_cast<size_t>(h) * nc + c] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int c = c0 + j;
      if (c < nc) {
        states[(static_cast<size_t>(h) * nc + c) * n_elem + e] = run;
        run = expf(dec[j]) * run + own[j];
      }
    }
  }
}

// ---- pass 3: the outputs of one 64-row tile of a chunk -------------------
// Warp w owns rows 16 (w / 2) .. + 15 of the tile; of y the columns
// (w % 2) DH / 2 .. + DH / 2 - 1, of each G the columns (w % 2) 32 .. + 31.
template <int DS, int DH>
constexpr int ssd_out_floats(int chunk) {
  return chunk + SSD_TILE * (DS + 4) +
         (SSD_TILE * (DS + 4) > DS * (DH + 8) ? SSD_TILE * (DS + 4)
                                              : DS * (DH + 8)) +
         SSD_TILE * (DH + 8) + SSD_TILE * (SSD_TILE + 4);
}

// Blocks an SM the instantiation's shared memory leaves room for at chunk
// 256: 2, but 1 at (128, 128) (~157 KB), whose register hint may then
// double.
template <int DS, int DH>
constexpr int ssd_out_blocks() {
  return 2 * ssd_out_floats<DS, DH>(256) * 4 <= SMEM_BYTES ? 2 : 1;
}

template <typename T, int DS, int DH>
__global__ void __launch_bounds__(SSD_THREADS, (ssd_out_blocks<DS, DH>()))
ssd_chunk_out_kernel(const T* __restrict__ x, const float* __restrict__ la,
                     const T* __restrict__ b, const T* __restrict__ c,
                     const float* __restrict__ states, T* __restrict__ y,
                     int Tn, int chunk, long long b_head_stride,
                     long long c_head_stride) {
  constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
  constexpr int LC = DS + 4;          // C_t, B_s rows: (g, t4) at g * LC + t4
  constexpr int LX = DH + 8;          // X_s, S_in rows: (t4, g) at t4 * LX + g
  constexpr int LG = SSD_TILE + 4;    // G rows: (g, t4) at g * LG + t4
  constexpr int NJ = DH / 16;         // n-tiles of y a warp
  constexpr int BUF = SSD_TILE * LC > DS * LX ? SSD_TILE * LC : DS * LX;
  extern __shared__ __align__(16) float smem[];
  __shared__ float part[SSD_THREADS / 32];
  float* cum = smem;                  // [chunk]
  float* cs = cum + chunk;            // [TILE][LC]: C_t
  float* bs = cs + SSD_TILE * LC;     // [TILE][LC]: B_s; first S_in [DS][LX]
  float* xs = bs + BUF;               // [TILE][LX]: X_s
  float* gs = xs + SSD_TILE * LX;     // [TILE][LG]: the decayed G
  const int tiles = chunk / SSD_TILE;
  const int nc = (Tn + chunk - 1) / chunk;  // blocks: head * nc * tiles + ...
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
    // S_in, DS rows of DH, contiguous
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
  const int tl0 = ti * SSD_TILE + r0 + g;   // chunk-local t of rows g, g + 8
  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // inter: y = exp(cum_t) C_t S_in
#pragma unroll 2
  for (int k0 = 0; k0 < DS; k0 += 8) {
    uint32_t ah[4], al[4];
    load_a<!EXACT>(cs + (r0 + g) * LC + k0 + t4, LC, ah, al);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* pb = bs + (k0 + t4) * LX + n0 + 8 * j + g;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32_int(pb[0], bh0, bl0);
      split_tf32_int(pb[4 * LX], bh1, bl1);
      mma_split<EXACT, false>(acc[j], ah, al, bh0, bh1, bl0, bl1);
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
    __syncthreads();  // the previous step is done with bs, xs and gs
    stage_rows<DS, LC>(bhd, s0, Tn, bs);
    stage_rows<DH, LX>(xh, s0, Tn, xs);
    __syncthreads();
    // G = C_t B_s^T on this warp's 16 rows x 32 columns, decayed and
    // masked into gs; on the diagonal tile columns past the warp's rows
    // are all masked
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
#pragma unroll 2
      for (int k0 = 0; k0 < DS; k0 += 8) {
        uint32_t ah[4], al[4];
        load_a<!EXACT>(cs + (r0 + g) * LC + k0 + t4, LC, ah, al);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          // B = B_s^T: element (k, n) at bs[n][k]
          const float* pb = bs + (sc0 + 8 * jj + g) * LC + k0 + t4;
          uint32_t bh0, bl0, bh1, bl1;
          tf32_parts<!EXACT>(pb[0], bh0, bl0);
          tf32_parts<!EXACT>(pb[4], bh1, bl1);
          mma_split<EXACT, EXACT>(gv[jj], ah, al, bh0, bh1, bl0, bl1);
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
    // y += G X_s, over the columns s of G that can be nonzero in these rows
    const int kend = diag ? r0 + 16 : SSD_TILE;
    for (int k0 = 0; k0 < kend; k0 += 8) {
      uint32_t ah[4], al[4];
      load_a<true>(gs + (r0 + g) * LG + k0 + t4, LG, ah, al);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* pb = xs + (k0 + t4) * LX + n0 + 8 * j + g;
        uint32_t bh0, bl0, bh1, bl1;
        tf32_parts<!EXACT>(pb[0], bh0, bl0);
        tf32_parts<!EXACT>(pb[4 * LX], bh1, bl1);
        mma_split<false, EXACT>(acc[j], ah, al, bh0, bh1, bl0, bl1);
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

template <typename T, int DS, int DH>
static cudaError_t launch_typed(const void* x, const void* la, const void* b,
                                const void* c, void* states, void* totals,
                                void* y, int bh, int Tn, int chunk,
                                long long bstride, long long cstride,
                                cudaStream_t stream) {
  const int nc = (Tn + chunk - 1) / chunk;
  const size_t smem1 =
      (chunk + SSD_TILE * (DS + 8) + SSD_TILE * (DH + 8)) * sizeof(float);
  const size_t smem3 = ssd_out_floats<DS, DH>(chunk) * sizeof(float);
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

// The instantiations, (ds, dh) exactly (kernels/ssd_scan.py INSTANCES: the
// wrapper zero-pads any other pair up to one of them).
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
  if (ds == 128 && dh == 128)
    return launch_typed<T, 128, 128>(x, la, b, c, states, totals, y, bh, Tn, chunk, bstride, cstride, s);
  return cudaErrorInvalidValue;
}

// ---- the generic kernel: any (ds, dh) --------------------------------------
//
// The literal recurrence, S_t = exp(log_a_t) S_{t-1} + b_t^T x_t and
// y_t = c_t S_t, in f32 on the CUDA cores.  It remains only as the route
// past the tensor-core passes' reach, a pair past (128, 128)
// (kernels/ssd_scan.py route() "generic"), which no config of the repo
// has.
// A block owns one head's state columns n0 .. n0 + 31, (ds, 32) f32 in
// shared memory, and walks t in order: thread (g, lane) updates state rows
// g, g + 8, ... of column n0 + lane, which no other thread touches, so the
// walk needs no barrier inside a window; its partial c_t . S_t over those
// rows goes to shared memory, and the eight partials of each (t, column)
// are summed once the window is done.  Windows of `steps` time steps
// (x, b, c and exp(log_a) staged together) amortise the barriers.  Bound on
// this card: operations, 4 ds dh FLOP a step at the fp32 rate, with BH x
// ceil(dh / 32) blocks and T steps in order: ~3.2 ms at 24 x 4096 with
// (128, 128) (chip_smoke.py row 6g's was_ms), where the padded passes fill
// the card with the chunked form.
constexpr int SG_COLS = 32;      // state columns a block: one a lane
constexpr int SG_GROUPS = 8;     // warps: state rows g, g + 8, ...

__device__ __forceinline__ void sg_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void sg_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(SG_COLS * SG_GROUPS)
ssd_scan_generic_kernel(const T* __restrict__ x, const float* __restrict__ la,
                        const T* __restrict__ b, const T* __restrict__ c,
                        T* __restrict__ y, int Tn, int ds, int dh, int steps,
                        long long b_head_stride, long long c_head_stride,
                        int col_tiles) {
  extern __shared__ float sg_smem[];
  float* st = sg_smem;                    // [ds][SG_COLS] state
  float* xs = st + ds * SG_COLS;          // [steps][SG_COLS]
  float* bs = xs + steps * SG_COLS;       // [steps][ds]
  float* cs = bs + steps * ds;            // [steps][ds]
  float* as = cs + steps * ds;            // [steps] exp(log_a)
  float* part = as + steps;               // [SG_GROUPS][steps][SG_COLS]
  const int h = static_cast<int>(blockIdx.x / col_tiles);
  const int n0 = static_cast<int>(blockIdx.x % col_tiles) * SG_COLS;
  const int g = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nthreads = SG_COLS * SG_GROUPS;
  const T* xh = x + static_cast<size_t>(h) * Tn * dh;
  const T* bh = b + static_cast<size_t>(h) * b_head_stride;
  const T* ch = c + static_cast<size_t>(h) * c_head_stride;
  const float* lah = la + static_cast<size_t>(h) * Tn;
  T* yh = y + static_cast<size_t>(h) * Tn * dh;
  for (int i = threadIdx.x; i < ds * SG_COLS; i += nthreads) st[i] = 0.f;

  for (int t0 = 0; t0 < Tn; t0 += steps) {
    const int n = min(steps, Tn - t0);
    for (int i = threadIdx.x; i < n * SG_COLS; i += nthreads) {
      const int col = n0 + i % SG_COLS;
      xs[i] = col < dh ? to_f32(xh[static_cast<size_t>(t0 + i / SG_COLS) * dh + col])
                       : 0.f;
    }
    for (int i = threadIdx.x; i < n * ds; i += nthreads) {
      const size_t at = static_cast<size_t>(t0) * ds + i;
      bs[i] = to_f32(bh[at]);
      cs[i] = to_f32(ch[at]);
    }
    for (int i = threadIdx.x; i < n; i += nthreads) as[i] = expf(lah[t0 + i]);
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float a = as[i], xv = xs[i * SG_COLS + lane];
      const float* bt = bs + i * ds;
      const float* ct = cs + i * ds;
      float acc = 0.f;
      for (int r = g; r < ds; r += SG_GROUPS) {
        const float sv = fmaf(a, st[r * SG_COLS + lane], bt[r] * xv);
        st[r * SG_COLS + lane] = sv;
        acc = fmaf(ct[r], sv, acc);
      }
      part[(g * steps + i) * SG_COLS + lane] = acc;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n * SG_COLS; i += nthreads) {
      const int col = n0 + i % SG_COLS;
      float sum = 0.f;
#pragma unroll
      for (int gg = 0; gg < SG_GROUPS; ++gg) sum += part[gg * steps * SG_COLS + i];
      if (col < dh)
        sg_store(yh + static_cast<size_t>(t0 + i / SG_COLS) * dh + col, sum);
    }
    // the next window's staging writes none of what this sum reads, and its
    // walk writes `part` only after the barrier that ends its staging
  }
}

// Shared memory of the generic kernel (kernels/ssd_scan.py
// generic_smem_bytes).
static size_t sg_smem_bytes(int ds, int steps) {
  return sizeof(float) *
         (static_cast<size_t>(ds) * SG_COLS + static_cast<size_t>(steps) *
          (SG_COLS + 2 * ds + 1 + SG_GROUPS * SG_COLS));
}

template <typename T>
static cudaError_t launch_generic(const void* x, const void* la, const void* b,
                                  const void* c, void* y, int bh, int Tn,
                                  int ds, int dh, int steps, long long bstride,
                                  long long cstride, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = allow_smem(ssd_scan_generic_kernel<T>, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const size_t smem = sg_smem_bytes(ds, steps);
  const int col_tiles = (dh + SG_COLS - 1) / SG_COLS;
  const long long blocks = static_cast<long long>(bh) * col_tiles;
  if (smem > static_cast<size_t>(SMEM_BYTES) || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  ssd_scan_generic_kernel<T>
      <<<static_cast<unsigned>(blocks), SG_COLS * SG_GROUPS, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const float*>(la),
          static_cast<const T*>(b), static_cast<const T*>(c),
          static_cast<T*>(y), Tn, ds, dh, steps, bstride, cstride, col_tiles);
  return cudaGetLastError();
}

// steps: time steps staged a window (kernels/ssd_scan.py generic_steps)
extern "C" int launch_ssd_scan_generic(const void* x, const void* la,
                                       const void* b, const void* c, void* y,
                                       int bh, int Tn, int ds, int dh,
                                       int steps, long long bstride,
                                       long long cstride, int bf16,
                                       void* stream) {
  if (steps < 1 || ds < 1 || dh < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_generic<__nv_bfloat16>(x, la, b, c, y, bh, Tn, ds, dh,
                                           steps, bstride, cstride, s)
           : launch_generic<float>(x, la, b, c, y, bh, Tn, ds, dh, steps,
                                   bstride, cstride, s);
  return static_cast<int>(err);
}

// (ds, dh): an instantiation of launch_dims; states: (BH, n_chunks, ds, dh)
// f32 scratch;
// totals: (BH, n_chunks) f32 scratch.  bf16: 1 for bf16 x/b/c/y, 0 for f32.
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
