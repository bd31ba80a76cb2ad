// Tiled GEMM with a fused bias + activation epilogue.
//
// Replaces: src/repro/kernels/matmul.py::matmul (Pallas bodies _matmul_kernel
// and _matmul_nobias_kernel), an MXU-tiled GEMM whose K-innermost grid axis
// carries an f32 accumulator in VMEM scratch.
//
// a (M, K), b (K, N), bias (N,) or null -> out (M, N), fp32, row-major.
//
// Bound on this card: on the path (the basecaller head, M = 512 lanes x 64
// frames, K = 128, N = 5) bytes: 17.5 MB in and out for 42 MFLOP.  A large
// square GEMM would be bound by operations.  Design: the textbook shared-
// memory tiling — a 64 x 64 output tile per block, 256 threads each holding
// a 4 x 4 register tile, K walked in slices of 16 staged in shared memory —
// with the ragged M, N and K edges masked (N = 5 takes one column tile).
// Each output sums its K products in ascending order through fmaf, the same
// order as a k = 1 conv in conv1d.cu and fused_stream.cu.  fp32 on the CUDA
// cores, not TF32: the parity bars are fp32 bars.
#include <cstdint>

#include <cuda_bf16.h>

#include "common.cuh"
#include "mma.cuh"

constexpr int MM_BM = 64;
constexpr int MM_BN = 64;
constexpr int MM_BK = 16;
constexpr int MM_THREADS = 256;

__global__ void __launch_bounds__(MM_THREADS)
matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ bias, float* __restrict__ out, int M,
              int N, int K, int act) {
  __shared__ float as[MM_BK][MM_BM + 1];  // A tile, transposed: as[k][m]
  __shared__ float bs[MM_BK][MM_BN];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * MM_BM;
  const int n0 = blockIdx.x * MM_BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += MM_BK) {
    for (int i = threadIdx.x; i < MM_BM * MM_BK; i += MM_THREADS) {
      const int r = i / MM_BK, c = i % MM_BK;
      const int gm = m0 + r, gk = k0 + c;
      as[c][r] = (gm < M && gk < K) ? a[static_cast<size_t>(gm) * K + gk] : 0.f;
    }
    for (int i = threadIdx.x; i < MM_BK * MM_BN; i += MM_THREADS) {
      const int r = i / MM_BN, c = i % MM_BN;
      const int gk = k0 + r, gn = n0 + c;
      bs[r][c] = (gk < K && gn < N) ? b[static_cast<size_t>(gk) * N + gn] : 0.f;
    }
    __syncthreads();
    const int kn = min(MM_BK, K - k0);  // never fold padding into a sum
    for (int kk = 0; kk < kn; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v = v + bias[n];
      out[static_cast<size_t>(m) * N + n] = activate(v, act);
    }
  }
}

extern "C" int launch_matmul(const void* a, const void* b, const void* bias,
                             void* out, int M, int N, int K, int act,
                             void* stream) {
  dim3 grid((N + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM);
  matmul_kernel<<<grid, MM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(bias), static_cast<float*>(out), M, N, K, act);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- int8 ----
// int8 x int8 -> int32 GEMM: the fixed-point MAC path.
//
// Replaces: the int8 branch of src/repro/kernels/matmul.py::matmul (the same
// Pallas bodies with int8 operands and an int32 accumulator).  Quantization
// and the dequant epilogue stay outside the kernel (kernels/ops.py), as in
// JAX.
//
// a (M, K) int8, b (K, N) int8 -> out (M, N) int32, row-major.
//
// Bound on this card: on the path (the head, M = 512 lanes x 64 frames,
// K = 128, N = 5) bytes: 4.2 MB of int8 in and 0.66 MB of int32 out for 21
// MMAC.  Design: the fp32 kernel's 64 x 64 tile, with K walked 32 at a
// time and packed four to an int32 word in shared memory as it is staged
// (byte loads, so any K, M and N work; the ragged edges stage zeros, which
// add nothing).  Each thread keeps a 4 x 4 int32 register tile fed by
// __dp4a, four MACs per instruction.
constexpr int MMI_BKW = 8;  // packed words of K per stage (32 int8)

__device__ __forceinline__ int pack4(int8_t b0, int8_t b1, int8_t b2,
                                     int8_t b3) {
  return static_cast<int>(static_cast<uint8_t>(b0)) |
         static_cast<int>(static_cast<uint8_t>(b1)) << 8 |
         static_cast<int>(static_cast<uint8_t>(b2)) << 16 |
         static_cast<int>(static_cast<uint32_t>(static_cast<uint8_t>(b3)) << 24);
}

__global__ void __launch_bounds__(MM_THREADS)
matmul_int8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                   int32_t* __restrict__ out, int M, int N, int K) {
  __shared__ int as[MMI_BKW][MM_BM + 1];  // as[kw][m]: a[m, 4kw .. 4kw+3]
  __shared__ int bs[MMI_BKW][MM_BN];      // bs[kw][n]: b[4kw .. 4kw+3, n]
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * MM_BM;
  const int n0 = blockIdx.x * MM_BN;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += 4 * MMI_BKW) {
    for (int i = threadIdx.x; i < MM_BM * MMI_BKW; i += MM_THREADS) {
      const int r = i / MMI_BKW, c = i % MMI_BKW;
      const int gm = m0 + r, gk = k0 + 4 * c;
      int8_t v[4] = {0, 0, 0, 0};
      if (gm < M) {
        const int8_t* ap = a + static_cast<size_t>(gm) * K;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gk + j < K) v[j] = ap[gk + j];
      }
      as[c][r] = pack4(v[0], v[1], v[2], v[3]);
    }
    for (int i = threadIdx.x; i < MMI_BKW * MM_BN; i += MM_THREADS) {
      const int r = i / MM_BN, c = i % MM_BN;
      const int gk = k0 + 4 * r, gn = n0 + c;
      int8_t v[4] = {0, 0, 0, 0};
      if (gn < N) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gk + j < K) v[j] = b[static_cast<size_t>(gk + j) * N + gn];
      }
      bs[r][c] = pack4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < MMI_BKW; ++kw) {
      int av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kw][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kw][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

extern "C" int launch_matmul_int8(const void* a, const void* b, void* out,
                                  int M, int N, int K, void* stream) {
  dim3 grid((N + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM);
  matmul_int8_kernel<<<grid, MM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<int32_t*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- bf16 ----
// bf16 x bf16 -> f32 -> bf16 GEMM with a bias + activation epilogue.
//
// Replaces: the bf16 case of src/repro/kernels/matmul.py::matmul (Pallas
// body _matmul_kernel with bf16 operands: jnp.dot with an f32 accumulator,
// bias and activation on the f32 sum, one cast to bf16).
//
// a (M, K), b (K, N), bias (N,) or null, out (M, N): bf16, row-major.
//
// Bound on this card: on the path (the qwen3-4b MLP at 4096 tokens:
// (4096, 2560) x (2560, 9728) gate + silu and up, (4096, 9728) x (9728,
// 2560) down) operations, 2.0e11 FLOP a GEMM against ~0.1 GB of operands.
// Design: the tensor cores through warp-wide mma.sync m16n8k16 (bf16 ->
// f32).  A 128 x 128 output tile per block of 8 warps (2 x 4, each warp 64
// x 32: 16 mma a k-step), K walked 32 at a time through shared memory with
// padded rows (conflict-free fragment reads); the next K slice is loaded
// into registers while the current one multiplies.  Loads are 16 bytes
// where a row allows it, else element by element; the ragged M, N and K
// edges stage zeros, which add exactly nothing to an f32 sum.  No TMA,
// wgmma or multi-stage pipeline yet.
constexpr int MB_BM = 128;
constexpr int MB_BN = 128;
constexpr int MB_BK = 32;
constexpr int MB_THREADS = 256;
constexpr int MB_LDA = MB_BK + 8;  // padded rows of the A tile (bf16)
constexpr int MB_LDB = MB_BN + 8;  // padded rows of the B tile (bf16)

// 8 consecutive bf16 of row `row` from column `col` (zeros outside the
// rows x cols matrix); `vec`: rows are 16-byte aligned.
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* base, int row,
                                            int col, int rows, int cols,
                                            bool vec) {
  if (row >= rows) return make_uint4(0u, 0u, 0u, 0u);
  const __nv_bfloat16* p = base + static_cast<size_t>(row) * cols + col;
  if (vec && col + 8 <= cols) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat16 z = __ushort_as_bfloat16(0);
    const __nv_bfloat16 lo = col + 2 * e < cols ? p[2 * e] : z;
    const __nv_bfloat16 hi = col + 2 * e + 1 < cols ? p[2 * e + 1] : z;
    w[e] = pack_bf16_bits(lo, hi);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void __launch_bounds__(MB_THREADS)
matmul_bf16_kernel(const __nv_bfloat16* __restrict__ a,
                   const __nv_bfloat16* __restrict__ b,
                   const __nv_bfloat16* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, int M, int N, int K,
                   int act, int vec_a, int vec_b) {
  __shared__ __align__(16) __nv_bfloat16 as[MB_BM * MB_LDA];
  __shared__ __align__(16) __nv_bfloat16 bs[MB_BK * MB_LDB];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / 4, wn = warp % 4;  // warp tile: rows 64 wm, cols 32 wn
  const int m0 = blockIdx.y * MB_BM;
  const int n0 = blockIdx.x * MB_BN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // each thread stages two 16-byte chunks of A (128 x 32) and of B (32 x 128)
  uint4 ra[2], rb[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = threadIdx.x + h * MB_THREADS;
      ra[h] = load8_bf16(a, m0 + i / 4, k0 + (i % 4) * 8, M, K, vec_a);
      rb[h] = load8_bf16(b, k0 + i / 16, n0 + (i % 16) * 8, K, N, vec_b);
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += MB_BK) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = threadIdx.x + h * MB_THREADS;
      *reinterpret_cast<uint4*>(as + (i / 4) * MB_LDA + (i % 4) * 8) = ra[h];
      *reinterpret_cast<uint4*>(bs + (i / 16) * MB_LDB + (i % 16) * 8) = rb[h];
    }
    __syncthreads();
    if (k0 + MB_BK < K) fetch(k0 + MB_BK);
#pragma unroll
    for (int kk = 0; kk < MB_BK / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat16* p = as + (wm * 64 + i * 16 + g) * MB_LDA + kk * 16 + 2 * t;
        af[i][0] = load_pair(p);
        af[i][1] = load_pair(p + 8 * MB_LDA);
        af[i][2] = load_pair(p + 8);
        af[i][3] = load_pair(p + 8 * MB_LDA + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* p = bs + (kk * 16 + 2 * t) * MB_LDB + wn * 32 + j * 8 + g;
        const uint32_t b0 = pack_bf16_bits(p[0], p[MB_LDB]);
        const uint32_t b1 = pack_bf16_bits(p[8 * MB_LDB], p[9 * MB_LDB]);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_bf16_16816(acc[i][j], af[i], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 64 + i * 16 + g + (e < 2 ? 0 : 8);
        const int n = n0 + wn * 32 + j * 8 + 2 * t + (e & 1);
        if (m >= M || n >= N) continue;
        float val = acc[i][j][e];
        if (bias != nullptr) val = val + __bfloat162float(bias[n]);
        out[static_cast<size_t>(m) * N + n] = __float2bfloat16_rn(activate(val, act));
      }
    }
  }
}

extern "C" int launch_matmul_bf16(const void* a, const void* b,
                                  const void* bias, void* out, int M, int N,
                                  int K, int act, int vec_a, int vec_b,
                                  void* stream) {
  dim3 grid((N + MB_BN - 1) / MB_BN, (M + MB_BM - 1) / MB_BM);
  matmul_bf16_kernel<<<grid, MB_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out),
      M, N, K, act, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}
