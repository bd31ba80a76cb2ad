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

#include "common.cuh"

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
