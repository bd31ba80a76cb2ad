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
