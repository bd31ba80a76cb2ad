// fp32 GEMM with a fused bias + activation epilogue: two kernels, chosen by
// N (kernels/matmul.py skinny).
//
// Replaces: src/repro/kernels/matmul.py::matmul (Pallas bodies _matmul_kernel
// and _matmul_nobias_kernel), an MXU-tiled GEMM whose K-innermost grid axis
// carries an f32 accumulator in VMEM scratch.
//
// a (M, K), b (K, N), bias (N,) or null -> out (M, N), fp32, row-major.
//
// Bound on this card: on the path (the basecaller head, M = 512 lanes x 64
// frames, K = 128, N = 5) bytes: 17.5 MB in and out for 42 MFLOP, ~5 us at
// 3.35 TB/s.  N <= 8 runs matmul_skinny_kernel, which streams A: a block
// owns 128 rows, one a thread, and stages them through a cp.async ring of
// 32-wide K slices (with B's matching rows), padded so that each thread's
// 16-byte reads of its own row hit distinct banks; each thread keeps N
// accumulators.  Larger N runs the textbook shared-memory tiling
// (matmul_kernel): a 64 x 64 output tile per block, 256 threads each holding
// a 4 x 4 register tile, K walked in slices of 16, the ragged M, N and K
// edges masked.  Both put M on the grid's x axis, so no M is too large.
// Each output sums its K products in ascending order through fmaf, the
// same order as a k = 1 conv on the CUDA cores (conv1d.cu) and in
// fused_stream.cu: the two kernels give the same bits, and the fused and
// unfused heads agree.  fp32 on the CUDA cores, not TF32: the parity bars
// are fp32 bars.
#include <cstdint>

#include <cuda_bf16.h>

#include "common.cuh"
#include "hopper.cuh"
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
  const int m0 = blockIdx.x * MM_BM;
  const int n0 = blockIdx.y * MM_BN;
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

// ------------------------------------------------------------ skinny N ----
constexpr int MS_ROWS = 128;  // rows per block, one per thread
constexpr int MS_BK = 32;     // K per staged slice
constexpr int MS_AP = MS_BK + 4;  // row pitch: MS_AP / 4 odd, no bank conflict
constexpr int MS_STAGES = 3;

// VEC: K % 4 == 0 and a 16-byte aligned, so rows copy in 16-byte pieces
template <int N, bool VEC>
__global__ void __launch_bounds__(MS_ROWS)
matmul_skinny_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int M, int K, int act) {
  // the ring: MS_STAGES slices of A's rows, then as many of B's
  extern __shared__ __align__(16) float ms_smem[];
  float* const as = ms_smem;
  float* const bs = ms_smem + MS_STAGES * MS_ROWS * MS_AP;
  const int tid = threadIdx.x;
  const size_t m0 = static_cast<size_t>(blockIdx.x) * MS_ROWS;
  const int slices = (K + MS_BK - 1) / MS_BK;
  auto stage = [&](int sl) {
    float* ad = as + (sl % MS_STAGES) * MS_ROWS * MS_AP;
    const int k0 = sl * MS_BK;
    if constexpr (VEC) {
      for (int i = tid; i < MS_ROWS * MS_BK / 4; i += MS_ROWS) {
        const int r = i / (MS_BK / 4), c = (i % (MS_BK / 4)) * 4;
        const bool ok = m0 + r < static_cast<size_t>(M) && k0 + c < K;
        cp_async16(ad + r * MS_AP + c,
                   ok ? a + (m0 + r) * K + k0 + c : a, ok);
      }
    } else {
      for (int i = tid; i < MS_ROWS * MS_BK; i += MS_ROWS) {
        const int r = i / MS_BK, c = i % MS_BK;
        const bool ok = m0 + r < static_cast<size_t>(M) && k0 + c < K;
        cp_async4(ad + r * MS_AP + c, ok ? a + (m0 + r) * K + k0 + c : a, ok);
      }
    }
    for (int i = tid; i < MS_BK * N; i += MS_ROWS) {
      const bool ok = k0 + i / N < K;
      cp_async4(bs + (sl % MS_STAGES) * MS_BK * N + i,
                ok ? b + static_cast<size_t>(k0) * N + i : b, ok);
    }
  };

  float acc[N];
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] = 0.f;
#pragma unroll
  for (int i = 0; i < MS_STAGES - 1; ++i) {
    if (i < slices) stage(i);
    cp_async_commit();
  }
  for (int sl = 0; sl < slices; ++sl) {
    cp_async_wait<MS_STAGES - 2>();
    __syncthreads();  // slice sl landed; slice sl - 1 consumed
    if (sl + MS_STAGES - 1 < slices) stage(sl + MS_STAGES - 1);
    cp_async_commit();
    const float* ar = as + (sl % MS_STAGES) * MS_ROWS * MS_AP + tid * MS_AP;
    const float* br = bs + (sl % MS_STAGES) * MS_BK * N;
    const int kn = min(MS_BK, K - sl * MS_BK);  // never fold padding in
    auto fma_k = [&](float av, int kk) {
#pragma unroll
      for (int n = 0; n < N; ++n) acc[n] = fmaf(av, br[kk * N + n], acc[n]);
    };
    int kk = 0;
    for (; kk + 4 <= kn; kk += 4) {
      const float4 v = *reinterpret_cast<const float4*>(ar + kk);
      fma_k(v.x, kk);
      fma_k(v.y, kk + 1);
      fma_k(v.z, kk + 2);
      fma_k(v.w, kk + 3);
    }
    for (; kk < kn; ++kk) fma_k(ar[kk], kk);
  }
  cp_async_wait<0>();

  const size_t m = m0 + tid;
  if (m >= static_cast<size_t>(M)) return;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float v = acc[n];
    if (bias != nullptr) v = v + bias[n];
    out[m * N + n] = activate(v, act);
  }
}

template <int N>
static int launch_skinny(const float* a, const float* b, const float* bias,
                         float* out, int M, int K, int act, bool vec,
                         cudaStream_t stream) {
  const unsigned blocks = (static_cast<unsigned>(M) + MS_ROWS - 1) / MS_ROWS;
  const size_t smem = MS_STAGES * (MS_ROWS * MS_AP + MS_BK * N) * sizeof(float);
  auto kernel = vec ? matmul_skinny_kernel<N, true>
                    : matmul_skinny_kernel<N, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, MS_ROWS, smem, stream>>>(a, b, bias, out, M, K, act);
  return static_cast<int>(cudaGetLastError());
}

// N <= 8 only (kernels/matmul.py skinny); anything else is refused.
extern "C" int launch_matmul_skinny(const void* a, const void* b,
                                    const void* bias, void* out, int M, int N,
                                    int K, int act, void* stream) {
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 1: return launch_skinny<1>(af, bf, cf, of, M, K, act, vec, s);
    case 2: return launch_skinny<2>(af, bf, cf, of, M, K, act, vec, s);
    case 3: return launch_skinny<3>(af, bf, cf, of, M, K, act, vec, s);
    case 4: return launch_skinny<4>(af, bf, cf, of, M, K, act, vec, s);
    case 5: return launch_skinny<5>(af, bf, cf, of, M, K, act, vec, s);
    case 6: return launch_skinny<6>(af, bf, cf, of, M, K, act, vec, s);
    case 7: return launch_skinny<7>(af, bf, cf, of, M, K, act, vec, s);
    case 8: return launch_skinny<8>(af, bf, cf, of, M, K, act, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int launch_matmul(const void* a, const void* b, const void* bias,
                             void* out, int M, int N, int K, int act,
                             void* stream) {
  dim3 grid((static_cast<unsigned>(M) + MM_BM - 1) / MM_BM,
            (N + MM_BN - 1) / MM_BN);
  matmul_kernel<<<grid, MM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(bias), static_cast<float*>(out), M, N, K, act);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- int8 ----
// int8 x int8 -> int32 GEMM: the fixed-point MAC path, two kernels chosen
// by N (kernels/matmul.py skinny).
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
// MMAC, 1.4 us at 3.35 TB/s.  N <= 8 runs matmul_int8_skinny_kernel, which
// streams A: each thread owns one row and reads its K bytes with 16-byte
// loads (4- or 1-byte loads where the rows are not 16- or 4-byte aligned;
// a ragged K tail packs zeros), B is packed four K to a word into shared
// memory once a block (K/4 x N words, 160 at the head), and N int32
// accumulators are fed by __dp4a.  Larger N runs the tiled kernel: the
// fp32 kernel's 64 x 64 tile, with K walked 32 at a time and packed four
// to an int32 word in shared memory as it is staged (byte loads, so any K,
// M and N work; the ragged edges stage zeros, which add nothing), each
// thread a 4 x 4 int32 register tile fed by __dp4a.  Integer sums have one
// answer: both kernels equal the plain version (and torch._int_mm) bit for
// bit.  Both number their blocks along the grid's x only (the tiled one as
// tile row * column tiles + tile column), so no M is too large.
constexpr int MMI_BKW = 8;  // packed words of K per stage (32 int8)
constexpr int MSI_ROWS = 128;  // skinny: rows per block, one per thread

__device__ __forceinline__ int pack4(int8_t b0, int8_t b1, int8_t b2,
                                     int8_t b3) {
  return static_cast<int>(static_cast<uint8_t>(b0)) |
         static_cast<int>(static_cast<uint8_t>(b1)) << 8 |
         static_cast<int>(static_cast<uint8_t>(b2)) << 16 |
         static_cast<int>(static_cast<uint32_t>(static_cast<uint8_t>(b3)) << 24);
}

// VEC: bytes a load (16, 4 or 1); 16 and 4 need rows aligned to VEC
// (K % VEC == 0 and an aligned base), so only VEC = 1 meets a K tail.
template <int N, int VEC>
__global__ void __launch_bounds__(MSI_ROWS)
matmul_int8_skinny_kernel(const int8_t* __restrict__ a,
                          const int8_t* __restrict__ b,
                          int32_t* __restrict__ out, int M, int K) {
  extern __shared__ int bw[];  // (ceil(K / 4), N): b[4kw .. 4kw+3, n]
  const int kw_n = (K + 3) / 4;
  for (int i = threadIdx.x; i < kw_n * N; i += MSI_ROWS) {
    const int kw = i / N, n = i % N;
    int8_t v[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * kw + j < K) v[j] = b[static_cast<size_t>(4 * kw + j) * N + n];
    bw[i] = pack4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();
  const size_t m = static_cast<size_t>(blockIdx.x) * MSI_ROWS + threadIdx.x;
  if (m >= static_cast<size_t>(M)) return;
  const int8_t* ar = a + m * K;
  int acc[N];
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] = 0;
  auto mac = [&](int x, int kw) {
#pragma unroll
    for (int n = 0; n < N; ++n) acc[n] = __dp4a(x, bw[kw * N + n], acc[n]);
  };
  if constexpr (VEC == 16) {
    const int4* a4 = reinterpret_cast<const int4*>(ar);
    for (int i = 0; i < K / 16; ++i) {
      const int4 v = __ldg(a4 + i);
      mac(v.x, 4 * i);
      mac(v.y, 4 * i + 1);
      mac(v.z, 4 * i + 2);
      mac(v.w, 4 * i + 3);
    }
  } else if constexpr (VEC == 4) {
    const int* a1 = reinterpret_cast<const int*>(ar);
    for (int kw = 0; kw < K / 4; ++kw) mac(__ldg(a1 + kw), kw);
  } else {
    for (int kw = 0; kw < kw_n; ++kw) {
      int8_t v[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * kw + j < K) v[j] = ar[4 * kw + j];
      mac(pack4(v[0], v[1], v[2], v[3]), kw);
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) out[m * N + n] = acc[n];
}

template <int N>
static int launch_skinny_int8(const int8_t* a, const int8_t* b, int32_t* out,
                              int M, int K, cudaStream_t stream) {
  const unsigned blocks = (static_cast<unsigned>(M) + MSI_ROWS - 1) / MSI_ROWS;
  const size_t smem = static_cast<size_t>((K + 3) / 4) * N * sizeof(int);
  const uintptr_t base = reinterpret_cast<uintptr_t>(a);
  auto kernel = (K % 16 == 0 && base % 16 == 0)
                    ? matmul_int8_skinny_kernel<N, 16>
                : (K % 4 == 0 && base % 4 == 0)
                    ? matmul_int8_skinny_kernel<N, 4>
                    : matmul_int8_skinny_kernel<N, 1>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, MSI_ROWS, smem, stream>>>(a, b, out, M, K);
  return static_cast<int>(cudaGetLastError());
}

// N <= 8 only (kernels/matmul.py skinny); anything else is refused.
extern "C" int launch_matmul_int8_skinny(const void* a, const void* b,
                                         void* out, int M, int N, int K,
                                         void* stream) {
  const int8_t* ai = static_cast<const int8_t*>(a);
  const int8_t* bi = static_cast<const int8_t*>(b);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 1: return launch_skinny_int8<1>(ai, bi, o, M, K, s);
    case 2: return launch_skinny_int8<2>(ai, bi, o, M, K, s);
    case 3: return launch_skinny_int8<3>(ai, bi, o, M, K, s);
    case 4: return launch_skinny_int8<4>(ai, bi, o, M, K, s);
    case 5: return launch_skinny_int8<5>(ai, bi, o, M, K, s);
    case 6: return launch_skinny_int8<6>(ai, bi, o, M, K, s);
    case 7: return launch_skinny_int8<7>(ai, bi, o, M, K, s);
    case 8: return launch_skinny_int8<8>(ai, bi, o, M, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

__global__ void __launch_bounds__(MM_THREADS)
matmul_int8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                   int32_t* __restrict__ out, int M, int N, int K,
                   int tiles_n) {
  __shared__ int as[MMI_BKW][MM_BM + 1];  // as[kw][m]: a[m, 4kw .. 4kw+3]
  __shared__ int bs[MMI_BKW][MM_BN];      // bs[kw][n]: b[4kw .. 4kw+3, n]
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = static_cast<int>(blockIdx.x / tiles_n) * MM_BM;
  const int n0 = static_cast<int>(blockIdx.x % tiles_n) * MM_BN;
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
  const long long tiles_n = (N + MM_BN - 1) / MM_BN;
  const long long blocks = tiles_n * ((M + MM_BM - 1) / MM_BM);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  matmul_int8_kernel<<<static_cast<unsigned>(blocks), MM_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<int32_t*>(out), M, N, K, static_cast<int>(tiles_n));
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
// Two kernels, chosen by shape (matmul.py says which ran):
//
//   matmul_bf16_wgmma_kernel, every shape TMA can address (K % 8 == 0,
//   N % 8 == 0, 16-byte aligned bases): warpgroup wgmma fed by a TMA ring,
//   the only way to the card's bf16 rate.
//   matmul_bf16_kernel, the rest: warp-wide mma.sync m16n8k16.
//
// The general variant: a 128 x 128 output tile per block of 8 warps (2 x 4,
// each warp 64 x 32: 16 mma a k-step), K walked 32 at a time through
// shared memory with padded rows (conflict-free fragment reads); the next
// K slice is loaded into registers while the current one multiplies.
// Loads are 16 bytes where a row allows it, else element by element; the
// ragged M, N and K edges stage zeros, which add exactly nothing to an f32
// sum.  Blocks are numbered along the grid's x only (tile row * column
// tiles + tile column, the order of the 2-D grid it replaced), so no M is
// too large.
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
                   int act, int vec_a, int vec_b, int tiles_n) {
  __shared__ __align__(16) __nv_bfloat16 as[MB_BM * MB_LDA];
  __shared__ __align__(16) __nv_bfloat16 bs[MB_BK * MB_LDB];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / 4, wn = warp % 4;  // warp tile: rows 64 wm, cols 32 wn
  const int m0 = static_cast<int>(blockIdx.x / tiles_n) * MB_BM;
  const int n0 = static_cast<int>(blockIdx.x % tiles_n) * MB_BN;

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
  const long long tiles_n = (N + MB_BN - 1) / MB_BN;
  const long long blocks = tiles_n * ((M + MB_BM - 1) / MB_BM);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  matmul_bf16_kernel<<<static_cast<unsigned>(blocks), MB_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out),
      M, N, K, act, vec_a, vec_b, static_cast<int>(tiles_n));
  return static_cast<int>(cudaGetLastError());
}

// The wgmma variant.  Persistent: one block per SM walks the output tiles
// in groups of MW_GROUP_M tile rows (tiles sharing A rows and B columns run
// close together in L2).  A block is three warpgroups: two consumers, each
// owning 64 rows x 256 columns of a 128 x 256 tile as f32 accumulators in
// registers (128 a thread, setmaxnreg 232), and a producer (setmaxnreg 40)
// one thread of which keeps a ring of 4 K-slices of 64 in flight by TMA.
// A stage: A 128 x 64 (K-major, 16 KB) and B 64 x 256 in four boxes of
// 64 x 64 (N-major, wgmma's transpose bit), all 128-byte swizzled, with
// one full and one empty mbarrier (192 KB in all).  Consumers issue
// m64n256k16 wgmma (4 a stage), keep one stage's group in flight and free
// a stage once wgmma.wait_group says its products are done.  The epilogue
// runs straight from the accumulators: bias, activation (a template
// argument), one rounding, masked 16-byte stores.  TMA fills the ragged
// M / N / K edges with zeros; B boxes wholly past N are not loaded (they
// feed only columns that are not stored).  128 x 128 tiles (more waves at
// N = 2560, but twice the L2 bytes a FLOP) ran slower at every qwen3-4b
// MLP shape, N = 2560 included (scripts/kernel_variants.py), so one tile
// shape serves every N.
constexpr int MW_BM = 128;
constexpr int MW_BN = 256;
constexpr int MW_BK = 64;
constexpr int MW_STAGES = 4;
constexpr int MW_THREADS = 384;
constexpr int MW_GROUP_M = 8;
constexpr int MW_A_BYTES = MW_BM * MW_BK * 2;  // 16 KB
constexpr int MW_BOX_BYTES = 64 * MW_BK * 2;   // one 64 x 64 box of B, 8 KB
constexpr int MW_STAGE_BYTES = MW_A_BYTES + MW_BN / 64 * MW_BOX_BYTES;
constexpr int MW_SMEM = MW_STAGES * MW_STAGE_BYTES + 1024;  // + alignment

// v[i] and v[i] = x for a runtime i < 4, by selects (no local memory).
__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

__device__ __forceinline__ void put4(uint32_t (&v)[4], int i, uint32_t x) {
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = i == k ? x : v[k];
}

__device__ __forceinline__ void mw_tile(int t, int tiles_m, int tiles_n,
                                        int& tm, int& tn) {
  const int per_group = MW_GROUP_M * tiles_n;
  const int first = (t / per_group) * MW_GROUP_M;
  const int rows = min(tiles_m - first, MW_GROUP_M);
  const int r = t % per_group;
  tm = first + r % rows;
  tn = r / rows;
}

template <int ACT>
__global__ void __launch_bounds__(MW_THREADS, 1)
matmul_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                         const __grid_constant__ CUtensorMap tb,
                         const __nv_bfloat16* __restrict__ bias,
                         __nv_bfloat16* __restrict__ out, int M, int N,
                         int K) {
  extern __shared__ uint8_t mw_smem_raw[];
  __shared__ __align__(8) uint64_t full[MW_STAGES];
  __shared__ __align__(8) uint64_t empty[MW_STAGES];
  uint8_t* smem = align1024(mw_smem_raw);
  const int tiles_m = (M + MW_BM - 1) / MW_BM;
  const int tiles_n = (N + MW_BN - 1) / MW_BN;
  const int tiles = tiles_m * tiles_n;
  const int nk = (K + MW_BK - 1) / MW_BK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < MW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int tm, tn;
        mw_tile(t, tiles_m, tiles_n, tm, tn);
        const int boxes = min(MW_BN / 64, (N - tn * MW_BN + 63) / 64);
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(&empty[s], ph ^ 1);
          uint8_t* st = smem + s * MW_STAGE_BYTES;
          mbar_expect_tx(&full[s], MW_A_BYTES + boxes * MW_BOX_BYTES);
          tma_load_2d(st, &ta, &full[s], kb * MW_BK, tm * MW_BM);
          for (int j = 0; j < boxes; ++j)
            tma_load_2d(st + MW_A_BYTES + j * MW_BOX_BYTES, &tb, &full[s],
                        tn * MW_BN + j * 64, kb * MW_BK);
          if (++s == MW_STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63
    regs_alloc<232>();
    const int lane = threadIdx.x % 32;
    const int wl = (threadIdx.x % 128) / 32;
    const int g = lane >> 2, t4 = lane & 3;
    float acc[MW_BN / 2];
#pragma unroll
    for (int i = 0; i < MW_BN / 2; ++i) acc[i] = 0.f;
    int s = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int tm, tn;
      mw_tile(t, tiles_m, tiles_n, tm, tn);
      int prev = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&full[s], ph);
        const uint8_t* st = smem + s * MW_STAGE_BYTES;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < MW_BK / 16; ++kk) {
          const uint64_t da = wgmma_desc(st + wg * 64 * 128 + kk * 32, 0, 1024, 128);
          const uint64_t db =
              wgmma_desc(st + MW_A_BYTES + kk * 16 * 128, MW_BOX_BYTES, 1024, 128);
          wgmma_ss<MW_BN, 1>(acc, da, db, (kb | kk) != 0);
        }
        wgmma_commit();
        fence_regs(acc);
        wgmma_wait<1>();  // the previous stage's products are done
        fence_regs(acc);
        if (kb > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == MW_STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // Four 8-column chunks at a time, transposed across the quad of
      // threads that holds a row: thread t4 then writes chunk 4j + t4 of
      // its row as one 16-byte store (64 contiguous bytes a row a warp).
      const int row = tm * MW_BM + wg * 64 + wl * 16 + g;
#pragma unroll
      for (int j = 0; j < MW_BN / 32; ++j) {
        uint32_t p[2][4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 4 * j + c;
          const int col = tn * MW_BN + i * 8 + 2 * t4;  // N % 8 == 0: col + 1 < N
          float b0 = 0.f, b1 = 0.f;
          if (bias != nullptr && col < N) {
            b0 = __bfloat162float(bias[col]);
            b1 = __bfloat162float(bias[col + 1]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
            if (bias != nullptr) {
              v0 = v0 + b0;
              v1 = v1 + b1;
            }
            p[h][c] = pack_bf16(activate(v0, ACT), activate(v1, ACT));
          }
        }
        const int col0 = tn * MW_BN + (4 * j + t4) * 8;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t q[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {  // lane s sends its chunk (s - r) & 3
            const uint32_t got = __shfl_sync(
                0xffffffffu, pick4(p[h], (t4 - r) & 3), (lane & ~3) | ((t4 + r) & 3));
            put4(q, (t4 + r) & 3, got);
          }
          const int r = row + 8 * h;
          if (r < M && col0 < N)
            *reinterpret_cast<uint4*>(out + static_cast<size_t>(r) * N + col0) =
                make_uint4(q[0], q[1], q[2], q[3]);
        }
      }
    }
  }
}

template <int ACT>
static int launch_wgmma(const void* a, const void* b, const void* bias,
                        void* out, int M, int N, int K, cudaStream_t stream) {
  CUtensorMap ta, tb;
  const cuuint64_t a_dims[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(M)};
  const cuuint64_t a_strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t a_box[2] = {MW_BK, MW_BM};
  int rc = encode_tmap_bf16(&ta, a, 2, a_dims, a_strides, a_box, 128);
  if (rc != 0) return rc;
  const cuuint64_t b_dims[2] = {static_cast<cuuint64_t>(N),
                                static_cast<cuuint64_t>(K)};
  const cuuint64_t b_strides[1] = {static_cast<cuuint64_t>(N) * 2};
  const cuuint32_t b_box[2] = {64, MW_BK};
  rc = encode_tmap_bf16(&tb, b, 2, b_dims, b_strides, b_box, 128);
  if (rc != 0) return rc;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = allow_smem(matmul_bf16_wgmma_kernel<ACT>, MW_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const long long tiles = static_cast<long long>((M + MW_BM - 1) / MW_BM) *
                          ((N + MW_BN - 1) / MW_BN);
  const int grid = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  matmul_bf16_wgmma_kernel<ACT><<<grid, MW_THREADS, MW_SMEM, stream>>>(
      ta, tb, static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// The activation is a template argument: the epilogue is unrolled over the
// whole accumulator, where a switch per element costs time
// (scripts/kernel_variants.py, act_per_element).
extern "C" int launch_matmul_bf16_wgmma(const void* a, const void* b,
                                        const void* bias, void* out, int M,
                                        int N, int K, int act, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case 0: return launch_wgmma<0>(a, b, bias, out, M, N, K, s);
    case 1: return launch_wgmma<1>(a, b, bias, out, M, N, K, s);
    case 2: return launch_wgmma<2>(a, b, bias, out, M, N, K, s);
    case 3: return launch_wgmma<3>(a, b, bias, out, M, N, K, s);
    case 4: return launch_wgmma<4>(a, b, bias, out, M, N, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
