// 'valid' strided 1-D convolution with a fused bias + activation epilogue.
//
// Replaces: src/repro/kernels/conv1d.py::conv1d (Pallas body _conv1d_kernel),
// which lowers the conv onto the TPU's matrix unit as K shifted GEMMs over
// an in-kernel im2col of a main block plus its halo block.
//
// x (B, T, Cin), w (K, Cin, Cout), bias (Cout,) or null -> out (B, T_out, Cout),
// T_out = (T - K) / stride + 1, all fp32, row-major and contiguous.
//
// Bound on this card: operations.  The basecaller's conv4/conv5 at 512 lanes
// x chunk 256 are 10.9 and 14.5 GFLOP against 17 and 34 MB of traffic, far
// above the ~20 FLOP/byte where fp32 on the CUDA cores stops being memory
// bound.  Design: a block owns (one batch row, TT output frames, 64 output
// channels); it stages the (TT - 1) * stride + K input rows of its tile (the
// tile plus its K - stride halo) in shared memory once.  Each thread keeps
// an RT x CT register tile (RT frames x CT consecutive channels): one staged
// input, a shared-memory broadcast across the warp, feeds CT FMAs, and one
// weight load (a float4 when CT = 4) feeds RT x CT FMAs.  Cout % 4 == 0 takes
// the 4-channel tile, any other Cout (the step codec's 5) the 1-channel one.
// fp32 FMAs on the CUDA cores, not TF32 tensor cores: the parity bars are
// fp32 bars (tensor cores come later).
#include <cstdint>

#include "common.cuh"

constexpr int CONV_TC = 64;  // output channels per block

template <int TT, int RT, int CT>
__global__ void __launch_bounds__((TT / RT) * (CONV_TC / CT))
conv1d_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ out, int T,
              int Cin, int K, int Cout, int stride, int T_out, int act) {
  extern __shared__ float xs[];  // (rows, Cin)
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * TT;
  const int rows = (TT - 1) * stride + K;
  const int r0 = t0 * stride;
  const float* xb = x + static_cast<size_t>(b) * T * Cin;
  for (int i = threadIdx.x; i < rows * Cin; i += blockDim.x) {
    const int r = r0 + i / Cin;
    xs[i] = r < T ? xb[static_cast<size_t>(r0) * Cin + i] : 0.f;
  }
  __syncthreads();

  constexpr int CG = CONV_TC / CT;  // channel groups per block
  const int co = blockIdx.y * CONV_TC + (threadIdx.x % CG) * CT;
  const int tl0 = (threadIdx.x / CG) * RT;
  if (co >= Cout) return;
  float acc[RT][CT];
#pragma unroll
  for (int j = 0; j < RT; ++j)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[j][c] = 0.f;
  for (int ci = 0; ci < Cin; ++ci) {
    for (int k = 0; k < K; ++k) {
      const float* wp = w + (static_cast<size_t>(k) * Cin + ci) * Cout + co;
      float wv[CT];
      if constexpr (CT == 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(wp);
        wv[0] = w4.x; wv[1] = w4.y; wv[2] = w4.z; wv[3] = w4.w;
      } else {
        wv[0] = *wp;
      }
      const float* xc = xs + (tl0 * stride + k) * Cin + ci;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const float xv = xc[j * stride * Cin];
#pragma unroll
        for (int c = 0; c < CT; ++c) acc[j][c] = fmaf(xv, wv[c], acc[j][c]);
      }
    }
  }
  float* ob = out + static_cast<size_t>(b) * T_out * Cout;
#pragma unroll
  for (int j = 0; j < RT; ++j) {
    const int t = t0 + tl0 + j;
    if (t >= T_out) continue;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      float v = acc[j][c];
      if (bias != nullptr) v = v + bias[co + c];
      ob[static_cast<size_t>(t) * Cout + co + c] = activate(v, act);
    }
  }
}

// the two tilings: (frames per block, frames per thread, channels per thread)
#define CONV_WIDE 64, 4, 4    // Cout % 4 == 0, w 16-byte aligned: 256 threads
#define CONV_NARROW 32, 8, 1  // any Cout: 256 threads

static bool wide_tile(int Cout, const void* w) {
  return Cout % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

// shared memory the launch for these operands needs (the wrapper checks it)
extern "C" int conv1d_smem_bytes(int Cin, int K, int stride, int Cout,
                                 const void* w) {
  const int tt = wide_tile(Cout, w) ? 64 : 32;
  return ((tt - 1) * stride + K) * Cin * static_cast<int>(sizeof(float));
}

template <int TT, int RT, int CT>
static int launch(const float* x, const float* w, const float* bias, float* out,
                  int B, int T, int Cin, int K, int Cout, int stride, int T_out,
                  int act, cudaStream_t stream) {
  const size_t smem = conv1d_smem_bytes(Cin, K, stride, Cout, w);
  cudaError_t err = allow_smem(conv1d_kernel<TT, RT, CT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((T_out + TT - 1) / TT, (Cout + CONV_TC - 1) / CONV_TC, B);
  conv1d_kernel<TT, RT, CT><<<grid, (TT / RT) * (CONV_TC / CT), smem, stream>>>(
      x, w, bias, out, T, Cin, K, Cout, stride, T_out, act);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int launch_conv1d(const void* x, const void* w, const void* bias,
                             void* out, int B, int T, int Cin, int K, int Cout,
                             int stride, int T_out, int act, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide_tile(Cout, w))
    return launch<CONV_WIDE>(xf, wf, bf, of, B, T, Cin, K, Cout, stride, T_out,
                             act, s);
  return launch<CONV_NARROW>(xf, wf, bf, of, B, T, Cin, K, Cout, stride, T_out,
                             act, s);
}

// ---------------------------------------------------------------- int8 ----
// int8 x int8 -> int32 'valid' strided conv: the fixed-point MAC path.
//
// Replaces: the int8 branch of src/repro/kernels/conv1d.py::conv1d (the same
// Pallas body with int8 operands and an int32 accumulator).  As in JAX, the
// activation quantization before and the dequant epilogue after stay outside
// the kernel (kernels/ops.py).
//
// x (B, T, Cin) int8 -> out (B, T_out, Cout) int32.  Cin % 4 == 0 reads the
// weights packed four input channels to an int32 word, (K, Cin/4, Cout)
// (quant/core.py pack_words), and multiplies with __dp4a: four int8 MACs
// into the int32 accumulator per instruction.  Any other Cin (conv1's 1)
// reads the (K, Cin, Cout) int8 weights and multiplies scalar ints.
//
// Bound on this card: at the int8 tensor-core rate, bytes — conv4 and conv5
// at 512 lanes x chunk 256 are 5.4 and 7.2 GMAC against 32 and 24 MB, most
// of it the int32 outputs.  This kernel runs dp4a on the CUDA cores, far
// below the tensor cores' rate, so operations bound it in practice.
//
// Design: the fp32 kernel's scheme on int8.  A block stages its rows plus
// the K - stride halo once in shared memory (4x fewer bytes than fp32),
// each thread keeps an RT x CT int32 register tile, and one int4 weight
// load (4 output channels x 4 input channels) feeds RT x 4 dp4a.  The int8
// tensor cores (wgmma s8) are a later step.  Integer sums have one answer,
// so the result equals the plain version bit for bit.

template <int TT, int RT, int CT, bool PACKED>
__global__ void __launch_bounds__((TT / RT) * (CONV_TC / CT))
conv1d_int8_kernel(const int8_t* __restrict__ x, const void* __restrict__ w,
                   int32_t* __restrict__ out, int T, int Cin, int K, int Cout,
                   int stride, int T_out) {
  extern __shared__ __align__(16) int8_t xq[];  // (rows, Cin) int8
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * TT;
  const int rows = (TT - 1) * stride + K;
  const int r0 = t0 * stride;
  const int8_t* xb = x + static_cast<size_t>(b) * T * Cin;
  if constexpr (PACKED) {
    const int cw = Cin / 4;  // words per row
    int32_t* xs = reinterpret_cast<int32_t*>(xq);
    const int32_t* xg =
        reinterpret_cast<const int32_t*>(xb + static_cast<size_t>(r0) * Cin);
    for (int i = threadIdx.x; i < rows * cw; i += blockDim.x)
      xs[i] = r0 + i / cw < T ? xg[i] : 0;
  } else {
    for (int i = threadIdx.x; i < rows * Cin; i += blockDim.x)
      xq[i] = r0 + i / Cin < T ? xb[static_cast<size_t>(r0) * Cin + i] : 0;
  }
  __syncthreads();

  constexpr int CG = CONV_TC / CT;
  const int co = blockIdx.y * CONV_TC + (threadIdx.x % CG) * CT;
  const int tl0 = (threadIdx.x / CG) * RT;
  if (co >= Cout) return;
  int acc[RT][CT];
#pragma unroll
  for (int j = 0; j < RT; ++j)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[j][c] = 0;
  if constexpr (PACKED) {
    const int cw = Cin / 4;
    const int32_t* xs = reinterpret_cast<const int32_t*>(xq);
    const int32_t* wp = static_cast<const int32_t*>(w);
    for (int c4 = 0; c4 < cw; ++c4) {
      for (int k = 0; k < K; ++k) {
        const int32_t* wk = wp + (static_cast<size_t>(k) * cw + c4) * Cout + co;
        int wv[CT];
        if constexpr (CT == 4) {
          const int4 w4 = *reinterpret_cast<const int4*>(wk);
          wv[0] = w4.x; wv[1] = w4.y; wv[2] = w4.z; wv[3] = w4.w;
        } else {
          wv[0] = *wk;
        }
        const int32_t* xc = xs + (tl0 * stride + k) * cw + c4;
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          const int xv = xc[j * stride * cw];
#pragma unroll
          for (int c = 0; c < CT; ++c) acc[j][c] = __dp4a(xv, wv[c], acc[j][c]);
        }
      }
    }
  } else {
    const int8_t* wb = static_cast<const int8_t*>(w);
    for (int ci = 0; ci < Cin; ++ci) {
      for (int k = 0; k < K; ++k) {
        const int8_t* wk = wb + (static_cast<size_t>(k) * Cin + ci) * Cout + co;
        int wv[CT];
        if constexpr (CT == 4) {
          const char4 w4 = *reinterpret_cast<const char4*>(wk);
          wv[0] = w4.x; wv[1] = w4.y; wv[2] = w4.z; wv[3] = w4.w;
        } else {
          wv[0] = *wk;
        }
        const int8_t* xc = xq + (tl0 * stride + k) * Cin + ci;
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          const int xv = xc[j * stride * Cin];
#pragma unroll
          for (int c = 0; c < CT; ++c) acc[j][c] += xv * wv[c];
        }
      }
    }
  }
  int32_t* ob = out + static_cast<size_t>(b) * T_out * Cout;
#pragma unroll
  for (int j = 0; j < RT; ++j) {
    const int t = t0 + tl0 + j;
    if (t >= T_out) continue;
#pragma unroll
    for (int c = 0; c < CT; ++c) ob[static_cast<size_t>(t) * Cout + co + c] = acc[j][c];
  }
}

static bool wide_tile_int8(int Cout, const void* w, bool packed) {
  return Cout % 4 == 0 &&
         reinterpret_cast<uintptr_t>(w) % (packed ? 16 : 4) == 0;
}

extern "C" int conv1d_int8_smem_bytes(int Cin, int K, int stride, int Cout,
                                      const void* w, int packed) {
  const int tt = wide_tile_int8(Cout, w, packed) ? 64 : 32;
  return (((tt - 1) * stride + K) * Cin + 15) / 16 * 16;
}

template <int TT, int RT, int CT, bool PACKED>
static int launch_int8(const int8_t* x, const void* w, int32_t* out, int B,
                       int T, int Cin, int K, int Cout, int stride, int T_out,
                       cudaStream_t stream) {
  const size_t smem = conv1d_int8_smem_bytes(Cin, K, stride, Cout, w, PACKED);
  cudaError_t err = allow_smem(conv1d_int8_kernel<TT, RT, CT, PACKED>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((T_out + TT - 1) / TT, (Cout + CONV_TC - 1) / CONV_TC, B);
  conv1d_int8_kernel<TT, RT, CT, PACKED>
      <<<grid, (TT / RT) * (CONV_TC / CT), smem, stream>>>(
          x, w, out, T, Cin, K, Cout, stride, T_out);
  return static_cast<int>(cudaGetLastError());
}

// w: packed int32 (K, Cin/4, Cout) when packed != 0 (needs Cin % 4 == 0 and
// x 4-byte aligned), else int8 (K, Cin, Cout).
extern "C" int launch_conv1d_int8(const void* x, const void* w, void* out,
                                  int B, int T, int Cin, int K, int Cout,
                                  int stride, int T_out, int packed,
                                  void* stream) {
  const int8_t* xq = static_cast<const int8_t*>(x);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = wide_tile_int8(Cout, w, packed != 0);
  if (packed) {
    if (Cin % 4 || reinterpret_cast<uintptr_t>(x) % 4)
      return static_cast<int>(cudaErrorInvalidValue);
    if (wide)
      return launch_int8<CONV_WIDE, true>(xq, w, o, B, T, Cin, K, Cout, stride,
                                          T_out, s);
    return launch_int8<CONV_NARROW, true>(xq, w, o, B, T, Cin, K, Cout, stride,
                                          T_out, s);
  }
  if (wide)
    return launch_int8<CONV_WIDE, false>(xq, w, o, B, T, Cin, K, Cout, stride,
                                         T_out, s);
  return launch_int8<CONV_NARROW, false>(xq, w, o, B, T, Cin, K, Cout, stride,
                                         T_out, s);
}
