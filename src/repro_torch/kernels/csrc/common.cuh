// Shared pieces of the hand-written Hopper kernels (built for sm_90a).
//
// Every float product of the fp32 CUDA-core kernels is IEEE fp32, and every
// sum runs in one fixed order through fmaf:
//
//   conv1d / fused conv layers:  acc = 0; for ci: for k: acc = fmaf(x, w, acc)
//   matmul / fused head:         acc = 0; for k:          acc = fmaf(a, b, acc)
//
// then acc + bias, then the activation.  A k=1 conv is then the same
// arithmetic as the GEMM, so the fused tick's head and the unfused matmul
// give the same bits.  The tensor-core conv (conv1d.cu conv1d_tc_kernel,
// 3xTF32) sums in another order: the unfused tick's conv2-conv5 match the
// fused ones within the fp32 bar, not bit for bit.
#pragma once

#include <cuda_runtime.h>

// activation codes: kernels/ref.py ACTIVATION_CODES
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1:  // relu
      return v > 0.f ? v : 0.f;
    case 2: {  // squared_relu
      float r = v > 0.f ? v : 0.f;
      return r * r;
    }
    case 3:  // silu: x * sigmoid(x)
      return v / (1.f + expf(-v));
    case 4: {  // gelu, tanh form (jax.nn.gelu's default)
      float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
      return 0.5f * v * (1.f + tanhf(u));
    }
    default:
      return v;
  }
}

// Shared memory one block may use on an H100 (kernels/_build.py SMEM_LIMIT).
constexpr int SMEM_BYTES = 232448;

// Dynamic shared memory above 48 KB must be opted into per kernel.
template <typename F>
static cudaError_t allow_smem(F kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// A launch entry point returns 0, a cudaError_t, or this plus the CUresult
// of a failed TMA tensor-map encoding (hopper.cuh).
constexpr int TMA_ENCODE_ERROR = 1 << 20;

extern "C" const char* kernel_error_string(int err) {
  if (err >= TMA_ENCODE_ERROR)
    return "cuTensorMapEncodeTiled refused the tensor map (CUresult = code "
           "- 1048576)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
