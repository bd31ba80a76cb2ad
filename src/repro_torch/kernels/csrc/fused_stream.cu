// One whole flowcell tick per lane: reset-masked conv carries, the conv
// stack, the k=1 head, argmax with pad frames forced to BLANK, the
// incremental CTC collapse, the bases/ticks counters and the new carries.
//
// Replaces: src/repro/kernels/fused_stream.py::_fused_pallas (Pallas body
// _fused_kernel), which keeps a block of lanes resident in VMEM for the
// whole chain.
//
// Bound on this card: operations.  At 512 lanes x chunk 256 the paper's
// CNN is 34.9 GFLOP per tick against ~3.5 MB of signal, carries, tokens and
// weights.  Design: one CTA per lane, every activation in shared memory.
// Two ping-pong buffers hold each layer's input as [carry | chunk] rows;
// layer i writes its output at an offset of layer i+1's carry rows, so the
// next input is [carry | output] with no copy.  The largest layer input is
// conv2's (5 + 256) x 64 fp32, so the two buffers take ~121 KB of the 227 KB
// a block may use (opted into with cudaFuncSetAttribute).  Weights are read
// from global memory: the fp32 CNN is 1.84 MB and stays in L2.  Each thread
// keeps a 4-frame x 4-channel register tile (8 x 1 where Cout % 4 != 0), so
// one float4 weight read feeds 16 FMAs.  Sums run in the order of conv1d.cu
// and matmul.cu (for ci: for k: fmaf), so the fused tick equals the unfused
// kernels bit for bit.  fp32 FMAs on the CUDA cores, not TF32.
//
// int8 layers (the edge_int8 preset; the fused_stream_kernel<true>
// instantiation): activations and carries stay fp32 in the ping-pong
// buffers, and the carry is written from them before quantization, as in
// the Pallas body.  A quantized layer first quantizes its whole input into
// an int8 buffer after the class buffer (conv2's 16.7 KB at chunk 256, so
// ~139 KB in all), then MACs int8 x int8 -> int32 with __dp4a against
// weights packed four input channels to a word (1/4 the fp32 bytes, read
// from L2), and applies the epilogue fma(float(acc), act_scale * w_scale,
// bias) with one rounding, the arithmetic of the unfused int8 path.
#include <cstdint>

#include "common.cuh"

constexpr int FS_MAX_LAYERS = 8;
constexpr int FS_QMAX = 127;

struct FsLayer {
  // fp32 layers: fp32 (K, cin, cout).  int8 layers: int32 words packing
  // four input channels, (K, cin/4, cout), when cin % 4 == 0, else int8
  // (K, cin, cout).
  const void* w;
  const float* b;          // (cout,)
  const float* carry_in;   // (lanes, K - stride, cin) or null
  float* carry_out;        // (lanes, K - stride, cin) or null
  const float* scale;      // int8 layers: act_scale * w.scale, (cout,)
  const float* act_scale;  // int8 layers: the input's calibrated scale
  int K, stride, cin, cout, act, quantized;
};

struct FsParams {
  FsLayer layers[FS_MAX_LAYERS];
  int n_layers;
  const float* rows;   // (lanes, chunk)
  const float* pads;   // (lanes, n_frames), > 0 where a frame is padding
  const float* reset;  // (lanes,), > 0 where the lane starts a new read
  const int* prev;     // (lanes,) CTC carry
  const int* bases;    // (lanes,)
  const int* ticks;    // (lanes,)
  int* tokens;         // (lanes, n_frames)
  int* lens;           // (lanes,)
  int* prev_out;
  int* bases_out;
  int* ticks_out;
  int chunk, n_frames, buf0, buf1;  // buffer sizes in floats
};

// One conv layer of one lane: `in` holds [carry | input] rows, `o` gets
// t_out rows.  Each thread keeps an RT x CT register tile (RT frames x CT
// consecutive channels; CT = 4 reads its weights as one float4), and every
// output sums in the order of conv1d.cu: for ci: for k: fmaf.
template <int RT, int CT>
__device__ __forceinline__ void conv_layer(const FsLayer& L, const float* in,
                                           float* o, int t_out, int tid,
                                           int nt) {
  const int cin = L.cin, cout = L.cout, K = L.K, s = L.stride;
  const int groups = (t_out + RT - 1) / RT;
  const int cgroups = cout / CT;
  for (int item = tid; item < groups * cgroups; item += nt) {
    const int co = (item % cgroups) * CT;
    const int tl0 = (item / cgroups) * RT;
    int off[RT];
    float acc[RT][CT];
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      off[j] = min(tl0 + j, t_out - 1) * s * cin;
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[j][c] = 0.f;
    }
    for (int ci = 0; ci < cin; ++ci) {
      for (int k = 0; k < K; ++k) {
        const float* wp = static_cast<const float*>(L.w) +
                          (static_cast<size_t>(k) * cin + ci) * cout + co;
        float wv[CT];
        if constexpr (CT == 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(wp);
          wv[0] = w4.x; wv[1] = w4.y; wv[2] = w4.z; wv[3] = w4.w;
        } else {
          wv[0] = *wp;
        }
        const float* xc = in + k * cin + ci;
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          const float xv = xc[off[j]];
#pragma unroll
          for (int c = 0; c < CT; ++c) acc[j][c] = fmaf(xv, wv[c], acc[j][c]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      if (tl0 + j >= t_out) continue;
#pragma unroll
      for (int c = 0; c < CT; ++c)
        o[(tl0 + j) * cout + co + c] = activate(acc[j][c] + L.b[co + c], L.act);
    }
  }
}

// One int8 layer of one lane: `q` holds the quantized [carry | input] rows
// (int8, or int32 words of four channels when PACKED).  Each thread keeps
// an RT x CT int32 register tile fed by __dp4a (scalar int MACs when the
// layer's cin is not a multiple of 4), then applies the epilogue of
// kernels/ops.py _int8_epilogue as one rounding: fma(float(acc), scale,
// bias), then the activation.
template <int RT, int CT, bool PACKED>
__device__ __forceinline__ void conv_layer_int8(const FsLayer& L,
                                                const int8_t* q, float* o,
                                                int t_out, int tid, int nt) {
  const int cin = L.cin, cout = L.cout, K = L.K, s = L.stride;
  const int cw = PACKED ? cin / 4 : cin;  // elements per row
  const int groups = (t_out + RT - 1) / RT;
  const int cgroups = cout / CT;
  for (int item = tid; item < groups * cgroups; item += nt) {
    const int co = (item % cgroups) * CT;
    const int tl0 = (item / cgroups) * RT;
    int off[RT];
    int acc[RT][CT];
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      off[j] = min(tl0 + j, t_out - 1) * s * cw;
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[j][c] = 0;
    }
    for (int ci = 0; ci < cw; ++ci) {
      for (int k = 0; k < K; ++k) {
        int wv[CT];
        if constexpr (PACKED) {
          const int32_t* wp = static_cast<const int32_t*>(L.w) +
                              (static_cast<size_t>(k) * cw + ci) * cout + co;
          if constexpr (CT == 4) {
            const int4 w4 = *reinterpret_cast<const int4*>(wp);
            wv[0] = w4.x; wv[1] = w4.y; wv[2] = w4.z; wv[3] = w4.w;
          } else {
            wv[0] = *wp;
          }
          const int32_t* xc = reinterpret_cast<const int32_t*>(q) + k * cw + ci;
#pragma unroll
          for (int j = 0; j < RT; ++j) {
            const int xv = xc[off[j]];
#pragma unroll
            for (int c = 0; c < CT; ++c) acc[j][c] = __dp4a(xv, wv[c], acc[j][c]);
          }
        } else {
          const int8_t* wp = static_cast<const int8_t*>(L.w) +
                             (static_cast<size_t>(k) * cw + ci) * cout + co;
          if constexpr (CT == 4) {
            const char4 w4 = *reinterpret_cast<const char4*>(wp);
            wv[0] = w4.x; wv[1] = w4.y; wv[2] = w4.z; wv[3] = w4.w;
          } else {
            wv[0] = *wp;
          }
          const int8_t* xc = q + k * cw + ci;
#pragma unroll
          for (int j = 0; j < RT; ++j) {
            const int xv = xc[off[j]];
#pragma unroll
            for (int c = 0; c < CT; ++c) acc[j][c] += xv * wv[c];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      if (tl0 + j >= t_out) continue;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float v = __fmaf_rn(__int2float_rn(acc[j][c]), L.scale[co + c],
                                  L.b[co + c]);
        o[(tl0 + j) * cout + co + c] = activate(v, L.act);
      }
    }
  }
}

// quantize n floats with the calibrated scale, as quant/core.py quantize:
// a true division, round half to even, clip to +-127
__device__ __forceinline__ void quantize_rows(const float* in, int8_t* q,
                                              int n, float sa, int tid,
                                              int nt) {
  for (int i = tid; i < n; i += nt) {
    const int v = __float2int_rn(__fdiv_rn(in[i], sa));
    q[i] = static_cast<int8_t>(max(-FS_QMAX, min(FS_QMAX, v)));
  }
}

template <bool INT8>
__device__ __forceinline__ void run_layer(const FsLayer& L, const float* in,
                                          int8_t* qbuf, float* o, int t_in,
                                          int t_out, int tid, int nt) {
  if (INT8 && L.quantized) {
    quantize_rows(in, qbuf, (L.K - L.stride + t_in) * L.cin, *L.act_scale,
                  tid, nt);
    __syncthreads();
    const bool packed = L.cin % 4 == 0;
    const bool wide = L.cout % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(L.w) % (packed ? 16 : 4) == 0;
    if (packed) {
      if (wide)
        conv_layer_int8<4, 4, true>(L, qbuf, o, t_out, tid, nt);
      else
        conv_layer_int8<8, 1, true>(L, qbuf, o, t_out, tid, nt);
    } else {
      if (wide)
        conv_layer_int8<4, 4, false>(L, qbuf, o, t_out, tid, nt);
      else
        conv_layer_int8<8, 1, false>(L, qbuf, o, t_out, tid, nt);
    }
    return;
  }
  if (L.cout % 4 == 0 && reinterpret_cast<uintptr_t>(L.w) % 16 == 0)
    conv_layer<4, 4>(L, in, o, t_out, tid, nt);
  else
    conv_layer<8, 1>(L, in, o, t_out, tid, nt);
}

template <bool INT8>
__global__ void __launch_bounds__(512) fused_stream_kernel(const FsParams p) {
  extern __shared__ float smem[];
  float* bufs[2] = {smem, smem + p.buf0};
  int* cls = reinterpret_cast<int*>(smem + p.buf0 + p.buf1);
  // int8 layers: the quantized input rows, after the class buffer
  int8_t* qbuf = reinterpret_cast<int8_t*>(cls + p.n_frames);
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const bool rst = p.reset[lane] > 0.f;

  // layer 0 input: [carry | raw chunk]
  {
    const FsLayer& L = p.layers[0];
    const int nc = (L.K - L.stride) * L.cin;
    float* in = bufs[0];
    for (int i = tid; i < nc; i += nt)
      in[i] = rst ? 0.f : L.carry_in[static_cast<size_t>(lane) * nc + i];
    for (int i = tid; i < p.chunk * L.cin; i += nt)
      in[nc + i] = p.rows[static_cast<size_t>(lane) * p.chunk * L.cin + i];
  }

  int t_in = p.chunk;
  for (int l = 0; l < p.n_layers; ++l) {
    __syncthreads();
    const FsLayer& L = p.layers[l];
    const float* in = bufs[l & 1];
    float* outb = bufs[(l + 1) & 1];
    const int carry = L.K - L.stride;
    const int cin = L.cin;
    // the next chunk's carry: the last K - stride input rows
    if (carry > 0) {
      const int nc = carry * cin;
      for (int i = tid; i < nc; i += nt)
        L.carry_out[static_cast<size_t>(lane) * nc + i] = in[t_in * cin + i];
    }
    // the next layer's carry rows head its input buffer
    int next_nc = 0;
    if (l + 1 < p.n_layers) {
      const FsLayer& N = p.layers[l + 1];
      next_nc = (N.K - N.stride) * N.cin;
      for (int i = tid; i < next_nc; i += nt)
        outb[i] = rst ? 0.f : N.carry_in[static_cast<size_t>(lane) * next_nc + i];
    }
    float* o = outb + next_nc;
    const int t_out = t_in / L.stride;
    run_layer<INT8>(L, in, qbuf, o, t_in, t_out, tid, nt);
    t_in = t_out;
  }
  __syncthreads();

  // argmax (first maximum), pad frames forced to BLANK
  const int F = p.n_frames;
  const int C = p.layers[p.n_layers - 1].cout;
  const float* logits = bufs[p.n_layers & 1];
  for (int f = tid; f < F; f += nt) {
    int best = 0;
    float bv = logits[f * C];
    for (int c = 1; c < C; ++c) {
      const float v = logits[f * C + c];
      if (v > bv) {
        bv = v;
        best = c;
      }
    }
    if (p.pads[static_cast<size_t>(lane) * F + f] > 0.f) best = 0;
    cls[f] = best;
  }
  __syncthreads();

  // incremental CTC collapse + counters (F <= a few hundred: one thread)
  if (tid == 0) {
    int prev = rst ? 0 : p.prev[lane];
    int n = 0;
    int* tok = p.tokens + static_cast<size_t>(lane) * F;
    for (int f = 0; f < F; ++f) {
      const int c = cls[f];
      if (c != 0 && c != prev) tok[n++] = c;
      prev = c;
    }
    for (int f = n; f < F; ++f) tok[f] = 0;
    p.lens[lane] = n;
    p.prev_out[lane] = cls[F - 1];
    p.bases_out[lane] = (rst ? 0 : p.bases[lane]) + n;
    p.ticks_out[lane] = (rst ? 0 : p.ticks[lane]) + 1;
  }
}

// meta: n_layers x (K, stride, cin, cout, act, quantized); ptrs: n_layers x
// (w, b, carry_in, carry_out, scale, act_scale).  Both are host arrays.
// qbytes: the int8 input buffer (0 when no layer is quantized, which runs
// the fp32-only kernel).
extern "C" int launch_fused_stream(const int* meta, void* const* ptrs,
                                   int n_layers, const void* rows,
                                   const void* pads, const void* reset,
                                   const void* prev, const void* bases,
                                   const void* ticks, void* tokens, void* lens,
                                   void* prev_out, void* bases_out,
                                   void* ticks_out, int lanes, int chunk,
                                   int n_frames, int buf0, int buf1,
                                   int qbytes, int threads, void* stream) {
  if (n_layers < 1 || n_layers > FS_MAX_LAYERS)
    return static_cast<int>(cudaErrorInvalidValue);
  FsParams p;
  bool any_int8 = false;
  for (int l = 0; l < n_layers; ++l) {
    FsLayer& L = p.layers[l];
    L.K = meta[6 * l];
    L.stride = meta[6 * l + 1];
    L.cin = meta[6 * l + 2];
    L.cout = meta[6 * l + 3];
    L.act = meta[6 * l + 4];
    L.quantized = meta[6 * l + 5];
    L.w = ptrs[6 * l];
    L.b = static_cast<const float*>(ptrs[6 * l + 1]);
    L.carry_in = static_cast<const float*>(ptrs[6 * l + 2]);
    L.carry_out = static_cast<float*>(ptrs[6 * l + 3]);
    L.scale = static_cast<const float*>(ptrs[6 * l + 4]);
    L.act_scale = static_cast<const float*>(ptrs[6 * l + 5]);
    any_int8 = any_int8 || L.quantized;
  }
  if (any_int8 && qbytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  p.n_layers = n_layers;
  p.rows = static_cast<const float*>(rows);
  p.pads = static_cast<const float*>(pads);
  p.reset = static_cast<const float*>(reset);
  p.prev = static_cast<const int*>(prev);
  p.bases = static_cast<const int*>(bases);
  p.ticks = static_cast<const int*>(ticks);
  p.tokens = static_cast<int*>(tokens);
  p.lens = static_cast<int*>(lens);
  p.prev_out = static_cast<int*>(prev_out);
  p.bases_out = static_cast<int*>(bases_out);
  p.ticks_out = static_cast<int*>(ticks_out);
  p.chunk = chunk;
  p.n_frames = n_frames;
  p.buf0 = buf0;
  p.buf1 = buf1;
  const size_t smem = (static_cast<size_t>(buf0) + buf1 + n_frames) * sizeof(float) +
                      (any_int8 ? qbytes : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (any_int8) {
    err = allow_smem(fused_stream_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_stream_kernel<true><<<lanes, threads, smem, s>>>(p);
  } else {
    err = allow_smem(fused_stream_kernel<false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_stream_kernel<false><<<lanes, threads, smem, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
