// 'valid' strided 1-D convolution with a fused bias + activation epilogue,
// fp32: two hand-written kernels, chosen by shape (kernels/conv1d.py).
//
// Replaces: src/repro/kernels/conv1d.py::conv1d (Pallas body _conv1d_kernel),
// which lowers the conv onto the TPU's matrix unit as K shifted GEMMs over
// an in-kernel im2col of a main block plus its halo block.
//
// x (B, T, Cin), w (K, Cin, Cout), bias (Cout,) or null -> out (B, T_out, Cout),
// T_out = (T - K) / stride + 1, all fp32, row-major and contiguous.
//
// The conv is a GEMM: M = B x T_out frames, N = Cout, and for frame t the
// (k, ci) reduction of x[b, t*s + k, ci] against w[k, ci, :].  At the
// basecaller's widths (512 lanes x chunk 256: conv2-conv5 are 3.8-14.5
// GFLOP against 17-34 MB) operations bound it, so the tensor cores carry
// every shape they can take (conv1d_tc_kernel); the rest (Cin 1, Cout 5,
// ragged channel counts) runs on the CUDA cores (conv1d_kernel).  Both walk
// Cin in slices staged through shared memory, so no Cin is too large.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

// ------------------------------------------------------ on the CUDA cores ---
// A block owns (one batch row, TT output frames, 64 output channels); for
// each slice of `cs` input channels it stages the (TT - 1) * stride + K
// input rows of its tile (the tile plus its K - stride halo) in shared
// memory.  Each thread keeps an RT x CT register tile (RT frames x CT
// consecutive channels): one staged input, a shared-memory broadcast across
// the warp, feeds CT FMAs, and one weight load (a float4 when CT = 4) feeds
// RT x CT FMAs.  Cout % 4 == 0 takes the 4-channel tile, any other Cout (the
// step codec's 5) the 1-channel one.  IEEE fp32 FMAs in the order of
// common.cuh (ci ascending across the slices, then k), so a k = 1 conv is
// the fused tick's arithmetic.
constexpr int CONV_TC = 64;  // output channels per block
constexpr int CONV_CS = 64;  // input channels per staged slice, at most

template <int TT, int RT, int CT>
__global__ void __launch_bounds__((TT / RT) * (CONV_TC / CT))
conv1d_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ out, int T,
              int Cin, int K, int Cout, int stride, int T_out, int act, int cs,
              int tiles_t) {
  extern __shared__ float xs[];  // (rows, cs)
  const int b = blockIdx.x / tiles_t;
  const int t0 = (blockIdx.x % tiles_t) * TT;
  const int rows = (TT - 1) * stride + K;
  const int r0 = t0 * stride;
  const float* xb = x + static_cast<size_t>(b) * T * Cin;

  constexpr int CG = CONV_TC / CT;  // channel groups per block
  const int co = blockIdx.y * CONV_TC + (threadIdx.x % CG) * CT;
  const int tl0 = (threadIdx.x / CG) * RT;
  float acc[RT][CT];
#pragma unroll
  for (int j = 0; j < RT; ++j)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[j][c] = 0.f;
  for (int c0 = 0; c0 < Cin; c0 += cs) {
    const int cn = min(cs, Cin - c0);
    __syncthreads();  // the previous slice is consumed
    for (int i = threadIdx.x; i < rows * cn; i += blockDim.x) {
      const int r = r0 + i / cn;
      xs[i] = r < T ? xb[static_cast<size_t>(r) * Cin + c0 + i % cn] : 0.f;
    }
    __syncthreads();
    if (co >= Cout) continue;
    for (int ci = 0; ci < cn; ++ci) {
      for (int k = 0; k < K; ++k) {
        const float* wp =
            w + (static_cast<size_t>(k) * Cin + c0 + ci) * Cout + co;
        float wv[CT];
        if constexpr (CT == 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(wp);
          wv[0] = w4.x; wv[1] = w4.y; wv[2] = w4.z; wv[3] = w4.w;
        } else {
          wv[0] = *wp;
        }
        const float* xc = xs + (tl0 * stride + k) * cn + ci;
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          const float xv = xc[j * stride * cn];
#pragma unroll
          for (int c = 0; c < CT; ++c) acc[j][c] = fmaf(xv, wv[c], acc[j][c]);
        }
      }
    }
  }
  if (co >= Cout) return;
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

// Units (channels, or packed words) of a staged slice: at most `cap`, and
// fewer where `rows` of them would not fit a block's shared memory.
static int slice_width(int n, int cap, int rows, int unit_bytes) {
  return max(1, min(min(n, cap), SMEM_BYTES / (rows * unit_bytes)));
}

template <int TT, int RT, int CT>
static int launch(const float* x, const float* w, const float* bias, float* out,
                  int B, int T, int Cin, int K, int Cout, int stride, int T_out,
                  int act, cudaStream_t stream) {
  const int rows = (TT - 1) * stride + K;
  const int cs = slice_width(Cin, CONV_CS, rows, sizeof(float));
  const size_t smem = static_cast<size_t>(rows) * cs * sizeof(float);
  cudaError_t err = allow_smem(conv1d_kernel<TT, RT, CT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_t = (T_out + TT - 1) / TT;
  dim3 grid(static_cast<unsigned>(B) * tiles_t, (Cout + CONV_TC - 1) / CONV_TC);
  conv1d_kernel<TT, RT, CT><<<grid, (TT / RT) * (CONV_TC / CT), smem, stream>>>(
      x, w, bias, out, T, Cin, K, Cout, stride, T_out, act, cs, tiles_t);
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

// ---------------------------------------------------- on the tensor cores ---
// Implicit GEMM on mma.sync.m16n8k8 TF32, 3xTF32.  Bound on this card:
// operations, three TF32 products a FLOP at the TF32 peak (the tick's
// conv2-conv5, 34.8 GFLOP: 0.21 ms at 495 TFLOP/s).
//
// Numerics.  One TF32 product keeps 11 significant bits of each operand
// (~2^-11 relative), far above the fp32 bar of 2e-5 that the port holds
// every fp32 kernel to.  So each operand is split v = hi + lo
// (mma.cuh split_tf32) and each product taken as lo_a hi_b + hi_a lo_b +
// hi_a hi_b, summed in f32 on the tensor cores; the dropped lo_a lo_b is
// ~2^-22 of the product.  The tensor cores do not round their f32 sums to
// nearest: summed into one accumulator over a whole reduction of the tick
// (448 to 1,728 terms) the error grows with its length and passes the bar
// (scripts/kernel_variants.py one_sum).  So each slice of Cin sums into
// fresh registers that are added to the running sum once per slice, in
// fp32 on the CUDA cores.  Sums run in another order than on the CUDA
// cores: results match the plain version within the bar, not bit for bit.
//
// Why mma.sync and not wgmma: wgmma takes TF32 only with both operands
// K-major in its canonical shared-memory layout, which rules out the
// overlapping im2col rows (row pitch stride * Cin) and the N-major w
// without extra copies; mma.sync fragments are loaded by the threads from
// any layout.  wgmma (with a transposing copy of w) is the next step if
// this kernel stays short of its bound.
//
// Tiling.  A block owns TC_SUBS sub-tiles of TC_FRAMES output frames, each
// a run of frames of one batch row (sub-tile q of the B x ceil(T_out / 64)
// in batch-major order; the tick's 64-frame rows pair up), times BN = 64
// output channels where Cout % 64 == 0, else 96 where Cout % 96 == 0, else
// 32: the tick's Cout 64, 192 and 128 take 64, its 96 (and the variant
// caller's) 96, and none wastes a column.  Eight warps: four along frames
// (32 each), two along channels (BN / 2 each).  The reduction walks Cin in
// slices of TC_CS = 8 channels, each slice all K taps: per slice the
// sub-tiles' (64 - 1) * s + K input rows x 8 channels and the K x 8 x BN
// weights come through a TC_STAGES-deep cp.async ring, so shared memory
// does not grow with Cin; two stages let two blocks share an SM (three
// hold one, and ran slower: scripts/kernel_variants.py).  Tap k of frame
// t reads staged row t*s + k: the TPU kernel's in-kernel im2col, done in
// shared-memory addressing.  Rows are stored by phase (row r in plane
// r % s at r / s), so the 8 frames of an A fragment read consecutive rows
// at any stride; a row pitch of 12 floats then puts the fragment's 32
// loads on 32 banks, and a weight pitch of BN + 8 does the same for B.
// Each thread splits the weights it copied into hi and lo planes once, as
// the slice lands; x is split as fragments load, which ran faster than
// hi and lo planes of x (TC_SPLIT_X_AT_STAGING, kernel_variants.py).  The
// grid puts the sub-tiles on x, so no batch is too large.
constexpr int TC_FRAMES = 64;    // output frames per sub-tile
constexpr int TC_SUBS = 2;       // sub-tiles per block: 128 GEMM rows
constexpr int TC_CS = 8;         // input channels per slice: one k-step a tap
constexpr int TC_STAGES = 2;     // depth of the cp.async ring
constexpr int TC_THREADS = 256;  // 8 warps: 4 along frames x 2 along channels
constexpr int TC_XP = 12;        // staged x row pitch (floats)
constexpr bool TC_SPLIT_X_AT_STAGING = false;
constexpr int TC_PASSES = 3;     // 3xTF32 (1: hi x hi only, under the bar)

constexpr int tc_bn(int Cout) {
  return Cout % 64 == 0 ? 64 : Cout % 96 == 0 ? 96 : 32;
}

// shared-memory floats of one stage: the sub-tiles' x rows (x2 when split
// at staging), then the weights' hi and lo planes
static int tc_stage_floats(int K, int stride, int bn) {
  const int prow = TC_FRAMES - 1 + (K + stride - 1) / stride;
  const int xf = TC_SUBS * stride * prow * TC_XP;
  return xf * (TC_SPLIT_X_AT_STAGING ? 2 : 1) + 2 * K * TC_CS * (bn + 8);
}

extern "C" int conv1d_tc_smem_bytes(int K, int stride, int Cout) {
  return TC_STAGES * tc_stage_floats(K, stride, tc_bn(Cout)) *
         static_cast<int>(sizeof(float));
}

__device__ __forceinline__ float4 tf32_split4(float4& v) {
  uint32_t h, l;
  float4 lo;
  split_tf32(v.x, h, l); v.x = __uint_as_float(h); lo.x = __uint_as_float(l);
  split_tf32(v.y, h, l); v.y = __uint_as_float(h); lo.y = __uint_as_float(l);
  split_tf32(v.z, h, l); v.z = __uint_as_float(h); lo.z = __uint_as_float(l);
  split_tf32(v.w, h, l); v.w = __uint_as_float(h); lo.w = __uint_as_float(l);
  return lo;
}

template <int NT>
__global__ void __launch_bounds__(TC_THREADS)
conv1d_tc_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int T, int Cin, int K, int Cout, int stride, int T_out,
                 int act, int tiles_t, long long n_sub) {
  constexpr int BN = 16 * NT;  // output channels per block
  constexpr int WP = BN + 8;   // weight row pitch (floats)
  extern __shared__ __align__(16) float tc_smem[];
  const int s = stride;
  const int prow = TC_FRAMES - 1 + (K + s - 1) / s;  // rows of a phase plane
  const int plane = prow * TC_XP;
  const int slab = s * plane;               // one sub-tile's staged rows
  const int xlo = TC_SUBS * slab;           // offset of x's lo plane
  const int x_floats = TC_SPLIT_X_AT_STAGING ? 2 * xlo : xlo;
  const int wlo = K * TC_CS * WP;           // offset of w's lo plane
  const int stage_floats = x_floats + 2 * wlo;
  const int R = (TC_FRAMES - 1) * s + K;    // rows a sub-tile reads
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int wm = warp % 4, wn = warp / 4;
  const int w_chunks = K * TC_CS * (BN / 4);  // 16-byte copies of w a slice
  const long long q0 = static_cast<long long>(blockIdx.x) * TC_SUBS;

  // each sub-tile's batch row and first staged row (past T: no sub-tile)
  const float* xrow[TC_SUBS];
  int row0[TC_SUBS];
#pragma unroll
  for (int j = 0; j < TC_SUBS; ++j) {
    const long long q = q0 + j;
    const bool real = q < n_sub;
    xrow[j] = real ? x + static_cast<size_t>(q / tiles_t) * T * Cin : x;
    row0[j] = real ? static_cast<int>(q % tiles_t) * TC_FRAMES * s : T;
  }
  // staged row r of a sub-tile sits in phase plane r % s at r / s
  auto x_at = [&](int r) {
    if (s == 1) return r * TC_XP;
    if (s == 2) return (r & 1) * plane + (r >> 1) * TC_XP;
    return (r % s) * plane + (r / s) * TC_XP;
  };
  auto w_chunk = [&](int i, int c0, const float*& src, int& dst, bool& ok) {
    const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
    ok = n0 + c < Cout;
    src = ok ? w + (static_cast<size_t>(r / TC_CS) * Cin + c0 + r % TC_CS) *
                       Cout + n0 + c
             : w;
    dst = r * WP + c;
  };
  auto stage = [&](int slice) {
    float* xs = tc_smem + (slice % TC_STAGES) * stage_floats;
    float* ws = xs + x_floats;
    const int c0 = slice * TC_CS;
    const float* src;
    int dst;
    bool ok;
    // x: each sub-tile's R rows x 8 channels, two 16-byte halves a row
#pragma unroll
    for (int j = 0; j < TC_SUBS; ++j) {
      for (int i = tid; i < 2 * R; i += TC_THREADS) {
        const int row = row0[j] + (i >> 1);
        ok = row < T;
        src = ok ? xrow[j] + static_cast<size_t>(row) * Cin + c0 + 4 * (i & 1)
                 : x;
        cp_async16(xs + j * slab + x_at(i >> 1) + 4 * (i & 1), src, ok);
      }
    }
    for (int i = tid; i < w_chunks; i += TC_THREADS) {
      w_chunk(i, c0, src, dst, ok);
      cp_async16(ws + dst, src, ok);
    }
  };
  // each thread splits what it copied: hi in place, lo in the lo plane
  auto split = [&](int slice) {
    float* xs = tc_smem + (slice % TC_STAGES) * stage_floats;
    float* ws = xs + x_floats;
    const float* src;
    int dst;
    bool ok;
    for (int i = tid; i < w_chunks; i += TC_THREADS) {
      w_chunk(i, 0, src, dst, ok);
      float4* p = reinterpret_cast<float4*>(ws + dst);
      float4 v = *p;
      const float4 lo = tf32_split4(v);
      *p = v;
      *reinterpret_cast<float4*>(ws + wlo + dst) = lo;
    }
    if constexpr (TC_SPLIT_X_AT_STAGING) {
#pragma unroll
      for (int j = 0; j < TC_SUBS; ++j) {
        for (int i = tid; i < 2 * R; i += TC_THREADS) {
          dst = j * slab + x_at(i >> 1) + 4 * (i & 1);
          float4* p = reinterpret_cast<float4*>(xs + dst);
          float4 v = *p;
          const float4 lo = tf32_split4(v);
          *p = v;
          *reinterpret_cast<float4*>(xs + xlo + dst) = lo;
        }
      }
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int slices = Cin / TC_CS;
  const int sub = wm / 2, f0 = (wm % 2) * 32;
#pragma unroll
  for (int i = 0; i < TC_STAGES - 1; ++i) {
    if (i < slices) stage(i);
    cp_async_commit();
  }
  for (int sl = 0; sl < slices; ++sl) {
    cp_async_wait<TC_STAGES - 2>();
    split(sl);
    __syncthreads();  // slice sl landed and split; slice sl - 1 consumed
    if (sl + TC_STAGES - 1 < slices) stage(sl + TC_STAGES - 1);
    cp_async_commit();

    const float* xs = tc_smem + (sl % TC_STAGES) * stage_floats + sub * slab;
    const float* ws = tc_smem + (sl % TC_STAGES) * stage_floats + x_floats +
                      t4 * WP + wn * (BN / 2) + g;
    float part[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
    int pk = 0, rk = 0;  // tap k's phase plane and row in it: k % s, k / s
    for (int k = 0; k < K; ++k) {
      const float* xa = xs + pk * plane + (rk + f0 + g) * TC_XP + t4;
      if (++pk == s) {
        pk = 0;
        ++rk;
      }
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int off = mt * 16 * TC_XP + (e & 1) * 8 * TC_XP + (e >> 1) * 4;
          if constexpr (TC_SPLIT_X_AT_STAGING) {
            ah[mt][e] = __float_as_uint(xa[off]);
            al[mt][e] = __float_as_uint(xa[xlo + off]);
          } else {
            split_tf32(xa[off], ah[mt][e], al[mt][e]);
          }
        }
      }
      const float* wb = ws + k * TC_CS * WP;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t bh0 = __float_as_uint(wb[nt * 8]);
        const uint32_t bh1 = __float_as_uint(wb[4 * WP + nt * 8]);
        const uint32_t bl0 = __float_as_uint(wb[wlo + nt * 8]);
        const uint32_t bl1 = __float_as_uint(wb[wlo + 4 * WP + nt * 8]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if constexpr (TC_PASSES == 3) {
            mma_tf32_1688(part[mt][nt], al[mt], bh0, bh1);
            mma_tf32_1688(part[mt][nt], ah[mt], bl0, bl1);
          }
          mma_tf32_1688(part[mt][nt], ah[mt], bh0, bh1);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  }
  cp_async_wait<0>();

  const long long q = q0 + sub;
  if (q >= n_sub) return;
  const int t0 = static_cast<int>(q % tiles_t) * TC_FRAMES + f0;
  float* ob = out + static_cast<size_t>(q / tiles_t) * T_out * Cout;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int co = n0 + wn * (BN / 2) + nt * 8 + 2 * t4;
    if (co >= Cout) continue;  // Cout % 8 == 0: co + 1 < Cout too
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      b0 = bias[co];
      b1 = bias[co + 1];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + mt * 16 + g + 8 * h;
        if (t >= T_out) continue;
        float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (bias != nullptr) {
          v0 = v0 + b0;
          v1 = v1 + b1;
        }
        *reinterpret_cast<float2*>(ob + static_cast<size_t>(t) * Cout + co) =
            make_float2(activate(v0, act), activate(v1, act));
      }
    }
  }
}

template <int NT>
static int launch_tc(const float* x, const float* w, const float* bias,
                     float* out, int B, int T, int Cin, int K, int Cout,
                     int stride, int T_out, int act, cudaStream_t stream) {
  const size_t smem = conv1d_tc_smem_bytes(K, stride, Cout);
  cudaError_t err = allow_smem(conv1d_tc_kernel<NT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_t = (T_out + TC_FRAMES - 1) / TC_FRAMES;
  const long long n_sub = static_cast<long long>(B) * tiles_t;
  dim3 grid(static_cast<unsigned>((n_sub + TC_SUBS - 1) / TC_SUBS),
            (Cout + 16 * NT - 1) / (16 * NT));
  conv1d_tc_kernel<NT><<<grid, TC_THREADS, smem, stream>>>(
      x, w, bias, out, T, Cin, K, Cout, stride, T_out, act, tiles_t, n_sub);
  return static_cast<int>(cudaGetLastError());
}

// Takes Cin % 8 == 0, Cout % 8 == 0 and 16-byte aligned x and w (the
// wrapper's kernels/conv1d.py tensor_core_shape); anything else is refused.
extern "C" int launch_conv1d_tc(const void* x, const void* w, const void* bias,
                                void* out, int B, int T, int Cin, int K,
                                int Cout, int stride, int T_out, int act,
                                void* stream) {
  if (Cin % TC_CS || Cout % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tc_bn(Cout)) {
    case 64:
      return launch_tc<4>(xf, wf, bf, of, B, T, Cin, K, Cout, stride, T_out,
                          act, s);
    case 96:
      return launch_tc<6>(xf, wf, bf, of, B, T, Cin, K, Cout, stride, T_out,
                          act, s);
    default:
      return launch_tc<2>(xf, wf, bf, of, B, T, Cin, K, Cout, stride, T_out,
                          act, s);
  }
}

// ---------------------------------------------------------------- int8 ----
// int8 x int8 -> int32 'valid' strided conv: the fixed-point MAC path, two
// kernels chosen by shape (kernels/conv1d.py int8_tensor_core_shape).
//
// Replaces: the int8 branch of src/repro/kernels/conv1d.py::conv1d (the same
// Pallas body with int8 operands and an int32 accumulator).  As in JAX, the
// activation quantization before and the dequant epilogue after stay outside
// the kernel (kernels/ops.py).
//
// x (B, T, Cin) int8 -> out (B, T_out, Cout) int32.  Integer sums have one
// answer in any order, so both kernels equal the plain version bit for bit.
//
// Bound on this card: bytes.  The tick's conv2-conv5 (512 lanes x chunk
// 256) are 17.4 G MACs, 0.018 ms at the int8 tensor-core rate, against 84
// MB of int32 output, 0.025 ms at 3.35 TB/s.
//
// conv1d_int8_tc_kernel (Cin % 32 == 0, Cout % 8 == 0, 16-byte aligned x:
// the paper CNN's conv2-conv5) is an implicit GEMM on mma.sync m16n8k32 s8
// -> s32: M = B x T_out frames, N = Cout, k in (32-channel slice, tap)
// order, the fused int8 tick's layer (fused_stream.cu tc_layer_int8) as a
// kernel of its own.  It takes the fp32 tensor-core kernel's tiling (above):
// two 64-frame sub-tiles a block, BN = 64 / 96 / 32 output channels, eight
// warps (4 along frames x 2 along channels), and a two-stage cp.async ring
// that stages, per slice of 32 input channels, the sub-tiles' (64 - 1) * s
// + K rows (the tile plus its K - stride halo: tap k of frame f reads staged
// row f * s + k, the TPU kernel's in-kernel im2col) and the slice's B
// fragments (QuantizedTensor.fragments: each lane's two registers in place,
// one 8-byte load).  Rows are stored by phase (row r in plane r % s at
// r / s), so an A fragment's 8 frames read 8 consecutive rows at any
// stride; a row pitch of 12 words (32 channels and 16 bytes) puts the 8
// rows' words on 8 disjoint groups of 4 banks, so its 32 loads hit 32
// banks.  Each thread stores its accumulators' two columns as one 8-byte
// int2: a warp writes whole 32-byte sectors.  The grid puts the sub-tiles
// on x, so no batch is too large, and the ring does not grow with Cin.
//
// conv1d_int8_kernel takes every other shape (conv1's Cin 1, the step
// codec, Cin 6 or 8, Cout 5 or 70).  It is the fp32 CUDA-core kernel's
// scheme on int8: Cin % 4 == 0 reads the weights packed four input
// channels to an int32 word, (K, Cin/4, Cout) (quant/core.py pack_words),
// and multiplies with __dp4a: four int8 MACs into the int32 accumulator
// per instruction; any other Cin reads the (K, Cin, Cout) int8 weights and
// multiplies scalar ints.  For each slice of Cin a block stages its rows
// plus the K - stride halo in shared memory, each thread keeps an RT x CT
// int32 register tile across the slices, and one int4 weight load (4
// output channels x 4 input channels) feeds RT x 4 dp4a.
constexpr int CONV_CS_INT8 = 256;  // input channels per staged slice, at most

template <int TT, int RT, int CT, bool PACKED>
__global__ void __launch_bounds__((TT / RT) * (CONV_TC / CT))
conv1d_int8_kernel(const int8_t* __restrict__ x, const void* __restrict__ w,
                   int32_t* __restrict__ out, int T, int Cin, int K, int Cout,
                   int stride, int T_out, int cs, int tiles_t) {
  // (rows, cs) int8, or (rows, cs) packed words when PACKED
  extern __shared__ __align__(16) int8_t xq[];
  const int b = blockIdx.x / tiles_t;
  const int t0 = (blockIdx.x % tiles_t) * TT;
  const int rows = (TT - 1) * stride + K;
  const int r0 = t0 * stride;
  const int8_t* xb = x + static_cast<size_t>(b) * T * Cin;
  // a row's length in the staged unit: words when PACKED, else channels
  const int cw = PACKED ? Cin / 4 : Cin;

  constexpr int CG = CONV_TC / CT;
  const int co = blockIdx.y * CONV_TC + (threadIdx.x % CG) * CT;
  const int tl0 = (threadIdx.x / CG) * RT;
  int acc[RT][CT];
#pragma unroll
  for (int j = 0; j < RT; ++j)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[j][c] = 0;
  for (int c0 = 0; c0 < cw; c0 += cs) {
    const int cn = min(cs, cw - c0);
    __syncthreads();  // the previous slice is consumed
    if constexpr (PACKED) {
      int32_t* xs = reinterpret_cast<int32_t*>(xq);
      const int32_t* xg = reinterpret_cast<const int32_t*>(xb);
      for (int i = threadIdx.x; i < rows * cn; i += blockDim.x) {
        const int r = r0 + i / cn;
        xs[i] = r < T ? xg[static_cast<size_t>(r) * cw + c0 + i % cn] : 0;
      }
    } else {
      for (int i = threadIdx.x; i < rows * cn; i += blockDim.x) {
        const int r = r0 + i / cn;
        xq[i] = r < T ? xb[static_cast<size_t>(r) * Cin + c0 + i % cn] : 0;
      }
    }
    __syncthreads();
    if (co >= Cout) continue;
    if constexpr (PACKED) {
      const int32_t* xs = reinterpret_cast<const int32_t*>(xq);
      const int32_t* wp = static_cast<const int32_t*>(w);
      for (int c4 = 0; c4 < cn; ++c4) {
        for (int k = 0; k < K; ++k) {
          const int32_t* wk =
              wp + (static_cast<size_t>(k) * cw + c0 + c4) * Cout + co;
          int wv[CT];
          if constexpr (CT == 4) {
            const int4 w4 = *reinterpret_cast<const int4*>(wk);
            wv[0] = w4.x; wv[1] = w4.y; wv[2] = w4.z; wv[3] = w4.w;
          } else {
            wv[0] = *wk;
          }
          const int32_t* xc = xs + (tl0 * stride + k) * cn + c4;
#pragma unroll
          for (int j = 0; j < RT; ++j) {
            const int xv = xc[j * stride * cn];
#pragma unroll
            for (int c = 0; c < CT; ++c)
              acc[j][c] = __dp4a(xv, wv[c], acc[j][c]);
          }
        }
      }
    } else {
      const int8_t* wb = static_cast<const int8_t*>(w);
      for (int ci = 0; ci < cn; ++ci) {
        for (int k = 0; k < K; ++k) {
          const int8_t* wk =
              wb + (static_cast<size_t>(k) * Cin + c0 + ci) * Cout + co;
          int wv[CT];
          if constexpr (CT == 4) {
            const char4 w4 = *reinterpret_cast<const char4*>(wk);
            wv[0] = w4.x; wv[1] = w4.y; wv[2] = w4.z; wv[3] = w4.w;
          } else {
            wv[0] = *wk;
          }
          const int8_t* xc = xq + (tl0 * stride + k) * cn + ci;
#pragma unroll
          for (int j = 0; j < RT; ++j) {
            const int xv = xc[j * stride * cn];
#pragma unroll
            for (int c = 0; c < CT; ++c) acc[j][c] += xv * wv[c];
          }
        }
      }
    }
  }
  if (co >= Cout) return;
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

template <int TT, int RT, int CT, bool PACKED>
static int launch_int8(const int8_t* x, const void* w, int32_t* out, int B,
                       int T, int Cin, int K, int Cout, int stride, int T_out,
                       cudaStream_t stream) {
  const int rows = (TT - 1) * stride + K;
  const int unit = PACKED ? 4 : 1;  // bytes per staged unit
  const int cs = slice_width(Cin / unit, CONV_CS_INT8 / unit, rows, unit);
  const size_t smem = (static_cast<size_t>(rows) * cs * unit + 15) / 16 * 16;
  cudaError_t err = allow_smem(conv1d_int8_kernel<TT, RT, CT, PACKED>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_t = (T_out + TT - 1) / TT;
  dim3 grid(static_cast<unsigned>(B) * tiles_t, (Cout + CONV_TC - 1) / CONV_TC);
  conv1d_int8_kernel<TT, RT, CT, PACKED>
      <<<grid, (TT / RT) * (CONV_TC / CT), smem, stream>>>(
          x, w, out, T, Cin, K, Cout, stride, T_out, cs, tiles_t);
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

// ------------------------------------------- int8 on the tensor cores ---
constexpr int I8_CS = 32;  // input channels per slice: one k-step a tap
constexpr int I8_XP = 12;  // staged x row pitch (words)

// shared-memory bytes of one ring stage: the sub-tiles' x rows, then the
// slice's B fragments (K taps x BN / 8 n-tiles x 256 bytes)
static int i8_stage_bytes(int K, int stride, int bn) {
  const int prow = TC_FRAMES - 1 + (K + stride - 1) / stride;
  return TC_SUBS * stride * prow * I8_XP * 4 + K * bn * I8_CS;
}

extern "C" int conv1d_int8_tc_smem_bytes(int K, int stride, int Cout) {
  return TC_STAGES * i8_stage_bytes(K, stride, tc_bn(Cout));
}

template <int NT>
__global__ void __launch_bounds__(TC_THREADS)
conv1d_int8_tc_kernel(const int8_t* __restrict__ x,
                      const uint2* __restrict__ wf, int32_t* __restrict__ out,
                      int T, int Cin, int K, int Cout, int stride, int T_out,
                      int tiles_t, long long n_sub) {
  constexpr int BN = 16 * NT;  // output channels per block
  extern __shared__ __align__(16) uint32_t i8_smem[];
  const int s = stride;
  const int prow = TC_FRAMES - 1 + (K + s - 1) / s;  // rows of a phase plane
  const int plane = prow * I8_XP;                    // words
  const int slab = s * plane;            // one sub-tile's staged rows
  const int x_words = TC_SUBS * slab;
  const int stage_words = x_words + K * BN * 8;
  const int R = (TC_FRAMES - 1) * s + K;  // rows a sub-tile reads
  const int n0 = blockIdx.y * BN, j0 = n0 / 8;
  const int n8 = Cout / 8, slices = Cin / I8_CS;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int wm = warp % 4, wn = warp / 4;
  const long long q0 = static_cast<long long>(blockIdx.x) * TC_SUBS;

  // each sub-tile's batch row and first staged row (past T: no sub-tile)
  const int8_t* xrow[TC_SUBS];
  int row0[TC_SUBS];
#pragma unroll
  for (int j = 0; j < TC_SUBS; ++j) {
    const long long q = q0 + j;
    const bool real = q < n_sub;
    xrow[j] = real ? x + static_cast<size_t>(q / tiles_t) * T * Cin : x;
    row0[j] = real ? static_cast<int>(q % tiles_t) * TC_FRAMES * s : T;
  }
  // staged row r of a sub-tile sits in phase plane r % s at r / s
  auto x_at = [&](int r) {
    if (s == 1) return r * I8_XP;
    if (s == 2) return (r & 1) * plane + (r >> 1) * I8_XP;
    return (r % s) * plane + (r / s) * I8_XP;
  };
  // the B fragments of tap k, slice sl, n-tile j (global)
  auto w_tile = [&](int k, int sl, int j) {
    return wf + ((static_cast<size_t>(k) * slices + sl) * n8 + j) * 32;
  };
  auto stage = [&](int sl) {
    uint32_t* xs = i8_smem + (sl % TC_STAGES) * stage_words;
    const int c0 = sl * I8_CS;
    // x: each sub-tile's R rows x 32 channels, two 16-byte halves a row
#pragma unroll
    for (int j = 0; j < TC_SUBS; ++j) {
      for (int i = tid; i < 2 * R; i += TC_THREADS) {
        const int row = row0[j] + (i >> 1);
        const bool ok = row < T;
        const int8_t* src =
            ok ? xrow[j] + static_cast<size_t>(row) * Cin + c0 + 16 * (i & 1)
               : x;
        cp_async16(xs + j * slab + x_at(i >> 1) + 4 * (i & 1), src, ok);
      }
    }
    // B: per tap, the block's BN / 8 n-tiles lie together (2 BN chunks)
    uint32_t* ws = xs + x_words;
    for (int i = tid; i < K * 2 * BN; i += TC_THREADS) {
      const int k = i / (2 * BN), c = i % (2 * BN);
      const bool ok = j0 + c / 16 < n8;
      const void* src = ok ? static_cast<const void*>(
                                 reinterpret_cast<const char*>(
                                     w_tile(k, sl, j0)) + 16 * c)
                           : static_cast<const void*>(wf);
      cp_async16(ws + k * BN * 8 + 4 * c, src, ok);
    }
  };

  int acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  const int sub = wm / 2, f0 = (wm % 2) * 32;
#pragma unroll
  for (int i = 0; i < TC_STAGES - 1; ++i) {
    if (i < slices) stage(i);
    cp_async_commit();
  }
  for (int sl = 0; sl < slices; ++sl) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // slice sl landed; slice sl - 1 consumed
    if (sl + TC_STAGES - 1 < slices) stage(sl + TC_STAGES - 1);
    cp_async_commit();

    const uint32_t* xs =
        i8_smem + (sl % TC_STAGES) * stage_words + sub * slab;
    const uint2* ws = reinterpret_cast<const uint2*>(
        i8_smem + (sl % TC_STAGES) * stage_words + x_words);
    int pk = 0, rk = 0;  // tap k's phase plane and row in it: k % s, k / s
    for (int k = 0; k < K; ++k) {
      const uint32_t* xa = xs + pk * plane + (rk + f0 + g) * I8_XP + t4;
      if (++pk == s) {
        pk = 0;
        ++rk;
      }
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t* xm = xa + mt * 16 * I8_XP;
        a[mt][0] = xm[0];
        a[mt][1] = xm[8 * I8_XP];
        a[mt][2] = xm[4];
        a[mt][3] = xm[8 * I8_XP + 4];
      }
      uint2 b[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        b[nt] = ws[(k * (BN / 8) + wn * NT + nt) * 32 + lane];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_s8_16832(acc[mt][nt], a[mt], b[nt].x, b[nt].y);
    }
  }
  cp_async_wait<0>();

  const long long q = q0 + sub;
  if (q >= n_sub) return;
  const int t0 = static_cast<int>(q % tiles_t) * TC_FRAMES + f0;
  int32_t* ob = out + static_cast<size_t>(q / tiles_t) * T_out * Cout;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int co = n0 + wn * (BN / 2) + nt * 8 + 2 * t4;
    if (co >= Cout) continue;  // Cout % 8 == 0: co + 1 < Cout too
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + mt * 16 + g + 8 * h;
        if (t >= T_out) continue;
        *reinterpret_cast<int2*>(ob + static_cast<size_t>(t) * Cout + co) =
            make_int2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
  }
}

template <int NT>
static int launch_int8_tc(const int8_t* x, const uint2* wf, int32_t* out,
                          int B, int T, int Cin, int K, int Cout, int stride,
                          int T_out, cudaStream_t stream) {
  const size_t smem = conv1d_int8_tc_smem_bytes(K, stride, Cout);
  cudaError_t err = allow_smem(conv1d_int8_tc_kernel<NT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_t = (T_out + TC_FRAMES - 1) / TC_FRAMES;
  const long long n_sub = static_cast<long long>(B) * tiles_t;
  dim3 grid(static_cast<unsigned>((n_sub + TC_SUBS - 1) / TC_SUBS),
            (Cout + 16 * NT - 1) / (16 * NT));
  conv1d_int8_tc_kernel<NT><<<grid, TC_THREADS, smem, stream>>>(
      x, wf, out, T, Cin, K, Cout, stride, T_out, tiles_t, n_sub);
  return static_cast<int>(cudaGetLastError());
}

// w: the B fragments (K, Cin/32, Cout/8, 32, 2) int32 (quant/core.py
// pack_fragments).  Takes Cin % 32 == 0, Cout % 8 == 0 and 16-byte aligned
// x and w (kernels/conv1d.py int8_tensor_core_shape); anything else is
// refused.
extern "C" int launch_conv1d_int8_tc(const void* x, const void* w, void* out,
                                     int B, int T, int Cin, int K, int Cout,
                                     int stride, int T_out, void* stream) {
  if (Cin % I8_CS || Cout % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* xq = static_cast<const int8_t*>(x);
  const uint2* wf = static_cast<const uint2*>(w);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tc_bn(Cout)) {
    case 64:
      return launch_int8_tc<4>(xq, wf, o, B, T, Cin, K, Cout, stride, T_out,
                               s);
    case 96:
      return launch_int8_tc<6>(xq, wf, o, B, T, Cin, K, Cout, stride, T_out,
                               s);
    default:
      return launch_int8_tc<2>(xq, wf, o, B, T, Cin, K, Cout, stride, T_out,
                               s);
  }
}
