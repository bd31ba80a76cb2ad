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
// weights; conv2-conv5 are 34.76 GFLOP of it, 0.213 ms at three TF32
// products a FLOP.  Design: one block per lane, every activation in shared
// memory.  Each layer's input is [carry | chunk] rows; layer i writes its
// output after layer i+1's carry rows, so the next input is [carry |
// output] with no copy.  Inputs and outputs sit at the two ends of the
// block's shared memory (layer i's input at the low end when i is even,
// its output at the high end, the other way round when i is odd); the gap
// between them is the layer's scratch (an int8 layer's quantized input).
// Python computes the offsets (kernels/fused_stream.py smem_plan); the
// largest layer, conv4 (input (7 + 128) x 96, output (8 + 64) x 192),
// takes 105 KB, so two lanes share an SM.
//
// Conv layers whose channels allow it (Cin % 8 == 0, Cout % 8 == 0; the
// paper CNN's conv2-conv5) run on the tensor cores: mma.sync.m16n8k8 TF32,
// 3xTF32, with the arithmetic of conv1d.cu conv1d_tc_kernel: each operand
// split hi + lo, three products a k-step (lo_a hi_b, hi_a lo_b, hi_a hi_b),
// each slice of 8 input channels summed over all K taps into fresh
// registers that are added to the running sum once per slice, in fp32 (the
// tensor cores' f32 sums do not round to nearest: one accumulator over the
// 448-1,728 terms of a reduction misses the fp32 bar).  Same fragments, same
// k order, same slices, same split bits: a fused layer gives the unfused
// kernel's bits.
//   * Weights (the fp32 CNN is 1.84 MB and stays in L2): each warp loads
//     its B fragments straight from L2, one tap ahead, and splits them as
//     they arrive.  A cp.async ring of raw weight slices in shared memory
//     (K x 8 x Cout floats a stage) would leave room for one lane an SM
//     and ran slower (scripts/kernel_variants.py ring_2, ring_1).
//   * Activations are too large to keep split, so A is split as its
//     fragments load too, by integer adds and masks (split_tf32_int, the
//     bits of cvt.rna.tf32 without the conversion pipe: cvt_split).
//   * Activations are stored with an XOR swizzle, not padding (padding 8
//     channels to 12 would not fit): row r of a layer with stride s keeps
//     its channel c at c ^ (((r / s) & m) << 2), m = 7 (Cin % 32 == 0),
//     3 or 1 (fs_swizzle).  The 8 frames of an A fragment read rows
//     r = t*s + k for 8 consecutive t, so r / s runs over 8 consecutive
//     values and the fragment's 32 loads hit 32 banks at either stride.
//     Each layer's epilogue (and each carry written in) stores in the
//     layout of the layer that reads it; carries going out are read back
//     through it and written to global memory plainly.
//   * Tiling: one lane is M = t_out frames (64-128) x N = Cout (64-192).
//     Eight warps a block, two blocks an SM (128 registers a thread); a
//     warp owns FS_FRAME_TILE = 32 frames (two m16 tiles) x 8*NT channels,
//     NT up to 4 (4, 3, 3, 4 for conv2-conv5 at chunk 256: one or two
//     passes of the eight warps).  A tensor-core layer's input rows are
//     padded up to whole 32-frame tiles (smem_plan; the launcher refuses a
//     plan that does not hold them), so fragment loads need no clamping;
//     rows past t_out are computed and not stored.  mma.sync asm is never
//     reordered, so each n-tile's products go out one product at a time
//     over its two m-tiles (two independent MMAs back to back).
//   * What holds it back (the timing-only patches of
//     scripts/kernel_variants.py): A's loads and splits (each activation
//     is loaded and split once a tap it meets and a warp column it feeds),
//     registers (128 a thread at two blocks an SM: the NT = 4 tiles
//     spill), B's split, and the lane's CUDA-core work; B's loads from L2
//     are not (b_smem).
// Every other layer keeps the CUDA-core code below and its fmaf order (for
// ci: for k: fmaf, as conv1d.cu and matmul.cu): conv1 (Cin 1), the head
// (Cout 5) and the step codec's layers, whose goldens are bitwise.
//
// int8 layers (the edge_int8 preset; the fused_stream_kernel<true>
// instantiation, 512 threads, one lane an SM: with its quantized input a
// lane's plan, 118 KB at chunk 256, leaves no room for a second):
// activations and carries stay fp32 in shared memory, and the carry is
// written from them before quantization, as in the Pallas body.  A
// quantized layer first quantizes its whole input into its scratch
// (int8), then sums int8 x int8 -> int32, and applies the epilogue
// fma(float(acc), act_scale * w_scale, bias) with one rounding, the
// arithmetic of the unfused int8 path.  Integer sums are exact in any
// order, so every way of summing gives the unfused kernels' bits.
//   * Layers with Cin % 32 == 0 and Cout % 8 == 0 (the paper CNN's
//     conv2-conv5) run on the tensor cores: mma.sync.m16n8k32 s8 -> s32,
//     k ordered (32-channel slice, tap), the warp tiles and n-tile choice
//     of the fp32 layers.  The quantizer writes the scratch as words of
//     four channels, its rows padded to whole FS_FRAME_TILE-frame tiles
//     (smem_plan) and XOR-swizzled inside each 32-word line (fs_qword), so
//     an A fragment's 32 word loads hit 32 banks.  B comes from L2, packed
//     once on the host in fragment order (quant/core.py pack_fragments:
//     a warp's B fragment is one coalesced 8-byte load a thread).
//   * Other quantized layers keep the CUDA cores: __dp4a against weights
//     packed four input channels to a word (1/4 the fp32 bytes, read from
//     L2), or scalar MACs where Cin % 4 != 0 (conv1, the step codec).
//   * What holds it back (timing-only patches of scripts/kernel_variants.py):
//     not the MMAs (~0.04 ms of a 0.39 ms tick at 512 x 256) but the
//     quantization into the scratch (~0.08), conv1 and the head on the
//     CUDA cores (~0.07) and B's loads from L2 (~0.05).  Loading A and B
//     ahead, unrolling and 256 or 1,024 threads were slower.
#include <algorithm>
#include <cstdint>
#include <initializer_list>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

constexpr int FS_MAX_LAYERS = 8;
constexpr int FS_QMAX = 127;
constexpr int FS_INT8_THREADS = 512;
constexpr int FS_WARPS = 8;              // fp32 kernel: warps a block
constexpr int FS_THREADS = FS_WARPS * 32;
constexpr int FS_BLOCKS = 2;             // fp32 blocks an SM
constexpr int FS_FRAME_TILE = 32;        // frames of a warp's tile
constexpr int FS_META = 10;              // ints a layer in the meta array

struct FsLayer {
  // fp32 layers: fp32 (K, cin, cout).  int8 layers: on the tensor cores
  // their B fragments, int32 (K, cin/32, cout/8, 32 lanes, 2); elsewhere
  // int32 words packing four input channels, (K, cin/4, cout), when
  // cin % 4 == 0, else int8 (K, cin, cout).
  const void* w;
  const float* b;          // (cout,)
  const float* carry_in;   // (lanes, K - stride, cin) or null
  float* carry_out;        // (lanes, K - stride, cin) or null
  const float* scale;      // int8 layers: act_scale * w.scale, (cout,)
  const float* act_scale;  // int8 layers: the input's calibrated scale
  int K, stride, cin, cout, act, quantized;
  int tc;                  // on the tensor cores
  int nt;                  // tensor-core layers: n-tiles of 8 a warp
  int in_off, out_off, scratch_off;  // floats into shared memory
  int sw_m;                // the input's swizzle mask (fs_swizzle; 0: plain)
  int q_m;                 // int8 tensor-core layers: the scratch's
                           // (fs_q_swizzle)
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
  int chunk, n_frames, cls_off;  // cls_off: floats to the class buffer
};

// Row r, channel c of a layer input with `cols` channels, stride s and
// swizzle mask m (0: plain).
__device__ __forceinline__ int fs_idx(int r, int c, int cols, int s, int m) {
  if (m == 0) return r * cols + c;
  const int q = s == 1 ? r : (s == 2 ? r >> 1 : r / s);
  return r * cols + (c ^ ((q & m) << 2));
}

// Where a layer writes frame t, channel c: the next layer's input (its
// carry rows first, in its layout), or the logits (plain).
struct FsOut {
  float* p;
  int row0, cols, s, m;
  __device__ __forceinline__ float* at(int t, int c) const {
    return p + fs_idx(row0 + t, c, cols, s, m);
  }
};

// One conv layer of one lane on the CUDA cores: `in` holds [carry | input]
// rows (plain), `o` gets t_out rows.  Each thread keeps an RT x CT register
// tile (RT frames x CT consecutive channels; CT = 4 reads its weights as one
// float4), and every output sums in the order of conv1d.cu: for ci: for k:
// fmaf.
template <int RT, int CT>
__device__ __forceinline__ void conv_layer(const FsLayer& L, const float* in,
                                           const FsOut& o, int t_out, int tid,
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
        *o.at(tl0 + j, co + c) = activate(acc[j][c] + L.b[co + c], L.act);
    }
  }
}

// One conv layer of one lane on the tensor cores (see the note at the top).
// `in` holds the [carry | input] rows in this layer's swizzled layout,
// padded to whole FS_FRAME_TILE-frame tiles.
template <int NT>
__device__ __forceinline__ void tc_layer(const FsLayer& L, const float* in,
                                         const FsOut& o, int t_out, int tid) {
  const int K = L.K, s = L.stride, cin = L.cin, cout = L.cout;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int slices = cin / 8;
  const int ngroups = cout / (8 * NT);
  const int items = (t_out + FS_FRAME_TILE - 1) / FS_FRAME_TILE * ngroups;
  const int R = 8 * s * cin;          // 8 frames of input rows
  const int swm = L.sw_m;
  const float* w = static_cast<const float*>(L.w);

  for (int it = warp; it < items; it += FS_WARPS) {
    const int tb = it / ngroups * FS_FRAME_TILE;
    const int n0 = it % ngroups * 8 * NT;
    const float* arow = in + (tb + g) * s * cin;
    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    for (int sl = 0; sl < slices; ++sl) {
      // B fragment b0 of n-tile 0 at tap 0, read from L2; to the next tap,
      // to b1
      const float* bb = w + static_cast<size_t>(sl * 8 + t4) * cout + n0 + g;
      const int tap_step = cin * cout, half = 4 * cout;
      float part[2][NT][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
      // tap k's raw fragments: A at frames tb + g (+8, +16, +24) and
      // channels 8 sl + t4 (+4), every row of this thread with the same
      // swizzle (r / s = frame + k / s, frames differ by multiples of 8);
      // B at rows t4 (+4) of the tap, columns n0 + 8 nt + g
      auto load_a = [&](int k, int kq, float (&xa)[2][4]) {  // kq = k / s
        const int m = ((g + kq) & swm) << 2;
        const int c0 = ((sl * 8) ^ m) | t4;
        const float* pa = arow + k * cin + c0;
        const float* pb = arow + k * cin + (c0 ^ 4);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          xa[mt][0] = pa[2 * mt * R];
          xa[mt][1] = pa[(2 * mt + 1) * R];
          xa[mt][2] = pb[2 * mt * R];
          xa[mt][3] = pb[(2 * mt + 1) * R];
        }
      };
      auto load_b = [&](int k, float (&wv)[NT][2]) {
        const float* wb = bb + k * tap_step;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          wv[nt][0] = __ldg(wb + nt * 8);
          wv[nt][1] = __ldg(wb + half + nt * 8);
        }
      };
      // A and B one tap ahead: tap k + 1 loads while tap k's MMAs run
      float xa[2][4], wv[NT][2];
      int nq = 0, nr = 0;  // (k + 1) / s and (k + 1) % s, counted up
      load_a(0, 0, xa);
      load_b(0, wv);
      for (int k = 0; k < K; ++k) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32_int(xa[mt][e], ah[mt][e], al[mt][e]);
        float wk[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          wk[nt][0] = wv[nt][0];
          wk[nt][1] = wv[nt][1];
        }
        if (++nr == s) {
          nr = 0;
          ++nq;
        }
        if (k + 1 < K) {
          load_a(k + 1, nq, xa);
          load_b(k + 1, wv);
        }
        // per n-tile: its B split, then each of the three products (in
        // conv1d_tc_kernel's order) over its two m-tiles, two independent
        // MMAs back to back
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32_int(wk[nt][0], bh0, bl0);
          split_tf32_int(wk[nt][1], bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_tf32_1688(part[mt][nt], al[mt], bh0, bh1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_tf32_1688(part[mt][nt], ah[mt], bl0, bl1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_tf32_1688(part[mt][nt], ah[mt], bh0, bh1);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
    }
    // bias and activation, stored in the next layer's layout
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int co = n0 + nt * 8 + 2 * t4;
      const float b0 = L.b[co], b1 = L.b[co + 1];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = tb + mt * 16 + g + 8 * h;
          if (t >= t_out) continue;
          // c ^ mask keeps the pair (co, co + 1) adjacent
          *reinterpret_cast<float2*>(o.at(t, co)) =
              make_float2(activate(acc[mt][nt][2 * h] + b0, L.act),
                          activate(acc[mt][nt][2 * h + 1] + b1, L.act));
        }
      }
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
                                                const int8_t* q,
                                                const FsOut& o, int t_out,
                                                int tid, int nt) {
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
        *o.at(tl0 + j, co + c) = activate(v, L.act);
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

// Word w (channels 4w .. 4w + 3) of quantized row r in an int8
// tensor-core layer's scratch of `words` words a row: word a = r * words +
// w, its bits 2-4 XORed with bits 5.. of a (mask m), which keeps it inside
// its 32-word line.
__device__ __forceinline__ int fs_qword(int a, int m) {
  return a ^ (((a >> 5) & m) << 2);
}

// quantize_rows for an int8 tensor-core layer: four channels to a word,
// each as quantize_rows computes it, stored at fs_qword.  `in` is plain and
// 16-byte aligned (the launcher checks the plan).
__device__ __forceinline__ void quantize_rows_tc(const float* in, uint32_t* q,
                                                 int n_words, int m, float sa,
                                                 int tid, int nt) {
  for (int i = tid; i < n_words; i += nt) {
    const float4 v = reinterpret_cast<const float4*>(in)[i];
    const float f[4] = {v.x, v.y, v.z, v.w};
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = max(-FS_QMAX, min(FS_QMAX, __float2int_rn(
                                                   __fdiv_rn(f[j], sa))));
      word |= (static_cast<uint32_t>(c) & 0xffu) << (8 * j);
    }
    q[fs_qword(i, m)] = word;
  }
}

// One int8 layer of one lane on the tensor cores (see the note at the
// top).  `q` holds the quantized [carry | input] rows, swizzled, padded to
// whole FS_FRAME_TILE-frame tiles.  A warp owns FS_FRAME_TILE frames (two
// m16 tiles) x 8 NT channels; rows past t_out are computed and not stored.
template <int NT>
__device__ __forceinline__ void tc_layer_int8(const FsLayer& L,
                                              const uint32_t* q,
                                              const FsOut& o, int t_out,
                                              int tid, int nwarps) {
  const int K = L.K, s = L.stride, words = L.cin / 4, m = L.q_m;
  const int slices = L.cin / 32, n8 = L.cout / 8;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int ngroups = n8 / NT;
  const int items = (t_out + FS_FRAME_TILE - 1) / FS_FRAME_TILE * ngroups;
  const uint2* wf = static_cast<const uint2*>(L.w);

  for (int it = warp; it < items; it += nwarps) {
    const int tb = it / ngroups * FS_FRAME_TILE;
    const int j0 = it % ngroups * NT;
    int acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    // k-steps in (32-channel slice, tap) order; word r0: the row of frame
    // tb + g at tap k, channels 32 sl + 4 t4 ..
    for (int sl = 0; sl < slices; ++sl) {
      for (int k = 0; k < K; ++k) {
        const int r0 = ((tb + g) * s + k) * words + sl * 8 + t4;
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = r0 + 16 * mt * s * words;   // frame + 16 mt
          const int r8 = r + 8 * s * words;          // frame + 8
          a[mt][0] = q[fs_qword(r, m)];
          a[mt][1] = q[fs_qword(r8, m)];
          a[mt][2] = q[fs_qword(r + 4, m)];
          a[mt][3] = q[fs_qword(r8 + 4, m)];
        }
        const uint2* wb =
            wf + ((static_cast<size_t>(k) * slices + sl) * n8 + j0) * 32 + lane;
        uint2 b[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) b[nt] = __ldg(wb + nt * 32);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_s8_16832(acc[mt][nt], a[mt], b[nt].x, b[nt].y);
      }
    }
    // the unfused epilogue, stored in the next layer's layout
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int co = (j0 + nt) * 8 + 2 * t4;
      const float sc0 = L.scale[co], sc1 = L.scale[co + 1];
      const float bias0 = L.b[co], bias1 = L.b[co + 1];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = tb + mt * 16 + g + 8 * h;
          if (t >= t_out) continue;
          const float v0 =
              __fmaf_rn(__int2float_rn(acc[mt][nt][2 * h]), sc0, bias0);
          const float v1 =
              __fmaf_rn(__int2float_rn(acc[mt][nt][2 * h + 1]), sc1, bias1);
          *reinterpret_cast<float2*>(o.at(t, co)) =
              make_float2(activate(v0, L.act), activate(v1, L.act));
        }
      }
    }
  }
}

template <bool INT8>
__device__ __forceinline__ void run_layer(const FsLayer& L, const float* in,
                                          float* scratch, const FsOut& o,
                                          int t_in, int t_out, int tid,
                                          int nt) {
  if constexpr (INT8) {
    if (L.quantized && L.tc) {
      uint32_t* qw = reinterpret_cast<uint32_t*>(scratch);
      quantize_rows_tc(in, qw, (L.K - L.stride + t_in) * L.cin / 4, L.q_m,
                       *L.act_scale, tid, nt);
      __syncthreads();
      switch (L.nt) {
        case 1: tc_layer_int8<1>(L, qw, o, t_out, tid, nt / 32); return;
        case 2: tc_layer_int8<2>(L, qw, o, t_out, tid, nt / 32); return;
        case 3: tc_layer_int8<3>(L, qw, o, t_out, tid, nt / 32); return;
        default: tc_layer_int8<4>(L, qw, o, t_out, tid, nt / 32); return;
      }
    }
    if (L.quantized) {
      int8_t* qbuf = reinterpret_cast<int8_t*>(scratch);
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
  } else {
    if (L.tc) {
      switch (L.nt) {
        case 1: tc_layer<1>(L, in, o, t_out, tid); return;
        case 2: tc_layer<2>(L, in, o, t_out, tid); return;
        case 3: tc_layer<3>(L, in, o, t_out, tid); return;
        default: tc_layer<4>(L, in, o, t_out, tid); return;
      }
    }
  }
  if (L.cout % 4 == 0 && reinterpret_cast<uintptr_t>(L.w) % 16 == 0)
    conv_layer<4, 4>(L, in, o, t_out, tid, nt);
  else
    conv_layer<8, 1>(L, in, o, t_out, tid, nt);
}

template <bool INT8>
__global__ void __launch_bounds__(INT8 ? FS_INT8_THREADS : FS_THREADS,
                                  INT8 ? 1 : FS_BLOCKS)
fused_stream_kernel(const FsParams p) {
  extern __shared__ __align__(16) float smem[];
  int* cls = reinterpret_cast<int*>(smem + p.cls_off);
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const bool rst = p.reset[lane] > 0.f;

  // layer 0 input: [carry | raw chunk]
  {
    const FsLayer& L = p.layers[0];
    const int s = L.stride, m = L.sw_m, cin = L.cin;
    const int carry = L.K - s, nc = carry * cin;
    float* in = smem + L.in_off;
    for (int i = tid; i < nc; i += nt)
      in[fs_idx(i / cin, i % cin, cin, s, m)] =
          rst ? 0.f : L.carry_in[static_cast<size_t>(lane) * nc + i];
    for (int i = tid; i < p.chunk * cin; i += nt)
      in[fs_idx(carry + i / cin, i % cin, cin, s, m)] =
          p.rows[static_cast<size_t>(lane) * p.chunk * cin + i];
  }

  int t_in = p.chunk;
  for (int l = 0; l < p.n_layers; ++l) {
    __syncthreads();
    const FsLayer& L = p.layers[l];
    const float* in = smem + L.in_off;
    const int carry = L.K - L.stride;
    const int cin = L.cin;
    // the next chunk's carry: the last K - stride input rows
    if (carry > 0) {
      const int nc = carry * cin;
      for (int i = tid; i < nc; i += nt)
        L.carry_out[static_cast<size_t>(lane) * nc + i] =
            in[fs_idx(t_in + i / cin, i % cin, cin, L.stride, L.sw_m)];
    }
    // the next layer's carry rows head its input; this layer's output
    // follows them, in the next layer's layout
    FsOut o{smem + L.out_off, 0, L.cout, 1, 0};
    if (l + 1 < p.n_layers) {
      const FsLayer& N = p.layers[l + 1];
      const int next_carry = N.K - N.stride, next_nc = next_carry * N.cin;
      o = FsOut{smem + L.out_off, next_carry, N.cin, N.stride, N.sw_m};
      for (int i = tid; i < next_nc; i += nt)
        o.p[fs_idx(i / N.cin, i % N.cin, N.cin, N.stride, N.sw_m)] =
            rst ? 0.f
                : N.carry_in[static_cast<size_t>(lane) * next_nc + i];
    }
    const int t_out = t_in / L.stride;
    run_layer<INT8>(L, in, smem + L.scratch_off, o, t_in, t_out, tid, nt);
    t_in = t_out;
  }
  __syncthreads();

  // argmax (first maximum), pad frames forced to BLANK
  const int F = p.n_frames;
  const FsLayer& H = p.layers[p.n_layers - 1];
  const int C = H.cout;
  const float* logits = smem + H.out_off;
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

// n-tiles of 8 channels a warp for a tensor-core layer: the fewest MMAs a
// warp over all passes of the block's warps, then the widest tile (fewer
// A fragments loaded, fewer passes over the weights).
static int pick_nt(int cout, int t_out, int warps) {
  const int n8 = cout / 8;
  const int mg = (t_out + FS_FRAME_TILE - 1) / FS_FRAME_TILE;
  int best = 1, cost = 1 << 30;
  for (int nt : {1, 2, 3, 4}) {
    if (n8 % nt) continue;
    const int items = mg * (n8 / nt);
    const int c = (items + warps - 1) / warps * nt;
    if (c <= cost) {
      best = nt;
      cost = c;
    }
  }
  return best;
}

// The XOR swizzle mask of a tensor-core layer's input (fs_idx): as many
// bits as whole rows of Cin channels hold.
static int fs_swizzle(int cin) {
  return cin % 32 == 0 ? 7 : (cin % 16 == 0 ? 3 : 1);
}

// The swizzle mask of an int8 tensor-core layer's scratch (fs_qword): the
// 8 rows of an A fragment are `stride` rows apart; where that is a whole
// number of 32-word lines they sit in 8 consecutive lines, three bits of
// the line set them apart, else (half lines apart at the paper CNN's
// widths) two.
static int fs_q_swizzle(int cin, int stride) {
  return (cin / 4 * stride) % 32 == 0 ? 7 : 3;
}

// Whether the plan's offsets hold every region the kernel touches, layer by
// layer, inside [0, cls_off) and apart: its [carry | input] rows (an fp32
// tensor-core layer's padded to whole FS_FRAME_TILE-frame tiles, which its
// fragments read), its output (the next layer's carry and input rows, or
// the logits) and an int8 layer's quantized input (on the tensor cores its
// rows padded the same way, in whole 32-word lines); and the class buffer
// inside the block's shared memory.  The plan is kernels/fused_stream.py
// smem_plan's: this is where a plan that does not match the kernel stops.
static bool plan_fits(const FsParams& p, int chunk, int smem_bytes) {
  long long t = chunk;
  for (int l = 0; l < p.n_layers; ++l) {
    const FsLayer& L = p.layers[l];
    const long long t_out = t / L.stride, carry = L.K - L.stride;
    long long rows = carry + t, padded = rows;
    if (L.tc) {
      const long long tiles = (t_out + FS_FRAME_TILE - 1) / FS_FRAME_TILE;
      padded = std::max(rows, (tiles * FS_FRAME_TILE - 1) * L.stride + L.K);
      if (L.out_off % 2) return false;  // float2 stores
      if (L.quantized && L.in_off % 4) return false;  // float4 loads
      if (!L.quantized) rows = padded;
    }
    long long out = t_out * L.cout;
    if (l + 1 < p.n_layers) {
      const FsLayer& N = p.layers[l + 1];
      out = (N.K - N.stride + t_out) * N.cin;
    }
    long long q = L.quantized ? (rows * L.cin + 3) / 4 : 0;
    if (L.quantized && L.tc) q = (padded * L.cin / 4 + 31) / 32 * 32;
    const long long r[3][2] = {{L.in_off, L.in_off + rows * L.cin},
                               {L.out_off, L.out_off + out},
                               {L.scratch_off, L.scratch_off + q}};
    for (int i = 0; i < 3; ++i) {
      if (r[i][1] == r[i][0]) continue;
      if (r[i][0] < 0 || r[i][1] > p.cls_off) return false;
      for (int j = 0; j < i; ++j)
        if (r[j][1] > r[j][0] && r[i][0] < r[j][1] && r[j][0] < r[i][1])
          return false;
    }
    t = t_out;
  }
  return t == p.n_frames &&
         (static_cast<long long>(p.cls_off) + p.n_frames) * 4 <= smem_bytes;
}

// meta: n_layers x (K, stride, cin, cout, act, quantized, tc, in_off,
// out_off, scratch_off); ptrs: n_layers x (w, b, carry_in, carry_out,
// scale, act_scale).  Both are host arrays; the offsets are
// kernels/fused_stream.py smem_plan's, and a plan that does not hold the
// kernel's regions is refused (plan_fits).  smem_bytes: the plan's total.
// A tensor-core layer needs cin and cout multiples of 8 (fp32) or cin of 32
// and cout of 8 (int8; its weights in fragment order, 8-byte aligned);
// int8 layers run in the int8 kernel, where only they take the tensor
// cores.
extern "C" int launch_fused_stream(const int* meta, void* const* ptrs,
                                   int n_layers, const void* rows,
                                   const void* pads, const void* reset,
                                   const void* prev, const void* bases,
                                   const void* ticks, void* tokens, void* lens,
                                   void* prev_out, void* bases_out,
                                   void* ticks_out, int lanes, int chunk,
                                   int n_frames, int cls_off, int smem_bytes,
                                   void* stream) {
  if (n_layers < 1 || n_layers > FS_MAX_LAYERS)
    return static_cast<int>(cudaErrorInvalidValue);
  FsParams p;
  bool any_int8 = false;
  int t = chunk;
  for (int l = 0; l < n_layers; ++l) {
    FsLayer& L = p.layers[l];
    const int* m = meta + FS_META * l;
    L.K = m[0];
    L.stride = m[1];
    L.cin = m[2];
    L.cout = m[3];
    L.act = m[4];
    L.quantized = m[5];
    L.tc = m[6];
    L.in_off = m[7];
    L.out_off = m[8];
    L.scratch_off = m[9];
    L.w = ptrs[6 * l];
    L.b = static_cast<const float*>(ptrs[6 * l + 1]);
    L.carry_in = static_cast<const float*>(ptrs[6 * l + 2]);
    L.carry_out = static_cast<float*>(ptrs[6 * l + 3]);
    L.scale = static_cast<const float*>(ptrs[6 * l + 4]);
    L.act_scale = static_cast<const float*>(ptrs[6 * l + 5]);
    any_int8 = any_int8 || L.quantized;
  }
  const int warps = (any_int8 ? FS_INT8_THREADS : FS_THREADS) / 32;
  for (int l = 0; l < n_layers; ++l) {
    FsLayer& L = p.layers[l];
    t /= L.stride;
    L.nt = L.tc ? pick_nt(L.cout, t, warps) : 0;
    L.sw_m = L.tc && !L.quantized ? fs_swizzle(L.cin) : 0;
    L.q_m = L.tc && L.quantized ? fs_q_swizzle(L.cin, L.stride) : 0;
    if (L.tc && (L.cin % (L.quantized ? 32 : 8) || L.cout % 8 ||
                 L.quantized != static_cast<int>(any_int8) ||
                 (L.quantized && reinterpret_cast<uintptr_t>(L.w) % 8)))
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
  p.cls_off = cls_off;
  if (!plan_fits(p, chunk, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(smem_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (any_int8) {
    err = allow_smem(fused_stream_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_stream_kernel<true><<<lanes, FS_INT8_THREADS, smem, s>>>(p);
  } else {
    err = allow_smem(fused_stream_kernel<false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_stream_kernel<false><<<lanes, FS_THREADS, smem, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
