// Banded Needleman-Wunsch (global) / Smith-Waterman (local) int32 scores.
//
// Replaces: src/repro/kernels/edit_distance.py::banded_align and
// ::levenshtein, both via _wavefront (Pallas body _wavefront_kernel), which
// puts the anti-diagonal on the TPU's sublanes and 128 independent pairs on
// its lanes.  levenshtein is this kernel with match 0, mismatch -1, gap -1,
// global and band = max(m, n), its distance minus the score.
//
// q (P, m), t (P, n) int32 tokens -> out (P,) int32; the semantics of
// src/repro/kernels/ref.py::banded_align: cells with |i - j| > band are
// -2^20 (global) or 0 (local), local cells floor at 0, local keeps the
// running max, and the first row and column are set, not maxed.
//
// Bound on this card: integer operations at the pathogen firehose (39,680
// local pairs of 256 x 512 a detect call, 5.2 G cells: the CUDA cores
// issue 64 int32 operations a clock an SM, and each cell takes several),
// latency at the mapper's call (2,048 pairs, 48 x 80, band 32, 7.9 M
// cells: too few pairs to fill the card, so each pair's dependent chain,
// a cell needing its left, upper and diagonal neighbours, sets the time).
//
// Design: the anti-diagonal across a group of G lanes, as the TPU kernel
// lays it across sublanes.  A pair belongs to G consecutive lanes of a warp
// (G a power of two <= 32; 32 / G pairs a warp); lane l keeps a strip of R
// consecutive query rows in registers (their DP column and their query
// tokens).  At step s lane l computes target column j = s - l for its
// strip, top to bottom: the cell above its first row arrives from lane
// l - 1 by __shfl_up_sync (that lane's bottom cell, computed at step s - 1),
// the diagonal is what arrived the step before, and the rest of the chain
// stays in registers.  A pair takes n + G - 1 steps; nothing on a cell's
// chain touches memory.  Each cell is max(up + gap, max(left + gap, diag +
// sub)), floored at 0 when local: the inner max leaves the chain, and the
// outer one is one DPX instruction (__viaddmax_s32, _relu when local),
// which sm_90 runs in hardware.  Query rows past m in the last strip are
// computed and kept out of the score (`pen` keeps them out of the local
// max; the global score is read from row m).
//
// A query longer than G * R rows (G = 32, R = BA_RMAX: 256) runs in
// stripes of 256 rows, one after another in the same group: the last row
// of a stripe (n ints) goes to the next through a buffer, in shared memory
// where a block's buffers fit, else in device scratch that the wrapper
// allocates (kernels/edit_distance.py plan).  Lane G - 1 writes column j
// at step j + G - 1 and lane 0 of the next stripe reads it at step j, so
// one buffer serves both: every write depends, through the shuffles, on
// the read of the same column.  No length, band or pair count is capped.
#include "common.cuh"

constexpr int BA_WARPS = 2;  // warps a block
constexpr int BA_THREADS = 32 * BA_WARPS;
constexpr int BA_RMAX = 8;   // rows a lane keeps in registers, at most
constexpr int BA_NEG = -(1 << 20);
constexpr int BA_PAD = -(1 << 30);  // keeps padded rows out of the max

// max(a + b, c), floored at 0 when RELU: one DPX instruction on sm_90
template <bool RELU>
__device__ __forceinline__ int add_max(int a, int b, int c) {
  if constexpr (RELU) return __viaddmax_s32_relu(a, b, c);
  return __viaddmax_s32(a, b, c);
}

template <int R, bool LOCAL, bool BANDED>
__global__ void __launch_bounds__(BA_THREADS)
banded_align_kernel(const int* __restrict__ q, const int* __restrict__ t,
                    int* __restrict__ out, int* __restrict__ scratch, int P,
                    int m, int n, int band, int match, int mismatch, int gap,
                    int G) {
  extern __shared__ int ba_hand[];  // a buffer of n ints per group
  const int lane = threadIdx.x % 32;
  const int l = lane % G;
  const long long pair =
      (static_cast<long long>(blockIdx.x) * BA_WARPS + threadIdx.x / 32) *
          (32 / G) + lane / G;
  const bool real = pair < P;
  // a group past the last pair steps through pair 0 and stores nothing
  const size_t p = real ? static_cast<size_t>(pair) : 0;
  const int* qp = q + p * m;
  const int* tp = t + p * n;
  const int H = G * R;  // rows a stripe
  const int stripes = m > H ? (m + H - 1) / H : 1;
  int* hand = scratch != nullptr ? scratch + p * n
                                 : ba_hand + (threadIdx.x / G) * n;
  const int agap = abs(gap);
  const int floor_v = LOCAL ? 0 : BA_NEG;
  // D[i][0] and D[0][jj] (jj >= 1), as ref.py sets them
  auto first_col = [&](int i) {
    return LOCAL ? 0 : (i * agap <= band * agap ? i * gap : BA_NEG);
  };
  auto first_row = [&](int jj) {
    return jj <= band ? (LOCAL ? 0 : gap * jj) : floor_v;
  };
  const int steps = n > 0 ? n + G - 1 : 0;
  int best = 0;
  int col[R], qr[R], pen[R];
  for (int k = 0; k < stripes; ++k) {
    const int top = k * H + l * R;  // the DP row above the lane's strip
    const bool hand_in = k > 0, hand_out = k + 1 < stripes;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = top + r + 1;
      col[r] = first_col(i);
      qr[r] = i <= m ? qp[i - 1] : 0;
      pen[r] = i <= m ? 0 : BA_PAD;
    }
    int diag = first_col(top);
    int bottom = 0;
    int tnext = n > 0 ? __ldg(tp + min(max(-l, 0), n - 1)) : 0;
    if (hand_in) __syncwarp();  // the previous stripe's buffer is written
    for (int s = 0; s < steps; ++s) {
      int up = __shfl_up_sync(0xffffffffu, bottom, 1, G);
      const int j = s - l;  // target column; DP column j + 1
      const int tj = tnext;
      tnext = __ldg(tp + min(max(j + 1, 0), n - 1));
      if (j >= 0 && j < n) {
        if (l == 0) up = hand_in ? hand[j] : first_row(j + 1);
        int u = up, d = diag;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int left = col[r];
          const int x = add_max<false>(left, gap,
                                       d + (qr[r] == tj ? match : mismatch));
          int v = add_max<LOCAL>(u, gap, x);
          if constexpr (BANDED) {
            if (abs(top + r - j) > band) v = floor_v;  // |i - (j + 1)|
          }
          if constexpr (LOCAL) best = add_max<false>(v, pen[r], best);
          d = left;
          u = v;
          col[r] = v;
        }
        bottom = col[R - 1];
        if (hand_out && l == G - 1 && real) hand[j] = bottom;
        diag = up;
      }
    }
  }
  if constexpr (LOCAL) {
    for (int o = G / 2; o > 0; o /= 2)
      best = max(best, __shfl_xor_sync(0xffffffffu, best, o, G));
    if (l == 0 && real) out[pair] = best;
  } else {
    // D[m][n]: row m of the last stripe, or the first row when m == 0
    const int rel = m - 1 - (stripes - 1) * H;
    if (m == 0) {
      if (l == 0 && real) out[pair] = first_row(n);
    } else if (l == rel / R && real) {
      int v = col[0];
#pragma unroll
      for (int r = 1; r < R; ++r)
        if (r == rel % R) v = col[r];
      out[pair] = v;
    }
  }
}

template <int R, bool LOCAL>
static int launch_r(bool banded, dim3 grid, size_t smem, cudaStream_t s,
                    const int* q, const int* t, int* out, int* scratch, int P,
                    int m, int n, int band, int match, int mismatch, int gap,
                    int G) {
  auto kernel = banded ? banded_align_kernel<R, LOCAL, true>
                       : banded_align_kernel<R, LOCAL, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, BA_THREADS, smem, s>>>(q, t, out, scratch, P, m, n, band,
                                        match, mismatch, gap, G);
  return static_cast<int>(cudaGetLastError());
}

template <bool LOCAL>
static int launch_local(int R, bool banded, dim3 grid, size_t smem,
                        cudaStream_t s, const int* q, const int* t, int* out,
                        int* scratch, int P, int m, int n, int band,
                        int match, int mismatch, int gap, int G) {
#define BA_CASE(RR)                                                         \
  case RR:                                                                  \
    return launch_r<RR, LOCAL>(banded, grid, smem, s, q, t, out, scratch, P, \
                               m, n, band, match, mismatch, gap, G);
  switch (R) {
    BA_CASE(1) BA_CASE(2) BA_CASE(3) BA_CASE(4)
    BA_CASE(5) BA_CASE(6) BA_CASE(7) BA_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BA_CASE
}

// The plan (kernels/edit_distance.py plan): G lanes a pair, R rows a lane.
// scratch: null where a query fits one stripe or the stripes' buffers fit
// the block's shared memory, else P x n ints of device memory.
extern "C" int launch_banded_align(const void* q, const void* t, void* out,
                                   void* scratch, int P, int m, int n,
                                   int band, int match, int mismatch, int gap,
                                   int local, int G, int R, void* stream) {
  if (G < 1 || G > 32 || (G & (G - 1)) || R < 1 || R > BA_RMAX || band < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = BA_WARPS * (32 / G);  // pairs a block
  const dim3 grid(static_cast<unsigned>((P + per_block - 1) / per_block));
  const bool striped = m > G * R;
  const size_t smem = striped && scratch == nullptr
                          ? static_cast<size_t>(per_block) * n * sizeof(int)
                          : 0;
  const bool banded = band < max(m, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qi = static_cast<const int*>(q);
  const int* ti = static_cast<const int*>(t);
  int* o = static_cast<int*>(out);
  int* sc = static_cast<int*>(scratch);
  return local ? launch_local<true>(R, banded, grid, smem, s, qi, ti, o, sc,
                                    P, m, n, band, match, mismatch, gap, G)
               : launch_local<false>(R, banded, grid, smem, s, qi, ti, o, sc,
                                     P, m, n, band, match, mismatch, gap, G);
}
