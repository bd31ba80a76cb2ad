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
// Bound on this card: neither bytes nor operations.  On the path (P = 2048
// pairs, m = 48, n = 80) the inputs are 1 MB and the DP 7.9 M cells, a few
// microseconds of either; what costs is the dependent chain of each DP row
// (left -> cell -> left).  Design: one thread per pair runs the row-scan DP
// of ref.py, keeping its DP row and its query in shared memory laid out
// [index][thread] (conflict-free banks), so the m x n cells cost no device
// memory traffic beyond one read of each target token.  One warp per block
// spreads the pairs over as many SMs as there are warps.
//
// The shared memory per block, (2m + 1) * 32 * 4 bytes, bounds the
// occupancy: at the pathogen panel compare (reads of m = 256 against
// 512-base windows, local) a block takes 65,664 bytes, so three blocks,
// three warps, fit on an SM, and each warp's dependent chain of cells runs
// with little to hide its latency.  Past m = 907 the row no longer fits a
// block: banded_align_scratch_kernel keeps it, and the query, in a device
// scratch laid out [index][pair] (the 32 threads of a warp touch 32
// consecutive ints a cell, one 128-byte line), which the wrapper allocates;
// the arithmetic is the same.  Laying one anti-diagonal across a warp, as
// the TPU kernel lays it across sublanes, would lift the occupancy limit;
// it is later work.
#include "common.cuh"

constexpr int BA_THREADS = 32;
constexpr int BA_NEG = -(1 << 20);

// One pair's score by the row-scan DP of ref.py: `row` and `qs` step by
// `S` ints an index (the pairs of a block, or of the launch, side by side).
template <typename Idx>
__device__ __forceinline__ int wavefront(const int* __restrict__ qp,
                                         const int* __restrict__ tp, int* row,
                                         int* qs, Idx S, int m, int n,
                                         int band, int match, int mismatch,
                                         int gap, int local) {
  const int agap = abs(gap);
  for (int i = 0; i < m; ++i) qs[i * S] = qp[i];
  for (int i = 0; i <= m; ++i)
    row[i * S] = local ? 0 : (i * agap <= band * agap ? i * gap : BA_NEG);
  const int floor_v = local ? 0 : BA_NEG;
  int best = 0;
  for (int j = 0; j < n; ++j) {
    const int tj = tp[j];
    const int first = (j + 1 <= band) ? (local ? 0 : gap * (j + 1)) : floor_v;
    int diag = row[0];
    row[0] = first;
    int left = first;
    int rmax = first;
    for (int i = 0; i < m; ++i) {
      const int up = row[(i + 1) * S];
      const int sub = (qs[i * S] == tj) ? match : mismatch;
      int v = max(max(left + gap, up + gap), diag + sub);
      if (local) v = max(v, 0);
      if (abs(i - j) > band) v = floor_v;  // |(i+1) - (j+1)| > band
      row[(i + 1) * S] = v;
      diag = up;
      left = v;
      rmax = max(rmax, v);
    }
    if (local) best = max(best, rmax);
  }
  return local ? best : row[m * S];
}

__global__ void __launch_bounds__(BA_THREADS)
banded_align_kernel(const int* __restrict__ q, const int* __restrict__ t,
                    int* __restrict__ out, int P, int m, int n, int band,
                    int match, int mismatch, int gap, int local) {
  extern __shared__ int smem[];
  const int S = blockDim.x;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  // row[i * S], i = 0..m, then qs[i * S], i = 0..m-1
  int* row = smem + threadIdx.x;
  out[p] = wavefront(q + static_cast<size_t>(p) * m,
                     t + static_cast<size_t>(p) * n, row, row + (m + 1) * S,
                     S, m, n, band, match, mismatch, gap, local);
}

// scratch: (2m + 1) x P ints, row[i][p] for i = 0..m, then qs[i][p]
__global__ void __launch_bounds__(BA_THREADS)
banded_align_scratch_kernel(const int* __restrict__ q,
                            const int* __restrict__ t, int* __restrict__ out,
                            int* __restrict__ scratch, int P, int m, int n,
                            int band, int match, int mismatch, int gap,
                            int local) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const size_t S = P;
  int* row = scratch + p;
  out[p] = wavefront(q + static_cast<size_t>(p) * m,
                     t + static_cast<size_t>(p) * n, row, row + (m + 1) * S,
                     S, m, n, band, match, mismatch, gap, local);
}

extern "C" int banded_align_smem_bytes(int m) {
  return (2 * m + 1) * BA_THREADS * static_cast<int>(sizeof(int));
}

// scratch: null for the shared-memory kernel (banded_align_smem_bytes(m)
// <= SMEM_BYTES), else (2m + 1) x P ints of device memory.
extern "C" int launch_banded_align(const void* q, const void* t, void* out,
                                   void* scratch, int P, int m, int n,
                                   int band, int match, int mismatch, int gap,
                                   int local, void* stream) {
  const int blocks = (P + BA_THREADS - 1) / BA_THREADS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qi = static_cast<const int*>(q);
  const int* ti = static_cast<const int*>(t);
  int* o = static_cast<int*>(out);
  if (scratch != nullptr) {
    banded_align_scratch_kernel<<<blocks, BA_THREADS, 0, s>>>(
        qi, ti, o, static_cast<int*>(scratch), P, m, n, band, match, mismatch,
        gap, local);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = banded_align_smem_bytes(m);
  cudaError_t err = allow_smem(banded_align_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  banded_align_kernel<<<blocks, BA_THREADS, smem, s>>>(
      qi, ti, o, P, m, n, band, match, mismatch, gap, local);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM at query length m (the occupancy the shared
// memory allows): written to *blocks.
extern "C" int banded_align_blocks_per_sm(int m, int* blocks) {
  const size_t smem = banded_align_smem_bytes(m);
  cudaError_t err = allow_smem(banded_align_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, banded_align_kernel, BA_THREADS, smem));
}
