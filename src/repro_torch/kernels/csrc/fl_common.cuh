// Shared pieces of the two facility-location kernels (fl_divergence.cu,
// fl_stream.cu): the block shape, the register-tiled hinge over a staged
// (rows x candidates) tile, the close of a probe pass, the split of the
// served rows across blocks, and the kernel that sums the splits.
//
// Row splits: a block walks all served rows of its 128 candidates, so a
// small candidate buffer (the later SS rounds, greedy over V') gives a grid
// of a few blocks on a 132-SM card.  The wrapper then splits the rows across
// gridDim.y blocks; each stores its partial hinge sums in a scratch buffer
// [split][probe][slot] and fl_finish adds the splits in a fixed order (no
// atomics: the result does not depend on scheduling) and takes the min over
// probes.
#pragma once

#include "common.cuh"

namespace repro {
namespace fl {

constexpr int TX = 32;         // threads along candidates
constexpr int TY = 8;          // threads along probes (or rows, one probe)
constexpr int CPT = 4;         // candidates per thread
constexpr int PPT = 8;         // probes per thread
constexpr int BC = TX * CPT;   // candidates per block
constexpr int BP = TY * PPT;   // probes per pass
constexpr int IK = 32;         // served rows per shared-memory chunk
constexpr int NT = TX * TY;    // threads per block

// The served rows [lo, hi) of this block's split.
struct RowSpan {
  long long lo, hi;
};
__device__ __forceinline__ RowSpan row_span(long long ni) {
  const long long span = (ni + gridDim.y - 1) / gridDim.y;
  const long long lo = static_cast<long long>(blockIdx.y) * span;
  return {lo, lo + span < ni ? lo + span : ni};
}

// acc[j][c] += sum_f max(S[f][tx + TX c] - M[f][ty + TY j], 0) over the IK
// staged rows: one shared read of S feeds PPT terms, one (broadcast) read of
// M feeds CPT.  The hinge is accumulated directly, never as
// sum max(S, M) - sum M, which would cancel in float32.
__device__ __forceinline__ void hinge_tile(float (*S)[BC + 1], float (*M)[BP + 1],
                                           float (&acc)[PPT][CPT], int tx,
                                           int ty) {
#pragma unroll 8
  for (int f = 0; f < IK; ++f) {
    float sv[CPT], mv[PPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) sv[c] = S[f][tx + TX * c];
#pragma unroll
    for (int j = 0; j < PPT; ++j) mv[j] = M[f][ty + TY * j];
#pragma unroll
    for (int j = 0; j < PPT; ++j)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[j][c] += fmaxf(sv[c] - mv[j], 0.f);
  }
}

// Stage MU[p0 .. p0 + BP, i0 .. i0 + IK] transposed into M (zeros outside r
// and below hi): read along MU's rows, stored with one word of padding.
__device__ __forceinline__ void stage_mu(float (*M)[BP + 1],
                                         const float* __restrict__ MU,
                                         long long ni, int r, int p0,
                                         long long i0, long long hi, int tid) {
  for (int e = tid; e < IK * BP; e += NT) {
    const int f = e % IK;
    const int p = p0 + e / IK;
    const long long i = i0 + f;
    M[f][e / IK] = (p < r && i < hi) ? MU[static_cast<long long>(p) * ni + i] : 0.f;
  }
}

// Close one probe pass.  Without a scratch buffer, fold the min over this
// pass's probes of acc - resid into best[] (per thread, then across the TY
// threads of a candidate); with one, store the pass's partial sums.
__device__ __forceinline__ void close_pass(float (&acc)[PPT][CPT], int p0,
                                           int r, const float* __restrict__ resid,
                                           float (*red)[BC], float* best,
                                           float* __restrict__ partial,
                                           long long c0, long long n_out, int tx,
                                           int ty, int tid) {
  if (partial) {
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int p = p0 + ty + TY * j;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const long long slot = c0 + tx + TX * c;
        if (p < r && slot < n_out)
          partial[(static_cast<long long>(blockIdx.y) * r + p) * n_out + slot] =
              acc[j][c];
      }
    }
    return;
  }
  float m[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) m[c] = kInf;
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = p0 + ty + TY * j;
    if (p < r) {
      const float rs = resid ? resid[p] : 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) m[c] = fminf(m[c], acc[j][c] - rs);
    }
  }
#pragma unroll
  for (int c = 0; c < CPT; ++c) red[ty][tx + TX * c] = m[c];
  __syncthreads();
  for (int c = tid; c < BC; c += NT) {
    float b = best[c];
#pragma unroll
    for (int y = 0; y < TY; ++y) b = fminf(b, red[y][c]);
    best[c] = b;
  }
  __syncthreads();
}

// The block's results: best[] for its candidates (NaN for a cand_idx entry
// outside the candidates), unless the rows were split.
__device__ __forceinline__ void write_out(const long long* cand, const float* best,
                                          float* __restrict__ out,
                                          const float* partial, long long c0,
                                          int tid) {
  if (partial) return;
  for (int c = tid; c < BC; c += NT) {
    const long long col = cand[c];
    if (col != -1) out[c0 + c] = col == -2 ? __int_as_float(0x7fc00000) : best[c];
  }
}

// out[slot] = min_p (sum over splits of partial[split][p][slot] - resid[p]).
// Static: each source that includes this header has its own copy.
static __global__ void fl_finish(const float* __restrict__ partial, int splits, int r,
                          long long n_out, const long long* __restrict__ cand_idx,
                          long long n_cand, const float* __restrict__ resid,
                          float* __restrict__ out) {
  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (slot >= n_out) return;
  if (row_of(cand_idx, slot, n_out, n_cand) == -2) {
    out[slot] = __int_as_float(0x7fc00000);
    return;
  }
  float best = kInf;
  for (int p = 0; p < r; ++p) {
    float s = 0.f;
    for (int y = 0; y < splits; ++y)
      s += partial[(static_cast<long long>(y) * r + p) * n_out + slot];
    best = fminf(best, s - (resid ? resid[p] : 0.f));
  }
  out[slot] = best;
}

// Launch fl_finish when the rows were split; returns the launch error.
static int finish(const float* partial, int splits, int r, long long n_out,
           const long long* cand_idx, long long n_cand, const float* resid,
           float* out, cudaStream_t stream) {
  if (splits > 1) {
    const unsigned blocks = static_cast<unsigned>((n_out + 255) / 256);
    fl_finish<<<blocks, 256, 0, stream>>>(partial, splits, r, n_out, cand_idx,
                                          n_cand, resid, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fl
}  // namespace repro
