// Shared pieces of the two facility-location kernels (fl_divergence.cu,
// fl_stream.cu): the block shapes, the many-probe register tile and its
// hinge, the cp.async ring that stages the probes' rows, the close of a
// probe pass, the split of the served rows across blocks, and the kernel
// that sums the splits.
//
// Block shapes, all over 128 candidates:
//   - one probe (greedy gains): TX x TY threads, CPT candidates each
//     (fl_gains_rows, fl_stream_gains_pieces); fl_stream_gains_resident
//     keeps the TY row slices with 128 threads of 8 candidates
//     (fl_stream.cu).
//   - many probes (an SS round): 16 threads along candidates x 16 along
//     probes.  A thread owns 8 candidates (two runs of 4: 4 tc .. 4 tc + 3
//     and 64 + 4 tc ..) and PPT consecutive probes, so its reads of a staged
//     row are 16-byte vectors.  PPT is a template parameter from 1 to
//     kMaxPPT, picked with the number of passes by
//     repro_torch/kernels/_build.py:fl_probe_tile(r): 128, 144 and 160
//     probes fill one pass with no pad slot.
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

// One probe.
constexpr int TX = 32;         // threads along candidates
constexpr int TY = 8;          // threads along rows
constexpr int CPT = 4;         // candidates per thread
constexpr int BC = TX * CPT;   // candidates per block
constexpr int IK = 32;         // served rows per shared-memory chunk
constexpr int NT = TX * TY;    // threads per block

// Many probes.  Must match FL_PROBE_THREADS and FL_MAX_PPT in
// repro_torch/kernels/_build.py.
constexpr int kProbeThreads = 16;
constexpr int kMaxPPT = 10;
constexpr int TC = NT / kProbeThreads;  // threads along candidates
constexpr int MCPT = BC / TC;           // candidates per thread (8)
static_assert(MCPT == 8 && TC * kProbeThreads == NT, "many-probe tile");

// The staged MU chunk: ROWS served rows of a pass's kProbeThreads * PPT
// probes; a thread's PPT probes sit at tp * PS, padded to PS (a multiple of
// 4) for 16-byte reads, and a row is MROW floats (4 mod 32 words, so the
// transposing stores of MuStager spread over all banks).
template <int PPT, int ROWS>
struct ProbeTile {
  static_assert(ROWS % 16 == 0 && NT % (4 * ROWS) == 0, "MuStager's row mapping");
  static constexpr int SP = kProbeThreads * PPT;   // probe slots per pass
  static constexpr int PS = (PPT + 3) / 4 * 4;
  static constexpr int MROW = kProbeThreads * PS + 4;
  static constexpr int MWORDS = ROWS * MROW;       // one ring slot
};

// The served rows [lo, hi) of this block's split.
struct RowSpan {
  long long lo, hi;
};
__device__ __forceinline__ RowSpan row_span(long long ni) {
  const long long span = (ni + gridDim.y - 1) / gridDim.y;
  const long long lo = static_cast<long long>(blockIdx.y) * span;
  return {lo, lo + span < ni ? lo + span : ni};
}

// -- cp.async: copies to shared memory that run while the hinge runs --------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 4 bytes, or 4 zero bytes when !valid (src is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
// 16 bytes (both addresses 16-byte aligned), or zeros when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Where a thread's MU copies go (MuStager): fixed per thread, so the index
// arithmetic is done once per pass.  Element e = tid + NT t of the
// (ROWS x SP) chunk has row f = (e & 7) + 8 ((e >> 5) % (ROWS / 8)) and slot
// 4 ((e >> 5) / (ROWS / 8)) + ((e >> 3) & 3): a warp reads 8 consecutive
// rows of 4 probes (four 32-byte sectors) and stores to 32 distinct banks.
// Past the first, a thread's slots step by STRIDE.
template <int PPT, int ROWS>
struct MuStager {
  using PT = ProbeTile<PPT, ROWS>;
  static constexpr int STEPS = ROWS * PT::SP / NT;  // copies per thread
  static constexpr int STRIDE = 4 * (NT / 32) / (ROWS / 8);
  const float* mu;    // MU itself: the address of a zero fill
  const float* src;   // MU row of this thread's first probe, at its row f
  long long ni;
  int f, slot0, live;  // live: copies whose probe is below r

  __device__ __forceinline__ MuStager(const float* MU, long long ni_, int r,
                                      int p0, int tid)
      : mu(MU), ni(ni_) {
    f = (tid & 7) + 8 * ((tid >> 5) % (ROWS / 8));
    slot0 = 4 * ((tid >> 5) / (ROWS / 8)) + ((tid >> 3) & 3);
    const int p = p0 + slot0;
    src = MU + static_cast<long long>(p) * ni + f;
    live = p < r ? (r - p + STRIDE - 1) / STRIDE : 0;
  }
  // MU[p0 + slot][i0 + f] into M[f][slot / PPT * PS + slot % PPT], zero
  // past r and at rows >= hi.
  __device__ __forceinline__ void stage(float* M, long long i0, long long hi) const {
    const bool row_ok = i0 + f < hi;
    const float* s = src + i0;
#pragma unroll
    for (int t = 0; t < STEPS; ++t) {
      const int slot = slot0 + STRIDE * t;
      float* dst = M + f * PT::MROW + slot / PPT * PT::PS + slot % PPT;
      const bool ok = row_ok && t < live;
      cp_async4(dst, ok ? s : mu, ok);
      s += STRIDE * ni;
    }
  }
};

// acc[j][c] += sum_f max(S[f][cand c] - M[f][probe j], 0) over the ROWS
// staged rows, in row order.  S is (ROWS x BC), M a MuStager chunk.  Per
// row a thread reads 2 + PS / 4 16-byte vectors against 24 PPT hinge
// instructions; UNROLL rows are unrolled.  The hinge is accumulated
// directly, never as sum max(S, M) - sum M, which would cancel in float32.
template <int PPT, int ROWS, int UNROLL>
__device__ __forceinline__ void hinge_rows(const float* S, const float* M,
                                           float (&acc)[PPT][MCPT], int tc,
                                           int tp) {
  using PT = ProbeTile<PPT, ROWS>;
#pragma unroll UNROLL
  for (int f = 0; f < ROWS; ++f) {
    const float4 a = *reinterpret_cast<const float4*>(S + f * BC + 4 * tc);
    const float4 b = *reinterpret_cast<const float4*>(S + f * BC + 64 + 4 * tc);
    const float sv[MCPT] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    float mv[PT::PS];
#pragma unroll
    for (int q = 0; q < PT::PS / 4; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(M + f * PT::MROW + tp * PT::PS + 4 * q);
      mv[4 * q] = v.x;
      mv[4 * q + 1] = v.y;
      mv[4 * q + 2] = v.z;
      mv[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < PPT; ++j)
#pragma unroll
      for (int c = 0; c < MCPT; ++c) acc[j][c] += fmaxf(sv[c] - mv[j], 0.f);
  }
}

// The block-local candidate of a thread's c-th accumulator column.
__device__ __forceinline__ int cand_of(int tc, int c) {
  return (c < 4 ? 4 * tc : 64 + 4 * tc) + (c & 3);
}

// Close one probe pass.  Without a scratch buffer, fold the min over this
// pass's probes of acc - resid into best[] (per thread, then across the
// kProbeThreads threads of a candidate); with one, store the pass's partial
// sums.  Ends with a barrier, so the ring can be refilled.
template <int PPT>
__device__ __forceinline__ void close_pass(float (&acc)[PPT][MCPT], int p0, int r,
                                           const float* __restrict__ resid,
                                           float (*red)[BC], float* best,
                                           float* __restrict__ partial,
                                           long long c0, long long n_out, int tc,
                                           int tp, int tid) {
  if (partial) {
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int p = p0 + tp * PPT + j;
#pragma unroll
      for (int c = 0; c < MCPT; ++c) {
        const long long slot = c0 + cand_of(tc, c);
        if (p < r && slot < n_out)
          partial[(static_cast<long long>(blockIdx.y) * r + p) * n_out + slot] =
              acc[j][c];
      }
    }
    __syncthreads();
    return;
  }
  float m[MCPT];
#pragma unroll
  for (int c = 0; c < MCPT; ++c) m[c] = kInf;
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = p0 + tp * PPT + j;
    if (p < r) {
      const float rs = resid ? resid[p] : 0.f;
#pragma unroll
      for (int c = 0; c < MCPT; ++c) m[c] = fminf(m[c], acc[j][c] - rs);
    }
  }
#pragma unroll
  for (int c = 0; c < MCPT; ++c) red[tp][cand_of(tc, c)] = m[c];
  __syncthreads();
  for (int c = tid; c < BC; c += NT) {
    float b = best[c];
#pragma unroll
    for (int y = 0; y < kProbeThreads; ++y) b = fminf(b, red[y][c]);
    best[c] = b;
  }
  __syncthreads();
}

// Calls fn(std::integral_constant<int, PPT>{}) for 1 <= ppt <= kMaxPPT: the
// template instances the launchers have.  False for any other ppt.
template <int PPT = 1, typename Fn>
inline bool dispatch_ppt(int ppt, Fn&& fn) {
  if constexpr (PPT > kMaxPPT) {
    return false;
  } else {
    if (ppt == PPT) {
      fn(std::integral_constant<int, PPT>{});
      return true;
    }
    return dispatch_ppt<PPT + 1>(ppt, fn);
  }
}

// The checks both launchers make of the probe tile they are given.
inline bool tile_covers(int r, int ppt, int passes) {
  return ppt >= 1 && ppt <= kMaxPPT && passes >= 1 &&
         static_cast<long long>(kProbeThreads) * ppt * passes >= r;
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

// Let a kernel instance take `bytes` of dynamic shared memory (above the
// 48 KiB default); returns the error.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace fl
}  // namespace repro
