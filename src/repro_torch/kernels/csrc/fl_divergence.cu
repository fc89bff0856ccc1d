// SS divergence and greedy gains of dense facility location, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/fl_divergence.py:fl_divergence_kernel (the
// Pallas TPU kernel, body _fl_divergence_kernel) and its single-probe
// instance fl_gains_kernel.
//
// Computes, for every candidate v (all columns of sim, or the columns
// cand_idx names):
//   out[v] = min_u [ sum_i max(sim[i, v] - MU[u, i], 0) - resid[u] ]
// over the served rows i.  A pad probe carries resid = -INF, so its term is
// about +INF and never wins.  With one probe (MU = the greedy state, resid
// NULL for 0) this is the greedy gain f(v | S).
//
// sim is (ni, n) row-major, float32 or bfloat16 (upcast per element), and
// is read in place: never padded, copied or transposed.  Candidates are
// columns and the reduction runs down the rows, so a non-symmetric sim is
// handled as it is.  The hinge terms are accumulated directly: the form
// sum_i max(sim, MU) - sum_i MU would lose the small gaps between candidates
// to float32 cancellation over ni rows.
//
// What bounds it on this card:
//   - many probes (an SS round): operations.  Each (probe, candidate, row)
//     term costs three FP32 instructions (subtract, max, add); at the first
//     round of a 2^16-frame video (128 probes) that is 1.6e15 instructions
//     against one 16 GiB read of sim.
//   - one probe (a greedy step): bytes, one read of sim.
//
// What the design does about it:
//   - many probes: a block owns 128 candidates and walks the probes in
//     passes of 64.  Each of its 256 threads keeps an 8 probe x 4 candidate
//     tile of hinge sums in registers, so one shared-memory read of sim feeds
//     eight terms and one (broadcast) read of MU feeds four (fl_common.cuh).
//     sim and MU arrive in 32-row chunks through shared memory, sim read
//     along its rows (coalesced when cand_idx is absent), MU along its rows,
//     both stored with one word of padding so the inner loop is free of bank
//     conflicts.  The min over probes happens here, so no (r, n) block
//     reaches memory; sim is re-read once per pass (twice at 128 probes).
//   - one probe: no shared-memory staging.  Each thread owns four
//     consecutive columns, read as one 16-byte (float32) or 8-byte (bf16)
//     vector per row when the columns are contiguous and aligned; the eight
//     warps of a block split the rows and their sums meet in shared memory
//     in a fixed order.
//   - a small candidate buffer (later SS rounds, greedy over V') would leave
//     most SMs idle, so the wrapper splits the rows across gridDim.y blocks
//     and fl_finish adds the partial sums in a fixed order (fl_common.cuh).
//   - with cand_idx the columns are gathered in place (sim[i, cand[v]]).
//     Those reads are not coalesced; sorted candidate buffers (the SS and
//     greedy compactions are ascending) keep neighbours in shared sectors.
//   - ragged ni, n and r are masked here: padded rows and probes stage as 0,
//     whose hinge max(0 - 0, 0) adds nothing.

#include <cstdint>

#include "fl_common.cuh"

namespace {

using namespace repro::fl;
using repro::kInf;

template <typename T>
__global__ void __launch_bounds__(NT) fl_divergence_tiled(
    const T* __restrict__ sim, long long ni, long long n,
    const long long* __restrict__ cand_idx, long long n_out,
    const float* __restrict__ MU, const float* __restrict__ resid, int r,
    float* __restrict__ partial, float* __restrict__ out) {
  __shared__ float Ss[IK][BC + 1];
  __shared__ float Ms[IK][BP + 1];
  __shared__ long long cols[BC];
  __shared__ float red[TY][BC];
  __shared__ float best[BC];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const long long c0 = static_cast<long long>(blockIdx.x) * BC;
  const RowSpan rows = row_span(ni);

  for (int c = tid; c < BC; c += NT) {
    cols[c] = repro::row_of(cand_idx, c0 + c, n_out, n);
    best[c] = kInf;
  }
  __syncthreads();

  for (int p0 = 0; p0 < r; p0 += BP) {
    float acc[PPT][CPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[j][c] = 0.f;

    for (long long i0 = rows.lo; i0 < rows.hi; i0 += IK) {
      for (int e = tid; e < IK * BC; e += NT) {
        const int c = e % BC;
        const int f = e / BC;
        const long long col = cols[c];
        const long long i = i0 + f;
        Ss[f][c] = (col >= 0 && i < rows.hi) ? repro::to_f32(sim[i * n + col])
                                             : 0.f;
      }
      stage_mu(Ms, MU, ni, r, p0, i0, rows.hi, tid);
      __syncthreads();
      hinge_tile(Ss, Ms, acc, tx, ty);
      __syncthreads();
    }
    close_pass(acc, p0, r, resid, red, best, partial, c0, n_out, tx, ty, tid);
  }
  write_out(cols, best, out, partial, c0, tid);
}

// One probe: out[v] = sum_i max(sim[i, v] - mu[i], 0) - resid[0], or the
// partial sum over this block's rows.
template <typename T, bool VEC>
__global__ void __launch_bounds__(NT) fl_gains_rows(
    const T* __restrict__ sim, long long ni, long long n,
    const long long* __restrict__ cand_idx, long long n_out,
    const float* __restrict__ mu, const float* __restrict__ resid,
    float* __restrict__ partial, float* __restrict__ out) {
  __shared__ float red[TY][BC];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const long long s0 = static_cast<long long>(blockIdx.x) * BC + tx * CPT;
  const RowSpan rows = row_span(ni);

  long long col[CPT];
  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    col[c] = repro::row_of(cand_idx, s0 + c, n_out, n);
    acc[c] = 0.f;
  }

  if constexpr (VEC) {
    // Contiguous columns s0 .. s0 + 3, all valid when s0 is (n % 4 == 0).
    if (col[0] >= 0) {
#pragma unroll 4
      for (long long i = rows.lo + ty; i < rows.hi; i += TY) {
        const float m = __ldg(mu + i);
        const float4 v = repro::load4(sim + i * n + s0);
        acc[0] += fmaxf(v.x - m, 0.f);
        acc[1] += fmaxf(v.y - m, 0.f);
        acc[2] += fmaxf(v.z - m, 0.f);
        acc[3] += fmaxf(v.w - m, 0.f);
      }
    }
  } else {
#pragma unroll 4
    for (long long i = rows.lo + ty; i < rows.hi; i += TY) {
      const float m = __ldg(mu + i);
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        if (col[c] >= 0) acc[c] += fmaxf(repro::to_f32(sim[i * n + col[c]]) - m, 0.f);
    }
  }

#pragma unroll
  for (int c = 0; c < CPT; ++c) red[ty][tx * CPT + c] = acc[c];
  __syncthreads();
  const float rs = resid ? resid[0] : 0.f;
  for (int c = tid; c < BC; c += NT) {
    const long long slot = static_cast<long long>(blockIdx.x) * BC + c;
    const long long cc = repro::row_of(cand_idx, slot, n_out, n);
    if (cc == -1) continue;
    float s = 0.f;
#pragma unroll
    for (int y = 0; y < TY; ++y) s += red[y][c];
    if (partial)
      partial[static_cast<long long>(blockIdx.y) * n_out + slot] = s;
    else
      out[slot] = cc == -2 ? __int_as_float(0x7fc00000) : s - rs;
  }
}

template <typename T>
int launch(const T* sim, long long ni, long long n, const long long* cand_idx,
           long long n_out, const float* MU, const float* resid, int r,
           int splits, float* partial, float* out, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n_out + BC - 1) / BC),
                  static_cast<unsigned>(splits));
  float* part = splits > 1 ? partial : nullptr;
  if (r == 1) {
    const bool vec = cand_idx == nullptr && n % 4 == 0 &&
                     reinterpret_cast<std::uintptr_t>(sim) % (4 * sizeof(T)) == 0;
    if (vec)
      fl_gains_rows<T, true><<<grid, NT, 0, stream>>>(sim, ni, n, cand_idx, n_out,
                                                      MU, resid, part, out);
    else
      fl_gains_rows<T, false><<<grid, NT, 0, stream>>>(sim, ni, n, cand_idx, n_out,
                                                       MU, resid, part, out);
  } else {
    fl_divergence_tiled<T><<<grid, NT, 0, stream>>>(sim, ni, n, cand_idx, n_out,
                                                    MU, resid, r, part, out);
  }
  return finish(part, splits, r, n_out, cand_idx, n, resid, out, stream);
}

}  // namespace

// resid may be NULL (all zero): the greedy-gains instance.  With splits > 1
// the served rows are split across that many blocks per candidate tile, and
// partial must hold splits * r * n_out floats.
extern "C" int fl_divergence_launch(const void* sim, int sim_bf16, long long ni,
                                    long long n, const long long* cand_idx,
                                    long long n_out, const float* MU,
                                    const float* resid, int r, int splits,
                                    float* partial, float* out, void* stream) {
  if (n_out <= 0) return 0;
  if (r < 1 || splits < 1 || (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return sim_bf16
             ? launch(static_cast<const __nv_bfloat16*>(sim), ni, n, cand_idx,
                      n_out, MU, resid, r, splits, partial, out, s)
             : launch(static_cast<const float*>(sim), ni, n, cand_idx, n_out,
                      MU, resid, r, splits, partial, out, s);
}
