// SS divergence and greedy gains of matrix-free facility location, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fl_stream.py:fl_stream_divergence_kernel (the
// Pallas TPU kernel, body _fl_stream_kernel) and its single-probe instance
// fl_stream_gains_kernel.
//
// Computes, for every candidate v (all rows of Xc, or the rows cand_idx
// names):
//   out[v] = min_u [ sum_i max(sim[i, v] - MU[u, i], 0) - resid[u] ],
//   sim[i, v] = max(Xs[i] . Xc[v], 0),
// over the served rows i of Xs.  The (ni, n) similarity never exists: each
// (32-row x 128-candidate) tile of it is formed here, consumed by the hinge
// and dropped.  A pad probe carries resid = -INF; with one probe (MU = the
// greedy state, resid NULL for 0) this is the greedy gain f(v | S).
//
// The dot products are IEEE float32 FFMA on the CUDA cores: no TF32 and no
// tensor cores, since a coarser similarity would change which candidates
// survive SS.  Xs and Xc are float32 (ni, d) and (n, d), read in place for
// any d (in chunks of 16 features, zero-filled past d), never padded or
// copied; cand_idx gathers rows of Xc in place.
//
// What bounds it on this card: operations.  Each (probe, candidate, row)
// term costs three FP32 instructions (subtract, max, add) and each
// (candidate, row) pair d FFMAs and a max; at the first round of a 2^18-row
// embedding set (144 probes, d = 16) that is 3.0e16 instructions, against
// inputs of a few MiB.  With one probe the d FFMAs of the similarity
// dominate.
//
// What the design does about it: the structure of fl_divergence.cu.  A
// block owns 128 candidates and walks the probes in passes of 64.  For each
// chunk of 32 served rows its 256 threads first form the similarity tile,
// each thread a 4-row x 4-candidate register tile of dot products over d
// (features staged through shared memory, served rows read as broadcasts),
// and store its relu in shared memory.  Then each thread runs the hinge on
// an 8-probe x 4-candidate register tile (fl_common.cuh), as in the dense
// kernel, and the min over probes closes each pass.  The similarity is
// recomputed once per pass: d FFMAs against 3 x 64 hinge instructions per
// element.  With one probe the threads keep their dot tile in registers and
// apply the hinge there; the eight row slices of a candidate are summed in a
// fixed order.  A small candidate buffer splits the served rows across
// blocks, as in the dense kernel.

#include "fl_common.cuh"

namespace {

using namespace repro::fl;
using repro::kInf;

constexpr int RPT = IK / TY;    // served rows per thread in the dot tile
constexpr int DK = 16;          // features per shared-memory chunk

template <bool SINGLE>
__global__ void __launch_bounds__(NT) fl_stream_kernel(
    const float* __restrict__ Xs, long long ni, int d,
    const float* __restrict__ Xc, long long n_rows,
    const long long* __restrict__ cand_idx, long long n_out,
    const float* __restrict__ MU, const float* __restrict__ resid, int r,
    float* __restrict__ partial, float* __restrict__ out) {
  __shared__ float Ss[IK][BC + 1];     // relu(Xs . Xc^T) tile
  __shared__ float Ms[IK][BP + 1];     // MU tile, transposed
  __shared__ float Xss[IK][DK + 1];    // served rows, one feature chunk
  __shared__ float Xcs[DK][BC + 1];    // candidate rows, transposed
  __shared__ long long rows[BC];
  __shared__ float red[TY][BC];
  __shared__ float best[BC];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const long long c0 = static_cast<long long>(blockIdx.x) * BC;
  const RowSpan span = row_span(ni);

  for (int c = tid; c < BC; c += NT) {
    rows[c] = repro::row_of(cand_idx, c0 + c, n_out, n_rows);
    best[c] = kInf;
  }
  __syncthreads();

  for (int p0 = 0; p0 < r; p0 += BP) {
    float acc[PPT][CPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[j][c] = 0.f;

    for (long long i0 = span.lo; i0 < span.hi; i0 += IK) {
      // (1) the similarity tile: rows i0 + ty + TY * j, candidates tx + TX * c.
      float dot[RPT][CPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j)
#pragma unroll
        for (int c = 0; c < CPT; ++c) dot[j][c] = 0.f;
      for (int d0 = 0; d0 < d; d0 += DK) {
        for (int e = tid; e < IK * DK; e += NT) {
          const int f = e / DK;
          const int k = e % DK;
          const long long i = i0 + f;
          Xss[f][k] = (i < span.hi && d0 + k < d) ? Xs[i * d + d0 + k] : 0.f;
        }
        for (int e = tid; e < BC * DK; e += NT) {
          const int c = e / DK;
          const int k = e % DK;
          const long long row = rows[c];
          Xcs[k][c] = (row >= 0 && d0 + k < d) ? Xc[row * d + d0 + k] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < DK; ++k) {
          float xs[RPT], xc[CPT];
#pragma unroll
          for (int j = 0; j < RPT; ++j) xs[j] = Xss[ty + TY * j][k];
#pragma unroll
          for (int c = 0; c < CPT; ++c) xc[c] = Xcs[k][tx + TX * c];
#pragma unroll
          for (int j = 0; j < RPT; ++j)
#pragma unroll
            for (int c = 0; c < CPT; ++c) dot[j][c] = fmaf(xs[j], xc[c], dot[j][c]);
        }
        __syncthreads();
      }

      if constexpr (SINGLE) {
        // (2') one probe: the hinge on the thread's own rows, in registers.
        // Rows past the split have sim = relu(0) = 0 and mu = 0: they add
        // nothing.
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const long long i = i0 + ty + TY * j;
          const float m = i < span.hi ? __ldg(MU + i) : 0.f;
#pragma unroll
          for (int c = 0; c < CPT; ++c)
            acc[0][c] += fmaxf(fmaxf(dot[j][c], 0.f) - m, 0.f);
        }
      } else {
        // (2) many probes: stage the tile and MU, then the register-tiled
        // hinge of fl_divergence.cu.
#pragma unroll
        for (int j = 0; j < RPT; ++j)
#pragma unroll
          for (int c = 0; c < CPT; ++c)
            Ss[ty + TY * j][tx + TX * c] = fmaxf(dot[j][c], 0.f);
        stage_mu(Ms, MU, ni, r, p0, i0, span.hi, tid);
        __syncthreads();
        hinge_tile(Ss, Ms, acc, tx, ty);
        __syncthreads();
      }
    }

    if constexpr (SINGLE) {
      // Sum the TY row slices of each candidate, in a fixed order.
#pragma unroll
      for (int c = 0; c < CPT; ++c) red[ty][tx + TX * c] = acc[0][c];
      __syncthreads();
      const float rs = resid ? resid[0] : 0.f;
      for (int c = tid; c < BC; c += NT) {
        float s = 0.f;
#pragma unroll
        for (int y = 0; y < TY; ++y) s += red[y][c];
        if (partial && c0 + c < n_out)
          partial[static_cast<long long>(blockIdx.y) * n_out + c0 + c] = s;
        best[c] = s - rs;
      }
      __syncthreads();
    } else {
      close_pass(acc, p0, r, resid, red, best, partial, c0, n_out, tx, ty, tid);
    }
  }
  write_out(rows, best, out, partial, c0, tid);
}

}  // namespace

// Xc is the (n_rows, d) candidate matrix (the served rows Xs themselves for
// the global objective); resid may be NULL (all zero): the greedy instance.
// With splits > 1 the served rows are split across that many blocks per
// candidate tile, and partial must hold splits * r * n_out floats.
extern "C" int fl_stream_launch(const float* Xs, long long ni, int d,
                                const float* Xc, long long n_rows,
                                const long long* cand_idx, long long n_out,
                                const float* MU, const float* resid, int r,
                                int splits, float* partial, float* out,
                                void* stream) {
  if (n_out <= 0) return 0;
  if (r < 1 || d < 1 || splits < 1 || (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n_out + BC - 1) / BC),
                  static_cast<unsigned>(splits));
  const auto s = static_cast<cudaStream_t>(stream);
  float* part = splits > 1 ? partial : nullptr;
  if (r == 1)
    fl_stream_kernel<true><<<grid, NT, 0, s>>>(Xs, ni, d, Xc, n_rows, cand_idx,
                                               n_out, MU, resid, r, part, out);
  else
    fl_stream_kernel<false><<<grid, NT, 0, s>>>(Xs, ni, d, Xc, n_rows, cand_idx,
                                                n_out, MU, resid, r, part, out);
  return finish(part, splits, r, n_out, cand_idx, n_rows, resid, out, s);
}
