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
// (64-row x 128-candidate) tile of it is formed here, consumed by the hinge
// and dropped.  A pad probe carries resid = -INF; with one probe (MU = the
// greedy state, resid NULL for 0) this is the greedy gain f(v | S).
//
// The dot products are IEEE float32 FFMA on the CUDA cores, summed over the
// features in order: no TF32 and no tensor cores, since a coarser
// similarity would change which candidates survive SS.  Xs and Xc are
// float32 (ni, d) and (n, d), read in place for any d (in pieces of 16
// features, zero-filled past d), never padded or copied; cand_idx gathers
// rows of Xc in place.
//
// What bounds it on this card: operations.  Each (probe, candidate, row)
// term costs three FP32 instructions (subtract, max, add) and each
// (candidate, row) pair d FFMAs and a max; at the first round of a 2^18-row
// embedding set (144 probes, d = 16) that is 3.0e16 instructions, against
// inputs of a few MiB.  With one probe (greedy) the d FFMAs of the
// similarity dominate: at d = 16 a pair is 16 FFMAs and three hinge
// instructions, 2^36 pairs at full width, and every other instruction a
// pair issues (loads, staging, loop and index work) costs as much as an
// FFMA, since a scheduler issues one warp instruction a clock either way.
//
// What the design does about it (many probes, an SS round):
//   - one pass over the probes where it fits: fl_probe_tile(r)
//     (kernels/_build.py) sets PPT, the probes per thread, and the passes;
//     144 probes run as 16 threads x 9 in one pass.  Fixed 64-probe
//     passes would compute 192 slots for 144 probes and form every
//     similarity tile three times.
//   - a block owns 128 candidates.  Per 64-row chunk its 256 threads form
//     the similarity tile, each a 4-row x 8-candidate register tile of dot
//     products (d FFMAs each, against 3 x 144 hinge instructions), store its
//     relu in shared memory, and then run the hinge on a PPT probe x 8
//     candidate register tile (fl_common.cuh): 4 or 5 16-byte shared loads a
//     row against 24 PPT hinge instructions.  Two barriers a chunk (tile
//     formed, tile consumed) are spread over 64 rows.
//   - the chunk's MU rows (transposed on the way) and, for d <= 16, its
//     served rows come through a two-slot cp.async ring: chunk k + 1's copies
//     are in flight while chunk k's tiles are formed and consumed.  For
//     d <= 16 the block's candidate rows are staged once and stay in shared
//     memory; a wider d stages each 16-feature piece of both per chunk.
//   - one block of 8 warps per SM, up to 255 registers a thread (ptxas
//     keeps one word on the stack at 144 probes).  Two blocks at 128
//     registers spilled and ran slower on an H100, as did 32-row chunks.
//   - a small candidate buffer splits the served rows across blocks, as in
//     the dense kernel.
//
// What the design does about it (one probe, d <= 16:
// fl_stream_gains_resident):
//   - each block's 128 candidate rows live in registers for the whole
//     launch, 8 a thread x 16 features (128 registers), loaded once: no
//     shared-memory read of a candidate in the loop.  Eight candidates, not
//     four: a shared load returns 128 bytes a clock to an SM's registers, so
//     a 16-byte row load of every thread takes 4 clocks of that path, and
//     with 4 candidates a thread the row loads took as long as the FFMAs
//     (the kernel ran slower on an H100).  So a block is 128 threads: 16
//     along candidates x the 8 row slices.
//   - the served rows come in 128-row chunks through a two-slot cp.async
//     ring, one barrier a chunk.  A half-warp shares a row, so a row costs a
//     thread four 16-byte shared loads and one of its m against 128 FFMAs
//     and 24 hinge instructions: about 20 instructions a pair against the
//     bound's 16.
//   - the hinge max(max(dot, 0) - m, 0) runs as max(dot - m, max(-m, 0)),
//     exactly equal (rounding is monotone), with max(-m, 0) once a row.
//   - two blocks an SM (184 registers a thread, no spills); each thread's 8
//     independent dot chains cover the FFMA latency.  Timed in turns on an
//     H100 and dropped, none clearly faster: 1 or 3 blocks an SM, unrolling
//     1 or 4 rows, and loading row t + 1 while row t runs.
//   - the sums keep the order of the first design: thread slice ty owns
//     the rows = ty (mod 8) of its split, in increasing order, each dot runs
//     over the features in order, and the eight slices of a candidate meet
//     in a fixed order, so the gains are bitwise those of that design and
//     no greedy tie can flip.
// A wider d (fl_stream_gains_pieces, not on a main path) stages a 16-feature
// piece of the chunk's rows and of the candidates in shared memory per
// 32-row chunk, with a 4-row x 4-candidate dot tile a thread: two barriers
// and 8 scalar shared loads for 16 FFMAs per feature, which bound it.

#include "fl_common.cuh"

namespace {

using namespace repro::fl;
using repro::kInf;

constexpr int RPT = IK / TY;    // served rows per thread in the one-probe dot tile (d > DK)
constexpr int DK = 16;          // features per shared-memory piece
// One probe, d <= DK (fl_stream_gains_resident).
constexpr int GK = 128;         // served rows per staged chunk
constexpr int GNT = 128;        // threads per block
constexpr int GLX = GNT / TY;   // threads along candidates in a row slice
constexpr int GCPT = BC / GLX;  // candidates per thread (8)
constexpr int GAINS_BLOCKS = 2;  // blocks per SM: at most 255 registers a thread
constexpr int XROW = DK + 1;    // a staged served row, one word of padding
constexpr int MIK = 64;          // served rows per staged chunk (many probes)
constexpr int HINGE_UNROLL = 4;  // rows of the hinge loop unrolled
constexpr int RJ = MIK / kProbeThreads;  // rows per thread in the many-probe dot tile

// Many probes, PPT per thread, `passes` passes of kProbeThreads * PPT.
template <int PPT>
__global__ void __launch_bounds__(NT, 1) fl_stream_tiled(
    const float* __restrict__ Xs, long long ni, int d,
    const float* __restrict__ Xc, long long n_rows,
    const long long* __restrict__ cand_idx, long long n_out,
    const float* __restrict__ MU, const float* __restrict__ resid, int r,
    int passes, float* __restrict__ partial, float* __restrict__ out) {
  using PT = ProbeTile<PPT, MIK>;
  constexpr int SLOT = PT::MWORDS + MIK * XROW;   // M, then the served rows
  static_assert(SLOT % 4 == 0, "ring slots stay 16-byte aligned");
  extern __shared__ float4 dyn[];
  float* ring = reinterpret_cast<float*>(dyn);  // two slots
  float* S = ring + 2 * SLOT;                   // [MIK][BC] relu(Xs . Xc^T)
  float* Xcs = S + MIK * BC;                     // [DK][BC] candidate rows^T
  __shared__ long long rows[BC];
  __shared__ float red[kProbeThreads][BC];
  __shared__ float best[BC];

  const int tid = threadIdx.x;
  const int tc = tid % TC;
  const int tp = tid / TC;
  const long long c0 = static_cast<long long>(blockIdx.x) * BC;
  const RowSpan span = row_span(ni);
  const bool resident = d <= DK;

  for (int c = tid; c < BC; c += NT) {
    rows[c] = repro::row_of(cand_idx, c0 + c, n_out, n_rows);
    best[c] = kInf;
  }
  __syncthreads();

  // Features d0 .. d0 + DK of the candidate rows into Xcs.
  auto stage_xc = [&](int d0) {
    for (int e = tid; e < BC * DK; e += NT) {
      const int c = e % BC;
      const int k = e / BC;
      const long long row = rows[c];
      Xcs[k * BC + c] = (row >= 0 && d0 + k < d) ? Xc[row * d + d0 + k] : 0.f;
    }
  };
  // The chunk's served rows (d <= DK): a thread copies feature xk of rows
  // xf and xf + NT / DK.
  const int xk = tid % DK;
  const int xf = tid / DK;
  const float* xsrc = Xs + static_cast<long long>(xf) * d + xk;
  auto stage_xs_async = [&](float* X, long long i0) {
    const float* src = xsrc + i0 * d;
#pragma unroll
    for (int f = xf; f < MIK; f += NT / DK, src += static_cast<long long>(NT / DK) * d) {
      const bool ok = i0 + f < span.hi && xk < d;
      cp_async4(X + f * XROW + xk, ok ? src : Xs, ok);
    }
  };
  auto stage_xs_sync = [&](float* X, long long i0, int d0) {
    for (int e = tid; e < MIK * DK; e += NT) {
      const int f = e / DK;
      const int k = e % DK;
      const long long i = i0 + f;
      X[f * XROW + k] = (i < span.hi && d0 + k < d) ? Xs[i * d + d0 + k] : 0.f;
    }
  };

  if (resident) stage_xc(0);   // seen by all threads after the first barrier

  const long long chunks = span.hi > span.lo ? (span.hi - span.lo + MIK - 1) / MIK : 0;
  for (int pass = 0; pass < passes; ++pass) {
    const int p0 = pass * PT::SP;
    const MuStager<PPT, MIK> mus(MU, ni, r, p0, tid);
    float acc[PPT][MCPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j)
#pragma unroll
      for (int c = 0; c < MCPT; ++c) acc[j][c] = 0.f;

    if (chunks > 0) {
      mus.stage(ring, span.lo, span.hi);
      if (resident) stage_xs_async(ring + PT::MWORDS, span.lo);
    }
    cp_async_commit();
    for (long long k = 0; k < chunks; ++k) {
      // Chunk k has landed, and every thread is done with chunk k - 1,
      // whose slot now takes chunk k + 1, and with the tile S.
      cp_async_wait_all();
      __syncthreads();
      const long long i0 = span.lo + k * MIK;
      if (k + 1 < chunks) {
        float* next = ring + ((k + 1) & 1) * SLOT;
        mus.stage(next, i0 + MIK, span.hi);
        if (resident) stage_xs_async(next + PT::MWORDS, i0 + MIK);
        cp_async_commit();
      }
      float* cur = ring + (k & 1) * SLOT;
      float* X = cur + PT::MWORDS;

      // (1) the similarity tile: rows tp + 16 j, the thread's 8 candidates,
      // each dot summed over the features in order.
      float dot[RJ][MCPT];
#pragma unroll
      for (int j = 0; j < RJ; ++j)
#pragma unroll
        for (int c = 0; c < MCPT; ++c) dot[j][c] = 0.f;
      for (int d0 = 0; d0 < d; d0 += DK) {
        if (!resident) {
          if (d0 > 0) __syncthreads();
          stage_xs_sync(X, i0, d0);
          stage_xc(d0);
          __syncthreads();
        }
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
          float xs[RJ];
#pragma unroll
          for (int j = 0; j < RJ; ++j) xs[j] = X[(tp + kProbeThreads * j) * XROW + kk];
          const float4 a = *reinterpret_cast<const float4*>(Xcs + kk * BC + 4 * tc);
          const float4 b = *reinterpret_cast<const float4*>(Xcs + kk * BC + 64 + 4 * tc);
          const float xc[MCPT] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int j = 0; j < RJ; ++j)
#pragma unroll
            for (int c = 0; c < MCPT; ++c) dot[j][c] = fmaf(xs[j], xc[c], dot[j][c]);
        }
      }
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        float* Srow = S + (tp + kProbeThreads * j) * BC;
        *reinterpret_cast<float4*>(Srow + 4 * tc) =
            make_float4(fmaxf(dot[j][0], 0.f), fmaxf(dot[j][1], 0.f),
                        fmaxf(dot[j][2], 0.f), fmaxf(dot[j][3], 0.f));
        *reinterpret_cast<float4*>(Srow + 64 + 4 * tc) =
            make_float4(fmaxf(dot[j][4], 0.f), fmaxf(dot[j][5], 0.f),
                        fmaxf(dot[j][6], 0.f), fmaxf(dot[j][7], 0.f));
      }
      __syncthreads();
      // (2) the hinge over the tile and the chunk's MU rows.
      hinge_rows<PPT, MIK, HINGE_UNROLL>(S, cur, acc, tc, tp);
    }
    close_pass<PPT>(acc, p0, r, resid, red, best, partial, c0, n_out, tc, tp, tid);
  }
  write_out(rows, best, out, partial, c0, tid);
}

// The close of the one-probe kernels: the TY row slices of each candidate
// summed in a fixed order (y = 0 .. TY - 1), into the block's partial sums
// or its outputs.  acc[c] is the thread's sum over slice ty for candidate
// lx + LX c; THREADS threads share the work.
template <int C, int LX, int THREADS>
__device__ __forceinline__ void close_gains(const float (&acc)[C], const long long* rows,
                                            float (*red)[BC], float* best,
                                            const float* __restrict__ resid,
                                            float* __restrict__ partial,
                                            float* __restrict__ out, long long c0,
                                            long long n_out, int lx, int ty, int tid) {
  static_assert(C * LX == BC && THREADS >= BC, "one slice covers the block");
#pragma unroll
  for (int c = 0; c < C; ++c) red[ty][lx + LX * c] = acc[c];
  __syncthreads();
  const float rs = resid ? resid[0] : 0.f;
  if (tid < BC) {
    const int c = tid;
    float s = 0.f;
#pragma unroll
    for (int y = 0; y < TY; ++y) s += red[y][c];
    if (partial && c0 + c < n_out)
      partial[static_cast<long long>(blockIdx.y) * n_out + c0 + c] = s;
    best[c] = s - rs;
  }
  __syncthreads();
  write_out(rows, best, out, partial, c0, tid);
}

// Row f of a staged chunk (GK rows of DK features, then their m) into
// registers.
__device__ __forceinline__ void load_row(const float* X, int f, float (&x)[DK], float& m) {
#pragma unroll
  for (int q = 0; q < DK / 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(X + f * DK + 4 * q);
    x[4 * q] = v.x;
    x[4 * q + 1] = v.y;
    x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
  m = X[GK * DK + f];
}

// One served row against the thread's resident candidates: each dot over
// the features in order, then acc[c] += max(dot - m, max(-m, 0)).
__device__ __forceinline__ void gains_row(const float (&x)[DK], float m,
                                          const float (&xc)[GCPT][DK],
                                          float (&acc)[GCPT]) {
  const float floor_m = fmaxf(-m, 0.f);
  float dot[GCPT];
#pragma unroll
  for (int c = 0; c < GCPT; ++c) dot[c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DK; ++kk)
#pragma unroll
    for (int c = 0; c < GCPT; ++c) dot[c] = fmaf(x[kk], xc[c][kk], dot[c]);
#pragma unroll
  for (int c = 0; c < GCPT; ++c) acc[c] += fmaxf(dot[c] - m, floor_m);
}

// One probe, d <= DK (the greedy gains, or their partial sums over this
// block's rows).  A block of GNT = 128 threads: thread (lx, ty), lx < GLX,
// keeps candidates lx + GLX c (c < GCPT = 8) in registers for the whole
// launch and owns the served rows = ty (mod TY) of its split, in increasing
// order; the chunk's rows arrive through a two-slot cp.async ring,
// zero-filled past d and past the split.
//
// Per row a thread reads the row from shared memory (four 16-byte loads;
// a warp reads two rows, one per half) and its m, then runs GCPT dot
// products of DK FFMAs and the hinge (gains_row).
__global__ void __launch_bounds__(GNT, GAINS_BLOCKS) fl_stream_gains_resident(
    const float* __restrict__ Xs, long long ni, int d,
    const float* __restrict__ Xc, long long n_rows,
    const long long* __restrict__ cand_idx, long long n_out,
    const float* __restrict__ MU, const float* __restrict__ resid,
    float* __restrict__ partial, float* __restrict__ out) {
  constexpr int SLOT = GK * DK + GK;            // the rows, then their m
  __shared__ __align__(16) float ring[2 * SLOT];
  __shared__ long long rows[BC];
  __shared__ float red[TY][BC];
  __shared__ float best[BC];

  const int tid = threadIdx.x;
  const int lx = tid % GLX;
  const int ty = tid / GLX;
  const long long c0 = static_cast<long long>(blockIdx.x) * BC;
  const RowSpan span = row_span(ni);

  if (tid < BC) {
    rows[tid] = repro::row_of(cand_idx, c0 + tid, n_out, n_rows);
    best[tid] = kInf;
  }
  __syncthreads();

  float xc[GCPT][DK];
#pragma unroll
  for (int c = 0; c < GCPT; ++c) {
    const long long row = rows[lx + GLX * c];
#pragma unroll
    for (int k = 0; k < DK; ++k)
      xc[c][k] = (row >= 0 && k < d) ? __ldg(Xc + row * d + k) : 0.f;
  }

  // A thread copies feature xk of chunk rows xf, xf + GNT / DK, ..., and
  // the m of chunk row tid.
  const int xk = tid % DK;
  const int xf = tid / DK;
  auto stage = [&](float* X, long long i0) {
    const float* src = Xs + (i0 + xf) * d + xk;
#pragma unroll
    for (int f = xf; f < GK; f += GNT / DK, src += static_cast<long long>(GNT / DK) * d) {
      const bool ok = i0 + f < span.hi && xk < d;
      cp_async4(X + f * DK + xk, ok ? src : Xs, ok);
    }
    const bool ok = i0 + tid < span.hi;
    cp_async4(X + GK * DK + tid, ok ? MU + i0 + tid : MU, ok);
  };

  float acc[GCPT];
#pragma unroll
  for (int c = 0; c < GCPT; ++c) acc[c] = 0.f;
  const long long chunks = span.hi > span.lo ? (span.hi - span.lo + GK - 1) / GK : 0;
  if (chunks > 0) stage(ring, span.lo);
  cp_async_commit();
  for (long long k = 0; k < chunks; ++k) {
    // Chunk k has landed, and every thread is done with chunk k - 1, whose
    // slot now takes chunk k + 1.
    cp_async_wait_all();
    __syncthreads();
    if (k + 1 < chunks) {
      stage(ring + ((k + 1) & 1) * SLOT, span.lo + (k + 1) * GK);
      cp_async_commit();
    }
    const float* X = ring + (k & 1) * SLOT;
    // The thread's rows of the chunk, ty + TY t, in order.
#pragma unroll 2
    for (int t = 0; t < GK / TY; ++t) {
      float x[DK], m;
      load_row(X, ty + TY * t, x, m);
      gains_row(x, m, xc, acc);
    }
  }
  close_gains<GCPT, GLX, GNT>(acc, rows, red, best, resid, partial, out, c0, n_out,
                              lx, ty, tid);
}

// One probe, d > DK: the features in pieces of DK, both sides staged per
// piece and chunk of IK rows (not on a main path).  Thread (tx, ty) owns
// candidates tx + TX c and row slice ty, summed in the resident kernel's
// order.
__global__ void __launch_bounds__(NT) fl_stream_gains_pieces(
    const float* __restrict__ Xs, long long ni, int d,
    const float* __restrict__ Xc, long long n_rows,
    const long long* __restrict__ cand_idx, long long n_out,
    const float* __restrict__ MU, const float* __restrict__ resid,
    float* __restrict__ partial, float* __restrict__ out) {
  __shared__ float Xss[IK][DK + 1];    // served rows, one feature piece
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

  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.f;
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
        float xs[RPT], xv[CPT];
#pragma unroll
        for (int j = 0; j < RPT; ++j) xs[j] = Xss[ty + TY * j][k];
#pragma unroll
        for (int c = 0; c < CPT; ++c) xv[c] = Xcs[k][tx + TX * c];
#pragma unroll
        for (int j = 0; j < RPT; ++j)
#pragma unroll
          for (int c = 0; c < CPT; ++c) dot[j][c] = fmaf(xs[j], xv[c], dot[j][c]);
      }
      __syncthreads();
    }

    // (2) the hinge on the thread's own rows, in registers.  Rows past the
    // split have sim = relu(0) = 0 and mu = 0: they add nothing.
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const long long i = i0 + ty + TY * j;
      const float m = i < span.hi ? __ldg(MU + i) : 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        acc[c] += fmaxf(fmaxf(dot[j][c], 0.f) - m, 0.f);
    }
  }
  close_gains<CPT, TX, NT>(acc, rows, red, best, resid, partial, out, c0, n_out, tx,
                          ty, tid);
}

}  // namespace

// Xc is the (n_rows, d) candidate matrix (the served rows Xs themselves for
// the global objective); resid may be NULL (all zero): the greedy instance.
// ppt and passes are fl_probe_tile(r) (kernels/_build.py); r == 1 takes the
// single-probe kernel and ignores them.  With splits > 1 the served rows are
// split across that many blocks per candidate tile, and partial must hold
// splits * r * n_out floats.
extern "C" int fl_stream_launch(const float* Xs, long long ni, int d,
                                const float* Xc, long long n_rows,
                                const long long* cand_idx, long long n_out,
                                const float* MU, const float* resid, int r,
                                int ppt, int passes, int splits, float* partial,
                                float* out, void* stream) {
  if (n_out <= 0) return 0;
  if (r < 1 || d < 1 || splits < 1 || (splits > 1 && partial == nullptr) ||
      !tile_covers(r, ppt, passes))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n_out + BC - 1) / BC),
                  static_cast<unsigned>(splits));
  const auto s = static_cast<cudaStream_t>(stream);
  float* part = splits > 1 ? partial : nullptr;
  if (r == 1) {
    if (d <= DK)
      fl_stream_gains_resident<<<grid, GNT, 0, s>>>(Xs, ni, d, Xc, n_rows, cand_idx,
                                                    n_out, MU, resid, part, out);
    else
      fl_stream_gains_pieces<<<grid, NT, 0, s>>>(Xs, ni, d, Xc, n_rows, cand_idx,
                                                 n_out, MU, resid, part, out);
  } else {
    cudaError_t err = cudaSuccess;
    dispatch_ppt(ppt, [&](auto tag) {
      constexpr int PPT = decltype(tag)::value;
      const auto kernel = fl_stream_tiled<PPT>;
      const size_t smem =
          (2 * (ProbeTile<PPT, MIK>::MWORDS + MIK * XROW) + MIK * BC + DK * BC) * sizeof(float);
      err = allow_smem(kernel, smem);
      if (err == cudaSuccess)
        kernel<<<grid, NT, smem, s>>>(Xs, ni, d, Xc, n_rows, cand_idx, n_out, MU,
                                      resid, r, passes, part, out);
    });
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return finish(part, splits, r, n_out, cand_idx, n_rows, resid, out, s);
}
