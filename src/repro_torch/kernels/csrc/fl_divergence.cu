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
// handled as it is.  The hinge terms are accumulated directly, in row
// order: the form sum_i max(sim, MU) - sum_i MU would lose the small gaps
// between candidates to float32 cancellation over ni rows.
//
// What bounds it on this card:
//   - many probes (an SS round): operations.  Each (probe, candidate, row)
//     term costs three FP32 instructions (subtract, max, add), which issue
//     at one warp instruction a clock per scheduler; at the first round of a
//     2^16-frame video (128 probes) that is 1.6e15 instructions against one
//     16 GiB read of sim.  What keeps a kernel from that bound is every
//     other instruction it issues (shared loads, staging, index
//     arithmetic), the probe slots it computes and throws away, and the
//     stalls while its operands arrive.
//   - one probe (a greedy step): bytes, one read of sim.
//
// What the design does about it:
//   - many probes: a block owns 128 candidates and all the probes of a pass;
//     each of its 256 threads keeps a PPT probe x 8 candidate tile of hinge
//     sums in registers (fl_common.cuh).  PPT and the number of passes come
//     from fl_probe_tile(r) (kernels/_build.py): 128, 144 and 160 probes
//     fill one pass exactly, so sim is read once and no pad slot is
//     computed.  A thread's candidates and probes are contiguous in shared
//     memory, so a staged row costs it 4 or 5 16-byte loads against 24 PPT
//     hinge instructions (192 to 240).
//   - sim and MU arrive in 32-row chunks through a two-slot cp.async ring:
//     the copies of chunk k + 1 are in flight while chunk k's hinge runs,
//     with one barrier per chunk.  sim goes as 16-byte copies when cand_idx
//     is absent, n % 4 == 0 and sim is 16-byte aligned (float32), else one
//     4-byte copy per element; bfloat16 is upcast by the threads on the way
//     (no cp.async: the chunk's loads are then not overlapped).  MU is read
//     along its rows and transposed on its way into shared memory.  Each
//     thread's column, row and probe offsets are fixed, worked out once per
//     pass, and out-of-range elements are zero-filled by the copy itself:
//     padded rows and probes add max(0 - 0, 0) = 0.
//   - one block of 8 warps per SM: the tile takes 198 registers a thread
//     at 128 probes and about 218 at 144, with no spills.  Capped at 128 for two blocks an SM,
//     ptxas spilled and the kernel ran slower on an H100; so did a 64-row
//     chunk, a shallower unroll of the hinge loop, and an FMA-pipe form of
//     the hinge term (t = s - m; acc = fma(0.5, t + |t|, acc), exact, but
//     three instructions still).  The hinge's 8 x PPT independent sums
//     hide the latency that more warps would.
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
//     One probe over a small buffer pays a 32-byte sector per element
//     (1024 columns of a 2^16-wide sim lie about 64 floats apart), so
//     greedy over V' does not come here: it copies the columns once into a
//     contiguous panel (kernels/fl_divergence.py:takes_panel,
//     fl_gains_panel) and every step takes the 16-byte vector route over it,
//     with the same rows in the same order: the gains are bitwise those of
//     the gathered route.

#include <cstdint>
#include <type_traits>

#include "fl_common.cuh"

namespace {

using namespace repro::fl;
using repro::kInf;

constexpr int MIK = 32;          // served rows per staged chunk (many probes)
constexpr int HINGE_UNROLL = 8;  // rows of the hinge loop unrolled

// Many probes, PPT per thread, `passes` passes of kProbeThreads * PPT.
// vec: 16-byte copies of sim (float32 only, see the note above).
template <typename T, int PPT>
__global__ void __launch_bounds__(NT, 1) fl_divergence_tiled(
    const T* __restrict__ sim, long long ni, long long n,
    const long long* __restrict__ cand_idx, long long n_out,
    const float* __restrict__ MU, const float* __restrict__ resid, int r,
    int passes, bool vec, float* __restrict__ partial, float* __restrict__ out) {
  using PT = ProbeTile<PPT, MIK>;
  constexpr int SLOT = MIK * BC + PT::MWORDS;   // S [MIK][BC], then M
  extern __shared__ float4 dyn[];
  float* ring = reinterpret_cast<float*>(dyn);  // two slots
  __shared__ long long cols[BC];
  __shared__ float red[kProbeThreads][BC];
  __shared__ float best[BC];

  const int tid = threadIdx.x;
  const int tc = tid % TC;
  const int tp = tid / TC;
  const long long c0 = static_cast<long long>(blockIdx.x) * BC;
  const RowSpan rows = row_span(ni);

  for (int c = tid; c < BC; c += NT) {
    cols[c] = repro::row_of(cand_idx, c0 + c, n_out, n);
    best[c] = kInf;
  }
  __syncthreads();

  // A thread stages one column of sim (vec: one run of 4) at every
  // SROW-th row of a chunk, from row sf on.
  const int sc = vec ? 4 * (tid % (BC / 4)) : tid % BC;
  const int sf = vec ? tid / (BC / 4) : tid / BC;
  const int srow = vec ? NT / (BC / 4) : NT / BC;
  const long long col = cols[sc];
  const T* cbase = sim + (col >= 0 ? col : 0) + sf * n;
  const long long step = srow * n;

  auto stage_sim = [&](float* S, long long i0) {
    const T* src = cbase + i0 * n;
    if constexpr (std::is_same_v<T, float>) {
      if (vec) {
#pragma unroll
        for (int f = sf; f < MIK; f += NT / (BC / 4), src += step) {
          const bool ok = col >= 0 && i0 + f < rows.hi;
          cp_async16(S + f * BC + sc, ok ? src : sim, ok);
        }
        return;
      }
#pragma unroll 4
      for (int f = sf; f < MIK; f += NT / BC, src += step) {
        const bool ok = col >= 0 && i0 + f < rows.hi;
        cp_async4(S + f * BC + sc, ok ? src : sim, ok);
      }
    } else {
#pragma unroll 4
      for (int f = sf; f < MIK; f += NT / BC, src += step)
        S[f * BC + sc] = (col >= 0 && i0 + f < rows.hi) ? repro::to_f32(*src) : 0.f;
    }
  };

  const long long chunks = rows.hi > rows.lo ? (rows.hi - rows.lo + MIK - 1) / MIK : 0;
  for (int pass = 0; pass < passes; ++pass) {
    const int p0 = pass * PT::SP;
    const MuStager<PPT, MIK> mus(MU, ni, r, p0, tid);
    float acc[PPT][MCPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j)
#pragma unroll
      for (int c = 0; c < MCPT; ++c) acc[j][c] = 0.f;

    if (chunks > 0) {
      stage_sim(ring, rows.lo);
      mus.stage(ring + MIK * BC, rows.lo, rows.hi);
    }
    cp_async_commit();
    for (long long k = 0; k < chunks; ++k) {
      // Chunk k has landed, and every thread is done with chunk k - 1,
      // whose slot now takes chunk k + 1.
      cp_async_wait_all();
      __syncthreads();
      if (k + 1 < chunks) {
        float* next = ring + ((k + 1) & 1) * SLOT;
        const long long i1 = rows.lo + (k + 1) * MIK;
        stage_sim(next, i1);
        mus.stage(next + MIK * BC, i1, rows.hi);
        cp_async_commit();
      }
      const float* cur = ring + (k & 1) * SLOT;
      hinge_rows<PPT, MIK, HINGE_UNROLL>(cur, cur + MIK * BC, acc, tc, tp);
    }
    close_pass<PPT>(acc, p0, r, resid, red, best, partial, c0, n_out, tc, tp, tid);
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
           long long n_out, const float* MU, const float* resid, int r, int ppt,
           int passes, int splits, float* partial, float* out,
           cudaStream_t stream) {
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
    const bool vec = std::is_same_v<T, float> && cand_idx == nullptr && n % 4 == 0 &&
                     reinterpret_cast<std::uintptr_t>(sim) % 16 == 0;
    cudaError_t err = cudaSuccess;
    dispatch_ppt(ppt, [&](auto tag) {
      constexpr int PPT = decltype(tag)::value;
      const auto kernel = fl_divergence_tiled<T, PPT>;
      const size_t smem = 2 * (MIK * BC + ProbeTile<PPT, MIK>::MWORDS) * sizeof(float);
      err = allow_smem(kernel, smem);
      if (err == cudaSuccess)
        kernel<<<grid, NT, smem, stream>>>(sim, ni, n, cand_idx, n_out, MU, resid,
                                           r, passes, vec, part, out);
    });
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return finish(part, splits, r, n_out, cand_idx, n, resid, out, stream);
}

}  // namespace

// resid may be NULL (all zero): the greedy-gains instance.  ppt and passes
// are fl_probe_tile(r) (kernels/_build.py); r == 1 takes the single-probe
// route and ignores them.  With splits > 1 the served rows are split across
// that many blocks per candidate tile, and partial must hold
// splits * r * n_out floats.
extern "C" int fl_divergence_launch(const void* sim, int sim_bf16, long long ni,
                                    long long n, const long long* cand_idx,
                                    long long n_out, const float* MU,
                                    const float* resid, int r, int ppt, int passes,
                                    int splits, float* partial, float* out,
                                    void* stream) {
  if (n_out <= 0) return 0;
  if (r < 1 || splits < 1 || (splits > 1 && partial == nullptr) ||
      !tile_covers(r, ppt, passes))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return sim_bf16
             ? launch(static_cast<const __nv_bfloat16*>(sim), ni, n, cand_idx,
                      n_out, MU, resid, r, ppt, passes, splits, partial, out, s)
             : launch(static_cast<const float*>(sim), ni, n, cand_idx, n_out,
                      MU, resid, r, ppt, passes, splits, partial, out, s);
}
