// SS divergence of FeatureCoverage, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ss_weights.py:ss_divergence_kernel (the
// Pallas TPU kernel, body _ss_divergence_kernel).
//
// Computes, for every candidate v (all rows of W, or the rows cand_idx
// names), in the difference form:
//   out[v] = min_u [ D[v, u] + Q[u] ]
//   D[v, u] = sum_{f : W[v, f] != 0} w_f (phi(CU[u, f] + W[v, f]) - phi(CU[u, f]))
//   Q[u]    = (sum_f w_f phi(CU[u, f]) - phi_cu[u]) - resid[u]
// which is the Pallas kernel's min_u [sum_f w_f phi(CU + W) - phi_cu - resid]
// for any phi_cu: a term with W[v, f] = 0 is exactly 0, because phi(CU)
// and phi(CU + W) come from the same instruction (repro::coverage_step).
// A pad probe carries phi_cu = -INF, so its Q is +INF and it never wins.
//
// Two small kernels run first, once per launch: ss_probe_table writes
// CT[f][u] = (CU[u, f], phi(CU[u, f])), transposed and padded to RP probes
// (a multiple of kProbePass, pads (0, 0)), and ss_probe_offsets writes Q
// (+INF on the pads), both into the scratch the wrapper allocates.
//
// What bounds it on this card: bytes.  W is TF-IDF: news_day(0, 2^20, 1024)
// holds about 10.5 nonzeros per 1024-wide row.  The work these inputs need is
// one read of W as stored (4 GiB at the main path's round 1: 1.28 ms) and
// one special function per (nonzero, probe), about 1.8e9 (0.42 ms).  Next
// come the gathers of CT[f][.] for the scattered features f: about 10.5 x
// 160 x 8 bytes per candidate, twice W's 4 KB, from L2.
//
// What the design does about it.  A block owns kBlockCands = 128 candidates
// and 8 warps; warp w owns the block's rows 16 w .. 16 w + 15.
//   1. Compaction (ss_divergence_sparse).  Each warp reads its rows once, in
//      place (through cand_idx; nothing is gathered or copied), a row at a
//      time with eight 16-byte loads a lane in flight, and appends each row's
//      nonzeros as (feature, value) to its share of a pool in shared memory,
//      in feature order (ballot and prefix popcount), marking the features
//      in a bitmap.  Alone, this phase read W about as fast as a plain
//      reduction over it; two rows in flight a warp ran slower.
//   2. The rule (pure, from the block's own data, and kept here only): the
//      block is dense iff F > kMaxSparseF or some warp's 16 rows hold more
//      than kWarpPool = 768 nonzeros (4.7% of 16 x 1024); a warp stops
//      reading once its rows exceed that.  Every block writes its choice to
//      its flag in the scratch (chip_smoke.py route_check reads the flags);
//      a dense block then leaves, and ss_divergence_dense computes it.
//      Nothing is caught and no failure picks a loop.
//   3. Sparse loop.  The features the block touches become slots in
//      feature order (about 350 of 1024 for 128 news_day rows), each entry's
//      feature is replaced by its slot, and the probes go in passes of 32,
//      one per lane.  Per pass, the CT rows of the touched slots are staged
//      by cp.async in chunks of SC = 192 slots (256 bytes a slot, a
//      coalesced row of CT), so one staged row serves every candidate of
//      the block that holds the feature, and untouched features cost
//      nothing.  A warp walks each of its 16 candidates' entries in the
//      chunk (one ballot finds where they end, then a counted loop unrolled
//      by 4: 16 register sums, entries read as broadcasts, CT as 8-byte
//      conflict-free reads), adds Q, takes the min over its 32 lanes with
//      shuffles and folds it into the candidate's running min.
//   4. Dense loop (ss_divergence_dense, a kernel of its own so that it keeps
//      the first design's occupancy: 4 probe x 4 candidate register sums a
//      thread, W and CT in 32-feature chunks through shared memory).  Over
//      the blocks the sparse kernel flagged, or all blocks when
//      F > kMaxSparseF.  It sums the same terms over all features in feature
//      order; a zero term adds exactly 0, so both loops give the same bits
//      for the same row: the route can change no result.
// Shared memory: 104,456 bytes a sparse block, so two blocks an SM (a
// 512-entry share with 128-slot chunks fits three, ran barely faster, and
// lowers the density the sparse loop takes).  The walk of step 3 issues
// about 14 instructions per (entry, pass) for 32 terms; PERF.md has the
// kernel's share of its bound.  Registers and spills:
// build/repro_torch/ss_divergence.ptxas.txt (chip_smoke.py prints them).

#include <atomic>
#include <cstdint>

#include "common.cuh"

namespace {

using repro::kInf;

constexpr unsigned kFull = 0xffffffffu;
constexpr int NT = 256;                 // threads per block
constexpr int WARPS = NT / 32;
// kBlockCands and kProbePass size the scratch: they must match
// SS_BLOCK_CANDS and SS_PROBE_PASS in repro_torch/kernels/_build.py.
constexpr int kBlockCands = 128;        // candidates per block (both loops)
constexpr int kWarpRows = 16;           // warp w compacts rows 16 w .. 16 w + 15
constexpr int kWarpPool = 768;          // nonzeros a warp's rows may hold
constexpr int kMaxSparseF = 8192;       // widest W the sparse loop takes
constexpr int kProbePass = 32;          // probes per pass; CT's probe padding
static_assert(kWarpRows * WARPS == kBlockCands, "rows per warp");

constexpr int kPool = WARPS * kWarpPool;
constexpr int kWords = kMaxSparseF / 32;  // bitmap words
constexpr int SC = 192;                   // slots staged per chunk
constexpr int UNV = 8;                    // 16-byte loads a lane per row piece
constexpr int UNS = 8;                    // 4-byte loads a lane per row piece

// The dense loop's tile.
constexpr int TX = 32;         // threads along candidates
constexpr int TY = 8;          // threads along probes
constexpr int CPT = 4;         // candidates per thread
constexpr int PPT = 4;         // probes per thread
constexpr int BP = TY * PPT;   // probes per pass
constexpr int FK = 32;         // features per shared-memory chunk
static_assert(TX * CPT == kBlockCands && TX * TY == NT && BP == kProbePass,
              "dense tile");

struct SparseSmem {
  long long rows[kBlockCands];
  float best[kBlockCands];
  float pw[kPool];                 // entry values
  unsigned short ps[kPool];        // entry features, then slots
  unsigned short slot_feat[kPool]; // slot -> feature
  unsigned bits[kWords];           // features the block touches
  int wpre[kWords];                // slots before each bitmap word
  int rstart[kBlockCands];         // a row's entries: rstart .. + rlen
  int rlen[kBlockCands];
  float2 cts[SC * kProbePass];     // staged CT rows of one chunk of slots
  float fws[SC];
  float caps[SC];
  int dense;
  int nslots;
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// CT[f][u] = (CU[u, f], phi(CU[u, f])) for u < RP, pads (0, 0): a 32 x 32
// tile a block, read along f and written along u.
template <int KIND>
__global__ void __launch_bounds__(256) ss_probe_table(
    const float* __restrict__ CU, int r, int F, int RP,
    const float* __restrict__ cap, float2* __restrict__ CT) {
  __shared__ float tile[32][33];
  const int f0 = blockIdx.x * 32;
  const int u0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32;
  const int ty = threadIdx.x / 32;
  for (int j = ty; j < 32; j += 8) {
    const int u = u0 + j, f = f0 + tx;
    tile[j][tx] = (u < r && f < F) ? CU[static_cast<long long>(u) * F + f] : 0.f;
  }
  __syncthreads();
  for (int j = ty; j < 32; j += 8) {
    const int f = f0 + j, u = u0 + tx;
    if (f < F) {
      const float c = tile[tx][j];
      const float pc = u < r ? repro::phi<KIND>(c, cap ? cap[f] : 0.f) : 0.f;
      CT[static_cast<long long>(f) * RP + u] = make_float2(c, pc);
    }
  }
}

// Q[u] = (sum_f w_f phi(CU[u, f]) - phi_cu[u]) - resid[u], +INF for
// r <= u < RP: one warp a probe, lane-strided sums in feature order, then a
// butterfly (every lane ends with the same bits).
template <int KIND>
__global__ void __launch_bounds__(256) ss_probe_offsets(
    const float* __restrict__ CU, int r, int F, int RP,
    const float* __restrict__ phi_cu, const float* __restrict__ resid,
    const float* __restrict__ cap, const float* __restrict__ fw,
    float* __restrict__ Q) {
  const int lane = threadIdx.x % 32;
  const int u = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (u >= RP) return;
  if (u >= r) {
    if (lane == 0) Q[u] = kInf;
    return;
  }
  float s = 0.f;
  for (int f = lane; f < F; f += 32)
    s = __fmaf_rn(fw ? fw[f] : 1.f,
                  repro::phi<KIND>(CU[static_cast<long long>(u) * F + f],
                                   cap ? cap[f] : 0.f),
                  s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) Q[u] = __fsub_rn(__fsub_rn(s, phi_cu[u]), resid[u]);
}

// Entry `pos` of the warp's share at `base`: feature f, value v, if v is a
// nonzero and the share holds it.
__device__ __forceinline__ void emit(SparseSmem& s, int base, int pos, int f, float v) {
  if (v != 0.f && pos < kWarpPool) {
    s.pw[base + pos] = v;
    s.ps[base + pos] = static_cast<unsigned short>(f);
    atomicOr(&s.bits[f >> 5], 1u << (f & 31));
  }
}

// Appends the nonzeros of one piece of a row (UNV 16-byte loads a lane,
// 128 UNV features from f0) to the warp's share, in feature order.
__device__ __forceinline__ void append4(SparseSmem& s, const float4 (&x)[UNV],
                                        int f0, int base, int lane, int& n) {
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < UNV; ++j) {
    const unsigned m0 = __ballot_sync(kFull, x[j].x != 0.f);
    const unsigned m1 = __ballot_sync(kFull, x[j].y != 0.f);
    const unsigned m2 = __ballot_sync(kFull, x[j].z != 0.f);
    const unsigned m3 = __ballot_sync(kFull, x[j].w != 0.f);
    int pos = n + __popc(m0 & lt) + __popc(m1 & lt) + __popc(m2 & lt) +
              __popc(m3 & lt);
    const int f = f0 + 128 * j + 4 * lane;
    emit(s, base, pos, f, x[j].x);
    pos += x[j].x != 0.f;
    emit(s, base, pos, f + 1, x[j].y);
    pos += x[j].y != 0.f;
    emit(s, base, pos, f + 2, x[j].z);
    pos += x[j].z != 0.f;
    emit(s, base, pos, f + 3, x[j].w);
    n += __popc(m0) + __popc(m1) + __popc(m2) + __popc(m3);
  }
}

// Step 1: the nonzeros of this warp's rows, appended in feature order to its
// share of the pool (entries past the share are counted, not written); the
// warp stops once its rows exceed the share.  Returns how many it counted.
template <typename T, bool VEC>
__device__ __forceinline__ int compact_rows(SparseSmem& s, const T* __restrict__ W,
                                            int F, int warp, int lane) {
  const int base = warp * kWarpPool;
  const int c0 = warp * kWarpRows;
  int n = 0;
  const unsigned lt = (1u << lane) - 1u;
  for (int k = 0; k < kWarpRows && n <= kWarpPool; ++k) {
    const long long row = s.rows[c0 + k];
    const int start = n;
    if (row >= 0) {
      const T* src = W + row * F;
      if constexpr (VEC) {
        for (int f0 = 0; f0 < F; f0 += 128 * UNV) {
          float4 x[UNV];
#pragma unroll
          for (int j = 0; j < UNV; ++j) {
            const int f = f0 + 128 * j + 4 * lane;
            x[j] = f < F ? repro::load4(src + f) : make_float4(0.f, 0.f, 0.f, 0.f);
          }
          append4(s, x, f0, base, lane, n);
        }
      } else {
        for (int f0 = 0; f0 < F; f0 += 32 * UNS) {
          float x[UNS];
#pragma unroll
          for (int j = 0; j < UNS; ++j) {
            const int f = f0 + 32 * j + lane;
            x[j] = f < F ? repro::to_f32(src[f]) : 0.f;
          }
#pragma unroll
          for (int j = 0; j < UNS; ++j) {
            const unsigned m = __ballot_sync(kFull, x[j] != 0.f);
            emit(s, base, n + __popc(m & lt), f0 + 32 * j + lane, x[j]);
            n += __popc(m);
          }
        }
      }
    }
    if (lane == 0) {
      s.rstart[c0 + k] = base + start;
      s.rlen[c0 + k] = n - start;
    }
  }
  return n;
}

// Step 3: slots, then the probe passes.  `used` is the number of entries
// in this warp's share.
template <int KIND>
__device__ __forceinline__ void sparse_loop(
    SparseSmem& s, int F, const float2* __restrict__ CT, const float* __restrict__ Q,
    int r, int RP, const float* __restrict__ cap, const float* __restrict__ fw,
    int warp, int lane, int used) {
  const int nw = (F + 31) / 32;
  if (warp == 0) {
    constexpr int WPL = kWords / 32;  // bitmap words per lane
    int cnt[WPL];
    int tot = 0;
#pragma unroll
    for (int j = 0; j < WPL; ++j) {
      cnt[j] = __popc(s.bits[lane * WPL + j]);
      tot += cnt[j];
    }
    int inc = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, inc, off);
      if (lane >= off) inc += y;
    }
    int run = inc - tot;
#pragma unroll
    for (int j = 0; j < WPL; ++j) {
      s.wpre[lane * WPL + j] = run;
      run += cnt[j];
    }
    if (lane == 31) s.nslots = inc;
  }
  __syncthreads();
  for (int w = threadIdx.x; w < nw; w += NT) {
    unsigned m = s.bits[w];
    int k = s.wpre[w];
    while (m) {
      s.slot_feat[k++] = static_cast<unsigned short>(32 * w + __ffs(m) - 1);
      m &= m - 1u;
    }
  }
  const int base = warp * kWarpPool;
  for (int e = base + lane; e < base + used; e += 32) {
    const int f = s.ps[e];
    s.ps[e] = static_cast<unsigned short>(
        s.wpre[f >> 5] + __popc(s.bits[f >> 5] & ((1u << (f & 31)) - 1u)));
  }
  __syncthreads();
  const int nslots = s.nslots;

  for (int p0 = 0; p0 < r; p0 += kProbePass) {
    float acc[kWarpRows];
    int cur[kWarpRows];
#pragma unroll
    for (int k = 0; k < kWarpRows; ++k) {
      acc[k] = 0.f;
      cur[k] = s.rstart[warp * kWarpRows + k];
    }
    for (int s0 = 0; s0 < nslots; s0 += SC) {
      const int ns = min(SC, nslots - s0);
      for (int i = warp; i < ns; i += WARPS) {
        const int f = s.slot_feat[s0 + i];
        cp_async8(&s.cts[i * kProbePass + lane],
                  &CT[static_cast<long long>(f) * RP + p0 + lane]);
        if (lane == 0) {
          s.fws[i] = fw ? fw[f] : 1.f;
          s.caps[i] = cap ? cap[f] : 0.f;
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      const bool last = s0 + SC >= nslots;
#pragma unroll
      for (int k = 0; k < kWarpRows; ++k) {
        const int ci = warp * kWarpRows + k;
        const int end = s.rstart[ci] + s.rlen[ci];
        int e = cur[k];
        // Entries are in slot order: this chunk's run is [e, ce).
        int ce = end;
        if (!last) {
          ce = e;
          for (;;) {
            const int idx = ce + lane;
            const unsigned in =
                __ballot_sync(kFull, idx < end && s.ps[idx] - s0 < SC);
            ce += __popc(in);
            if (in != kFull) break;
          }
        }
        float a = acc[k];
#pragma unroll 4
        for (; e < ce; ++e) {
          const int sl = s.ps[e] - s0;
          const float2 c = s.cts[sl * kProbePass + lane];
          a = repro::coverage_step<KIND>(a, s.fws[sl], c.x, c.y, s.pw[e], s.caps[sl]);
        }
        acc[k] = a;
        cur[k] = e;
      }
      __syncthreads();
    }
    const float q = Q[p0 + lane];
#pragma unroll
    for (int k = 0; k < kWarpRows; ++k) {
      float v = __fadd_rn(acc[k], q);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = fminf(v, __shfl_xor_sync(kFull, v, off));
      if (lane == 0) {
        const int ci = warp * kWarpRows + k;
        s.best[ci] = fminf(s.best[ci], v);
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void write_out(const long long* rows, const float* best,
                                          long long c0, float* __restrict__ out) {
  for (int ci = threadIdx.x; ci < kBlockCands; ci += NT) {
    const long long row = rows[ci];
    if (row != -1) out[c0 + ci] = row == -2 ? __int_as_float(0x7fc00000) : best[ci];
  }
}

// Steps 1-3: a block compacts its rows; a dense block sets its flag and
// leaves, a sparse one runs the sparse loop and writes its outputs.
template <typename T, int KIND, bool VEC>
__global__ void __launch_bounds__(NT, 2) ss_divergence_sparse(
    const T* __restrict__ W, long long n_rows, int F,
    const long long* __restrict__ cand_idx, long long n_out,
    const float2* __restrict__ CT, const float* __restrict__ Q, int r, int RP,
    const float* __restrict__ cap, const float* __restrict__ fw,
    int* __restrict__ dense, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SparseSmem& s = *reinterpret_cast<SparseSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long c0 = static_cast<long long>(blockIdx.x) * kBlockCands;

  for (int i = tid; i < kBlockCands; i += NT) {
    s.rows[i] = repro::row_of(cand_idx, c0 + i, n_out, n_rows);
    s.best[i] = kInf;
  }
  for (int i = tid; i < kWords; i += NT) s.bits[i] = 0u;
  if (tid == 0) s.dense = 0;
  __syncthreads();
  const int used = compact_rows<T, VEC>(s, W, F, warp, lane);
  if (lane == 0 && used > kWarpPool) s.dense = 1;
  __syncthreads();
  const bool is_dense = s.dense != 0;
  if (tid == 0) dense[blockIdx.x] = is_dense;
  if (is_dense) return;
  sparse_loop<KIND>(s, F, CT, Q, r, RP, cap, fw, warp, lane, used);
  write_out(s.rows, s.best, c0, out);
}

// Step 4: the dense loop, over the blocks flagged dense (all of them when
// dense is NULL).
template <typename T, int KIND>
__global__ void __launch_bounds__(NT) ss_divergence_dense(
    const T* __restrict__ W, long long n_rows, int F,
    const long long* __restrict__ cand_idx, long long n_out,
    const float2* __restrict__ CT, const float* __restrict__ Q, int r, int RP,
    const float* __restrict__ cap, const float* __restrict__ fw,
    const int* __restrict__ dense, float* __restrict__ out) {
  if (dense && !dense[blockIdx.x]) return;
  __shared__ float Ws[FK][kBlockCands + 1];
  __shared__ float2 Cs[FK][BP + 1];
  __shared__ float fws[FK];
  __shared__ float caps[FK];
  __shared__ long long rows[kBlockCands];
  __shared__ float red[TY][kBlockCands];
  __shared__ float best[kBlockCands];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const long long c0 = static_cast<long long>(blockIdx.x) * kBlockCands;
  for (int i = tid; i < kBlockCands; i += NT) {
    rows[i] = repro::row_of(cand_idx, c0 + i, n_out, n_rows);
    best[i] = kInf;
  }
  __syncthreads();

  for (int p0 = 0; p0 < r; p0 += BP) {
    float acc[PPT][CPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j)
#pragma unroll
      for (int i = 0; i < CPT; ++i) acc[j][i] = 0.f;

    for (int f0 = 0; f0 < F; f0 += FK) {
      for (int e = tid; e < kBlockCands * FK; e += NT) {
        const int ci = e / FK;
        const int f = e % FK;
        const long long row = rows[ci];
        float v = 0.f;
        if (row >= 0 && f0 + f < F) v = repro::to_f32(W[row * F + f0 + f]);
        Ws[f][ci] = v;
      }
      for (int e = tid; e < BP * FK; e += NT) {
        const int pi = e % BP;
        const int f = e / BP;
        Cs[f][pi] = f0 + f < F ? CT[static_cast<long long>(f0 + f) * RP + p0 + pi]
                               : make_float2(0.f, 0.f);
      }
      if (tid < FK) {
        const bool in = f0 + tid < F;
        fws[tid] = in ? (fw ? fw[f0 + tid] : 1.f) : 0.f;
        caps[tid] = (in && cap) ? cap[f0 + tid] : 0.f;
      }
      __syncthreads();

#pragma unroll 8
      for (int f = 0; f < FK; ++f) {
        float wv[CPT];
        float2 cv[PPT];
#pragma unroll
        for (int i = 0; i < CPT; ++i) wv[i] = Ws[f][tx + TX * i];
#pragma unroll
        for (int j = 0; j < PPT; ++j) cv[j] = Cs[f][ty + TY * j];
        const float w_f = fws[f];
        const float cap_f = caps[f];
#pragma unroll
        for (int j = 0; j < PPT; ++j)
#pragma unroll
          for (int i = 0; i < CPT; ++i)
            acc[j][i] = repro::coverage_step<KIND>(acc[j][i], w_f, cv[j].x,
                                                   cv[j].y, wv[i], cap_f);
      }
      __syncthreads();
    }

    // Min over this pass's probes: per thread, then across the TY threads
    // that share a candidate, folded into the running min.  Q is +INF on
    // the pads, so no probe needs a bound check.
    float m[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) m[i] = kInf;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const float q = Q[p0 + ty + TY * j];
#pragma unroll
      for (int i = 0; i < CPT; ++i) m[i] = fminf(m[i], __fadd_rn(acc[j][i], q));
    }
#pragma unroll
    for (int i = 0; i < CPT; ++i) red[ty][tx + TX * i] = m[i];
    __syncthreads();
    for (int ci = tid; ci < kBlockCands; ci += NT) {
      float b = best[ci];
#pragma unroll
      for (int y = 0; y < TY; ++y) b = fminf(b, red[y][ci]);
      best[ci] = b;
    }
    __syncthreads();
  }
  write_out(rows, best, c0, out);
}

// Opts an instance of the sparse kernel into its dynamic shared memory,
// once per device (bit d of `done`, for devices 0 .. 63) rather than once
// per launch: the host call is saved on every later launch.
template <typename T, int KIND, bool VEC>
cudaError_t allow_sparse_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(ss_divergence_sparse<T, KIND, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(SparseSmem)));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace

// scratch: 2 F RP + RP + ceil(n_out / kBlockCands) floats (RP = r rounded
// up to kProbePass): CT, Q, then the blocks' dense flags.
extern "C" int ss_divergence_launch(
    const void* W, int w_bf16, long long n_rows, int F,
    const long long* cand_idx, long long n_out, const float* CU,
    const float* phi_cu, const float* resid, int r, const float* cap,
    const float* fw, int phi_kind, float* scratch, float* out, void* stream) {
  if (n_out <= 0) return 0;
  const int RP = (r + kProbePass - 1) / kProbePass * kProbePass;
  float2* CT = reinterpret_cast<float2*>(scratch);
  float* Q = scratch + 2LL * F * RP;
  int* dense = reinterpret_cast<int*>(Q + RP);
  const dim3 grid(static_cast<unsigned>((n_out + kBlockCands - 1) / kBlockCands));
  const size_t elem = w_bf16 ? 2 : 4;
  const bool vec =
      F % 4 == 0 && reinterpret_cast<uintptr_t>(W) % (4 * elem) == 0;
  const bool sparse = F <= kMaxSparseF;
  cudaError_t err = cudaSuccess;
  const bool known = repro::dispatch(w_bf16, phi_kind, [&](auto t, auto k) {
    using T = typename decltype(t)::type;
    constexpr int KIND = decltype(k)::value;
    const auto s = static_cast<cudaStream_t>(stream);
    const T* w = static_cast<const T*>(W);
    if (F > 0)
      ss_probe_table<KIND><<<dim3((F + 31) / 32, RP / 32), 256, 0, s>>>(
          CU, r, F, RP, cap, CT);
    ss_probe_offsets<KIND><<<(RP + 7) / 8, 256, 0, s>>>(CU, r, F, RP, phi_cu,
                                                        resid, cap, fw, Q);
    if (sparse) {
      auto kernel = vec ? ss_divergence_sparse<T, KIND, true>
                        : ss_divergence_sparse<T, KIND, false>;
      err = vec ? allow_sparse_smem<T, KIND, true>()
                : allow_sparse_smem<T, KIND, false>();
      if (err != cudaSuccess) return;
      kernel<<<grid, NT, sizeof(SparseSmem), s>>>(w, n_rows, F, cand_idx, n_out,
                                                  CT, Q, r, RP, cap, fw, dense, out);
    }
    ss_divergence_dense<T, KIND><<<grid, NT, 0, s>>>(
        w, n_rows, F, cand_idx, n_out, CT, Q, r, RP, cap, fw,
        sparse ? dense : nullptr, out);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
