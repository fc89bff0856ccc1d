// The gain table of sieve streaming, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The reference runs sieve streaming as one
// lax.scan step per stream element (src/repro/core/sieve.py:_sieve_step),
// each step a vmapped fn.add and two fn.values over the T sieves, and no
// Pallas kernel.  The port walks the stream in chunks instead
// (repro_torch/core/sieve.py), and these kernels are the scan body's
// arithmetic for a whole chunk at once: the table of every live sieve state
// against every element of the chunk,
//   out[j, c] = sum_l h(S[j, l], E(c, l)),
//   h(s, e)   = w_l phi(s + e)   FeatureCoverage (E(c, .) a row of W)
//             = max(s, e)        facility location (E(c, .) a column of sim,
//                                or of relu(X_served X^T) for a chunk),
// so value(add(S_j, v)) = out[j, c], and value(S_j) is the entry of the zero
// element (idx[c] = -1): the gain value(add(s, v)) - value(s) is the
// reference's literal form, both terms from this one sum, so a zero row (or
// an element the state dominates) gains exactly 0.
//
// The order of each sum is fixed and is the same in the plain version
// (kernels/ref.py:sieve_gains_ref), so an entry's bits depend on neither the
// chunk, the tile, the route, nor which other sieves and elements share the
// launch: l runs in segments of 32; each segment is summed as a contiguous
// pairwise tree ((h0 + h1) + (h2 + h3)) + ..., the segments of a slab (4096
// leaves) are added in l order to a running sum from 0, and the slabs' sums
// in order to another.  Leaves past L are 0 (w = s = e = 0 is staged there),
// which adds exactly 0.  Every step rounds on its own (__fadd_rn, __fmul_rn:
// no contraction).  That is what lets one element at a time (sieve_update)
// give the bits of the whole stream at once, and the card's
// facility-location decisions equal the plain route's bit for bit.
//
// Two routes, by a pure rule of the layout (kernels/sieve_gains.py): phi
// with rows of W (FeatureCoverage's sieve_elements) takes the sparse route;
// everything else (facility location's columns, FeatureCoverage given
// columns) the tile.
//
// 1. The sparse route (FeatureCoverage).  What bounds it on this card:
// bytes.  A zero leaf's term w_l phi(s + 0) depends on the sieve and the
// leaf, not on the element (S holds sums of nonnegative W from +0, so it
// never holds -0.0, and s + (-0.0) = s + (+0.0) = s: a leaf whose bits are
// +0.0 or -0.0 is a zero leaf).  So for one sieve, every node of the fixed
// tree whose leaves are all zero in row c has the value that the tree over
// the zero terms Z[j, l] = w_l phi(s + 0) has there, from the same phi
// instruction.  Entry (j, c) needs only: the chain of segment adds, with the
// zero tree's total G[j, k] for each segment that holds no nonzero of c;
// and for a segment that holds some, the nonzeros' own terms and the adds
// up their paths, with Z's nodes as the untouched siblings.  Every add gets
// the operands of the dense tree (addition commutes bit for bit), so the
// result is identical, not merely close.  What these inputs need is one
// read of the chunk's rows of W (8193 x 1024 floats, 33.6 MB at the
// FeatureCoverage sieve's chunk: 0.010 ms at 3.35 TB/s), L/32 adds an entry
// and the nonzeros' terms (about 10.5 in a news_day row); the dense tree's
// L terms an entry, phi at each, are 60x that.
//   a. sieve_zero_tree, once a launch: for each sieve j (padded to RP, a
//      multiple of 32) and segment k, the zero tree's nodes, levels 0..4
//      (32 + 16 + 8 + 4 + 2 = 62 values) at Z[(k * 62 + node) * RP + j], the
//      total at G[k * RP + j], and S transposed, ST[l * RP + j], all in
//      the scratch the wrapper allocates.  The [k][node][j] layout is free
//      of bank conflicts and coalesced: the lanes of a warp are sieves and
//      read 32 consecutive floats.
//   b. sieve_sparse: a block owns SP_BLOCK = 16 elements, a warp 2 of them.
//      Each warp reads its rows once, in place through idx (16-byte loads,
//      eight a lane in flight), and appends each row's nonzeros as (leaf,
//      value) to its share of a pool in shared memory, in leaf order
//      (ballot and prefix popcount, as csrc/ss_divergence.cu does).  The
//      rule (pure, from the block's own data): the block is dense iff some
//      warp's 2 rows hold more than kWarpPool = 256 nonzeros (12.5 % of 2 x
//      1024); a warp stops reading once its rows exceed that.  Every block
//      writes its choice to its flag in the scratch (chip_smoke.py counts
//      the routes' blocks from them).  A sparse block then maps lanes to
//      (sieve, element) pairs by a pure rule of R: lpe lanes an element (R
//      rounded up to a power of two, at most 32), so that a re-launch of
//      1-8 rows keeps its lanes busy; the lanes of an element walk the same
//      nonzeros.  An entry walks the segments: G (staged in shared memory
//      when it fits) where the row has no nonzero; a segment with one or
//      two nonzeros issues all its loads first (the nonzeros' s, Z's
//      siblings up both paths) and then its adds: one latency a segment;
//      three or more (rare at news_day's density) take the node walk.  (The
//      node walk for every segment took a third more device time on the
//      FeatureCoverage sieve's launches: chip_ab_sieve.py, PERF.md.)  The
//      table of one pass of sieves is staged in shared memory and written
//      row by row, coalesced.  What holds it back is the L2: each
//      (element, nonzero) reads 6 floats a sieve from the scratch (1.5 KB
//      at 64 sieves, about 130 MB at the record shape), and a segment's
//      loads are one latency in its warp's chain.
//   c. A dense block runs the tile below (with the flags: only the columns
//      of flagged blocks are written), which sums the same terms in the
//      same order, so the route can change no result.  Nothing is caught
//      and no failure picks a route.
//
// 2. The tile (facility location, and FeatureCoverage's dense blocks and
// columns).  What bounds it on this card: operations.  A term of facility
// location is a max and an add (FMNMX, FADD): 2.1e11 at path A's record
// shape 51 x 8193 x 2^16 takes 1.63 ms at the float32 rate; 3.4e12 at
// 2^18 x 2^18 x 50 (0.2 s).  The design: a block of 256 threads owns 8
// sieves x 256 elements and one slab of l, and walks it in tiles of 32,
// staging the tile of S (8 x 32) and of E (32 x 256, rows of W along l,
// columns of sim along c) in shared memory; each thread keeps 2 sieves x 4
// elements in registers, so a leaf costs it 8 shared loads (with w_l and
// the cap) for 8 terms.  The tree needs no stack: a segment is one tile.
// fl_common.cuh's probe x candidate tile does not fit: it sums the hinge
// max(e - s, 0) in row order, and the sieve needs the literal form in this
// fixed tree order.  The slabs are the grid's z, each block writing its
// slab's sums to a scratch [slab][sieve][element] that sieve_gains_finish
// adds in slab order (no atomics: the bits do not depend on scheduling).
// A per-row start skips the columns a sieve has passed (a block whose
// columns all lie before its rows' starts returns at once), so a round
// recomputes only what the sieves that changed still need.  Its loop
// issues about 4.8 instructions a term (the shared loads among them), which
// leaves it at 0.24-0.30 of its bound.  A
// register tile (8 sieves x 2 elements a thread, 16-byte cp.async stages
// of a transposed S) was faster at the largest chunk with all 51 sieves
// but took 37 % more device time on path A's real mix of launches (chunks
// from 64 columns, re-launches of a few sieves with starts) and no less on
// path B's (chip_ab_sieve.py; PERF.md §6), so this kernel stays.
// Registers, spills and shared memory of each kernel:
// build/repro_torch/sieve_gains.ptxas.txt (chip_smoke.py prints them).

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int SEG = 32;                 // leaves a segment: kernels/ref.py SIEVE_SEG
constexpr int SEGS_PER_SLAB = 128;
constexpr long long SLAB = SEGS_PER_SLAB * SEG;  // kernels/ref.py SIEVE_SLAB
constexpr int kZNodes = 62;             // levels 0..4 of a segment's tree

// -- the tile ---------------------------------------------------------------

constexpr int NT = 256;           // threads per block
constexpr int TRT = 4;            // threads along sieves
constexpr int TCT = NT / TRT;     // threads along elements (64)
constexpr int RT = 2;             // sieves per thread
constexpr int CT = 4;             // elements per thread
constexpr int BR = TRT * RT;      // sieves per block (8)
constexpr int BC = TCT * CT;      // elements per block (256)
constexpr int SROW = BR + 1;      // padded shared rows: no bank conflicts
constexpr int EROW = BC + 1;      // on the transposing stores

// -- the sparse route: must match SIEVE_SPARSE_BLOCK in kernels/sieve_gains.py

constexpr int SP_BLOCK = 16;            // elements a block
constexpr int SP_WARPS = 8;
constexpr int SP_ROWS = SP_BLOCK / SP_WARPS;  // rows a warp compacts
constexpr int kWarpPool = 256;          // nonzeros a warp's rows may hold
constexpr int kGStage = 4096;           // floats of G a block stages
constexpr int UNV = 8;                  // 16-byte loads a lane per row piece
constexpr int UNS = 8;                  // 4-byte loads a lane per row piece
constexpr unsigned kFull = 0xffffffffu;
static_assert(BC % SP_BLOCK == 0, "a tile's columns are whole sparse blocks");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An asynchronous 4-byte copy into shared memory; ok false zero-fills (src
// is then any valid address and is not read).
__device__ __forceinline__ void cp4(void* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int KIND, bool FL>
__device__ __forceinline__ float term(float s, float e, float w, float cap) {
  if constexpr (FL) {
    return fmaxf(s, e);
  } else {
    return __fmul_rn(w, repro::phi<KIND>(__fadd_rn(s, e), cap));
  }
}

// out[r, c] for rows r of S (R x L, row-major) and elements c, each
// E(c, l) = E[idx[c] * ld + l] (rows: FeatureCoverage's W, n_e x ld) or
// E[l * ld + idx[c]] (cols: sim or a chunk's columns, L x ld); idx[c] = -1
// is the zero element, any other idx outside [0, n_e) gives NaN.  Entries
// with c < start[r] (and idx[c] >= 0) are not written.  Block z sums slab z
// into partial[z][r][c], or into out when there is one slab (partial NULL).
// With dense (the sparse route's flags), only the columns of flagged
// SP_BLOCK blocks are written, and a block with none returns at once.
template <int KIND, bool FL, bool COLS>
__global__ void __launch_bounds__(NT) sieve_tile(
    const float* __restrict__ S, int R, long long L,
    const float* __restrict__ E, long long ld, long long n_e,
    const long long* __restrict__ idx, int n_cols,
    const long long* __restrict__ start, const float* __restrict__ fw,
    const float* __restrict__ cap, const int* __restrict__ dense,
    float* __restrict__ partial, float* __restrict__ out) {
  __shared__ float Ss[SEG][SROW];
  __shared__ float Es[SEG][EROW];
  __shared__ float Ws[SEG];
  __shared__ float Cs[SEG];
  __shared__ long long cols[BC];
  __shared__ int skip;

  const int tid = threadIdx.x;
  const int tr = tid / TCT;
  const int tc = tid % TCT;
  const int r0 = blockIdx.y * BR;
  const long long c0 = static_cast<long long>(blockIdx.x) * BC;

  // The block's elements, and whether every one of them lies before the
  // start of every one of its rows (1), or no column was flagged dense (2).
  if (tid == 0) {
    long long first = start ? start[r0] : 0;
    for (int r = 1; r < BR && r0 + r < R; ++r)
      first = min(first, start ? start[r0 + r] : 0LL);
    int s = c0 + BC <= first;
    if (dense) {
      int any = 0;
      for (long long c = c0; c < c0 + BC && c < n_cols; c += SP_BLOCK)
        any |= dense[c / SP_BLOCK];
      s = any ? s : 2;
    }
    skip = s;
  }
  __syncthreads();
  for (int c = tid; c < BC; c += NT) {
    const long long col = c0 + c;
    long long e = -3;                       // past the end
    if (col < n_cols) {
      e = idx[col];
      if (e < -1 || e >= n_e) e = -2;       // bad index: NaN
      if (e == -1 && skip == 1) skip = 0;   // the zero element is always due
    }
    cols[c] = e;
  }
  __syncthreads();
  if (skip) return;

  float acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;

  const long long lo = static_cast<long long>(blockIdx.z) * SLAB;
  const long long hi = lo + SLAB < L ? lo + SLAB : L;
  for (long long l0 = lo; l0 < hi; l0 += SEG) {
    // stage S: 8 rows x 32 leaves, one value a thread
    {
      const int r = tid / SEG, l = tid % SEG;
      const bool ok = r0 + r < R && l0 + l < L;
      Ss[l][r] = ok ? S[static_cast<long long>(r0 + r) * L + l0 + l] : 0.f;
    }
    if (tid < SEG) {
      const bool ok = l0 + tid < L;
      Ws[tid] = ok ? (fw ? fw[l0 + tid] : 1.f) : 0.f;
      Cs[tid] = ok && cap ? cap[l0 + tid] : 0.f;
    }
    // stage E: 32 leaves x 256 elements
    if constexpr (COLS) {
      // along the elements: consecutive threads, consecutive columns
      const long long e = cols[tid];
      for (int l = 0; l < SEG; ++l) {
        float v = 0.f;
        if (e >= 0 && l0 + l < L) v = E[(l0 + l) * ld + e];
        Es[l][tid] = v;
      }
    } else {
      // along the leaves: a warp reads 32 consecutive features of one row
      const int l = tid % SEG;
      for (int c = tid / SEG; c < BC; c += NT / SEG) {
        const long long e = cols[c];
        float v = 0.f;
        if (e >= 0 && l0 + l < L) v = E[e * ld + l0 + l];
        Es[l][c] = v;
      }
    }
    __syncthreads();

    // One segment: four 8-leaf trees g0..g3, each ((p0 + p1) + (p2 + p3))
    // with p = h(2i) + h(2i + 1), folded as ((g0 + g1) + (g2 + g3)) and
    // added to the running sum.
    float a[RT][CT], b[RT][CT];
#pragma unroll
    for (int q = 0; q < SEG / 8; ++q) {
      float u[RT][CT], v[RT][CT], g[RT][CT];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float pr[RT][CT];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int l = 8 * q + 2 * p + h;
          const float w = Ws[l], cp = Cs[l];
          float sv[RT], ev[CT];
#pragma unroll
          for (int i = 0; i < RT; ++i) sv[i] = Ss[l][tr * RT + i];
#pragma unroll
          for (int j = 0; j < CT; ++j) ev[j] = Es[l][tc + TCT * j];
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < CT; ++j) {
              const float t = term<KIND, FL>(sv[i], ev[j], w, cp);
              pr[i][j] = h == 0 ? t : __fadd_rn(pr[i][j], t);
            }
        }
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j) {
            if (p == 0) u[i][j] = pr[i][j];
            else if (p == 1) u[i][j] = __fadd_rn(u[i][j], pr[i][j]);
            else if (p == 2) v[i][j] = pr[i][j];
            else g[i][j] = __fadd_rn(u[i][j], __fadd_rn(v[i][j], pr[i][j]));
          }
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          if (q == 0) a[i][j] = g[i][j];
          else if (q == 1) a[i][j] = __fadd_rn(a[i][j], g[i][j]);
          else if (q == 2) b[i][j] = g[i][j];
          else acc[i][j] = __fadd_rn(acc[i][j],
                                     __fadd_rn(a[i][j], __fadd_rn(b[i][j], g[i][j])));
        }
    }
    __syncthreads();
  }

  float* dst = partial ? partial + static_cast<long long>(blockIdx.z) * R * n_cols : out;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = r0 + tr * RT + i;
    if (r >= R) continue;
    const long long first = start ? start[r] : 0;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int cl = tc + TCT * j;
      const long long c = c0 + cl;
      const long long e = cols[cl];
      if (e == -3 || (dense && !dense[c / SP_BLOCK])) continue;
      if (e == -2) {
        dst[static_cast<long long>(r) * n_cols + c] = __int_as_float(0x7fc00000);
      } else if (e == -1 || c >= first) {
        dst[static_cast<long long>(r) * n_cols + c] = acc[i][j];
      }
    }
  }
}

// out = the slabs' sums added in slab order from 0 (with dense: only the
// columns of flagged blocks).  An entry a block skipped (before its row's
// start) sums whatever the scratch holds there: unspecified, as the kernel
// leaves it.
__global__ void sieve_gains_finish(const float* __restrict__ partial, int slabs,
                                   int n_cols, long long entries,
                                   const int* __restrict__ dense,
                                   float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= entries) return;
  if (dense && !dense[(i % n_cols) / SP_BLOCK]) return;
  float s = 0.f;
  for (int z = 0; z < slabs; ++z) s = __fadd_rn(s, partial[z * entries + i]);
  out[i] = s;
}

// -- the sparse route ---------------------------------------------------------

__host__ __device__ constexpr int node_base(int t) {
  return t == 0 ? 0 : t == 1 ? 32 : t == 2 ? 48 : t == 3 ? 56 : 60;
}

// One level of a segment's tree, in place: z[i] = z[2 i] + z[2 i + 1] for
// i < W, each node written to dst[i * RP].
template <int W>
__device__ __forceinline__ void zero_level(float (&z)[SEG], float* __restrict__ dst,
                                           int RP) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    z[i] = __fadd_rn(z[2 * i], z[2 * i + 1]);
    dst[static_cast<long long>(i) * RP] = z[i];
  }
}

// The zero tree: a thread a (sieve j, segment k), 32 sieves x 8 segments a
// block; S's 32 x 256 tile is staged through shared memory so that its rows
// are read coalesced.
template <int KIND>
__global__ void __launch_bounds__(256) sieve_zero_tree(
    const float* __restrict__ S, int R, long long L, int RP,
    const float* __restrict__ fw, const float* __restrict__ cap,
    float* __restrict__ Z, float* __restrict__ G, float* __restrict__ ST) {
  __shared__ float Sx[32][8 * SEG + 1];
  const int tid = threadIdx.x;
  const int j0 = blockIdx.y * 32;
  const long long k0 = static_cast<long long>(blockIdx.x) * 8;
  for (int i = tid; i < 32 * 8 * SEG; i += 256) {
    const int jj = i / (8 * SEG), ll = i % (8 * SEG);
    const long long l = k0 * SEG + ll;
    const bool ok = j0 + jj < R && l < L;
    cp4(&Sx[jj][ll], ok ? S + static_cast<long long>(j0 + jj) * L + l : S, ok);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  const int jx = tid % 32, ky = tid / 32;
  const long long k = k0 + ky;
  if (k >= (L + SEG - 1) / SEG) return;
  const int j = j0 + jx;
  float z[SEG];
#pragma unroll
  for (int i = 0; i < SEG; ++i) {
    const long long l = k * SEG + i;
    const float s = Sx[jx][ky * SEG + i];
    ST[l * RP + j] = s;
    z[i] = l < L ? __fmul_rn(fw ? fw[l] : 1.f,
                             repro::phi<KIND>(__fadd_rn(s, 0.f), cap ? cap[l] : 0.f))
                 : 0.f;
    Z[(k * kZNodes + i) * RP + j] = z[i];
  }
  zero_level<16>(z, Z + (k * kZNodes + node_base(1)) * RP + j, RP);
  zero_level<8>(z, Z + (k * kZNodes + node_base(2)) * RP + j, RP);
  zero_level<4>(z, Z + (k * kZNodes + node_base(3)) * RP + j, RP);
  zero_level<2>(z, Z + (k * kZNodes + node_base(4)) * RP + j, RP);
  G[k * RP + j] = __fadd_rn(z[0], z[1]);
}

struct SpSmem {
  long long cols[SP_BLOCK];   // idx; -2 bad, -3 past the end, -4 before every start
  int rstart[SP_BLOCK];       // a row's entries: rstart .. + rlen
  int rlen[SP_BLOCK];
  int leaf[SP_WARPS * kWarpPool];
  float val[SP_WARPS * kWarpPool];
  float tab[32][SP_BLOCK + 1];  // one pass of sieves x the block's elements
  float gst[kGStage];           // G, where nseg x RP fits
  long long wfirst[SP_WARPS];
  long long first;
  int dense;
};

// What segment_tree reads for sieve j and segment k.
struct Walk {
  const float* Z;     // Z + k * 62 * RP + j
  const float* ST;    // ST + j
  const float* val;   // the row's entries' values, from e0 on
  const float* fw;
  const float* cap;
  long long k;
  int RP;
  int e0;
};

// Node Q of level T of a segment's tree for sieve j: Z's node where the
// row has no nonzero under it, else the sum of its children (a leaf: w
// phi(s + e)).
template <int KIND, int T, int Q>
__device__ __forceinline__ float node(const Walk& w, unsigned mask) {
  constexpr int N = 1 << T;
  if constexpr (T < 5) {
    constexpr unsigned sub = ((1u << N) - 1u) << (Q * N);
    if ((mask & sub) == 0u) return w.Z[(node_base(T) + Q) * w.RP];
  }
  if constexpr (T == 0) {
    const long long l = w.k * SEG + Q;
    const float e = w.val[w.e0 + __popc(mask & ((1u << Q) - 1u))];
    return __fmul_rn(w.fw ? w.fw[l] : 1.f,
                     repro::phi<KIND>(__fadd_rn(w.ST[l * w.RP], e), w.cap ? w.cap[l] : 0.f));
  } else {
    return __fadd_rn(node<KIND, T - 1, 2 * Q>(w, mask),
                     node<KIND, T - 1, 2 * Q + 1>(w, mask));
  }
}

// A segment that holds three or more of the row's nonzeros (rare at
// news_day's density): its tree by the node walk.
template <int KIND>
__device__ __noinline__ float segment_tree(Walk w, unsigned mask) {
  return node<KIND, 5, 0>(w, mask);
}

// The chain of one entry: segment k's value is added to the running sum of
// its slab, the slabs' sums to total.
struct Chain {
  float acc, total;
  int k;   // the next segment
};

__device__ __forceinline__ void chain_add(Chain& ch, float x) {
  if (ch.k > 0 && ch.k % SEGS_PER_SLAB == 0) {
    ch.total = __fadd_rn(ch.total, ch.acc);
    ch.acc = 0.f;
  }
  ch.acc = __fadd_rn(ch.acc, x);
  ++ch.k;
}

// The zero tree's totals of segments ch.k .. kend - 1, eight loads ahead.
__device__ __forceinline__ void chain_zeros(Chain& ch, int kend, const float* G, int RP,
                                            int j) {
  for (; ch.k + 8 <= kend;) {
    float g[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) g[i] = G[(ch.k + i) * RP + j];
#pragma unroll
    for (int i = 0; i < 8; ++i) chain_add(ch, g[i]);
  }
  while (ch.k < kend) chain_add(ch, G[ch.k * RP + j]);
}

// What a segment with one or two nonzeros needs, loaded ahead of its adds:
// the nonzeros' s and weights, and Z's siblings up the paths.  One
// nonzero at leaf p: zp[t] = Z's sibling of p's node at level t, t < 5.
// Two, at p < q, whose paths meet at level d + 1 (d the highest bit where
// p and q differ): zp[t] for t < d and t > d, zq[t] for q's path, t < d.
struct Path {
  float zp[5], zq[5], s[2], w[2], c[2];
};

__device__ __forceinline__ void path_load(Path& a, unsigned mask, long long k, int RP,
                                          const float* __restrict__ Z,
                                          const float* __restrict__ ST,
                                          const float* __restrict__ fw,
                                          const float* __restrict__ cap) {
  const int p = __ffs(mask) - 1;
  const unsigned rest = mask & (mask - 1u);
  const int q = rest ? __ffs(rest) - 1 : p;
  const int d = rest ? 31 - __clz(p ^ q) : 5;
  const float* zk = Z + k * kZNodes * RP;
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    if (t != d) a.zp[t] = zk[(node_base(t) + ((p >> t) ^ 1)) * RP];
    if (t < d && rest) a.zq[t] = zk[(node_base(t) + ((q >> t) ^ 1)) * RP];
  }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const long long l = k * SEG + (n ? q : p);
    if (n == 0 || rest) {
      a.s[n] = ST[l * RP];
      a.w[n] = fw ? fw[l] : 1.f;
      a.c[n] = cap ? cap[l] : 0.f;
    }
  }
}

template <int KIND>
__device__ __forceinline__ float path_sum(const Path& a, unsigned mask, const float* val) {
  const unsigned rest = mask & (mask - 1u);
  const int d = rest ? 31 - __clz((__ffs(mask) - 1) ^ (__ffs(rest) - 1)) : 5;
  float vp = __fmul_rn(a.w[0], repro::phi<KIND>(__fadd_rn(a.s[0], val[0]), a.c[0]));
#pragma unroll
  for (int t = 0; t < 5; ++t)
    if (t < d) vp = __fadd_rn(vp, a.zp[t]);
  if (rest) {
    float vq = __fmul_rn(a.w[1], repro::phi<KIND>(__fadd_rn(a.s[1], val[1]), a.c[1]));
#pragma unroll
    for (int t = 0; t < 5; ++t)
      if (t < d) vq = __fadd_rn(vq, a.zq[t]);
    vp = __fadd_rn(vp, vq);
#pragma unroll
    for (int t = 0; t < 5; ++t)
      if (t > d) vp = __fadd_rn(vp, a.zp[t]);
  }
  return vp;
}

// Entry (j, c): the segments' chain, G (from shared memory where it fits)
// where row c has no nonzero.  A segment that holds one or two nonzeros has
// all its loads issued before its adds (path_load: one latency a segment);
// one with three or more goes to segment_tree.
template <int KIND>
__device__ float sparse_entry(const SpSmem& sm, int c, int j, long long L,
                              const float* __restrict__ Z, const float* G,
                              const float* __restrict__ ST, int RP,
                              const float* __restrict__ fw,
                              const float* __restrict__ cap) {
  const int nseg = static_cast<int>((L + SEG - 1) / SEG);
  int e = sm.rstart[c];
  const int end = e + sm.rlen[c];
  Chain ch{0.f, 0.f, 0};
  while (e < end) {
    const int k = sm.leaf[e] / SEG, first = e;
    unsigned m = 0u;
    for (; e < end && sm.leaf[e] < (k + 1) * SEG; ++e) m |= 1u << (sm.leaf[e] & 31);
    float seg;
    if (__popc(m) <= 2) {
      Path a;
      path_load(a, m, k, RP, Z + j, ST + j, fw, cap);
      chain_zeros(ch, k, G, RP, j);
      seg = path_sum<KIND>(a, m, sm.val + first);
    } else {
      chain_zeros(ch, k, G, RP, j);
      seg = segment_tree<KIND>(
          Walk{Z + static_cast<long long>(k) * kZNodes * RP + j, ST + j, sm.val, fw, cap, k,
               RP, first},
          m);
    }
    chain_add(ch, seg);
  }
  chain_zeros(ch, nseg, G, RP, j);
  return nseg > SEGS_PER_SLAB ? __fadd_rn(ch.total, ch.acc) : ch.acc;
}

__device__ __forceinline__ void emit(SpSmem& sm, int base, int pos, int l, float v) {
  if (v != 0.f && pos < kWarpPool) {
    sm.leaf[base + pos] = l;
    sm.val[base + pos] = v;
  }
}

// The nonzeros of this warp's rows, appended in leaf order to its share of
// the pool (entries past the share are counted, not written); the warp stops
// once its rows exceed the share.  Returns how many it counted.
__device__ int compact_rows(SpSmem& sm, const float* __restrict__ E, long long ld,
                            long long L, bool vec, int warp, int lane) {
  const int base = warp * kWarpPool;
  const unsigned lt = (1u << lane) - 1u;
  int n = 0;
  for (int kk = 0; kk < SP_ROWS; ++kk) {
    const int c = warp * SP_ROWS + kk;
    const long long e = sm.cols[c];
    const int n0 = n;
    if (e >= 0 && n <= kWarpPool) {
      const float* src = E + e * ld;
      if (vec) {
        for (long long f0 = 0; f0 < L; f0 += 128 * UNV) {
          float4 x[UNV];
#pragma unroll
          for (int q = 0; q < UNV; ++q) {
            const long long f = f0 + 128 * q + 4 * lane;
            x[q] = f < L ? repro::load4(src + f) : make_float4(0.f, 0.f, 0.f, 0.f);
            if (f + 3 >= L) {   // the row's end inside this load (ld >= L)
              if (f + 1 >= L) x[q].y = 0.f;
              if (f + 2 >= L) x[q].z = 0.f;
              x[q].w = 0.f;
            }
          }
#pragma unroll
          for (int q = 0; q < UNV; ++q) {
            const unsigned m0 = __ballot_sync(kFull, x[q].x != 0.f);
            const unsigned m1 = __ballot_sync(kFull, x[q].y != 0.f);
            const unsigned m2 = __ballot_sync(kFull, x[q].z != 0.f);
            const unsigned m3 = __ballot_sync(kFull, x[q].w != 0.f);
            int pos = n + __popc(m0 & lt) + __popc(m1 & lt) + __popc(m2 & lt) +
                      __popc(m3 & lt);
            const int f = static_cast<int>(f0) + 128 * q + 4 * lane;
            emit(sm, base, pos, f, x[q].x);
            pos += x[q].x != 0.f;
            emit(sm, base, pos, f + 1, x[q].y);
            pos += x[q].y != 0.f;
            emit(sm, base, pos, f + 2, x[q].z);
            pos += x[q].z != 0.f;
            emit(sm, base, pos, f + 3, x[q].w);
            n += __popc(m0) + __popc(m1) + __popc(m2) + __popc(m3);
          }
        }
      } else {
        for (long long f0 = 0; f0 < L; f0 += 32 * UNS) {
          float x[UNS];
#pragma unroll
          for (int q = 0; q < UNS; ++q) {
            const long long f = f0 + 32 * q + lane;
            x[q] = f < L ? src[f] : 0.f;
          }
#pragma unroll
          for (int q = 0; q < UNS; ++q) {
            const unsigned m = __ballot_sync(kFull, x[q] != 0.f);
            emit(sm, base, n + __popc(m & lt), static_cast<int>(f0) + 32 * q + lane, x[q]);
            n += __popc(m);
          }
        }
      }
    }
    if (lane == 0) {
      sm.rstart[c] = base + n0;
      sm.rlen[c] = n - n0;
    }
  }
  return n;
}

template <int KIND>
__global__ void __launch_bounds__(256) sieve_sparse(
    int R, long long L, const float* __restrict__ E, long long ld, long long n_e,
    const long long* __restrict__ idx, int n_cols,
    const long long* __restrict__ start, const float* __restrict__ fw,
    const float* __restrict__ cap, const float* __restrict__ Z,
    const float* __restrict__ G, const float* __restrict__ ST, int RP,
    int* __restrict__ dense, float* __restrict__ out) {
  __shared__ SpSmem sm;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const long long c0 = static_cast<long long>(blockIdx.x) * SP_BLOCK;

  // The earliest start of any row: the columns before it are due nowhere.
  long long first = start ? LLONG_MAX : 0;
  if (start)
    for (int r = tid; r < R; r += 256) first = min(first, start[r]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    first = min(first, __shfl_xor_sync(kFull, first, off));
  if (lane == 0) sm.wfirst[warp] = first;
  if (tid == 0) sm.dense = 0;
  __syncthreads();
  if (tid == 0) {
    long long f = sm.wfirst[0];
    for (int w = 1; w < SP_WARPS; ++w) f = min(f, sm.wfirst[w]);
    sm.first = f;
  }
  __syncthreads();
  if (tid < SP_BLOCK) {
    const long long col = c0 + tid;
    long long e = -3;
    if (col < n_cols) {
      e = idx[col];
      if (e < -1 || e >= n_e) e = -2;
      else if (e >= 0 && col < sm.first) e = -4;
    }
    sm.cols[tid] = e;
  }
  __syncthreads();

  const bool vec = ld % 4 == 0 && (reinterpret_cast<uintptr_t>(E) & 15) == 0;
  const int used = compact_rows(sm, E, ld, L, vec, warp, lane);
  if (lane == 0 && used > kWarpPool) sm.dense = 1;
  __syncthreads();
  const int is_dense = sm.dense;
  if (tid == 0) dense[blockIdx.x] = is_dense;
  if (is_dense) return;
  const long long gsize = (L + SEG - 1) / SEG * RP;
  const float* Gp = G;
  if (gsize <= kGStage) {
    for (int i = tid; i < gsize; i += 256) cp4(&sm.gst[i], G + i, true);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    Gp = sm.gst;
  }

  // lpe lanes an element (R up to a power of two, at most 32), passes of
  // lpe sieves.
  const int lpe = R >= 32 ? 32 : 1 << (32 - __clz(R - 1));
  const int gpw = 32 / lpe;
  const int passes = (R + lpe - 1) / lpe;
  const int grp = warp * gpw + lane / lpe, ngrp = SP_WARPS * gpw;
  const int jl = lane % lpe;
  for (int p = 0; p < passes; ++p) {
    const int j = p * lpe + jl;   // < RP: pad sieves read the pad columns
    for (int c = grp; c < SP_BLOCK; c += ngrp) {
      const long long e = sm.cols[c];
      if (e == -1 || e >= 0)
        sm.tab[jl][c] = sparse_entry<KIND>(sm, c, j, L, Z, Gp, ST, RP, fw, cap);
    }
    __syncthreads();
    for (int i = tid; i < lpe * SP_BLOCK; i += 256) {
      const int jj = i / SP_BLOCK, c = i % SP_BLOCK, r = p * lpe + jj;
      if (r >= R) continue;
      const long long e = sm.cols[c], col = c0 + c;
      float* o = out + static_cast<long long>(r) * n_cols + col;
      if (e == -2) *o = __int_as_float(0x7fc00000);
      else if (e == -1 || (e >= 0 && col >= (start ? start[r] : 0))) *o = sm.tab[jj][c];
    }
    __syncthreads();
  }
}

// The sieves' pitch in the sparse route's transposed tables: R rounded up
// to a multiple of 32.
int sieve_pitch(int R) { return (R + 31) / 32 * 32; }

// Floats of the slabs' partial sums.
long long partial_floats(int R, long long L, int n_cols) {
  const long long slabs = (L + SLAB - 1) / SLAB;
  return slabs > 1 ? slabs * R * n_cols : 0;
}

}  // namespace

// Floats of scratch a launch takes: [slabs x R x n_cols partial sums, when
// L > SLAB][sparse route: ST nseg x 32 x RP, Z nseg x 62 x RP, G nseg x RP,
// then one int32 flag a SP_BLOCK block].
extern "C" long long sieve_gains_scratch_floats(int R, long long L, int n_cols,
                                                int sparse) {
  const long long nseg = (L + SEG - 1) / SEG;
  const long long RP = sieve_pitch(R);
  long long n = partial_floats(R, L, n_cols);
  if (sparse)
    n += nseg * (SEG + kZNodes + 1) * RP + (n_cols + SP_BLOCK - 1) / SP_BLOCK;
  return n;
}

// The table: the sparse route (sparse != 0: phi over rows of E) or the tile,
// with the scratch of sieve_gains_scratch_floats (NULL where that is 0).
extern "C" int sieve_gains_launch(const float* S, int R, long long L, const float* E,
                                  int e_cols, long long ld, long long n_e,
                                  const long long* idx, int n_cols,
                                  const long long* start, int fl, int phi_kind,
                                  const float* fw, const float* cap, int sparse,
                                  float* scratch, float* out, void* stream) {
  if (R <= 0 || n_cols <= 0) return 0;
  const long long slabs = (L + SLAB - 1) / SLAB;
  if (L < 1 || L >= INT_MAX || slabs > 65535 || (sparse && (fl || e_cols)) ||
      (scratch == nullptr && sieve_gains_scratch_floats(R, L, n_cols, sparse) > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  float* partial = slabs > 1 ? scratch : nullptr;
  const long long nseg = (L + SEG - 1) / SEG;
  const int RP = sieve_pitch(R);
  float* ST = sparse ? scratch + partial_floats(R, L, n_cols) : nullptr;
  float* Z = sparse ? ST + nseg * SEG * RP : nullptr;
  float* G = sparse ? Z + nseg * kZNodes * RP : nullptr;
  int* flags = sparse ? reinterpret_cast<int*>(G + nseg * RP) : nullptr;

  const dim3 tgrid(static_cast<unsigned>((n_cols + BC - 1) / BC),
                   static_cast<unsigned>((R + BR - 1) / BR),
                   static_cast<unsigned>(slabs));
  auto tile = [&](auto kernel) {
    kernel<<<tgrid, NT, 0, s>>>(S, R, L, E, ld, n_e, idx, n_cols, start, fw, cap, flags,
                                partial, out);
  };
  if (fl) {
    if (e_cols) tile(sieve_tile<0, true, true>);
    else tile(sieve_tile<0, true, false>);
  } else {
    const bool known = repro::dispatch_kind<float>(phi_kind, [&](auto, auto k) {
      constexpr int KIND = decltype(k)::value;
      if (sparse) {
        const dim3 zgrid(static_cast<unsigned>((nseg + 7) / 8),
                         static_cast<unsigned>(RP / 32));
        sieve_zero_tree<KIND><<<zgrid, 256, 0, s>>>(S, R, L, RP, fw, cap, Z, G, ST);
        const unsigned blocks = static_cast<unsigned>((n_cols + SP_BLOCK - 1) / SP_BLOCK);
        sieve_sparse<KIND><<<blocks, 256, 0, s>>>(R, L, E, ld, n_e, idx, n_cols, start, fw,
                                                  cap, Z, G, ST, RP, flags, out);
      }
      if (e_cols) tile(sieve_tile<KIND, false, true>);
      else tile(sieve_tile<KIND, false, false>);
    });
    if (!known) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (slabs > 1) {
    const long long entries = static_cast<long long>(R) * n_cols;
    const unsigned blocks = static_cast<unsigned>((entries + 255) / 256);
    sieve_gains_finish<<<blocks, 256, 0, s>>>(partial, static_cast<int>(slabs), n_cols,
                                              entries, flags, out);
  }
  return static_cast<int>(cudaGetLastError());
}
