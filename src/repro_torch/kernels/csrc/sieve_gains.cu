// The gain table of sieve streaming, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The reference runs sieve streaming as one
// lax.scan step per stream element (src/repro/core/sieve.py:_sieve_step),
// each step a vmapped fn.add and two fn.values over the T sieves, and no
// Pallas kernel.  The port walks the stream in chunks instead
// (repro_torch/core/sieve.py), and this kernel is the scan body's arithmetic
// for a whole chunk at once: the table of every live sieve state against
// every element of the chunk,
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
// chunk, the tile, nor which other sieves and elements share the launch:
// l runs in segments of 32; each segment is summed as a contiguous pairwise
// tree ((h0 + h1) + (h2 + h3)) + ..., the segments of a slab (4096 leaves)
// are added in l order to a running sum from 0, and the slabs' sums in order
// to another.  Leaves past L are 0 (w = s = e = 0 is staged there), which
// adds exactly 0.  Every step rounds on its own (__fadd_rn,
// __fmul_rn: no contraction).  That is what lets one element at a time
// (sieve_update) give the bits of the whole stream at once, and the card's
// facility-location decisions equal the plain route's bit for bit.
//
// What bounds it on this card: operations.  Every (sieve, element, leaf)
// term costs one add of the fixed tree.  For FeatureCoverage that is the
// bound: a zero leaf of W gives the term w_l phi(s), one value per sieve
// and leaf, so phi is needed only at W's nonzeros (about 20 of a news_day
// row's 1024) and once per sieve and leaf.  The tree's adds at 2^20
// elements x 1024 features x 50 sieves, 5.4e10, take about 1.6 ms at the
// float32 rate, and reading W's 4 GiB 1.3 ms.  This kernel evaluates phi
// at every term, as if W were dense (13 ms of special functions at that
// size), so it reaches only a few hundredths of that bound; skipping the
// zeros' phi is left for a later design.  Facility location costs a max
// and an add per (sieve, element, served row): 2.1e11 at 2^16 x 2^16 x 50
// (13 ms against 5 ms for sim's 16 GiB), 3.4e12 at 2^18 x 2^18 x 50
// (0.2 s).
//
// What the design does about it: a block of 256 threads owns 8 sieves x 256
// elements and one slab of l, and walks it in tiles of 32, staging the tile
// of S (8 x 32) and of
// E (32 x 256, upcast as read: rows of W along l, columns of sim along c)
// in shared memory; each thread keeps 2 sieves x 4 elements in registers,
// so a leaf costs it 8 shared loads (with w_l and the cap) for 8 terms.  The tree needs no stack:
// a segment is one tile.  fl_common.cuh's probe x candidate tile does not
// fit: it sums the hinge max(e - s, 0) in row order, and the sieve needs
// the literal form in this fixed tree order.  The slabs are the grid's z:
// 51 sieves x 1025 elements is 35 tiles, which would leave most of the 132
// SMs idle over 2^18 served rows, and 64 slabs make it 2240 blocks; with
// more than one slab each block writes its slab's sums to a scratch
// [slab][sieve][element] and sieve_gains_finish adds them in slab order (no
// atomics: the bits do not depend on scheduling).  A per-row start skips the
// columns a sieve has passed (a block whose columns all lie before its rows'
// starts returns at once), so a round recomputes only what the sieves that
// changed still need.  A simple kernel, right first: 8 loads a leaf leave
// the facility-location table short of the add/max rate.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int NT = 256;           // threads per block
constexpr int TRT = 4;            // threads along sieves
constexpr int TCT = NT / TRT;     // threads along elements (64)
constexpr int RT = 2;             // sieves per thread
constexpr int CT = 4;             // elements per thread
constexpr int BR = TRT * RT;      // sieves per block (8)
constexpr int BC = TCT * CT;      // elements per block (256)
constexpr int LK = 32;            // leaves per tile (one segment)
constexpr long long SLAB = 128 * LK;  // leaves per slab: kernels/ref.py SIEVE_SLAB
constexpr int SROW = BR + 1;      // padded shared rows: no bank conflicts
constexpr int EROW = BC + 1;      // on the transposing stores

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
template <int KIND, bool FL, bool COLS>
__global__ void __launch_bounds__(NT) sieve_gains_kernel(
    const float* __restrict__ S, int R, long long L,
    const float* __restrict__ E, long long ld, long long n_e,
    const long long* __restrict__ idx, int n_cols,
    const long long* __restrict__ start, const float* __restrict__ fw,
    const float* __restrict__ cap, float* __restrict__ partial,
    float* __restrict__ out) {
  __shared__ float Ss[LK][SROW];
  __shared__ float Es[LK][EROW];
  __shared__ float Ws[LK];
  __shared__ float Cs[LK];
  __shared__ long long cols[BC];
  __shared__ int skip;

  const int tid = threadIdx.x;
  const int tr = tid / TCT;
  const int tc = tid % TCT;
  const int r0 = blockIdx.y * BR;
  const long long c0 = static_cast<long long>(blockIdx.x) * BC;

  // The block's elements, and whether every one of them lies before the
  // start of every one of its rows.
  if (tid == 0) {
    long long first = start ? start[r0] : 0;
    for (int r = 1; r < BR && r0 + r < R; ++r)
      first = min(first, start ? start[r0 + r] : 0LL);
    skip = c0 + BC <= first;
  }
  __syncthreads();
  for (int c = tid; c < BC; c += NT) {
    const long long col = c0 + c;
    long long e = -3;                       // past the end
    if (col < n_cols) {
      e = idx[col];
      if (e < -1 || e >= n_e) e = -2;       // bad index: NaN
      if (e == -1) skip = 0;                // the zero element is always due
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
  for (long long l0 = lo; l0 < hi; l0 += LK) {
    // stage S: 8 rows x 32 leaves, one value a thread
    {
      const int r = tid / LK, l = tid % LK;
      const bool ok = r0 + r < R && l0 + l < L;
      Ss[l][r] = ok ? S[static_cast<long long>(r0 + r) * L + l0 + l] : 0.f;
    }
    if (tid < LK) {
      const bool ok = l0 + tid < L;
      Ws[tid] = ok ? (fw ? fw[l0 + tid] : 1.f) : 0.f;
      Cs[tid] = ok && cap ? cap[l0 + tid] : 0.f;
    }
    // stage E: 32 leaves x 256 elements
    if constexpr (COLS) {
      // along the elements: consecutive threads, consecutive columns
      const long long e = cols[tid];
      for (int l = 0; l < LK; ++l) {
        float v = 0.f;
        if (e >= 0 && l0 + l < L) v = E[(l0 + l) * ld + e];
        Es[l][tid] = v;
      }
    } else {
      // along the leaves: a warp reads 32 consecutive features of one row
      const int l = tid % LK;
      for (int c = tid / LK; c < BC; c += NT / LK) {
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
    for (int q = 0; q < LK / 8; ++q) {
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
      if (e == -3) continue;
      if (e == -2) {
        dst[static_cast<long long>(r) * n_cols + c] = __int_as_float(0x7fc00000);
      } else if (e == -1 || c >= first) {
        dst[static_cast<long long>(r) * n_cols + c] = acc[i][j];
      }
    }
  }
}

// out = the slabs' sums added in slab order from 0.  An entry a block
// skipped (before its row's start) sums whatever the scratch holds there:
// unspecified, as the kernel leaves it.
__global__ void sieve_gains_finish(const float* __restrict__ partial, int slabs,
                                   long long entries, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= entries) return;
  float s = 0.f;
  for (int z = 0; z < slabs; ++z) s = __fadd_rn(s, partial[z * entries + i]);
  out[i] = s;
}

}  // namespace

extern "C" int sieve_gains_launch(const float* S, int R, long long L, const float* E,
                                  int e_cols, long long ld, long long n_e,
                                  const long long* idx, int n_cols,
                                  const long long* start, int fl, int phi_kind,
                                  const float* fw, const float* cap, float* partial,
                                  float* out, void* stream) {
  if (R <= 0 || n_cols <= 0) return 0;
  const long long slabs = (L + SLAB - 1) / SLAB;
  if (L < 1 || slabs > 65535 || (slabs > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n_cols + BC - 1) / BC),
                  static_cast<unsigned>((R + BR - 1) / BR),
                  static_cast<unsigned>(slabs));
  const auto s = static_cast<cudaStream_t>(stream);
  float* part = slabs > 1 ? partial : nullptr;
  auto go = [&](auto kernel) {
    kernel<<<grid, NT, 0, s>>>(S, R, L, E, ld, n_e, idx, n_cols, start, fw, cap, part,
                               out);
  };
  if (fl) {
    if (e_cols) go(sieve_gains_kernel<0, true, true>);
    else go(sieve_gains_kernel<0, true, false>);
  } else {
    const bool known = repro::dispatch_kind<float>(phi_kind, [&](auto, auto k) {
      constexpr int KIND = decltype(k)::value;
      if (e_cols) go(sieve_gains_kernel<KIND, false, true>);
      else go(sieve_gains_kernel<KIND, false, false>);
    });
    if (!known) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (slabs > 1) {
    const long long entries = static_cast<long long>(R) * n_cols;
    const unsigned blocks = static_cast<unsigned>((entries + 255) / 256);
    sieve_gains_finish<<<blocks, 256, 0, s>>>(partial, static_cast<int>(slabs), entries,
                                              out);
  }
  return static_cast<int>(cudaGetLastError());
}
