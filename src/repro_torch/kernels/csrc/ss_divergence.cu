// SS divergence of FeatureCoverage, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ss_weights.py:ss_divergence_kernel (the
// Pallas TPU kernel, body _ss_divergence_kernel).
//
// Computes, for every candidate v (all rows of W, or the rows cand_idx
// names):
//   out[v] = min_u [ sum_f w_f * phi(CU[u, f] + W[v, f]) - phi_cu[u] - resid[u] ]
// A pad probe carries phi_cu = -INF, so its term is +INF and never wins.
//
// What bounds it on this card: operations.  phi is nonlinear, so the
// (probe x candidate x feature) work is CUDA-core arithmetic, not a matrix
// product (wgmma does not apply); for sqrt and log1p each element also costs
// a special-function instruction.  At the main path's first round
// (n = 2^20 candidates, r = 160 probes, F = 1024) that is 1.7e11 elements
// against one 4 GiB read of W, far above the card's ops-per-byte line.
//
// What the design does about it:
//   - a block owns 128 candidates and walks the probes in passes of 32;
//     each of its 256 threads keeps a 4 probe x 4 candidate tile of partial
//     sums in registers, so every shared-memory read feeds four phi
//     evaluations;
//   - W and CU arrive in 32-feature chunks through shared memory (float32,
//     bf16 W upcast on load), read coalesced along the feature axis and
//     stored transposed with one word of padding so the inner loop reads
//     are free of bank conflicts;
//   - the min over probes happens here, pass by pass, so no (r, n) or
//     (r, n, F) intermediate ever reaches device memory; W is read in place
//     through cand_idx, never padded or copied, and the ragged edges of n,
//     F and r are masked inside the kernel (padded features carry weight 0).
// W is re-read once per probe pass (5 passes at r = 160): 20 GB of traffic,
// still a few times below the arithmetic time.

#include "common.cuh"

namespace {

using repro::kInf;

constexpr int TX = 32;         // threads along candidates
constexpr int TY = 8;          // threads along probes
constexpr int CPT = 4;         // candidates per thread
constexpr int PPT = 4;         // probes per thread
constexpr int BC = TX * CPT;   // candidates per block
constexpr int BP = TY * PPT;   // probes per pass
constexpr int FK = 32;         // features per shared-memory chunk
constexpr int NT = TX * TY;    // threads per block

template <typename T, int KIND>
__global__ void __launch_bounds__(NT) ss_divergence_kernel(
    const T* __restrict__ W, long long n_rows, int F,
    const long long* __restrict__ cand_idx, long long n_out,
    const float* __restrict__ CU, const float* __restrict__ phi_cu,
    const float* __restrict__ resid, int r, const float* __restrict__ cap,
    const float* __restrict__ fw, float* __restrict__ out) {
  __shared__ float Ws[FK][BC + 1];
  __shared__ float Cs[FK][BP + 1];
  __shared__ float fws[FK];
  __shared__ float caps[FK];
  __shared__ long long rows[BC];
  __shared__ float red[TY][BC];
  __shared__ float best[BC];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const long long c0 = static_cast<long long>(blockIdx.x) * BC;

  for (int i = tid; i < BC; i += NT) {
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
      for (int e = tid; e < BC * FK; e += NT) {
        const int ci = e / FK;
        const int f = e % FK;
        const long long row = rows[ci];
        float v = 0.f;
        if (row >= 0 && f0 + f < F) v = repro::to_f32(W[row * F + f0 + f]);
        Ws[f][ci] = v;
      }
      for (int e = tid; e < BP * FK; e += NT) {
        const int pi = e / FK;
        const int f = e % FK;
        const int p = p0 + pi;
        Cs[f][pi] = (p < r && f0 + f < F)
                        ? CU[static_cast<long long>(p) * F + f0 + f]
                        : 0.f;
      }
      if (tid < FK) {
        const bool in = f0 + tid < F;
        fws[tid] = in ? (fw ? fw[f0 + tid] : 1.f) : 0.f;
        caps[tid] = (in && cap) ? cap[f0 + tid] : 0.f;
      }
      __syncthreads();

#pragma unroll 8
      for (int f = 0; f < FK; ++f) {
        float wv[CPT], cv[PPT];
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
            acc[j][i] += w_f * repro::phi<KIND>(cv[j] + wv[i], cap_f);
      }
      __syncthreads();
    }

    // Min over this pass's probes: per thread, then across the TY threads
    // that share a candidate, folded into the running min.
    float m[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) m[i] = kInf;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int p = p0 + ty + TY * j;
      if (p < r) {
        const float base = phi_cu[p];
        const float rs = resid[p];
#pragma unroll
        for (int i = 0; i < CPT; ++i)
          m[i] = fminf(m[i], (acc[j][i] - base) - rs);
      }
    }
#pragma unroll
    for (int i = 0; i < CPT; ++i) red[ty][tx + TX * i] = m[i];
    __syncthreads();
    for (int ci = tid; ci < BC; ci += NT) {
      float b = best[ci];
#pragma unroll
      for (int y = 0; y < TY; ++y) b = fminf(b, red[y][ci]);
      best[ci] = b;
    }
    __syncthreads();
  }

  for (int ci = tid; ci < BC; ci += NT) {
    const long long row = rows[ci];
    if (row != -1) out[c0 + ci] = row == -2 ? __int_as_float(0x7fc00000) : best[ci];
  }
}

}  // namespace

extern "C" int ss_divergence_launch(
    const void* W, int w_bf16, long long n_rows, int F,
    const long long* cand_idx, long long n_out, const float* CU,
    const float* phi_cu, const float* resid, int r, const float* cap,
    const float* fw, int phi_kind, float* out, void* stream) {
  if (n_out <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((n_out + BC - 1) / BC));
  const bool known = repro::dispatch(w_bf16, phi_kind, [&](auto t, auto k) {
    using T = typename decltype(t)::type;
    constexpr int KIND = decltype(k)::value;
    ss_divergence_kernel<T, KIND><<<grid, NT, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(W), n_rows, F, cand_idx, n_out, CU, phi_cu,
        resid, r, cap, fw, out);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
