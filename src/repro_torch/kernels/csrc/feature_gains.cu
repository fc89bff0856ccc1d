// Greedy gains of FeatureCoverage, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/feature_gains.py:feature_gains_kernel (the
// Pallas TPU kernel, body _feature_gains_kernel).
//
// Computes, for every candidate v (all rows of W, or the rows cand_idx
// names):
//   out[v] = sum_f w_f * phi(c[f] + W[v, f]) - phi_c
// with phi_c = sum_f w_f * phi(c[f]) handed in as a device scalar, so a
// greedy step never waits on the host.
//
// What bounds it on this card: bytes.  Each element of W is read once and
// costs a handful of operations, far below the card's ops-per-byte line:
// one read of W (4 GiB at n = 2^20, F = 1024) is the floor.
//
// What the design does about it: one warp per row, four rows per warp in
// flight, lanes striding along the feature axis so each warp's loads are
// contiguous lines of the row-major W: four elements per lane in one vector
// load when F is a multiple of 4 and W is aligned (512 bytes a warp for
// float32), one element per lane otherwise.  The coverage row c, the
// caps and the feature weights are staged in shared memory in chunks of
// 1024 features and shared by the block's 32 rows.  W is read in place
// through cand_idx, never gathered or padded; the partial sums are reduced
// across the warp with shuffles.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;            // warps per block
constexpr int NT = 32 * WARPS;      // threads per block
constexpr int RPW = 4;              // rows per warp
constexpr int ROWS = WARPS * RPW;   // rows per block
constexpr int FCH = 1024;           // features staged per chunk

template <typename T, int KIND, bool VEC>
__global__ void __launch_bounds__(NT) feature_gains_kernel(
    const T* __restrict__ W, long long n_rows, int F,
    const long long* __restrict__ cand_idx, long long n_out,
    const float* __restrict__ c, const float* __restrict__ phi_c,
    const float* __restrict__ cap, const float* __restrict__ fw,
    float* __restrict__ out) {
  __shared__ __align__(16) float cs[FCH];
  __shared__ __align__(16) float ws[FCH];
  __shared__ __align__(16) float caps[FCH];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long s0 = static_cast<long long>(blockIdx.x) * ROWS + warp * RPW;

  long long row[RPW];
  float acc[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    row[i] = repro::row_of(cand_idx, s0 + i, n_out, n_rows);
    acc[i] = 0.f;
  }

  for (int f0 = 0; f0 < F; f0 += FCH) {
    const int nf = min(FCH, F - f0);
    for (int f = threadIdx.x; f < nf; f += NT) {
      cs[f] = c[f0 + f];
      ws[f] = fw ? fw[f0 + f] : 1.f;
      caps[f] = cap ? cap[f0 + f] : 0.f;
    }
    __syncthreads();
    if constexpr (VEC) {
      // nf is a multiple of 4 here: F is, and so is FCH.
      for (int f = 4 * lane; f < nf; f += 4 * 32) {
        const float4 cf = *reinterpret_cast<const float4*>(&cs[f]);
        const float4 wf = *reinterpret_cast<const float4*>(&ws[f]);
        const float4 capf = *reinterpret_cast<const float4*>(&caps[f]);
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          if (row[i] >= 0) {
            const float4 x = repro::load4(W + row[i] * F + f0 + f);
            acc[i] += wf.x * repro::phi<KIND>(cf.x + x.x, capf.x);
            acc[i] += wf.y * repro::phi<KIND>(cf.y + x.y, capf.y);
            acc[i] += wf.z * repro::phi<KIND>(cf.z + x.z, capf.z);
            acc[i] += wf.w * repro::phi<KIND>(cf.w + x.w, capf.w);
          }
        }
      }
    } else {
      for (int f = lane; f < nf; f += 32) {
        const float cf = cs[f];
        const float wf = ws[f];
        const float capf = caps[f];
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          if (row[i] >= 0) {
            const float x = repro::to_f32(W[row[i] * F + f0 + f]);
            acc[i] += wf * repro::phi<KIND>(cf + x, capf);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  if (lane == 0) {
    const float base = *phi_c;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      if (row[i] == -2) {
        out[s0 + i] = __int_as_float(0x7fc00000);
      } else if (row[i] >= 0) {
        out[s0 + i] = acc[i] - base;
      }
    }
  }
}

}  // namespace

extern "C" int feature_gains_launch(
    const void* W, int w_bf16, long long n_rows, int F,
    const long long* cand_idx, long long n_out, const float* c,
    const float* phi_c, const float* cap, const float* fw, int phi_kind,
    float* out, void* stream) {
  if (n_out <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((n_out + ROWS - 1) / ROWS));
  const size_t elem = w_bf16 ? 2 : 4;
  const bool vec =
      F % 4 == 0 && reinterpret_cast<uintptr_t>(W) % (4 * elem) == 0;
  const bool known = repro::dispatch(w_bf16, phi_kind, [&](auto t, auto k) {
    using T = typename decltype(t)::type;
    constexpr int KIND = decltype(k)::value;
    const auto s = static_cast<cudaStream_t>(stream);
    if (vec) {
      feature_gains_kernel<T, KIND, true><<<grid, NT, 0, s>>>(
          static_cast<const T*>(W), n_rows, F, cand_idx, n_out, c, phi_c,
          cap, fw, out);
    } else {
      feature_gains_kernel<T, KIND, false><<<grid, NT, 0, s>>>(
          static_cast<const T*>(W), n_rows, F, cand_idx, n_out, c, phi_c,
          cap, fw, out);
    }
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
