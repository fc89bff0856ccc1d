// Greedy gains of FeatureCoverage, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/feature_gains.py:feature_gains_kernel (the
// Pallas TPU kernel, body _feature_gains_kernel).
//
// Computes, for every candidate v (all rows of W, or the rows cand_idx
// names), in the difference form:
//   out[v] = sum_{f : W[v, f] != 0} w_f (phi(c[f] + W[v, f]) - phi(c[f])) + T
//   T      = sum_f w_f phi(c[f]) - phi_c
// which is the Pallas kernel's sum_f w_f phi(c + W[v]) - phi_c for any phi_c
// (a device scalar, so a greedy step never waits on the host): phi(c) and
// phi(c + W) come from the same instruction (repro::coverage_step), so a
// zero of W adds exactly 0 and costs no special function.
//
// What bounds it on this card: bytes.  Each element of W is read once and
// costs a compare; the nonzeros (about 1% of a TF-IDF row) cost a handful of
// operations each.  One read of the rows is the floor: 4 GiB at full width
// (greedy on V, n = 2^20, F = 1024), 8 MB over V' (2048 slots).
//
// What the design does about it: one warp per row, lanes striding along the
// feature axis so each warp's loads are contiguous lines of the row-major W:
// four elements per lane in one vector load when F is a multiple of 4 and W
// is aligned, one element per lane otherwise.  A block of 8 warps takes 8
// rows, so V' (2048 slots) fills 256 blocks, about two for each of the 132
// SMs, and full width 131072.  Each block stages c, phi(c), the caps and the
// feature weights in shared memory in chunks of 1024 features, and sums its
// own copy of T from them in a fixed order (1024 phi a block; every block
// gets the same bits).  W is read in place through cand_idx, never gathered
// or padded; the partial sums are reduced across the warp with shuffles.
// Four rows a warp (the first design's shape) ran slower, also at full
// width, and so did a grid of one block per SM slot striding over the rows
// and staging once a block.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int WARPS = 8;            // warps (rows) per block
constexpr int NT = 32 * WARPS;      // threads per block
constexpr int FCH = 1024;           // features staged per chunk

template <typename T, int KIND, bool VEC>
__global__ void __launch_bounds__(NT) feature_gains_kernel(
    const T* __restrict__ W, long long n_rows, int F,
    const long long* __restrict__ cand_idx, long long n_out,
    const float* __restrict__ c, const float* __restrict__ phi_c,
    const float* __restrict__ cap, const float* __restrict__ fw,
    float* __restrict__ out) {
  __shared__ __align__(16) float cs[FCH];
  __shared__ __align__(16) float pcs[FCH];
  __shared__ __align__(16) float ws[FCH];
  __shared__ __align__(16) float caps[FCH];
  __shared__ float part[WARPS];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long slot = static_cast<long long>(blockIdx.x) * WARPS + warp;
  const long long row = repro::row_of(cand_idx, slot, n_out, n_rows);
  float acc = 0.f;
  float t = 0.f;  // this thread's part of sum_f w_f phi(c[f])

  for (int f0 = 0; f0 < F; f0 += FCH) {
    const int nf = min(FCH, F - f0);
    for (int f = threadIdx.x; f < nf; f += NT) {
      const float cf = c[f0 + f];
      const float wf = fw ? fw[f0 + f] : 1.f;
      const float capf = cap ? cap[f0 + f] : 0.f;
      const float pf = repro::phi<KIND>(cf, capf);
      cs[f] = cf;
      pcs[f] = pf;
      ws[f] = wf;
      caps[f] = capf;
      t = __fmaf_rn(wf, pf, t);
    }
    __syncthreads();
    if (row >= 0) {
      const T* src = W + row * F + f0;
      if constexpr (VEC) {
        // nf is a multiple of 4 here: F is, and so is FCH.
#pragma unroll 4
        for (int f = 4 * lane; f < nf; f += 4 * 32) {
          const float4 x = repro::load4(src + f);
          const float4 cf = *reinterpret_cast<const float4*>(&cs[f]);
          const float4 pf = *reinterpret_cast<const float4*>(&pcs[f]);
          const float4 wf = *reinterpret_cast<const float4*>(&ws[f]);
          const float4 capf = *reinterpret_cast<const float4*>(&caps[f]);
          if (x.x != 0.f)
            acc = repro::coverage_step<KIND>(acc, wf.x, cf.x, pf.x, x.x, capf.x);
          if (x.y != 0.f)
            acc = repro::coverage_step<KIND>(acc, wf.y, cf.y, pf.y, x.y, capf.y);
          if (x.z != 0.f)
            acc = repro::coverage_step<KIND>(acc, wf.z, cf.z, pf.z, x.z, capf.z);
          if (x.w != 0.f)
            acc = repro::coverage_step<KIND>(acc, wf.w, cf.w, pf.w, x.w, capf.w);
        }
      } else {
#pragma unroll 4
        for (int f = lane; f < nf; f += 32) {
          const float x = repro::to_f32(src[f]);
          if (x != 0.f)
            acc = repro::coverage_step<KIND>(acc, ws[f], cs[f], pcs[f], x, caps[f]);
        }
      }
    }
    __syncthreads();
  }

  // T: the block's sum over its threads in a fixed order, so every block
  // gets the same bits.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    t += __shfl_xor_sync(kFull, t, off);
    acc += __shfl_xor_sync(kFull, acc, off);
  }
  if (lane == 0) part[warp] = t;
  __syncthreads();
  if (lane == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += part[w];
    const float offset = __fsub_rn(sum, *phi_c);  // T
    if (row == -2) {
      out[slot] = __int_as_float(0x7fc00000);
    } else if (row >= 0) {
      out[slot] = __fadd_rn(acc, offset);
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
  const dim3 grid(static_cast<unsigned>((n_out + WARPS - 1) / WARPS));
  const size_t elem = w_bf16 ? 2 : 4;
  const bool vec =
      F % 4 == 0 && reinterpret_cast<uintptr_t>(W) % (4 * elem) == 0;
  const bool known = repro::dispatch(w_bf16, phi_kind, [&](auto t, auto k) {
    using T = typename decltype(t)::type;
    constexpr int KIND = decltype(k)::value;
    auto kernel = vec ? feature_gains_kernel<T, KIND, true>
                      : feature_gains_kernel<T, KIND, false>;
    kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(W), n_rows, F, cand_idx, n_out, c, phi_c, cap, fw,
        out);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
