// Shared pieces of the kernels: the concave transforms phi of
// FeatureCoverage, the float32 upcast of an input element, vector loads, the
// host-side dispatch from the runtime (W dtype, phi kind) pair to a
// FeatureCoverage kernel template instance, and the candidate lookup.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace repro {

// Must match PHI_CODES in repro_torch/kernels/_build.py.
enum PhiKind {
  PHI_SQRT = 0,
  PHI_LOG1P = 1,
  PHI_SETCOVER = 2,
  PHI_SATCOV = 3,
  PHI_LINEAR = 4,
};

// The plain versions use 1e30 as +INF (a finite value that min chains
// cannot turn into NaN); the kernels keep the same constant.
constexpr float kInf = 1e30f;

template <int KIND>
__device__ __forceinline__ float phi(float c, float cap) {
  if constexpr (KIND == PHI_SQRT) {
    // One special-function instruction, MUFU.SQRT (max error about 1 ulp).
    // The IEEE sqrtf takes a fix-up branch at 0, where most arguments of a
    // TF-IDF row lie; .ftz takes a subnormal argument (below 1.2e-38) as 0,
    // which drops the compare and two multiplies that scale one around the
    // MUFU (measured in PERF.md).
    float r;
    asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(fmaxf(c, 0.f)));
    return r;
  } else if constexpr (KIND == PHI_LOG1P) {
    return log1pf(fmaxf(c, 0.f));
  } else if constexpr (KIND == PHI_SETCOVER) {
    return fminf(c, 1.f);
  } else if constexpr (KIND == PHI_SATCOV) {
    return fminf(c, cap);
  } else {
    return c;
  }
}

// One term of the coverage difference form, acc + fw (phi(c + w) - phi(c)),
// with phic = phi<KIND>(c, cap) from the same instruction: the term is
// exactly 0 at w = 0, so a sum over a row's nonzeros in feature order is
// bitwise the sum over all its features.  Each step rounds on its own
// (no contraction), so every kernel that sums these terms in the same order
// gets the same bits.
template <int KIND>
__device__ __forceinline__ float coverage_step(float acc, float fw, float c,
                                               float phic, float w, float cap) {
  return __fmaf_rn(fw, __fsub_rn(phi<KIND>(__fadd_rn(c, w), cap), phic), acc);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four consecutive elements as float32, in one 16-byte (float) or 8-byte
// (bf16) load: p must be aligned to four elements.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T>
struct TypeTag {
  using type = T;
};

// Calls fn(TypeTag<T>{}, std::integral_constant<int, KIND>{}) for the W
// element type and phi kind given at run time.  False for an unknown kind.
template <typename T, typename Fn>
inline bool dispatch_kind(int kind, Fn&& fn) {
  switch (kind) {
    case PHI_SQRT:
      fn(TypeTag<T>{}, std::integral_constant<int, PHI_SQRT>{});
      return true;
    case PHI_LOG1P:
      fn(TypeTag<T>{}, std::integral_constant<int, PHI_LOG1P>{});
      return true;
    case PHI_SETCOVER:
      fn(TypeTag<T>{}, std::integral_constant<int, PHI_SETCOVER>{});
      return true;
    case PHI_SATCOV:
      fn(TypeTag<T>{}, std::integral_constant<int, PHI_SATCOV>{});
      return true;
    case PHI_LINEAR:
      fn(TypeTag<T>{}, std::integral_constant<int, PHI_LINEAR>{});
      return true;
    default:
      return false;
  }
}

template <typename Fn>
inline bool dispatch(int w_bf16, int kind, Fn&& fn) {
  return w_bf16 ? dispatch_kind<__nv_bfloat16>(kind, fn)
                : dispatch_kind<float>(kind, fn);
}

// Candidate behind output slot `slot` (a row of W or Xc, a column of sim):
// the slot itself, or cand_idx[slot].  -1 past the end of the output; -2
// for an index outside the n_rows candidates (the kernels write NaN there
// instead of reading out of bounds).
__device__ __forceinline__ long long row_of(const long long* cand_idx,
                                            long long slot, long long n_out,
                                            long long n_rows) {
  if (slot >= n_out) return -1;
  long long row = cand_idx ? cand_idx[slot] : slot;
  return (row < 0 || row >= n_rows) ? -2 : row;
}

}  // namespace repro
