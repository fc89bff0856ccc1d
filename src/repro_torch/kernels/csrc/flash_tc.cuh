// What the tensor-core flash kernels share (flash_attention_tc.cu, the
// forward; flash_attention_bwd_tc.cu, the backward), for Hopper (sm_90a):
// mbarriers, TMA loads and their tensor maps, shared-memory matrix
// descriptors with the 128-byte swizzle, and the bf16 wgmma products with
// float32 accumulators.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro::tc {

// -- mbarriers, TMA and bulk copies -------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Until the phase of the given parity has completed.  A wait takes
// microseconds; one that lasts 10 s (a load that never lands) traps, so a
// fault in the pipeline ends the launch with an error instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = global_ns();
    } else if (global_ns() - start > 10000000000ull) {
      __trap();
    }
  }
}

// The same for every lane of a consumer warp, which leaves the wait
// converged for the warp-wide instructions that follow (wgmma, shuffles).
__device__ __forceinline__ void warp_wait(uint32_t bar, uint32_t parity) {
  mbar_wait(bar, parity);
  __syncwarp();
}

// One box of a 4-D tensor map (hd, heads, S, B) into shared memory;
// completion is counted in bytes on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory; completion is counted in bytes on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// -- wgmma --------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle, for an operand of
// 128-byte rows (64 bf16): start address, stride byte offset 1024 (the next
// 8 rows: of M or N for an operand K-major, of K for one MN-major).  The
// leading byte offset (one 16-byte unit) is not read: no operand here is
// wider than one 64-column chunk.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep a register's value where wgmma reads or writes it until here: the
// compiler must not move or reuse it across the asynchronous product.
__device__ __forceinline__ void keep(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void keep(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

#define D8(i)                                                               \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define D_REGS                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64, float32) (+)= A (64 x 16, K-major in shared memory) ·
// B (16 x 64, K-major in shared memory).
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " D_REGS
      ", %32, %33, p, 1, 1, 0, 0;\n}"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, float32) (+)= A (64 x 16, bf16 pairs in registers) ·
// B (16 x 64, MN-major in shared memory).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " D_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x 32, float32) (+)= A (64 x 16, K-major in shared memory) ·
// B (16 x 32, K-major in shared memory).
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t da, uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, 0, 0;\n}"
      : D8(0), D8(8)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef D8
#undef D_REGS

template <int N>
__device__ __forceinline__ void keep_all(float (&x)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) keep(x[e]);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// -- host side --------------------------------------------------------------------

// cuTensorMapEncodeTiled lives in libcuda; it is fetched through the runtime
// so that the library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of one (B, S, heads, hd) bfloat16 tensor with element strides
// (sb, ss, sh, 1): boxes of 64 features x 1 head x rows positions, 128-byte
// swizzle, zeros past the edge.  The encoder is a libcuda call that needs a
// context current on the calling thread, which a thread that has made no
// runtime call yet lacks (autograd's backward thread, whose allocations
// came from the cache): cudaSetDevice makes the current device's primary
// context current first.
inline bool make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int S, int B,
              long long sb, long long ss, long long sh, int rows) {
  const EncodeTiled encode = encode_tiled();
  int device = 0;
  if (encode == nullptr || cudaGetDevice(&device) != cudaSuccess ||
      cudaSetDevice(device) != cudaSuccess)
    return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace repro::tc
