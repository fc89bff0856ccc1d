// Fused online-softmax attention (prefill) on Hopper's tensor cores, for
// bfloat16 inputs at head_dim 64 and 128 (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention (the Pallas
// TPU kernel, body _flash_kernel) on the route that kernels/flash_attention.py
// calls "tc"; float32 inputs and other head widths stay on the CUDA-core
// kernel in flash_attention.cu.
//
// Computes what the TPU kernel computes, for every (batch b, query head h,
// query position i), with K and V read from KV head h / G in place:
//   O[i] = sum_j p_ij V[j] / max(sum_j p_ij, 1e-30),
//   s_ij = (Q[i] . K[j]) * scale where the mask keeps (i, j), else -1e30,
// the mask keeping j < S and, when causal, i >= j and (window > 0)
// i - j < window.  The running max starts at the finite -1e30 and the
// recurrence is the TPU kernel's, tile by tile: m' = max(m, max_j s),
// alpha = exp(m - m'), l' = l alpha + sum_j p, acc' = acc alpha + P V with
// P V summed afresh for the tile.  Exponentials are taken as 2^x on scores
// pre-multiplied by log2(e).  O is written in bfloat16.
//
// Arithmetic.  q and k are bfloat16, so each product q_d k_d is exact in
// float32: QKᵀ on the bf16 tensor cores with float32 sums is the TPU
// kernel's function up to summation order.  P is float32 and must stay so
// (rounding it to bf16 once, as scaled_dot_product_attention does, is a
// different result).  Each p is split into PARTS = 3 bf16 parts,
//   hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid),
// each subtraction exact in float32, together 24 significant bits, and a
// tile's P V is one wgmma per part into one fresh float32 accumulator,
// which is then added to O in IEEE float32 (acc alpha + tile, one FMA): the
// tensor cores accumulate 12 steps of 16 products a tile, never a whole row.
//
// What bounds it on this card: the tensor cores.  Each unmasked (i, j) pair
// costs 2 hd flops for QKᵀ and 2 hd PARTS for P V at 989 TFLOP/s, and one
// exponential; at B = 4, S = 2048, H = 32, hd = 128, causal, that is 0.278
// ms, against 0.05 ms for the bytes of q, k, v and o.
//
// What the design does about it: one CTA per (b, h, 128-row query tile),
// heavy (late) causal tiles launched first; a producer warpgroup (one
// thread issues every load; its registers go to the consumers with
// setmaxnreg) and two consumer warpgroups of 64 query rows each.  The
// producer loads the Q tile once and streams 64-key tiles of K and V
// through a ring of STAGES shared-memory slots with TMA (128-byte swizzle,
// zero fill past S, the KV head chosen by the tensor map's head
// coordinate), each slot with its own K-full, V-full and empty mbarriers.
// A consumer warpgroup's iteration i issues S(i) = Q K(i)ᵀ (both operands
// K-major in shared memory) and P(i-1) V(i-1) (A = P's parts from
// registers, whose layout is the accumulator's; V MN-major in shared
// memory) back to back, in its turn at the tensor cores: the two
// warpgroups take turns through named barriers, so one's products run
// while the other scales, masks and runs the online softmax on its score
// fragments in registers (a row's max over the 4 threads of a quad by
// shuffles; the row sum kept per thread, reduced once at the end) and
// splits P.  Tiles wholly above the diagonal or outside the window of the
// whole CTA are not loaded; a tile wholly masked for one warpgroup's rows
// is computed all the same (its p are 0, or wiped by alpha = 0 when the
// rows' first real key arrives, as in the TPU kernel), so that no wgmma
// sits in a divergent branch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 128;           // query rows per CTA (two warpgroups)
constexpr int BK = 64;            // keys per tile
constexpr int STAGES = 4;         // K/V ring depth
constexpr int PARTS = 3;          // bf16 parts of P
constexpr int NCONS = 256;        // consumer threads
constexpr int NT = NCONS + 128;   // and one producer warpgroup
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle's
// period): the Q tile, then STAGES K tiles, STAGES V tiles, the barriers.
// Every tile is stored as hd / 64 column chunks of rows x 128 bytes.
template <int HD>
struct Smem {
  static constexpr int CH = HD / 64;
  static constexpr uint32_t q_bytes = CH * BQ * 128;
  static constexpr uint32_t kv_bytes = CH * BK * 128;
  static constexpr uint32_t k_off = q_bytes;
  static constexpr uint32_t v_off = k_off + STAGES * kv_bytes;
  static constexpr uint32_t bar_off = v_off + STAGES * kv_bytes;
  static constexpr size_t bytes = bar_off + 8 * (1 + 3 * STAGES) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers and TMA --------------------------------------------------------

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

// -- wgmma --------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle, for an operand of
// 128-byte rows (64 bf16): start address, stride byte offset 1024 (the next
// 8 rows: the next 8 keys or query rows K-major, the next 8 keys of V
// MN-major).  The leading byte offset (one 16-byte unit) is not read: no
// operand here is wider than one 64-column chunk.
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

#undef D8
#undef D_REGS

template <int N>
__device__ __forceinline__ void keep_all(float (&x)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) keep(x[e]);
}

// The registers of an in-flight P V: its accumulator and P's parts.
template <int CH>
__device__ __forceinline__ void keep_operands(float (&tile)[CH][32],
                                              uint32_t (&pa)[PARTS][BK / 16][4]) {
#pragma unroll
  for (int c = 0; c < CH; ++c) keep_all(tile[c]);
#pragma unroll
  for (int part = 0; part < PARTS; ++part)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) keep(pa[part][kk][j]);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// -- the consumer's steps ---------------------------------------------------------

// Issue S = Q Kᵀ for one 64-key tile: hd / 16 steps of 16 features, both
// operands K-major in shared memory (the 16 features at 32-byte offsets
// inside a 128-byte swizzled row).
template <int HD>
__device__ __forceinline__ void qk(float (&sc)[32], uint32_t sQw, uint32_t sKs) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    mma_ss(sc, desc(sQw + (kk / 4) * BQ * 128 + off),
           desc(sKs + (kk / 4) * BK * 128 + off), kk > 0);
  }
}

// Issue tile = P V for one 64-key tile, summed afresh: one product per bf16
// part of P, per 16 keys, per 64-column chunk of V (MN-major in shared
// memory).
template <int CH>
__device__ __forceinline__ void pv(float (&tile)[CH][32],
                                   const uint32_t (&pa)[PARTS][BK / 16][4],
                                   uint32_t sVs) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int part = 0; part < PARTS; ++part)
        mma_rs(tile[c], pa[part][kk], desc(sVs + c * BK * 128 + kk * 16 * 128),
               kk > 0 || part > 0);
}

// O = O alpha + tile, in IEEE float32: the TPU kernel's acc alpha + P V.
template <int CH>
__device__ __forceinline__ void merge(float (&acc)[CH][32], const float (&alpha)[2],
                                      const float (&tile)[CH][32]) {
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e)
      acc[c][e] = fmaf(acc[c][e], alpha[(e >> 1) & 1], tile[c][e]);
}

// Scale, mask and the online softmax of one tile's scores, in place: sc
// becomes p = 2^(s - m'), m and l advance, alpha = 2^(m - m') for O.
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int k0, int qa, int r0, int cq, int S,
                                             int causal, int window,
                                             float scale_log2) {
  const bool full =
      k0 + BK <= S &&
      (!causal || (k0 + BK - 1 <= qa && (window == 0 || qa + 63 - k0 < window)));
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int r = (e >> 1) & 1;
    float x = sc[e] * scale_log2;
    if (!full) {
      const int key = k0 + 8 * (e >> 2) + cq + (e & 1);
      const int row = r0 + 8 * r;
      bool keepit = key < S;
      if (causal) {
        keepit = keepit && row >= key;
        if (window > 0) keepit = keepit && row - key < window;
      }
      x = keepit ? x : kNegInf;
    }
    sc[e] = x;
    mx[r] = fmaxf(mx[r], x);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    sc[e] = ex2(sc[e] - m[(e >> 1) & 1]);
    sum[(e >> 1) & 1] += sc[e];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// P in PARTS bf16 parts, as wgmma A fragments: pa[part][kk][4].
__device__ __forceinline__ void split(const float (&sc)[32],
                                      uint32_t (&pa)[PARTS][BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x0 = sc[8 * kk + 2 * j], x1 = sc[8 * kk + 2 * j + 1];
#pragma unroll
      for (int part = 0; part < PARTS; ++part) {
        const __nv_bfloat162 hb = __floats2bfloat162_rn(x0, x1);
        pa[part][kk][j] = bits(hb);
        const float2 back = __bfloat1622float2(hb);
        x0 -= back.x;    // exact: x0 and back.x share their leading bits
        x1 -= back.y;
      }
    }
}

// The turn at the tensor cores alternates between the two consumer
// warpgroups through named barriers 1 and 2 (barrier 1 + w is warpgroup w's
// turn): take waits for the other warpgroup's pass.
__device__ __forceinline__ void turn_take(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(NCONS) : "memory");
}
__device__ __forceinline__ void turn_pass(int to) {
  asm volatile("bar.arrive %0, %1;" ::"r"(1 + to), "n"(NCONS) : "memory");
}

// A consumer warp is done with a ring slot.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// -- the kernel -----------------------------------------------------------------
//
// Accumulator layout of a 64 x 64 wgmma result (32 floats a thread): thread
// t of the warpgroup, warp w = t / 32, lane l, holds d[4j + 2r + c] at row
// 16 w + l / 4 + 8 r, column 8 j + 2 (l % 4) + c.  The same registers,
// paired as bf16, are the A operand of a 64 x 16 wgmma for columns
// [16 kk, 16 kk + 16): {d[8kk], d[8kk+1]}, {d[8kk+2], d[8kk+3]},
// {d[8kk+4], d[8kk+5]}, {d[8kk+6], d[8kk+7]}.

// What one CTA works on: its shared-memory ring and barriers, its head and
// query tile, and the key tiles [kt_lo, kt_hi] its mask reaches.
template <int HD>
struct Cta {
  using L = Smem<HD>;
  uint32_t sQ, sK, sV, qbar;
  int b, h, q0, kt_lo, kt_hi;

  __device__ uint32_t kfull(int s) const { return qbar + 8u * (1 + s); }
  __device__ uint32_t vfull(int s) const { return qbar + 8u * (1 + STAGES + s); }
  __device__ uint32_t empty(int s) const { return qbar + 8u * (1 + 2 * STAGES + s); }
  __device__ uint32_t k_slot(int s) const { return sK + s * L::kv_bytes; }
  __device__ uint32_t v_slot(int s) const { return sV + s * L::kv_bytes; }
};

// The producer's one thread: the Q tile, then every K and V tile in turn,
// each into the next ring slot once both consumer warpgroups have freed it.
template <int HD>
__device__ __forceinline__ void produce(const Cta<HD>& t, const CUtensorMap* qmap,
                                        const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, int kvh) {
  using L = Smem<HD>;
  mbar_expect_tx(t.qbar, L::q_bytes);
  for (int c = 0; c < L::CH; ++c)
    tma_load(t.sQ + c * BQ * 128, qmap, t.qbar, 64 * c, t.h, t.q0, t.b);
  for (int kt = t.kt_lo, i = 0; kt <= t.kt_hi; ++kt, ++i) {
    const int s = i % STAGES;
    if (i >= STAGES) mbar_wait(t.empty(s), (i / STAGES - 1) & 1);
    mbar_expect_tx(t.kfull(s), L::kv_bytes);
    for (int c = 0; c < L::CH; ++c)
      tma_load(t.k_slot(s) + c * BK * 128, kmap, t.kfull(s), 64 * c, kvh, kt * BK,
               t.b);
    mbar_expect_tx(t.vfull(s), L::kv_bytes);
    for (int c = 0; c < L::CH; ++c)
      tma_load(t.v_slot(s) + c * BK * 128, vmap, t.vfull(s), 64 * c, kvh, kt * BK,
               t.b);
  }
}

// A consumer warpgroup: 64 query rows from qa = q0 + 64 wg.  Iteration i
// issues S(i) = Q K(i)ᵀ and P(i-1) V(i-1) back to back in its turn at the
// tensor cores, passes the turn, runs the softmax of S(i) while the
// products run, then adds P(i-1) V(i-1) into O and splits P(i).  Every tile
// of the CTA's range is computed by both warpgroups, so that no wgmma sits
// in a divergent branch: a tile wholly masked for a row block leaves it as
// it was (p = 0), or adds what alpha = 0 wipes when its first real key
// arrives, as in the TPU kernel.
template <int HD>
__device__ __forceinline__ void consume(const Cta<HD>& t, __nv_bfloat16* o, int S,
                                        long long osb, long long oss, long long osh,
                                        int causal, int window, float scale_log2) {
  constexpr int CH = Smem<HD>::CH;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int qa = t.q0 + 64 * wg;
  const int r0 = qa + 16 * ((threadIdx.x % 128) / 32) + lane / 4;  // and r0 + 8
  const int cq = 2 * (lane % 4);
  const uint32_t sQw = t.sQ + wg * 64 * 128;
  const int n = t.kt_hi - t.kt_lo + 1;

  float acc[CH][32], tile[CH][32], sc[32];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t pa[PARTS][BK / 16][4];
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;

  if (wg == 1) turn_pass(0);              // warpgroup 0 takes the first turn
  warp_wait(t.qbar, 0);
  // Tile 0: S only.
  warp_wait(t.kfull(0), 0);
  turn_take(wg);
  wg_fence();
  qk<HD>(sc, sQw, t.k_slot(0));
  wg_commit();
  if (wg == 0 || n > 1) turn_pass(1 - wg);
  wg_wait<0>();
  keep_all(sc);
  softmax_tile(sc, m, l, alpha, t.kt_lo * BK, qa, r0, cq, S, causal, window,
               scale_log2);
  split(sc, pa);
  for (int i = 1; i < n; ++i) {
    const int s = i % STAGES, sp = (i - 1) % STAGES;
    const float alpha_pv[2] = {alpha[0], alpha[1]};
    keep_operands(tile, pa);
    warp_wait(t.kfull(s), (i / STAGES) & 1);
    warp_wait(t.vfull(sp), ((i - 1) / STAGES) & 1);
    turn_take(wg);
    wg_fence();
    qk<HD>(sc, sQw, t.k_slot(s));
    wg_commit();
    pv<CH>(tile, pa, t.v_slot(sp));
    wg_commit();
    // The pass count matches the other warpgroup's takes.
    if (wg == 0 || i < n - 1) turn_pass(1 - wg);
    wg_wait<1>();                          // S(i) is in
    keep_all(sc);
    softmax_tile(sc, m, l, alpha, (t.kt_lo + i) * BK, qa, r0, cq, S, causal,
                 window, scale_log2);
    wg_wait<0>();                          // P(i-1) V(i-1) is in
    keep_operands(tile, pa);
    release(t.empty(sp), lane);
    merge(acc, alpha_pv, tile);
    split(sc, pa);
  }
  // The last tile's P V.
  const int sp = (n - 1) % STAGES;
  keep_operands(tile, pa);
  warp_wait(t.vfull(sp), ((n - 1) / STAGES) & 1);
  wg_fence();
  pv<CH>(tile, pa, t.v_slot(sp));
  wg_commit();
  wg_wait<0>();
  keep_operands(tile, pa);
  release(t.empty(sp), lane);
  merge(acc, alpha, tile);

  // O / max(l, 1e-30) in bfloat16, rows below S.
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= S) continue;
    const float lse = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = o + t.b * osb + row * oss + t.h * osh;
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 64 * c + 8 * j + cq) =
            __floats2bfloat162_rn(acc[c][4 * j + 2 * r] / lse,
                                  acc[c][4 * j + 2 * r + 1] / lse);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT, 1) flash_kernel_tc(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
    int H, int G, int S, long long osb, long long oss, long long osh, int causal,
    int window, float scale_log2) {
  using L = Smem<HD>;
  extern __shared__ uint8_t smem_raw[];
  Cta<HD> t;
  t.sQ = (smem_addr(smem_raw) + 1023u) & ~1023u;
  t.sK = t.sQ + L::k_off;
  t.sV = t.sQ + L::v_off;
  t.qbar = t.sQ + L::bar_off;
  t.b = blockIdx.x / H;
  t.h = blockIdx.x % H;
  t.q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  t.kt_lo = 0;
  t.kt_hi = (S - 1) / BK;
  if (causal) {
    t.kt_hi = min(t.kt_hi, (t.q0 + BQ - 1) / BK);
    if (window > 0) t.kt_lo = max(0, t.q0 - window + 1) / BK;
  }

  if (threadIdx.x == 0) {
    mbar_init(t.qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(t.kfull(s), 1);
      mbar_init(t.vfull(s), 1);
      mbar_init(t.empty(s), NCONS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // One branch per role, never rejoined, so that setmaxnreg holds.
  if (threadIdx.x >= NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == NCONS) produce(t, &qmap, &kmap, &vmap, t.h / G);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    consume(t, o, S, osb, oss, osh, causal, window, scale_log2);
  }
}

// -- host side --------------------------------------------------------------------

// cuTensorMapEncodeTiled lives in libcuda; it is fetched through the runtime
// so that the library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
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
// swizzle, zeros past the edge.
bool make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int S, int B,
              long long sb, long long ss, long long sh, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
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

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, const long long* st, int causal, int window,
           float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, HD, H, S, B, st[0], st[1], st[2], BQ) ||
      !make_map(&km, k, HD, KV, S, B, st[3], st[4], st[5], BK) ||
      !make_map(&vm, v, HD, KV, S, B, st[6], st[7], st[8], BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kern = flash_kernel_tc<HD>;
  const size_t bytes = Smem<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  kern<<<grid, NT, bytes, stream>>>(qm, km, vm, static_cast<__nv_bfloat16*>(o), H,
                                    H / KV, S, st[9], st[10], st[11], causal,
                                    window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bfloat16 q, k, v, o with (batch, seq, head) element strides; every
// pointer 16-byte aligned and every stride a multiple of 8 elements (TMA's
// 16 bytes), head_dim 64 or 128.  Returns a cudaError_t.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int KV, int hd, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh, int causal, int window,
    float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, osb, oss, osh};
  bool aligned = true;
  for (int i = 0; i < 9; ++i) aligned = aligned && st[i] % 8 == 0;
  for (const void* p : {q, k, v})
    aligned = aligned && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  if (KV <= 0 || H % KV != 0 || window < 0 || (S + BQ - 1) / BQ > 65535 ||
      !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, o, B, S, H, KV, st, causal, window, scale, s);
    case 128:
      return launch<128>(q, k, v, o, B, S, H, KV, st, causal, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
