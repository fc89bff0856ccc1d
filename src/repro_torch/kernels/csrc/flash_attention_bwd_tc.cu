// The gradient of fused attention on Hopper's tensor cores, for bfloat16
// q, k, v, O and dO at head_dim 64, 128 and 256 (sm_90a): the backward pass
// of the route that kernels/flash_attention.py calls "tc"
// (flash_attention_tc.cu).  float32 inputs and head_dim 32 stay on the
// CUDA-core kernel in flash_attention_bwd.cu.
//
// Replaces: no TPU kernel.  The JAX package takes this gradient by autodiff
// of src/repro/models/attention.py:blockwise_attention;
// kernels/flash_attention.py:FlashAttentionFn calls it.
//
// Computes what flash_attention_bwd.cu computes, for every (batch b, query
// head h) with K and V read in place from KV head h / G:
//   D_i  = sum_d dO_id O_id                         (a pre-pass)
//   P_ij = exp(s_ij - L_i) where the mask keeps (i, j), else 0,
//   s_ij = (Q_i . K_j) scale,
//   dV_j = sum_i P_ij dO_i,  dS_ij = P_ij ((dO_i . V_j) - D_i),
//   dQ_i = scale sum_j dS_ij K_j,  dK_j = scale sum_i dS_ij Q_i,
// with dK and dV of a KV head summed over its G query heads, the forward's
// mask (j < S and, when causal, i >= j and (window > 0) i - j < window),
// L the forward's (B, H, S) float32 log-sum-exp, and the gradients written
// in bfloat16.  Exponentials are taken as 2^x on s scale log2(e) - L log2(e).
//
// Arithmetic.  q, k, v and dO are bfloat16, so QKᵀ and dO Vᵀ are single bf16
// wgmma products with float32 sums, exact products.  P and dS are float32
// and stay so: never rounded to bf16 once (that is what
// scaled_dot_product_attention's backward computes, another function).
// Each of the three products that takes P or dS as an operand (dV = Pᵀ dO,
// dK = dSᵀ Q, dQ = dS K) runs once per bf16 part of P or dS, split as in
// the forward: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid),
// each subtraction exact, 24 bits in all (kernels/ref.py:split_bf16).
// dK, dV and dQ accumulate in the wgmma accumulator across tiles (the
// tensor cores' own adder), not tile by tile into a float32 sum as the
// forward's O does: at head_dim 128 the dK and dV accumulators alone take
// 128 registers a thread, and a second float32 copy of them does not fit
// in registers or, beside K, V and the ring, in shared memory.
// chip_smoke.py measures the flip rate this costs (bf16 gradients that
// differ from the plain float32 ones rounded) against the FFMA kernel's and
// the plain version's at 1, 2 and 3 parts, and fails above a quarter of the
// one-part rate.
//
// What bounds it on this card: the tensor cores.  The function needs, a
// (q, k) pair the mask keeps, 2 hd flops for QKᵀ, 2 hd for dO Vᵀ and
// 2 hd x 3 parts for each of dV, dK and dQ: 22 hd at 989 TFLOP/s, and one
// exponential.  This design computes QKᵀ and dO Vᵀ once in each of its two
// kernels, so its own bound is 26 hd flops a pair; at B = 4, S = 2048,
// H = 24, KV = 8, hd = 128, causal (2.0e8 pairs) that is 0.68 ms against
// the function's 0.57.
//
// What the design does about it: two kernels after the pre-pass, as in
// flash_attention_bwd.cu, neither with atomics: every output element has
// one writer, and sums run in a fixed order, so the bits do not depend on
// the launch.  Both use the forward's machinery (flash_tc.cuh): a producer
// warpgroup (one thread issues every load by TMA, 128-byte swizzle, zero
// fill past S; its registers go to the consumers with setmaxnreg) and two
// consumer warpgroups of 64 rows each, a ring of STAGES shared-memory
// slots with full and empty mbarriers, and the wgmma accumulator layout
// reused as the A operand of the next product.
// - The key-block kernel owns (b, KV head, 128 keys): K and V stay in shared
//   memory, and 64-row tiles of Q and dO (with their rows' L and D) stream
//   through the ring over the G query heads and the query tiles the mask
//   reaches.  Warpgroup w computes Sᵀ = K_w Qᵀ and dPᵀ = V_w dOᵀ for its 64
//   keys (both operands K-major), turns them into Pᵀ and dSᵀ in registers,
//   and adds Pᵀ dO into dV and dSᵀ Q into dK (A from registers, dO and Q
//   read MN-major from the same tiles).  It takes each tile in two halves
//   of 32 queries: with dK and dV at 128 registers a thread (hd 128), a
//   whole tile's P, dS and parts would spill.  A half the mask wholly
//   hides from a warpgroup's keys is skipped by that warpgroup.
// - The query-block kernel owns (b, query head, 128 queries): Q and dO stay
//   in shared memory, and 64-key tiles of K and V stream through the ring.
//   It recomputes S and dP, and adds dS K into dQ (K read MN-major); tile
//   i's S and dP are issued beside tile i-1's dS K, so the products of one
//   run while the exponentials of the other are taken.
// Heavy causal blocks are launched first in both (early keys, late
// queries).  The two consumer warpgroups of a CTA are not made to take
// turns at the tensor cores.
//
// Head_dim 256.  A 128-row own tile of K and V (or Q and dO) would take
// 128 KiB of shared memory, and four stages of 64-row Q and dO tiles 256
// KiB more, against 227 KiB; the dK and dV accumulators of 64 rows x 256
// columns would take 256 registers a thread.  Both of QKᵀ and dO Vᵀ
// contract over all 256 features, so a CTA holds K and V (or Q and dO)
// whole whatever share of the gradients' columns it owns.  So at 256 a CTA
// owns 64 rows, and its two consumer warpgroups take the same 64 rows,
// each one column half (128 columns) of dK and dV, or of dQ (SPLIT): both
// compute the whole Sᵀ and dPᵀ (S and dP) over all 256 features, so they
// take the same P and dS bit for bit (wgmma sums in a fixed order), and
// each adds only its columns, dV[:, half] += Pᵀ dO[:, half], dK[:, half] +=
// dSᵀ Q[:, half], dQ[:, half] += dS K[:, half]: hd 128's accumulators and
// registers a thread.  The halves share one copy of every tile in shared
// memory, which two CTAs of one half each would load twice.  Streamed tiles
// are 32 rows, so that the ring keeps 4 stages: the own tiles take 64 KiB
// and 4 stages of two 32-row tiles 128 KiB, 193 KiB with the rows' L and D
// (64-row tiles would leave room for 2 stages, and the query-block kernel,
// which holds a slot until the next tile's products are in, would wait on
// every load).  No element's sum changes: a column half sums the same
// terms in the same order as a full-width accumulator.  QKᵀ and dO Vᵀ run
// in both warpgroups of both kernels, 4 (2 + 2) hd + 18 hd = 34 hd flops a
// pair against the function's 22 hd; at B = 2, S = 4096, H = 10, KV = 1,
// window 2048 (recurrentgemma-2b's local layers, 1.26e8 pairs) that bound
// is 1.11 ms against the function's 0.72.

#include "flash_tc.cuh"

namespace {

using namespace repro::tc;

constexpr int PAD = 128;          // the L and D scratch pads S to a multiple
constexpr int WR = 64;            // rows of a warpgroup's products (wgmma M)
constexpr int HQ = 32;            // queries a key-block step takes
constexpr int STAGES = 4;         // ring depth
constexpr int PARTS = 3;          // bf16 parts of P and dS
constexpr int NCONS = 256;        // consumer threads
constexpr int NT = NCONS + 128;   // and one producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// The geometry of one head width, and the shared memory of either kernel,
// from a 1024-byte aligned base (the 128-byte swizzle's period): the CTA's
// own two BLK-row tiles (K and V, or Q and dO), STAGES slots of each of the
// two streamed BT-row tiles (Q and dO, or K and V), STAGES slots of the
// streamed rows' L and D (key-block kernel), the barriers.  Every tile is
// stored as hd / 64 column chunks of rows x 128 bytes.  At hd 64 and 128
// warpgroup w owns rows [64 w, 64 w + 64) of the CTA's 128 at full width;
// at 256 (SPLIT) both own the CTA's 64 rows, warpgroup w columns
// [128 w, 128 w + 128).
template <int HD>
struct Smem {
  static constexpr bool SPLIT = HD == 256;
  static constexpr int CH = HD / 64;               // column chunks of a row
  static constexpr int CW = SPLIT ? CH / 2 : CH;   // chunks a warpgroup owns
  static constexpr int BLK = SPLIT ? 64 : 128;     // rows a CTA owns
  static constexpr int BT = SPLIT ? 32 : 64;       // rows of a streamed tile
  static constexpr uint32_t own_bytes = CH * BLK * 128;
  static constexpr uint32_t tile_bytes = CH * BT * 128;
  static constexpr uint32_t rows_bytes = 2 * BT * 4;    // L and D of BT rows
  static constexpr uint32_t own2_off = own_bytes;
  static constexpr uint32_t ring_off = 2 * own_bytes;
  static constexpr uint32_t ring2_off = ring_off + STAGES * tile_bytes;
  static constexpr uint32_t rows_off = ring2_off + STAGES * tile_bytes;
  static constexpr uint32_t bar_off = rows_off + STAGES * rows_bytes;
  static constexpr size_t bytes = bar_off + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(bytes <= 232448, "over a block's shared memory");
  static_assert(PAD % BLK == 0 && BT % HQ == 0, "tiles do not divide");
};

template <int CH>
__device__ __forceinline__ void keep_acc(float (&x)[CH][32]) {
#pragma unroll
  for (int c = 0; c < CH; ++c) keep_all(x[c]);
}

template <int NK>
__device__ __forceinline__ void keep_parts(uint32_t (&pa)[PARTS][NK][4]) {
#pragma unroll
  for (int part = 0; part < PARTS; ++part)
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) keep(pa[part][kk][j]);
}

__device__ __forceinline__ float2 lds2(uint32_t addr) {
  float2 x;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(x.x), "=f"(x.y) : "r"(addr));
  return x;
}

// -- the consumers' steps ---------------------------------------------------------
//
// Accumulator layout of a 64 x N wgmma result (N / 2 floats a thread):
// thread t of the warpgroup, warp w = t / 32, lane l, holds d[4j + 2r + c]
// at row 16 w + l / 4 + 8 r, column 8 j + 2 (l % 4) + c.  The same registers,
// paired as bf16, are the A operand of a 64 x 16 wgmma for columns
// [16 kk, 16 kk + 16): {d[8kk], d[8kk+1]}, {d[8kk+2], d[8kk+3]},
// {d[8kk+4], d[8kk+5]}, {d[8kk+6], d[8kk+7]}.

// Issue X = A1 B1ᵀ and Y = A2 B2ᵀ for 64 rows of A against N = 2 M rows of
// B: hd / 16 steps of 16 features each, all four operands K-major in shared
// memory (the 16 features at 32-byte offsets inside a 128-byte swizzled
// row; a column chunk of A every a_chunk bytes, of B every b_chunk).  At hd
// 256 A's addresses (the CTA's own tiles) are made opaque at each call, so
// that their 32 descriptors are formed where they are used: hoisted out of
// the tile loop, they would hold 64 registers and spill.
template <int HD, int M>
__device__ __forceinline__ void two_products(float (&x)[M], float (&y)[M],
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a_chunk, uint32_t b1,
                                             uint32_t b2, uint32_t b_chunk) {
  if constexpr (HD == 256) {
    keep(a1);
    keep(a2);
  }
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    mma_ss(x, desc(a1 + (kk / 4) * a_chunk + off), desc(b1 + (kk / 4) * b_chunk + off),
           kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    mma_ss(y, desc(a2 + (kk / 4) * a_chunk + off), desc(b2 + (kk / 4) * b_chunk + off),
           kk > 0);
  }
}

// Issue acc += A B for A (64 x 16 NK) in PARTS bf16 parts from registers
// and B 16 NK rows of a BT-row tile (MN-major in shared memory, from sB, a
// 64-column chunk every BT x 128 bytes): one product per part, per 16 rows
// of B, per 64-column chunk.
template <int CH, int NK, int BT>
__device__ __forceinline__ void add_parts(float (&acc)[CH][32],
                                          const uint32_t (&pa)[PARTS][NK][4],
                                          uint32_t sB) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int part = 0; part < PARTS; ++part)
        mma_rs(acc[c], pa[part][kk], desc(sB + c * BT * 128 + kk * 16 * 128), 1);
}

// x (64 x 16 NK in the accumulator layout) in PARTS bf16 parts, as wgmma A
// fragments: pa[part][kk][4].
template <int NK>
__device__ __forceinline__ void split(const float (&x)[8 * NK],
                                      uint32_t (&pa)[PARTS][NK][4]) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x0 = x[8 * kk + 2 * j], x1 = x[8 * kk + 2 * j + 1];
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

// Whether the mask keeps (query i, key j).
__device__ __forceinline__ bool kept(int i, int j, int S, int causal, int window) {
  bool keepit = i < S && j < S;
  if (causal) {
    keepit = keepit && i >= j;
    if (window > 0) keepit = keepit && i - j < window;
  }
  return keepit;
}

// A consumer warp is done with a ring slot.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// Rows [r0, r0 + 8) and [r0 + 8, r0 + 16) of a 64 x 64 CH accumulator
// (times `scale`, in bfloat16) into rows below S of one head of a (.., S,
// .., hd) tensor with row stride rs, from the head's column `head`.
template <int CH>
__device__ __forceinline__ void write_rows(__nv_bfloat16* head, long long rs,
                                           const float (&acc)[CH][32], int r0,
                                           int cq, int S, float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* out = head + row * rs;
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + 64 * c + 8 * j + cq) =
            __floats2bfloat162_rn(acc[c][4 * j + 2 * r] * scale,
                                  acc[c][4 * j + 2 * r + 1] * scale);
  }
}

// -- what a CTA works on --------------------------------------------------------

// Its shared memory and barriers: `own` (the CTA's own tiles have
// landed), full[s] and empty[s] of each ring slot.
template <int HD>
struct Cta {
  using L = Smem<HD>;
  uint32_t base, bars;
  int b, h, r0;     // batch, head (KV head in the key-block kernel), first row

  __device__ uint32_t own() const { return bars; }
  __device__ uint32_t full(int s) const { return bars + 8u * (1 + s); }
  __device__ uint32_t empty(int s) const { return bars + 8u * (1 + STAGES + s); }
  __device__ uint32_t own1() const { return base; }
  __device__ uint32_t own2() const { return base + L::own2_off; }
  __device__ uint32_t slot1(int s) const {
    return base + L::ring_off + s * L::tile_bytes;
  }
  __device__ uint32_t slot2(int s) const {
    return base + L::ring2_off + s * L::tile_bytes;
  }
  __device__ uint32_t rows(int s) const { return base + L::rows_off + s * L::rows_bytes; }

  static constexpr int BLK = L::BLK, BT = L::BT;

  __device__ void init(uint8_t* raw) {
    base = (smem_addr(raw) + 1023u) & ~1023u;
    bars = base + L::bar_off;
    if (threadIdx.x == 0) {
      mbar_init(own(), 1);
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full(s), 1);
        mbar_init(empty(s), NCONS / 32);  // one arrival per consumer warp
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }

  // The producer's one thread: the CTA's own BLK-row tiles of two tensors
  // (rows r0 of head `head`).
  __device__ void load_own(const CUtensorMap* m1, const CUtensorMap* m2, int head) const {
    mbar_expect_tx(own(), 2 * L::own_bytes);
    for (int c = 0; c < L::CH; ++c) {
      tma_load(own1() + c * BLK * 128, m1, own(), 64 * c, head, r0, b);
      tma_load(own2() + c * BLK * 128, m2, own(), 64 * c, head, r0, b);
    }
  }

  // Tile i of the stream into slot i % STAGES once every consumer warp has
  // freed it: BT rows from `row` of head `head` of two tensors, and (rows
  // not null) the rows' L and D.
  __device__ void load_tile(int i, const CUtensorMap* m1, const CUtensorMap* m2,
                            int head, int row, const float* rows_src,
                            int rows_stride) const {
    const int s = i % STAGES;
    if (i >= STAGES) mbar_wait(empty(s), (i / STAGES - 1) & 1);
    mbar_expect_tx(full(s), 2 * L::tile_bytes + (rows_src ? L::rows_bytes : 0));
    for (int c = 0; c < L::CH; ++c) {
      tma_load(slot1(s) + c * BT * 128, m1, full(s), 64 * c, head, row, b);
      tma_load(slot2(s) + c * BT * 128, m2, full(s), 64 * c, head, row, b);
    }
    if (rows_src != nullptr) {
      bulk_load(rows(s), rows_src, BT * 4, full(s));
      bulk_load(rows(s) + BT * 4, rows_src + rows_stride, BT * 4, full(s));
    }
  }
};

// -- the key-block kernel: dK and dV ----------------------------------------------
//
// The rows' L (log2 domain) and D come from the pre-pass's (B H, 2, Spad)
// buffer `ld`: row (b H + h) holds Spad values of L log2(e), then Spad of
// D, zero past S; Spad is S rounded up to PAD.

template <int HD>
__global__ void __launch_bounds__(NT, 1) dkdv_tc(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
    const float* __restrict__ ld, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int H, int KV, int S, int Spad, long long dksb,
    long long dkss, long long dksh, long long dvsb, long long dvss, long long dvsh,
    int causal, int window, float scale_log2, float scale) {
  using L = Smem<HD>;
  constexpr int CW = L::CW, BLK = L::BLK, BT = L::BT;
  extern __shared__ uint8_t smem_raw[];
  Cta<HD> t;
  t.b = blockIdx.x / KV;
  t.h = blockIdx.x % KV;
  t.r0 = blockIdx.y * BLK;                 // early (heavy) key blocks first
  const int G = H / KV;
  // The query tiles the mask reaches, inclusive.
  int qt_lo = 0, qt_hi = (S - 1) / BT;
  if (causal) {
    qt_lo = t.r0 / BT;
    if (window > 0) qt_hi = min(qt_hi, (t.r0 + BLK - 1 + window - 1) / BT);
  }
  const int nq = qt_hi - qt_lo + 1;
  t.init(smem_raw);

  // One branch per role, never rejoined, so that setmaxnreg holds.
  if (threadIdx.x >= NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != NCONS) return;
    t.load_own(&kmap, &vmap, t.h);
    for (int i = 0; i < G * nq; ++i) {
      const int h = t.h * G + i / nq, q0 = (qt_lo + i % nq) * BT;
      t.load_tile(i, &qmap, &domap, h, q0,
                  ld + (static_cast<long long>(t.b) * H + h) * 2 * Spad + q0, Spad);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int rw = L::SPLIT ? 0 : WR * wg;     // the warpgroup's first row of the CTA's
  const int cw = L::SPLIT ? CW * wg : 0;     // and its first column chunk
  const int kw = t.r0 + rw;                                      // the warpgroup's keys
  const int key0 = kw + 16 * ((threadIdx.x % 128) / 32) + lane / 4;  // and key0 + 8
  const int cq = 2 * (lane % 4);
  const uint32_t sK = t.own1() + rw * 128, sV = t.own2() + rw * 128;

  // A tile's BT queries are taken HQ at a time: Sᵀ and dPᵀ of a step are
  // 64 x 32, so that their float32 P and dS and the bf16 parts of one fit
  // beside the dK and dV accumulators without a spill at hd 128.
  float dK[CW][32], dV[CW][32], sc[HQ / 2], dp[HQ / 2];
  uint32_t pa[PARTS][HQ / 16][4];
#pragma unroll
  for (int c = 0; c < CW; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) dK[c][e] = dV[c][e] = 0.f;

  warp_wait(t.own(), 0);
  for (int i = 0; i < G * nq; ++i) {
    const int s = i % STAGES;
    warp_wait(t.full(s), (i / STAGES) & 1);
#pragma unroll 1
    for (int half = 0; half < BT / HQ; ++half) {
      const int q0 = (qt_lo + i % nq) * BT + HQ * half;
      // Skip a step the mask wholly hides from this warpgroup's keys.
      if (kw >= S || (causal && (q0 + HQ - 1 < kw ||
                                 (window > 0 && q0 - (kw + WR - 1) >= window))))
        continue;
      const uint32_t sQ = t.slot1(s) + HQ * half * 128;
      const uint32_t sdO = t.slot2(s) + HQ * half * 128;
      // Sᵀ = K_w Qᵀ and dPᵀ = V_w dOᵀ: rows keys, columns queries.
      wg_fence();
      two_products<HD>(sc, dp, sK, sV, BLK * 128, sQ, sdO, BT * 128);
      wg_commit();
      wg_wait<0>();
      keep_all(sc);
      keep_all(dp);
      const bool full = kw + WR - 1 < S && q0 + HQ - 1 < S &&
                        (!causal || (q0 >= kw + WR - 1 &&
                                     (window == 0 || q0 + HQ - 1 - kw < window)));
      const uint32_t rows = t.rows(s) + 4 * (HQ * half + cq);   // L (log2), then D
#pragma unroll
      for (int j = 0; j < HQ / 8; ++j) {
        const float2 l2 = lds2(rows + 32 * j);
        const float2 dd = lds2(rows + 4 * BT + 32 * j);
#pragma unroll
        for (int e = 4 * j; e < 4 * j + 4; ++e) {
          const int c = e & 1;
          float p = ex2(fmaf(sc[e], scale_log2, -(c ? l2.y : l2.x)));
          if (!full &&
              !kept(q0 + 8 * j + cq + c, key0 + 8 * ((e >> 1) & 1), S, causal, window))
            p = 0.f;
          sc[e] = p;
          dp[e] = p * (dp[e] - (c ? dd.y : dd.x));
        }
      }
      // dV += Pᵀ dO, then dK += dSᵀ Q, each over the parts, on the
      // warpgroup's columns.
      split<HQ / 16>(sc, pa);
      wg_fence();
      add_parts<CW, HQ / 16, BT>(dV, pa, sdO + cw * BT * 128);
      wg_commit();
      wg_wait<0>();
      keep_acc(dV);
      keep_parts(pa);
      split<HQ / 16>(dp, pa);
      wg_fence();
      add_parts<CW, HQ / 16, BT>(dK, pa, sQ + cw * BT * 128);
      wg_commit();
      wg_wait<0>();
      keep_acc(dK);
      keep_parts(pa);
    }
    release(t.empty(s), lane);
  }
  write_rows<CW>(dk + t.b * dksb + t.h * dksh + 64 * cw, dkss, dK, key0, cq, S, scale);
  write_rows<CW>(dv + t.b * dvsb + t.h * dvsh + 64 * cw, dvss, dV, key0, cq, S, 1.f);
}

// -- the query-block kernel: dQ -------------------------------------------------------

// S and dP of one N-key tile in place: sc becomes nothing, dp becomes
// dS = P (dP - D) with P = 2^(s scale log2(e) - L log2(e)) where the mask
// keeps the pair.
template <int N>
__device__ __forceinline__ void grad_tile(const float (&sc)[N / 2], float (&dp)[N / 2],
                                          const float (&l2)[2], const float (&dd)[2],
                                          int k0, int qa, int row0, int cq, int S,
                                          int causal, int window, float scale_log2) {
  const bool full =
      k0 + N <= S &&
      (!causal || (k0 + N - 1 <= qa && (window == 0 || qa + WR - 1 - k0 < window)));
#pragma unroll
  for (int e = 0; e < N / 2; ++e) {
    const int r = (e >> 1) & 1;
    float p = ex2(fmaf(sc[e], scale_log2, -l2[r]));
    if (!full && !kept(row0 + 8 * r, k0 + 8 * (e >> 2) + cq + (e & 1), S, causal, window))
      p = 0.f;
    dp[e] = p * (dp[e] - dd[r]);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT, 1) dq_tc(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const float* __restrict__ ld, __nv_bfloat16* __restrict__ dq, int H, int KV, int S,
    int Spad, long long dqsb, long long dqss, long long dqsh, int causal, int window,
    float scale_log2, float scale) {
  using L = Smem<HD>;
  constexpr int CW = L::CW, BLK = L::BLK, BT = L::BT;
  extern __shared__ uint8_t smem_raw[];
  Cta<HD> t;
  t.b = blockIdx.x / H;
  t.h = blockIdx.x % H;
  t.r0 = (gridDim.y - 1 - blockIdx.y) * BLK;   // late (heavy) query blocks first
  // The key tiles the mask reaches, inclusive.
  int kt_lo = 0, kt_hi = (S - 1) / BT;
  if (causal) {
    kt_hi = min(kt_hi, (t.r0 + BLK - 1) / BT);
    if (window > 0) kt_lo = max(0, t.r0 - window + 1) / BT;
  }
  const int n = kt_hi - kt_lo + 1;
  const int kvh = t.h / (H / KV);
  t.init(smem_raw);

  if (threadIdx.x >= NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != NCONS) return;
    t.load_own(&qmap, &domap, t.h);
    for (int i = 0; i < n; ++i)
      t.load_tile(i, &kmap, &vmap, kvh, (kt_lo + i) * BT, nullptr, 0);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int rw = L::SPLIT ? 0 : WR * wg;     // the warpgroup's first row of the CTA's
  const int cw = L::SPLIT ? CW * wg : 0;     // and its first column chunk
  const uint32_t cb = cw * BT * 128;         // of a K tile in shared memory
  const int qa = t.r0 + rw;                                       // the warpgroup's rows
  const int row0 = qa + 16 * ((threadIdx.x % 128) / 32) + lane / 4;  // and row0 + 8
  const int cq = 2 * (lane % 4);
  const uint32_t sQ = t.own1() + rw * 128, sdO = t.own2() + rw * 128;
  const float* ldr = ld + (static_cast<long long>(t.b) * H + t.h) * 2 * Spad;
  const float l2[2] = {ldr[row0], ldr[row0 + 8]};           // rows < Spad
  const float dd[2] = {ldr[Spad + row0], ldr[Spad + row0 + 8]};

  float dQ[CW][32], sc[BT / 2], dp[BT / 2];
  uint32_t pa[PARTS][BT / 16][4];   // dS's parts
#pragma unroll
  for (int c = 0; c < CW; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) dQ[c][e] = 0.f;

  warp_wait(t.own(), 0);
  // Tile 0: S and dP only.
  warp_wait(t.full(0), 0);
  wg_fence();
  two_products<HD>(sc, dp, sQ, sdO, BLK * 128, t.slot1(0), t.slot2(0), BT * 128);
  wg_commit();
  wg_wait<0>();
  keep_all(sc);
  keep_all(dp);
  grad_tile<BT>(sc, dp, l2, dd, kt_lo * BT, qa, row0, cq, S, causal, window, scale_log2);
  split<BT / 16>(dp, pa);
  for (int i = 1; i < n; ++i) {
    const int s = i % STAGES, sp = (i - 1) % STAGES;
    keep_acc(dQ);
    keep_parts(pa);
    warp_wait(t.full(s), (i / STAGES) & 1);
    wg_fence();
    two_products<HD>(sc, dp, sQ, sdO, BLK * 128, t.slot1(s), t.slot2(s), BT * 128);
    wg_commit();
    add_parts<CW, BT / 16, BT>(dQ, pa, t.slot1(sp) + cb);   // dQ += dS(i-1) K(i-1)
    wg_commit();
    wg_wait<1>();                            // S(i) and dP(i) are in
    keep_all(sc);
    keep_all(dp);
    grad_tile<BT>(sc, dp, l2, dd, (kt_lo + i) * BT, qa, row0, cq, S, causal, window,
                  scale_log2);
    wg_wait<0>();                            // dS(i-1) K(i-1) is in
    keep_acc(dQ);
    keep_parts(pa);
    release(t.empty(sp), lane);
    split<BT / 16>(dp, pa);
  }
  // The last tile's dS K.
  const int sp = (n - 1) % STAGES;
  keep_acc(dQ);
  keep_parts(pa);
  wg_fence();
  add_parts<CW, BT / 16, BT>(dQ, pa, t.slot1(sp) + cb);
  wg_commit();
  wg_wait<0>();
  keep_acc(dQ);
  keep_parts(pa);
  release(t.empty(sp), lane);
  write_rows<CW>(dq + t.b * dqsb + t.h * dqsh + 64 * cw, dqss, dQ, row0, cq, S, scale);
}

// -- the pre-pass ---------------------------------------------------------------

// L log2(e) and D = rowsum(dO ∘ O) of every query row into `ld` (zero past
// S): one warp a (b H + h, i < Spad) row.
__global__ void __launch_bounds__(256) rows_kernel(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ ld, int B, int S, int Spad,
    int H, int hd, long long osb, long long oss, long long osh, long long dsb,
    long long dss, long long dsh) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (row >= static_cast<long long>(B) * H * Spad) return;
  const int lane = threadIdx.x % 32;
  const int i = static_cast<int>(row % Spad);
  const long long bh = row / Spad;
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  float l2 = 0.f, acc = 0.f;
  if (i < S) {
    const __nv_bfloat16* orow = o + b * osb + i * oss + h * osh;
    const __nv_bfloat16* grow = dout + b * dsb + i * dss + h * dsh;
    for (int d = lane; d < hd; d += 32)
      acc = fmaf(__bfloat162float(orow[d]), __bfloat162float(grow[d]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    l2 = lse[bh * S + i] * kLog2e;
  }
  if (lane == 0) {
    ld[bh * 2 * Spad + i] = l2;
    ld[bh * 2 * Spad + Spad + i] = acc;
  }
}

// -- host side --------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* ld;
  void *dq, *dk, *dv;
  int B, S, H, KV, Spad;
  const long long* st;   // (batch, seq, head) strides: q k v o dout dq dk dv
  int causal, window;
  float scale;
};

enum { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV };

template <int HD>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int BLK = Smem<HD>::BLK, BT = Smem<HD>::BT;
  const long long* st = a.st;
  // The map of tensor t (kQ, kK, kV or kDO) in boxes of `rows` positions.
  const auto map = [&](CUtensorMap* m, const void* ptr, int t, int rows) {
    const long long* s = st + 3 * t;
    return make_map(m, ptr, HD, t == kQ || t == kDO ? a.H : a.KV, a.S, a.B, s[0],
                    s[1], s[2], rows);
  };
  CUtensorMap q_own, do_own, k_tile, v_tile;   // the query-block kernel's
  CUtensorMap k_own, v_own, q_tile, do_tile;   // the key-block kernel's
  if (!map(&q_own, a.q, kQ, BLK) || !map(&do_own, a.dout, kDO, BLK) ||
      !map(&k_tile, a.k, kK, BT) || !map(&v_tile, a.v, kV, BT) ||
      !map(&k_own, a.k, kK, BLK) || !map(&v_own, a.v, kV, BLK) ||
      !map(&q_tile, a.q, kQ, BT) || !map(&do_tile, a.dout, kDO, BT))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(a.B) * a.H * a.Spad;
  const long long *so = st + 3 * kO, *sd = st + 3 * kDO;
  rows_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.o), static_cast<const __nv_bfloat16*>(a.dout),
      a.lse, a.ld, a.B, a.S, a.Spad, a.H, HD, so[0], so[1], so[2], sd[0], sd[1], sd[2]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int bytes = static_cast<int>(Smem<HD>::bytes);
  const int blocks = (a.S + BLK - 1) / BLK;
  if (blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = a.scale * kLog2e;
  const auto kv_kern = dkdv_tc<HD>;
  err = cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long *sdk = st + 3 * kDK, *sdv = st + 3 * kDV, *sdq = st + 3 * kDQ;
  kv_kern<<<dim3(a.B * a.KV, blocks), NT, bytes, stream>>>(
      k_own, v_own, q_tile, do_tile, a.ld, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.H, a.KV, a.S, a.Spad, sdk[0], sdk[1], sdk[2],
      sdv[0], sdv[1], sdv[2], a.causal, a.window, scale_log2, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto q_kern = dq_tc<HD>;
  err = cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  q_kern<<<dim3(a.B * a.H, blocks), NT, bytes, stream>>>(
      q_own, do_own, k_tile, v_tile, a.ld, static_cast<__nv_bfloat16*>(a.dq), a.H, a.KV,
      a.S, a.Spad, sdq[0], sdq[1], sdq[2], a.causal, a.window, scale_log2, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bfloat16 q (B, S, H, hd), k and v (B, S, KV, hd), o and dout like q, with
// the (batch, seq, head) element strides in strides[0..15) (q, k, v, o,
// dout; the last axis contiguous); q, k, v and dout 16-byte aligned with
// strides of a multiple of 8 elements (TMA's 16 bytes); head_dim 64, 128
// or 256; lse the forward's (B, H, S) float32 L; ld a 16-byte aligned float32
// scratch of B H 2 Spad, Spad = S rounded up to a multiple of 128; dq, dk,
// dv bfloat16 like q, k, v with even strides in strides[15..24).  Three
// launches on `stream`.  Returns a cudaError_t.
extern "C" int flash_attention_bwd_tc_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* ld, void* dq, void* dk, void* dv, int B, int S, int H,
    int KV, int hd, const long long* strides, int causal, int window, float scale,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  bool aligned = true;
  for (int t : {kQ, kK, kV, kDO})
    for (int i = 0; i < 3; ++i) aligned = aligned && strides[3 * t + i] % 8 == 0;
  for (int t : {kDQ, kDK, kDV})
    for (int i = 0; i < 3; ++i) aligned = aligned && strides[3 * t + i] % 2 == 0;
  for (const void* p : {q, k, v, dout, static_cast<const void*>(ld)})
    aligned = aligned && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (const void* p : {dq, dk, dv})
    aligned = aligned && reinterpret_cast<uintptr_t>(p) % 4 == 0;
  if (KV <= 0 || H % KV != 0 || window < 0 || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Spad = (S + PAD - 1) / PAD * PAD;
  const Args a{q, k, v, o, dout, lse, ld, dq, dk, dv, B, S, H, KV, Spad, strides,
               causal, window, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch<64>(a, s);
    case 128: return launch<128>(a, s);
    case 256: return launch<256>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
