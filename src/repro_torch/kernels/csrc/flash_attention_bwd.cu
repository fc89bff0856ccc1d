// The gradient of fused attention (the backward pass of flash_attention.cu and
// flash_attention_tc.cu), for Hopper (sm_90a).
//
// Replaces: no TPU kernel.  The JAX package takes this gradient by autodiff
// of src/repro/models/attention.py:blockwise_attention, which
// rematerialises each key step's scores (the flash-style backward).  Here
// kernels/flash_attention.py:FlashAttentionFn calls it, so that training
// through the flash kernel gets q, k and v their gradients.
//
// Computes, from q, k, v, the forward's O, the output gradient dO and each
// row's L = m + log(max(l, 1e-30)) (written by the forward kernels), for
// every (batch b, query head h) with K and V read from KV head h / G:
//   D_i  = sum_d dO_id O_id                         (a pre-pass)
//   P_ij = exp(s_ij - L_i) where the mask keeps (i, j), else 0,
//   s_ij = (Q_i . K_j) scale,
//   dV_j = sum_i P_ij dO_i,  dS_ij = P_ij ((dO_i . V_j) - D_i),
//   dQ_i = scale sum_j dS_ij K_j,  dK_j = scale sum_i dS_ij Q_i,
// with dK and dV of a KV head summed over its G query heads.  The mask is
// the forward's: j < S and, when causal, i >= j and (window > 0)
// i - j < window.  q, k, v, O and dO are float32 or bfloat16, all
// arithmetic is IEEE float32 FFMA, and the gradients are written in the
// input dtype.
//
// What bounds it on this card: operations.  The function itself needs, a
// (q, k) pair the mask keeps, QKᵀ and dO Vᵀ as exact bf16 products and the
// three products with float32 P or dS (dV, dQ, dK) at 3 bf16 parts each,
// 22 hd flops on the tensor cores, and one exponential; at B = 4, S = 2048,
// H = 24, KV = 8, hd = 128, causal (2.0e8 pairs) that is 0.57 ms.  This
// design spends 7 hd FFMAs a pair (QKᵀ and dO Vᵀ twice, once in each
// kernel below; dV, dK, dQ once), 3.6e11 flops, 5.4 ms at 67 TFLOP/s.
//
// What the design does about it: a simple CUDA-core kernel first, right and
// deterministic; the tensor cores are later work.  Two kernels after the
// pre-pass, neither with atomics: every output element has one writer, and
// sums run in a fixed order, so the bits do not depend on the launch.
// - The key-block kernel owns (b, KV head, T keys).  It keeps its K and V
//   tiles in shared memory and walks the G query heads of the KV head and,
//   for each, the query tiles its mask reaches; each tile pair recomputes
//   S, P and dS (through shared memory) and adds Pᵀ dO into dV and dSᵀ Q
//   into dK, held in registers.
// - The query-block kernel owns (b, query head, T queries), keeps Q and dO,
//   walks the key tiles its mask reaches, and adds dS K into dQ.
// 256 threads as 16 x 16; a thread owns the scores of rows ty + 16 a and
// keys tx + 16 c (T / 16 each), and accumulator rows ty + 16 a of hd / 16
// columns.  Tiles are staged as float32 rows padded by 4 floats, so a
// quarter warp's 16-byte loads along a row hit distinct banks.  T is 64,
// and 32 at head_dim 256 (shared memory and registers).

#include "common.cuh"

namespace {

constexpr int NT = 256;          // threads: 16 (tx) x 16 (ty)

template <int HD>
struct Tile {
  static constexpr int T = HD == 256 ? 32 : 64;   // rows (queries, keys) a tile
  static constexpr int R = T / 16;                // rows (keys) a thread owns
  static constexpr int LD = HD + 4;               // padded row of a staged tile
  static constexpr int LP = T + 4;                // padded row of P and dS
  static constexpr int CV = HD / 16;              // accumulator columns a thread
  // A, Bt: two (T, HD) tiles each side; P and dS; L and D of the query rows
  static constexpr size_t floats = 4 * T * LD + 2 * T * LP + 2 * T;
  static constexpr size_t bytes = sizeof(float) * floats;
};

// Rows [r0, r0 + T) of one head of a (.., S, .., HD) tensor as float32 rows
// of dst (leading dimension LD); rows at or past S are zero.
template <int HD, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long row_stride,
                                      int r0, int S) {
  using L = Tile<HD>;
  for (int idx = threadIdx.x; idx < L::T * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    const int row = r0 + r;
    dst[r * L::LD + d] = row < S ? repro::to_f32(src[row * row_stride + d]) : 0.f;
  }
}

// The accumulator's column c of a thread (hd / 16 of them): 16-byte groups
// 64 apart (hd >= 64), or a pair (hd = 32).
template <int HD>
__device__ __forceinline__ int column(int c, int tx) {
  return HD >= 64 ? 64 * (c / 4) + 4 * tx + c % 4 : 2 * tx + c;
}

// acc[a][c] += w[a] x row[column(c)] for one staged row.
template <int HD>
__device__ __forceinline__ void axpy_row(float (&acc)[Tile<HD>::R][Tile<HD>::CV],
                                         const float (&w)[Tile<HD>::R],
                                         const float* row, int tx) {
  using L = Tile<HD>;
  if constexpr (HD >= 64) {
#pragma unroll
    for (int c4 = 0; c4 < HD / 64; ++c4) {
      const float4 x = *reinterpret_cast<const float4*>(&row[64 * c4 + 4 * tx]);
#pragma unroll
      for (int a = 0; a < L::R; ++a) {
        acc[a][4 * c4] = fmaf(w[a], x.x, acc[a][4 * c4]);
        acc[a][4 * c4 + 1] = fmaf(w[a], x.y, acc[a][4 * c4 + 1]);
        acc[a][4 * c4 + 2] = fmaf(w[a], x.z, acc[a][4 * c4 + 2]);
        acc[a][4 * c4 + 3] = fmaf(w[a], x.w, acc[a][4 * c4 + 3]);
      }
    }
  } else {
    const float2 x = *reinterpret_cast<const float2*>(&row[2 * tx]);
#pragma unroll
    for (int a = 0; a < L::R; ++a) {
      acc[a][0] = fmaf(w[a], x.x, acc[a][0]);
      acc[a][1] = fmaf(w[a], x.y, acc[a][1]);
    }
  }
}

// One (query tile, key tile) pair: P and dS of the pair into shared memory
// (Ps, dSs: [query][key], leading dimension LP).  Q and dO are the staged
// query rows, K and V the staged key rows; Ls and Ds the rows' L and D.
template <int HD>
__device__ __forceinline__ void pair_tile(const float* Q, const float* dO,
                                          const float* K, const float* V,
                                          const float* Ls, const float* Ds,
                                          float* Ps, float* dSs, int q0, int k0,
                                          int S, int causal, int window,
                                          float scale) {
  using L = Tile<HD>;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[L::R][L::R], dp[L::R][L::R];
#pragma unroll
  for (int a = 0; a < L::R; ++a)
#pragma unroll
    for (int c = 0; c < L::R; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 qa[L::R], ga[L::R];
#pragma unroll
    for (int a = 0; a < L::R; ++a) {
      qa[a] = *reinterpret_cast<const float4*>(&Q[(ty + 16 * a) * L::LD + d]);
      ga[a] = *reinterpret_cast<const float4*>(&dO[(ty + 16 * a) * L::LD + d]);
    }
#pragma unroll
    for (int c = 0; c < L::R; ++c) {
      const float4 kc = *reinterpret_cast<const float4*>(&K[(tx + 16 * c) * L::LD + d]);
      const float4 vc = *reinterpret_cast<const float4*>(&V[(tx + 16 * c) * L::LD + d]);
#pragma unroll
      for (int a = 0; a < L::R; ++a) {
        s[a][c] = fmaf(qa[a].x, kc.x, s[a][c]);
        s[a][c] = fmaf(qa[a].y, kc.y, s[a][c]);
        s[a][c] = fmaf(qa[a].z, kc.z, s[a][c]);
        s[a][c] = fmaf(qa[a].w, kc.w, s[a][c]);
        dp[a][c] = fmaf(ga[a].x, vc.x, dp[a][c]);
        dp[a][c] = fmaf(ga[a].y, vc.y, dp[a][c]);
        dp[a][c] = fmaf(ga[a].z, vc.z, dp[a][c]);
        dp[a][c] = fmaf(ga[a].w, vc.w, dp[a][c]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < L::R; ++a) {
    const int r = ty + 16 * a, qi = q0 + r;
#pragma unroll
    for (int c = 0; c < L::R; ++c) {
      const int kc = tx + 16 * c, kj = k0 + kc;
      bool keep = qi < S && kj < S;
      if (causal) {
        keep = keep && qi >= kj;
        if (window > 0) keep = keep && qi - kj < window;
      }
      const float p = keep ? expf(s[a][c] * scale - Ls[r]) : 0.f;
      if (Ps != nullptr) Ps[r * L::LP + kc] = p;
      dSs[r * L::LP + kc] = p * (dp[a][c] - Ds[r]);
    }
  }
}

// L and D of query rows [q0, q0 + T) of head (b, h) into shared memory (0
// past S).
template <int HD>
__device__ __forceinline__ void stage_rows(float* Ls, float* Ds, const float* lse,
                                           const float* delta, long long bh, int q0,
                                           int S) {
  for (int r = threadIdx.x; r < Tile<HD>::T; r += NT) {
    const int qi = q0 + r;
    Ls[r] = qi < S ? lse[bh * S + qi] : 0.f;
    Ds[r] = qi < S ? delta[bh * S + qi] : 0.f;
  }
}

// (batch, seq, head) element strides of q, k, v, o, dO, dq, dk, dv.
struct Strides {
  long long s[24];
  __host__ __device__ const long long* of(int t) const { return s + 3 * t; }
};

enum { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV };

// D = rowsum(dO ∘ O): one warp a (b, i, h) row, into delta[(b H + h) S + i].
template <typename T>
__global__ void __launch_bounds__(NT) delta_kernel(const T* __restrict__ o,
                                                   const T* __restrict__ dout,
                                                   float* __restrict__ delta,
                                                   int B, int S, int H, int hd,
                                                   Strides st) {
  const long long row = static_cast<long long>(blockIdx.x) * (NT / 32) + threadIdx.x / 32;
  if (row >= static_cast<long long>(B) * S * H) return;
  const int lane = threadIdx.x % 32;
  const int h = row % H;
  const int i = (row / H) % S;
  const int b = row / (static_cast<long long>(H) * S);
  const long long* so = st.of(kO);
  const long long* sd = st.of(kDO);
  const T* orow = o + b * so[0] + i * so[1] + h * so[2];
  const T* grow = dout + b * sd[0] + i * sd[1] + h * sd[2];
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32)
    acc = fmaf(repro::to_f32(orow[d]), repro::to_f32(grow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[(static_cast<long long>(b) * H + h) * S + i] = acc;
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// acc (rows r0 + ty + 16 a, scaled by `scale`) into a (.., S, .., HD) head.
template <int HD, typename T>
__device__ __forceinline__ void write_rows(T* dst, long long row_stride,
                                           const float (&acc)[Tile<HD>::R][Tile<HD>::CV],
                                           int r0, int S, float scale) {
  using L = Tile<HD>;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < L::R; ++a) {
    const int row = r0 + ty + 16 * a;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < L::CV; ++c)
      store_out(dst + row * row_stride + column<HD>(c, tx), acc[a][c] * scale);
  }
}

// dK and dV of keys [k0, k0 + T) of KV head kvh: grid (B KV, key tiles).
template <typename T, int HD>
__global__ void __launch_bounds__(NT, 1) dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H,
    int KV, int S, Strides st, int causal, int window, float scale) {
  using L = Tile<HD>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // [T][LD]: the query tile's q
  float* Gs = Qs + L::T * L::LD;          // [T][LD]: its dO
  float* Ks = Gs + L::T * L::LD;          // [T][LD]: this block's keys
  float* Vs = Ks + L::T * L::LD;          // [T][LD]: and values
  float* Ps = Vs + L::T * L::LD;          // [T][LP]: P of the pair
  float* dSs = Ps + L::T * L::LP;         // [T][LP]: dS of the pair
  float* Ls = dSs + L::T * L::LP;         // [T]
  float* Ds = Ls + L::T;                  // [T]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int G = H / KV;
  const int k0 = blockIdx.y * L::T;       // early (heavy) key tiles first
  const long long *sq = st.of(kQ), *sk = st.of(kK), *sv = st.of(kV),
                  *sd = st.of(kDO);
  stage<HD>(Ks, k + b * sk[0] + kvh * sk[2], sk[1], k0, S);
  stage<HD>(Vs, v + b * sv[0] + kvh * sv[2], sv[1], k0, S);

  float dK[L::R][L::CV], dV[L::R][L::CV];
#pragma unroll
  for (int a = 0; a < L::R; ++a)
#pragma unroll
    for (int c = 0; c < L::CV; ++c) dK[a][c] = dV[a][c] = 0.f;

  const int nq = (S + L::T - 1) / L::T;
  int qt_lo = 0, qt_hi = nq - 1;          // query tiles, inclusive
  if (causal) {
    qt_lo = k0 / L::T;
    if (window > 0) qt_hi = min(qt_hi, (k0 + L::T - 1 + window - 1) / L::T);
  }
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long long bh = static_cast<long long>(b) * H + h;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * L::T;
      __syncthreads();                    // the last pair's tiles are read
      stage<HD>(Qs, q + b * sq[0] + h * sq[2], sq[1], q0, S);
      stage<HD>(Gs, dout + b * sd[0] + h * sd[2], sd[1], q0, S);
      stage_rows<HD>(Ls, Ds, lse, delta, bh, q0, S);
      __syncthreads();
      pair_tile<HD>(Qs, Gs, Ks, Vs, Ls, Ds, Ps, dSs, q0, k0, S, causal, window,
                    scale);
      __syncthreads();
      // dV[j] += sum_i P[i][j] dO[i];  dK[j] += sum_i dS[i][j] Q[i]
#pragma unroll 4
      for (int i = 0; i < L::T; ++i) {
        float p[L::R], ds[L::R];
#pragma unroll
        for (int a = 0; a < L::R; ++a) {
          p[a] = Ps[i * L::LP + ty + 16 * a];
          ds[a] = dSs[i * L::LP + ty + 16 * a];
        }
        axpy_row<HD>(dV, p, &Gs[i * L::LD], tx);
        axpy_row<HD>(dK, ds, &Qs[i * L::LD], tx);
      }
    }
  }
  const long long *sdk = st.of(kDK), *sdv = st.of(kDV);
  write_rows<HD>(dk + b * sdk[0] + kvh * sdk[2], sdk[1], dK, k0, S, scale);
  write_rows<HD>(dv + b * sdv[0] + kvh * sdv[2], sdv[1], dV, k0, S, 1.f);
}

// dQ of queries [q0, q0 + T) of head h: grid (B H, query tiles).
template <typename T, int HD>
__global__ void __launch_bounds__(NT, 1) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int H, int KV, int S,
    Strides st, int causal, int window, float scale) {
  using L = Tile<HD>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Gs = Qs + L::T * L::LD;
  float* Ks = Gs + L::T * L::LD;
  float* Vs = Ks + L::T * L::LD;
  float* dSs = Vs + L::T * L::LD + L::T * L::LP;   // (P is not kept)
  float* Ls = dSs + L::T * L::LP;
  float* Ds = Ls + L::T;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::T;   // late (heavy) tiles first
  const long long bh = static_cast<long long>(b) * H + h;
  const long long *sq = st.of(kQ), *sk = st.of(kK), *sv = st.of(kV),
                  *sd = st.of(kDO);
  stage<HD>(Qs, q + b * sq[0] + h * sq[2], sq[1], q0, S);
  stage<HD>(Gs, dout + b * sd[0] + h * sd[2], sd[1], q0, S);
  stage_rows<HD>(Ls, Ds, lse, delta, bh, q0, S);

  float dQ[L::R][L::CV];
#pragma unroll
  for (int a = 0; a < L::R; ++a)
#pragma unroll
    for (int c = 0; c < L::CV; ++c) dQ[a][c] = 0.f;

  int kt_lo = 0, kt_hi = (S - 1) / L::T;  // key tiles, inclusive
  if (causal) {
    kt_hi = min(kt_hi, (q0 + L::T - 1) / L::T);
    if (window > 0) kt_lo = max(0, q0 - window + 1) / L::T;
  }
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * L::T;
    __syncthreads();
    stage<HD>(Ks, k + b * sk[0] + kvh * sk[2], sk[1], k0, S);
    stage<HD>(Vs, v + b * sv[0] + kvh * sv[2], sv[1], k0, S);
    __syncthreads();
    pair_tile<HD>(Qs, Gs, Ks, Vs, Ls, Ds, nullptr, dSs, q0, k0, S, causal, window,
                  scale);
    __syncthreads();
    // dQ[i] += sum_j dS[i][j] K[j]
#pragma unroll 4
    for (int j = 0; j < L::T; ++j) {
      float ds[L::R];
#pragma unroll
      for (int a = 0; a < L::R; ++a) ds[a] = dSs[(ty + 16 * a) * L::LP + j];
      axpy_row<HD>(dQ, ds, &Ks[j * L::LD], tx);
    }
  }
  const long long* sdq = st.of(kDQ);
  write_rows<HD>(dq + b * sdq[0] + h * sdq[2], sdq[1], dQ, q0, S, scale);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, S, H, KV;
  Strides st;
  int causal, window;
  float scale;
};

template <typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
  using L = Tile<HD>;
  const auto* q = static_cast<const T*>(a.q);
  const auto* k = static_cast<const T*>(a.k);
  const auto* v = static_cast<const T*>(a.v);
  const auto* dout = static_cast<const T*>(a.dout);
  const long long rows = static_cast<long long>(a.B) * a.S * a.H;
  delta_kernel<T><<<static_cast<unsigned>((rows + NT / 32 - 1) / (NT / 32)), NT, 0,
                    stream>>>(static_cast<const T*>(a.o), dout, a.delta, a.B, a.S,
                              a.H, HD, a.st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bytes = static_cast<int>(L::bytes);
  const int tiles = (a.S + L::T - 1) / L::T;
  const auto kv_kern = dkdv_kernel<T, HD>;
  err = cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kv_kern<<<dim3(a.B * a.KV, tiles), NT, bytes, stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.H, a.KV, a.S, a.st, a.causal, a.window, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto q_kern = dq_kernel<T, HD>;
  err = cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  q_kern<<<dim3(a.B * a.H, tiles), NT, bytes, stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.H, a.KV, a.S, a.st,
      a.causal, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, S, H, hd), k and v (B, S, KV, hd), o and dout like q, all float32 or
// all bfloat16 (bf16 = 1) with the (batch, seq, head) element strides in
// strides[0..15) (q, k, v, o, dout; the last axis contiguous); lse the
// forward's (B, H, S) float32 L; delta a (B, H, S) float32 scratch; dq, dk,
// dv like q, k, v in the input dtype, strides in strides[15..24).  Three
// launches on `stream`.  Returns a cudaError_t.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int bf16, int B,
    int S, int H, int KV, int hd, const long long* strides, int causal, int window,
    float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || window < 0 || (S + 31) / 32 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, {}, causal, window,
         scale};
  for (int i = 0; i < 24; ++i) a.st.s[i] = strides[i];
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_hd<__nv_bfloat16>(hd, a, s) : launch_hd<float>(hd, a, s);
}
