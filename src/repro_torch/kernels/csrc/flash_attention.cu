// Fused online-softmax attention (prefill), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention (the Pallas
// TPU kernel, body _flash_kernel), the fused form of the LM path's
// models/attention.py:blockwise_attention, on the route that
// kernels/flash_attention.py calls "ffma": float32 inputs, and bfloat16 at
// head_dim 32 or 256.  bfloat16 at head_dim 64 and 128 (the LM path) takes
// the tensor-core kernel in flash_attention_tc.cu.
//
// Computes, for every (batch b, query head h, query position i):
//   O[i] = sum_j p_ij V[j] / sum_j p_ij,  p_ij = exp(s_ij - max_j s_ij),
//   s_ij = (Q[i] . K[j]) * scale  where the mask keeps (i, j), else -1e30,
// with K and V read from KV head h / G (G = H / KV: grouped-query
// attention, no expanded copy).  The mask keeps j < S and, when causal,
// i >= j and (with window > 0) i - j < window.  Arithmetic is float32 on
// float32 or bfloat16 inputs; O is written in the input dtype.  As in the
// TPU kernel, the running max starts at the finite -1e30 and the final sum
// is floored at 1e-30, and the online-softmax recurrence is the same:
//   m' = max(m, max_j s), l' = l exp(m - m') + sum_j exp(s - m'),
//   acc' = acc exp(m - m') + sum_j exp(s - m') V[j].
// Tiles wholly above the diagonal or outside the window are skipped; the
// ragged edge past S is masked here, nothing is padded or copied.  When
// lse is not null, each row's float32 statistic L = m + log(max(l, 1e-30))
// (the log of its softmax denominator, which the backward pass in
// flash_attention_bwd.cu reads) is written to lse[(b H + h) S + i]; O is the
// same either way.
//
// What bounds it on this card: operations.  Each unmasked (i, j) pair costs
// 2 hd FFMAs (Q.K and P.V) and one exponential, against one read of q, k, v
// and one write of o: at B = 4, S = 2048, H = 32, hd = 128 that is 1.4e11
// FLOP (2.05 ms at 67 TFLOP/s on the CUDA cores) against 168 MB (0.05 ms).
//
// What the design does about it: a simple CUDA-core kernel, IEEE float32
// FFMA throughout (no tensor cores, no TF32).  One block of 256 threads per
// (b, h, 64-row query tile); heavy (late) causal tiles are launched first.
// The Q tile stays in shared memory, transposed, for the whole key loop;
// each 64-key tile of K is staged transposed, then V in the same buffer.
// Each thread owns a 4-query x 4-key register tile of scores, read with one
// 16-byte shared load of Q and one of K per feature (16 FFMAs per two
// loads), and a 4-query x hd/16 slice of the output accumulator, which
// P (stored transposed) and V rows feed the same way.  The online-softmax
// state (m, l) of a query row lives in the registers of the 16 threads that
// share the row, reduced with shuffles.

#include "common.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int NT = 256;         // threads: 16 (keys / columns) x 16 (rows)
constexpr int QP = BQ + 4;      // padded row of the transposed Q and P tiles
constexpr int KP = BK + 4;      // padded row of the transposed K tile
constexpr float kNegInf = -1e30f;

template <int HD>
struct Smem {
  static constexpr int q = HD * QP;                                  // Qᵀ
  static constexpr int kv = HD * KP > BK * HD ? HD * KP : BK * HD;   // Kᵀ, V
  static constexpr int p = BK * QP;                                  // Pᵀ
  static constexpr size_t bytes = sizeof(float) * (q + kv + p);
};

// Rows [r0, r0 + rows) of one head of a (.., S, .., HD) tensor as float32
// into shared memory: transposed (dst[d * ld + r]) or not (dst[r * HD + d]).
// Rows at or past S are zero.  Consecutive threads read consecutive d.
template <int HD, bool TRANSPOSE, typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long row_stride, int r0, int S) {
  for (int idx = threadIdx.x; idx < BK * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    const int row = r0 + r;
    const float x = row < S ? repro::to_f32(src[row * row_stride + d]) : 0.f;
    if constexpr (TRANSPOSE) {
      dst[d * ld + r] = x;
    } else {
      dst[r * HD + d] = x;
    }
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ void to_array(float4 a, float (&out)[4]) {
  out[0] = a.x;
  out[1] = a.y;
  out[2] = a.z;
  out[3] = a.w;
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT, HD <= 128 ? 2 : 1) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int H, int G, int S,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    int causal, int window, float scale) {
  static_assert(BQ == BK, "one staging loop serves Q, K and V tiles");
  constexpr int CV = HD / 16;   // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                       // [HD][QP]
  float* KV = Qt + Smem<HD>::q;           // Kᵀ [HD][KP], then V [BK][HD]
  float* Pt = KV + Smem<HD>::kv;          // [BK][QP]

  const int tx = threadIdx.x & 15;        // key / column group
  const int ty = threadIdx.x >> 4;        // query row group
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const T* qh = q + b * qsb + h * qsh;
  const T* kh = k + b * ksb + (h / G) * ksh;
  const T* vh = v + b * vsb + (h / G) * vsh;

  stage<HD, true>(Qt, QP, qh, qss, q0, S);

  float acc[4][CV];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CV; ++c) acc[i][c] = 0.f;
  }

  int kt_lo = 0, kt_hi = (S - 1) / BK;    // key tiles, inclusive
  if (causal) {
    kt_hi = min(kt_hi, (q0 + BQ - 1) / BK);
    if (window > 0) kt_lo = max(0, q0 - window + 1) / BK;
  }
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                      // the last tile's V and P are read
    stage<HD, true>(KV, KP, kh, kss, k0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], c[4];
      to_array(*reinterpret_cast<const float4*>(&Qt[d * QP + 4 * ty]), a);
      to_array(*reinterpret_cast<const float4*>(&KV[d * KP + 4 * tx]), c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + 4 * tx + j;
        bool keep = kj < S;
        if (causal) {
          keep = keep && qi >= kj;
          if (window > 0) keep = keep && qi - kj < window;
        }
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CV; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();                      // every thread is done with Kᵀ
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(4 * tx + j) * QP + 4 * ty]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    stage<HD, false>(KV, HD, vh, vss, k0, S);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
      to_array(*reinterpret_cast<const float4*>(&Pt[kk * QP + 4 * ty]), p);
      if constexpr (HD >= 64) {
#pragma unroll
        for (int c4 = 0; c4 < HD / 64; ++c4) {
          float w[4];
          to_array(*reinterpret_cast<const float4*>(
                       &KV[kk * HD + 64 * c4 + 4 * tx]), w);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][4 * c4 + e] = fmaf(p[i], w[e], acc[i][4 * c4 + e]);
        }
      } else {
        const float2 w = *reinterpret_cast<const float2*>(&KV[kk * HD + 2 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(p[i], w.x, acc[i][0]);
          acc[i][1] = fmaf(p[i], w.y, acc[i][1]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + b * osb + qi * oss + h * osh;
#pragma unroll
    for (int c = 0; c < CV; ++c) {
      const int col = HD >= 64 ? 64 * (c / 4) + 4 * tx + c % 4 : 2 * tx + c;
      store_out(orow + col, acc[i][c] / den);
    }
    // m and l are the same in the 16 threads of the row
    if (lse != nullptr && tx == 0)
      lse[(static_cast<long long>(b) * H + h) * S + qi] = m[i] + logf(den);
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B, S, H, KV;
  long long st[12];  // (batch, seq, head) strides of q, k, v, o
  int causal, window;
  float scale;
};

template <typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
  const auto kern = flash_kernel<T, HD>;
  const size_t bytes = Smem<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.B * a.H, (a.S + BQ - 1) / BQ);
  const long long* st = a.st;
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.H, a.H / a.KV,
      a.S,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], a.causal, a.window, a.scale);
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

// lse: NULL, or (B, H, S) float32 for each row's L.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* lse, int bf16,
    int B,
    int S, int H, int KV, int hd,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    int causal, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || window < 0 || (S + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, lse, B, S, H, KV,
               {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh},
               causal, window, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_hd<__nv_bfloat16>(hd, a, s) : launch_hd<float>(hd, a, s);
}
