// K4: flash-attention forward (online softmax), f32 or bf16.
//
// Replaces src/repro/kernels/flashattn/flashattn.py::_kernel (launched
// by flash_attention_call) and computes what the serving path runs,
// src/repro/models/attention.py::chunked_attention:
//   * q is pre-scaled by 1/sqrt(D) and rounded to q's dtype;
//   * s = q.k in f32 (bf16 products are exact in f32), soft-capped as
//     cap * tanh(s / cap) when a cap is given (gemma2's score softcap,
//     f32, after the scaled product and before the mask), then masked
//     with -1e30 where k_pos >= Skv, (causal) k_pos > q_pos, or outside
//     the sliding window — padded keys are masked by k_pos < Skv, never
//     by forcing causality;
//   * running max, denominator and accumulator in f32, p cast to v's
//     dtype before P.V, acc = acc * corr + P.V per key block;
//   * one normalisation at the end by max(l, 1e-30), cast to q's dtype.
// GQA: query head h reads kv head h / (H / KV); K and V are not repeated.
// Layouts are the model's: q (B,S,H,D), k (B,Skv,KV,D), v (B,Skv,KV,Dv),
// out (B,S,H,Dv), all contiguous; D, Dv <= 256.
//
// Design: one 256-thread block per (64 queries, batch*head), 64-key
// tiles of K and V in shared memory (f32, rows padded by one word so
// column walks hit distinct banks), staged one row per warp with the
// lanes along the head (no index division: dividing a flat index by the
// runtime D cost as much as the products).  Both products are
// register-tiled on CUDA cores: thread (ty, tx) of a 16x16 grid owns
// query rows 4*ty..4*ty+3 and, for S = Q.K^T, keys tx + 16*j (j < 4);
// for O += P.V the value columns tx + 16*c (c < WD/16).  The kernel is a
// template over the head-width class WD: 128 (deepseek-7b) or 256
// (gemma2-2b).  At D = 256 the f32 tiles need 214 KB of shared memory
// (opted in with cudaFuncSetAttribute; one block per SM) and each
// thread holds 2 x 64 accumulators; 32x32 tiles (103 KB, two blocks per
// SM) measured slower on the H100, their Q.K^T issuing one shared load
// per FMA instead of two.  Row max and row sum reduce over the 16
// threads of a row group with warp shuffles; P goes through shared
// memory between the two products.  Key tiles past the causal
// diagonal of the whole query block are skipped (tile 0 always runs, so
// every row has seen key 0 before a tile is skipped).
// Bound on the H100 at prefill sizes: operations (2*S*Skv*D per head
// for each of Q.K and P.V, about half under the causal mask).  This
// kernel runs them in f32 on CUDA cores (no TF32 on the exact rung);
// tensor-core tiles for the bf16 rung are later work.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 256, WARPS = THREADS / 32, MAXD = 256;
constexpr int RPT = 4;              // query rows per thread
constexpr int KPT = BKV / 16;       // keys per thread in S
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// round to T and back (the reference's .astype(dtype) on f32 values)
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// reductions over the 16 threads (tx) sharing a row group inside a warp
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// WD: the head-width class (D, Dv <= WD); CPT value columns per thread
template <typename T, int WD>
__global__ void __launch_bounds__(THREADS) flash_fwd(const T* __restrict__ q,
                                                     const T* __restrict__ k,
                                                     const T* __restrict__ v, T* __restrict__ out,
                                                     int S, int H, int Skv, int KV, int D, int Dv,
                                                     float scale, int causal, int window,
                                                     float softcap) {
  constexpr int CPT = WD / 16;
  extern __shared__ float smem[];
  const int DP = D + 1, VP = Dv + 1, PP = BKV + 1;
  float* Qs = smem;               // BQ x DP
  float* Ks = Qs + BQ * DP;       // BKV x DP
  float* Vs = Ks + BKV * DP;      // BKV x VP
  float* Ps = Vs + BKV * VP;      // BQ x PP
  const int t = threadIdx.x, tx = t % 16, ty = t / 16, lane = t % 32, warp = t / 32;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h / (H / KV);

  // tiles are staged row by row, one warp per row, lanes along the head
  for (int r = warp; r < BQ; r += WARPS) {
    const int qi = q0 + r;
    const size_t row = (static_cast<size_t>(b) * S + qi) * H + h;
    for (int d = lane; d < D; d += 32)
      Qs[r * DP + d] = qi < S ? round_to<T>(to_f(q[row * D + d]) * scale) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][CPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;
  }

  int kv_end = Skv;  // keys past the block's last query are masked for every row
  if (causal) kv_end = min(Skv, min(q0 + BQ, S));
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the previous tile is consumed (and Qs is written)
    for (int j = warp; j < BKV; j += WARPS) {
      const int kj = k0 + j;
      const size_t row = (static_cast<size_t>(b) * Skv + kj) * KV + kvh;
      for (int d = lane; d < D; d += 32) Ks[j * DP + d] = kj < Skv ? to_f(k[row * D + d]) : 0.f;
      for (int d = lane; d < Dv; d += 32) Vs[j * VP + d] = kj < Skv ? to_f(v[row * Dv + d]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for rows 4ty..4ty+3, keys tx + 16j
    float s[RPT][KPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[r][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[KPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) qv[r] = Qs[(ty * RPT + r) * DP + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[r][j] = fmaf(qv[r], kv[j], s[r][j]);
    }

    float corr[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int qi = q0 + ty * RPT + r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (softcap > 0.f) s[r][j] = softcap * tanhf(s[r][j] / softcap);
        bool valid = kp < Skv;
        if (causal) valid = valid && kp <= qi;
        if (window > 0) valid = valid && kp > qi - window;
        s[r][j] = valid ? s[r][j] : NEG_INF;
        mx = fmaxf(mx, s[r][j]);
      }
      const float m_new = fmaxf(m[r], group_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = expf(s[r][j] - m_new);
        psum += p;
        Ps[(ty * RPT + r) * PP + tx + 16 * j] = round_to<T>(p);
      }
      corr[r] = expf(m[r] - m_new);
      l[r] = l[r] * corr[r] + group_sum(psum);
      m[r] = m_new;
    }
    __syncthreads();

    // O = O * corr + P V for rows 4ty..4ty+3, value columns tx + 16c
    float pv[RPT][CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) pv[r][c] = 0.f;
    for (int j = 0; j < BKV; ++j) {
      float pj[RPT], vj[CPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) pj[r] = Ps[(ty * RPT + r) * PP + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int d = tx + 16 * c;
        vj[c] = d < Dv ? Vs[j * VP + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) pv[r][c] = fmaf(pj[r], vj[c], pv[r][c]);
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] = acc[r][c] * corr[r] + pv[r][c];
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int qi = q0 + ty * RPT + r;
    if (qi >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = tx + 16 * c;
      if (d < Dv)
        out[((static_cast<size_t>(b) * S + qi) * H + h) * Dv + d] = from_f<T>(acc[r][c] / den);
    }
  }
}

template <typename T, int WD>
int launch_wd(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int Skv,
              int KV, int D, int Dv, float scale, int causal, int window, float softcap,
              cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * (D + 1) + BKV * (D + 1) + BKV * (Dv + 1) + BQ * (BKV + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, WD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd<T, WD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, Skv, KV, D, Dv, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int Skv,
           int KV, int D, int Dv, float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  if (D <= 128 && Dv <= 128)
    return launch_wd<T, 128>(q, k, v, out, B, S, H, Skv, KV, D, Dv, scale, causal, window,
                             softcap, stream);
  return launch_wd<T, 256>(q, k, v, out, B, S, H, Skv, KV, D, Dv, scale, causal, window, softcap,
                           stream);
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// dtype 0: float32, 1: bfloat16.  window <= 0: no sliding window;
// softcap <= 0: no score softcap.
REPRO_EXPORT int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                       int B, int S, int H, int Skv, int KV, int D, int Dv,
                                       float scale, int causal, int window, float softcap,
                                       int dtype, void* stream) {
  if (D > MAXD || Dv > MAXD || D < 1 || Dv < 1 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, S, H, Skv, KV, D, Dv, scale, causal, window, softcap, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, S, H, Skv, KV, D, Dv, scale, causal, window,
                                 softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
