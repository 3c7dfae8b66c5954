// K4: flash-attention forward (online softmax), f32 or bf16.
//
// Replaces src/repro/kernels/flashattn/flashattn.py::_kernel (launched
// by flash_attention_call), whose two products run on the TPU's matrix
// unit, and computes what the serving path runs,
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
// Bound on the H100 at prefill sizes: operations (2*S*Skv*D per head
// for each of Q.K and P.V, about half under the causal mask, less under
// a window) — in bf16 at the tensor cores' 989 TFLOP/s, in f32 at the
// CUDA cores' 67.  Both kernels are templates over the head-width class
// WD: 128 (deepseek-7b) or 256 (gemma2-2b).
//
// bf16 (the q16_16 rung), flash_fwd_tc: both products on the tensor
// cores, mma.sync.m16n8k16 bf16 with f32 accumulators, as the TPU kernel
// runs them on its matrix unit.  Q, K and V stay bf16 in shared memory,
// rows swizzled (16-byte chunk c of row r at c ^ (r & 7)) so that the
// ldmatrix reads hit distinct banks; K and V tiles come in by cp.async
// in two stages, the next tile loading while the current one is
// multiplied, behind one barrier per tile.  Each warp owns 16 query
// rows: the Q.K^T accumulator stays in registers, the softcap and the
// masks apply to its fragments, row max and row sum reduce over the four
// lanes that share a row, and p = exp(s - m) (MUFU.EX2 of (s - m) *
// log2 e) is rounded to bf16 in registers — the reference's
// p.astype(v.dtype) — and fed straight to P.V as the A operand; V's B
// fragments come from ldmatrix .trans.  Q's fragments are reloaded from
// shared memory for every k-step, so at D = 256 the registers hold the
// 16 x 256 output accumulator (128 per thread) and one 32-key score
// tile; D <= 128 takes 64-key tiles.  A block has 8 warps (128 queries);
// at D = 256 (128 KB of tiles, one block per SM) it has 4 where 8 would
// leave SMs without two blocks.  The softcap is a template parameter
// (its tanh, (1 - e) / (1 + e) with e = exp(-2|y|), stays out of the
// uncapped loop).  The grid runs the query blocks with the most keys
// first, over all heads: under the causal mask query block i reads i + 1
// blocks of keys, and launched head by head the last wave was left with
// the longest.  Key tiles past the causal diagonal or before the sliding
// window of every row of the block are never loaded, and a warp skips
// the tiles masked for all of its 16 rows: a skipped tile adds exactly
// nothing to a row that has seen its diagonal key, and a fully masked
// tile that ran first would be wiped by corr = 0 at the row's first
// valid key (s - m is exactly 0 there, so p = 1 as in the reference).
//
// f32 (the exact rung), flash_fwd_f32: CUDA-core FMAs, no TF32.  One
// 256-thread block per (64 queries, batch*head), 64-key tiles of K and V
// in shared memory (f32, rows padded by one word so column walks hit
// distinct banks), staged one row per warp with the lanes along the
// head.  Thread (ty, tx) of a 16x16 grid owns query rows 4*ty..4*ty+3
// and, for S = Q.K^T, keys tx + 16*j (j < 4); for O += P.V the value
// columns tx + 16*c (c < WD/16).  At D = 256 the tiles need 214 KB of
// shared memory (one block per SM).  Row max and row sum reduce over
// the 16 threads of a row group with warp shuffles; P goes through
// shared memory between the two products.  Key tiles past the causal
// diagonal of the whole query block are skipped.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int MAXD = 256;
constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64, BKV = 64, THREADS = 256, WARPS = THREADS / 32;
constexpr int RPT = 4;              // query rows per thread
constexpr int KPT = BKV / 16;       // keys per thread in S

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
template <int WD>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32(const float* __restrict__ q,
                                                         const float* __restrict__ k,
                                                         const float* __restrict__ v,
                                                         float* __restrict__ out, int S, int H,
                                                         int Skv, int KV, int D, int Dv,
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
    for (int d = lane; d < D; d += 32) Qs[r * DP + d] = qi < S ? q[row * D + d] * scale : 0.f;
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
      for (int d = lane; d < D; d += 32) Ks[j * DP + d] = kj < Skv ? k[row * D + d] : 0.f;
      for (int d = lane; d < Dv; d += 32) Vs[j * VP + d] = kj < Skv ? v[row * Dv + d] : 0.f;
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
        Ps[(ty * RPT + r) * PP + tx + 16 * j] = p;
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
      if (d < Dv) out[((static_cast<size_t>(b) * S + qi) * H + h) * Dv + d] = acc[r][c] / den;
    }
  }
}

template <int WD>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
               int Skv, int KV, int D, int Dv, float scale, int causal, int window, float softcap,
               cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * (D + 1) + BKV * (D + 1) + BKV * (Dv + 1) + BQ * (BKV + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<WD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_f32<WD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), S, H, Skv, KV, D, Dv, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// key-tile rows per width class: the registers of one score tile and the
// 16 x WD output accumulator must fit beside each other at D = 256
template <int WD>
struct TcTile {
  static constexpr int BKV = WD <= 128 ? 64 : 32;
};

// K and V tiles in flight: the next one loads while the current one is
// multiplied (a third stage measured no faster)
constexpr int KV_STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

// 2**x (MUFU.EX2; relative error ~2**-22, 0 for x = -inf or below -126)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// tanh(y) = (1 - e) / (1 + e) with e = exp(-2|y|) in (0, 1]: no overflow,
// absolute error ~2**-22
__device__ __forceinline__ float fast_tanh(float y) {
  const float e = fast_exp2(-2.f * LOG2E * fabsf(y));
  return copysignf(__fdividef(1.f - e, 1.f + e), y);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; src_bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// element offset of 16-byte chunk c of row r in a swizzled tile WD wide
template <int WD>
__device__ __forceinline__ int swz(int r, int c) {
  return (r * (WD / 8) + (c ^ (r & 7))) * 8;
}

// rows [r0, r0 + ROWS) of a (rows, width) bf16 operand with row stride
// `stride` into a swizzled shared tile; rows >= n_rows and columns >=
// width read as 0.  vec: every row starts 16-byte aligned and width % 8
// == 0, so whole chunks go by cp.async; else element by element.
template <int WD, int ROWS, int THREADS_>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, size_t stride,
                                          int r0, int n_rows, int width, bool vec) {
  constexpr int CHUNKS = WD / 8;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS_) {
    const int r = i / CHUNKS, c = i % CHUNKS, row = r0 + r, col = c * 8;
    const bool live = row < n_rows && col < width;
    bf16* d = dst + swz<WD>(r, c);
    if (vec) {
      cp_async16(d, live ? src + row * stride + col : src, live ? 16 : 0);
    } else {
      __align__(16) bf16 e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = live && col + j < width ? src[row * stride + col + j] : __float2bfloat16_rn(0.f);
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(e);
    }
  }
}

template <int WD, int NW, bool CAP>
__global__ void __launch_bounds__(32 * NW) flash_fwd_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, int S, int H, int Skv, int KV, int D, int Dv, float scale, int causal,
    int window, float softcap, int vec) {
  constexpr int BKV = TcTile<WD>::BKV, NT = BKV / 8, DT = WD / 8;
  constexpr int TC_THREADS = 32 * NW, TC_BQ = 16 * NW;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);  // TC_BQ x WD
  bf16* KVs = Qs + TC_BQ * WD;                  // KV_STAGES x (K, V), BKV x WD each
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, tq = lane % 4;
  // the last query blocks have the most keys under the causal mask: the
  // grid starts them first, for every head, before any shorter block
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BQ;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const size_t kv_stride = static_cast<size_t>(KV) * D, v_stride = static_cast<size_t>(KV) * Dv;
  const bf16* kb = k + static_cast<size_t>(b) * Skv * kv_stride + static_cast<size_t>(kvh) * D;
  const bf16* vb = v + static_cast<size_t>(b) * Skv * v_stride + static_cast<size_t>(kvh) * Dv;

  // key tiles that hold a valid key for some row of the block
  int kv_begin = 0, kv_end = Skv;
  if (causal) kv_end = min(Skv, min(q0 + TC_BQ, S));
  if (window > 0) kv_begin = max(0, q0 - window + 1) / BKV * BKV;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  auto load_kv = [&](int tile, int stage) {
    bf16* ks = KVs + stage * 2 * BKV * WD;
    const int k0 = kv_begin + tile * BKV;
    load_tile<WD, BKV, TC_THREADS>(ks, kb, kv_stride, k0, Skv, D, vec);
    load_tile<WD, BKV, TC_THREADS>(ks + BKV * WD, vb, v_stride, k0, Skv, Dv, vec);
  };
#pragma unroll
  for (int st = 0; st < KV_STAGES - 1; ++st) {
    if (st < n_tiles) load_kv(st, st);
    cp_async_commit();
  }

  // Q: scaled in f32 and rounded to bf16 (the reference's q rounding)
  for (int i = threadIdx.x; i < TC_BQ * DT; i += TC_THREADS) {
    const int r = i / DT, c = i % DT, qi = q0 + r;
    const bf16* src = q + ((static_cast<size_t>(b) * S + qi) * H + h) * D + c * 8;
    __align__(16) bf16 e[8];
    if (vec && qi < S && c * 8 < D) *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool live = qi < S && c * 8 + j < D;
      const bf16 x = vec ? e[j] : (live ? src[j] : e[j]);
      e[j] = __float2bfloat16_rn(live ? __bfloat162float(x) * scale : 0.f);
    }
    *reinterpret_cast<uint4*>(Qs + swz<WD>(r, c)) = *reinterpret_cast<const uint4*>(e);
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int qa = q0 + warp * 16;      // the warp's first query row
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  const int rows[2] = {qa + g, qa + g + 8};

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<KV_STAGES - 2>();
    // tile `it` (and Qs) visible to every warp; every warp is done with
    // tile it - 1, whose stage the next load refills
    __syncthreads();
    const int nxt = it + KV_STAGES - 1;
    if (nxt < n_tiles) load_kv(nxt, nxt % KV_STAGES);
    cp_async_commit();
    const int k0 = kv_begin + it * BKV;
    const bf16* Ks = KVs + (it % KV_STAGES) * 2 * BKV * WD;
    const bf16* Vs = Ks + BKV * WD;
    // a tile masked for all 16 rows of this warp adds nothing to them
    const bool skip = (causal && k0 > qa + 15) || (window > 0 && k0 + BKV - 1 <= qa - window);
    if (!skip) {
      // S = Q K^T: 16 rows x BKV keys per warp, in registers
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < WD / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, Qs + swz<WD>(warp * 16 + lane % 16, 2 * kk + lane / 16));
#pragma unroll
        for (int jn = 0; jn < NT / 2; ++jn) {
          uint32_t bk[4];
          ldsm_x4(bk, Ks + swz<WD>(jn * 16 + lane % 8 + (lane / 16) * 8, 2 * kk + (lane / 8) % 2));
          mma_bf16(s[2 * jn], a, bk[0], bk[1]);
          mma_bf16(s[2 * jn + 1], a, bk[2], bk[3]);
        }
      }
      // softcap and masks on the fragments: s[j][e] is row rows[e / 2],
      // key k0 + 8j + 2tq + (e % 2)
      const bool masked = k0 + BKV > Skv || (causal && k0 + BKV - 1 > qa) ||
                          (window > 0 && k0 <= qa + 15 - window);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e];
          if (CAP) x = softcap * fast_tanh(x * inv_cap);
          if (masked) {
            const int kp = k0 + 8 * j + 2 * tq + (e & 1), qi = rows[e >> 1];
            bool valid = kp < Skv;
            if (causal) valid = valid && kp <= qi;
            if (window > 0) valid = valid && kp > qi - window;
            x = valid ? x : NEG_INF;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = expf(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[j][0] *= corr[0];
        acc[j][1] *= corr[0];
        acc[j][2] *= corr[1];
        acc[j][3] *= corr[1];
      }
      // p = exp(s - m) in f32 for the denominator, rounded to bf16 for P.V
      // (s - m is exactly 0 where both are -1e30, as in the reference)
      uint32_t pa[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = fast_exp2((s[j][e] - m[e >> 1]) * LOG2E);
          l[e >> 1] += p[e];
        }
        pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
      // O += P V: P (16 x BKV) from registers, V by ldmatrix .trans
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
        for (int jd = 0; jd < DT / 2; ++jd) {
          uint32_t bv[4];
          ldsm_x4_t(bv, Vs + swz<WD>(kk * 16 + lane % 8 + ((lane / 8) % 2) * 8, 2 * jd + lane / 16));
          mma_bf16(acc[2 * jd], pa[kk], bv[0], bv[1]);
          mma_bf16(acc[2 * jd + 1], pa[kk], bv[2], bv[3]);
        }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = rows[r];
    if (qi >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    bf16* o = out + ((static_cast<size_t>(b) * S + qi) * H + h) * Dv;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int d = 8 * j + 2 * tq;
      const float x0 = acc[j][2 * r] / den, x1 = acc[j][2 * r + 1] / den;
      if (vec && d < Dv) {
        *reinterpret_cast<__nv_bfloat162*>(o + d) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < Dv) o[d] = __float2bfloat16_rn(x0);
        if (d + 1 < Dv) o[d + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

template <int WD, int NW, bool CAP>
int launch_tc_nw(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
                 int Skv, int KV, int D, int Dv, float scale, int causal, int window,
                 float softcap, cudaStream_t stream) {
  constexpr int BKV = TcTile<WD>::BKV, TC_THREADS = 32 * NW, TC_BQ = 16 * NW;
  const size_t smem = sizeof(bf16) * WD * (TC_BQ + 2 * KV_STAGES * BKV);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc<WD, NW, CAP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = D % 8 == 0 && Dv % 8 == 0 && aligned(q) && aligned(k) && aligned(v) &&
                  aligned(out);
  dim3 grid(B * H, (S + TC_BQ - 1) / TC_BQ);
  flash_fwd_tc<WD, NW, CAP><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), S, H, Skv, KV, D, Dv, scale, causal, window, softcap, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int WD, bool CAP>
int launch_tc_cap(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
                  int Skv, int KV, int D, int Dv, float scale, int causal, int window,
                  float softcap, cudaStream_t stream) {
  // 8 warps (128 queries) per block; at D = 256 (128 KB of tiles, one
  // block per SM) only where that still gives every SM two blocks
  constexpr bool narrow = WD <= 128;
  if constexpr (!narrow) {
    const long blocks = static_cast<long>((S + 127) / 128) * B * H;
    if (blocks < 2 * 132)
      return launch_tc_nw<WD, 4, CAP>(q, k, v, out, B, S, H, Skv, KV, D, Dv, scale, causal,
                                      window, softcap, stream);
  }
  return launch_tc_nw<WD, 8, CAP>(q, k, v, out, B, S, H, Skv, KV, D, Dv, scale, causal, window,
                                  softcap, stream);
}

template <int WD>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
              int Skv, int KV, int D, int Dv, float scale, int causal, int window, float softcap,
              cudaStream_t stream) {
  if (softcap > 0.f)
    return launch_tc_cap<WD, true>(q, k, v, out, B, S, H, Skv, KV, D, Dv, scale, causal, window,
                                   softcap, stream);
  return launch_tc_cap<WD, false>(q, k, v, out, B, S, H, Skv, KV, D, Dv, scale, causal, window,
                                  softcap, stream);
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
  const bool narrow = D <= 128 && Dv <= 128;
  if (dtype == 0)
    return narrow ? launch_f32<128>(q, k, v, out, B, S, H, Skv, KV, D, Dv, scale, causal, window,
                                    softcap, st)
                  : launch_f32<256>(q, k, v, out, B, S, H, Skv, KV, D, Dv, scale, causal, window,
                                    softcap, st);
  if (dtype == 1)
    return narrow ? launch_tc<128>(q, k, v, out, B, S, H, Skv, KV, D, Dv, scale, causal, window,
                                   softcap, st)
                  : launch_tc<256>(q, k, v, out, B, S, H, Skv, KV, D, Dv, scale, causal, window,
                                   softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
