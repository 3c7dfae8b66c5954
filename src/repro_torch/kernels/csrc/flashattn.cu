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
// f32 (the exact rung), flash_fwd_f32: CUDA-core FFMA only, no TF32 and
// no tensor-core instruction (chip_smoke.py checks its SASS).  Both
// products are register-blocked outer products, as in an SGEMM: warp w
// owns R query rows of the block, each lane an RL-row strip of them, a
// block of scores and a block of output columns (F32Plan).  Q (scaled
// once) and K sit in shared memory d-major, so one LDS.128 gives a lane
// four rows of Q^T or four keys of K^T; V is row-major, so one LDS.128
// gives four columns.  Lanes of a row group read the same Q^T (and P^T)
// words and the row groups the same K^T (and V) words.  The card moves
// one 128-byte shared-memory wavefront for four warp-wide FFMA a cycle,
// so what bounds a product is FFMA per float a lane loads: at D <= 128 on
// full grids (F32Full) a lane runs 8 x 8 scores and 8 x 8 output columns,
// 4 FFMA a float in both products (before: 2 for scalar loads); on short
// grids (F32Short) 8 x 4 (2.7); at D = 256 (F32Wide) 4 x 8 scores (2.7)
// and 4 x 16 columns (3.2), as its 64 x 256 output tile and 227 KB allow.
// K^T is transposed on its way in by 4-byte cp.async, 8 lanes along d,
// into rows padded by 4 floats so the 32 stores hit 32 banks (Q^T
// likewise, scaled in place once its copies land); V comes by 16-byte
// cp.async.  Loads overlap the products: a 128-key tile runs in phases
// (S over K^T, then P.V over V; at D = 256 each in two halves), each
// reading one of two shared panels while the next phase's operand loads
// into the other, one barrier a phase.  P goes through a key-major P^T
// private to its warp, 32 keys at a time, and comes back as LDS.128.  The
// row max reduces over the LKG lanes of a row group by shuffles; the
// denominator stays a per-lane partial until the end.  Scores, the
// softcap (tanhf), masks, corr = exp(m_old - m_new), p = exp(s - m)
// (MUFU.EX2 of (s - m) * log2 e: relative error ~2**-22, exactly 1 where
// s = m = -1e30), acc scaled by corr before P.V accumulates into it, and
// the final division are all f32, as in the reference.  Grid order and
// skipped key tiles are the bf16 path's (below): longest query blocks of
// all heads first, key tiles outside the causal diagonal or the window of
// the whole block never loaded, tiles masked for all rows of a warp (and
// P.V pieces past all its rows or past Skv) skipped by it.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int MAXD = 256;
constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// shared by both paths
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;

// 2**x (MUFU.EX2; relative error ~2**-22, 0 for x = -inf or below -126)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; src_bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}
// 4 bytes global -> shared; src_bytes = 0 writes 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

// The f32 kernel's tile plan: head-width class WD, R query rows per warp,
// RL rows per lane, BKV keys per tile, P^T handed over in pieces of PK
// keys, K^T and V each cut into NS slices.  Warp w of NW owns query rows
// [w R, w R + R) of the block in both products; lane = ry * LKG + kx owns
// rows RL ry .. RL ry + RL - 1 of those, in S the keys 4 LKG c + 4 kx + e
// (c < KC) and in O the value columns 4 LKG c + 4 kx + e (c < CC), e < 4.
// Q^T is d-major with rows padded by 4 floats.  A tile runs in 2 NS
// phases, each reading one of two shared panels while the next phase's
// operand loads into the other: S over the d-slices of K^T (DS rows each,
// d-major, padded like Q^T), then P.V over the key slices of V (row-major,
// BKV / NS rows each); a panel holds either.  P^T is key-major, PK keys at
// a time, one per warp.  Every expression here is plain integer
// arithmetic (the CPU tests evaluate them).
template <int WD_, int R_, int RL_, int BKV_, int PK_, int NS_>
struct F32Plan {
  static constexpr int WD = WD_;
  static constexpr int R = R_;
  static constexpr int RL = RL_;
  static constexpr int BKV = BKV_;
  static constexpr int PK = PK_;
  static constexpr int NS = NS_;
  static constexpr int NW = 8;
  static constexpr int THREADS = 32 * NW;
  static constexpr int BQ = R * NW;
  static constexpr int LRG = R / RL;
  static constexpr int LKG = 32 / LRG;
  static constexpr int KC = BKV / (4 * LKG);
  static constexpr int CC = WD / (4 * LKG);
  static constexpr int DS = WD / NS;
  static constexpr int QS = BQ + 4;
  static constexpr int KS = BKV + 4;
  static constexpr int PR = R + 4;
  static constexpr int PANEL = DS * KS;
  static constexpr int SMEM = 4 * (WD * QS + 2 * PANEL + NW * PK * PR);
};

// 16 rows a warp, 8 x 8 scores and 8 x 8 output columns a lane, 128-key
// tiles: D <= 128 on grids of more than one wave of these blocks
using F32Full = F32Plan<128, 16, 8, 128, 32, 1>;
// 8 rows a warp (64 queries a block, so short prompts spread over twice
// the blocks), 8 x 4 scores and 8 x 4 output columns a lane: D <= 128 on
// small grids (deepseek's prompts to ~500 tokens)
using F32Short = F32Plan<128, 8, 8, 128, 32, 1>;
// D = 256: a lane's 64 accumulators hold a 4 x 16 strip of the 64 x 256
// output tile beside 4 x 8 scores of a 128-key tile, whose K^T and V (256
// KB) pass through the two panels in halves
using F32Wide = F32Plan<256, 8, 4, 128, 32, 2>;

// rows [r0, r0 + ROWS) of a row-major f32 operand (row stride `stride`,
// `width` wide), columns d in [d_lo, d_hi) (d_lo a multiple of 8), into a
// d-major tile (row d - d_lo at `dst` + (d - d_lo) * ts) by 4-byte
// cp.async; rows >= n_rows and d >= width read as 0.  A warp moves 8 d x
// 4 rows per step, lanes along d (32 contiguous bytes of a row): with
// rows padded by 4 floats the 32 stores hit 32 distinct banks.
template <int ROWS, int NW>
__device__ __forceinline__ void load_t(float* dst, int ts, const float* __restrict__ src,
                                       size_t stride, int r0, int n_rows, int d_lo, int d_hi,
                                       int width) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int jb = warp; jb < ROWS / 4; jb += NW) {
    const int j = 4 * jb + lane / 8, row = r0 + j;
    const bool row_live = row < n_rows;
    const float* s = src + (row_live ? static_cast<size_t>(row) * stride : 0);
    for (int d = d_lo + lane % 8; d < d_hi; d += 8) {
      const bool live = row_live && d < width;
      cp_async4(dst + (d - d_lo) * ts + j, live ? s + d : src, live ? 4 : 0);
    }
  }
}

// multiplies the elements of a d-major tile that this thread's load_t
// copied (d < dp) by `scale`, once its copies have landed: q * D**-0.5
// rounded to f32 once, as in the reference
template <int ROWS, int NW>
__device__ __forceinline__ void scale_t(float* dst, int ts, int dp, float scale) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int jb = warp; jb < ROWS / 4; jb += NW)
    for (int d = lane % 8; d < dp; d += 8) dst[d * ts + 4 * jb + lane / 8] *= scale;
}

// rows [r0, r0 + ROWS) of v into a row-major tile WD wide; columns >= width
// and rows >= n_rows read as 0.  vec: rows start 16-byte aligned and
// width % 4 == 0, so 16-byte copies; else 4-byte ones.
template <int ROWS, int WD, int NW>
__device__ __forceinline__ void load_v(float* dst, const float* __restrict__ src, size_t stride,
                                       int r0, int n_rows, int width, bool vec) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int j = warp; j < ROWS; j += NW) {
    const int row = r0 + j;
    const bool row_live = row < n_rows;
    const float* s = src + (row_live ? static_cast<size_t>(row) * stride : 0);
    if (vec) {
      for (int c = 4 * lane; c < WD; c += 128) {
        const bool live = row_live && c < width;
        cp_async16(dst + j * WD + c, live ? s + c : src, live ? 16 : 0);
      }
    } else {
      for (int c = lane; c < WD; c += 32) {
        const bool live = row_live && c < width;
        cp_async4(dst + j * WD + c, live ? s + c : src, live ? 4 : 0);
      }
    }
  }
}

__device__ __forceinline__ float f4(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

template <class P, bool CAP>
__global__ void __launch_bounds__(P::THREADS, 1) flash_fwd_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int S, int H, int Skv, int KV, int D, int Dv, float scale, int causal,
    int window, float softcap, int vec) {
  constexpr int R = P::R, RL = P::RL, NW = P::NW, BQ = P::BQ, BKV = P::BKV, PK = P::PK;
  constexpr int LKG = P::LKG, KC = P::KC, CC = P::CC, WD = P::WD, QS = P::QS, KS = P::KS;
  constexpr int PR = P::PR, NS = P::NS, DS = P::DS, PANEL = P::PANEL, VR = BKV / NS;
  extern __shared__ __align__(16) float f32_smem[];
  float* Qt = f32_smem;          // WD x QS: Q^T, scaled
  float* panels = Qt + WD * QS;  // 2 x PANEL: a d-slice of K^T or a key slice of V
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, ry = lane / LKG, kx = lane % LKG;
  float* Pt = panels + 2 * PANEL + warp * PK * PR;  // PK x PR: the warp's P^T piece
  // the last query blocks have the most keys under the causal mask: the
  // grid starts them first, for every head, before any shorter block
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const size_t kv_stride = static_cast<size_t>(KV) * D, v_stride = static_cast<size_t>(KV) * Dv;
  const float* kb = k + static_cast<size_t>(b) * Skv * kv_stride + static_cast<size_t>(kvh) * D;
  const float* vb = v + static_cast<size_t>(b) * Skv * v_stride + static_cast<size_t>(kvh) * Dv;
  const int dp = (D + 7) / 8 * 8;

  // key tiles that hold a valid key for some row of the block
  int kv_begin = 0, kv_end = Skv;
  if (causal) kv_end = min(Skv, min(q0 + BQ, S));
  if (window > 0) kv_begin = max(0, q0 - window + 1) / BKV * BKV;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  // the operand of phase ph of tile `it` into panel ph % 2: for ph < NS the
  // d-slice ph of K^T, else the key slice ph - NS of V
  const auto load_phase = [&](int it, int ph) {
    float* dst = panels + (ph % 2) * PANEL;
    const int k0 = kv_begin + it * BKV;
    if (ph < NS)
      load_t<BKV, NW>(dst, KS, kb, kv_stride, k0, Skv, ph * DS, min(dp, ph * DS + DS), D);
    else
      load_v<VR, WD, NW>(dst, vb, v_stride, k0 + (ph - NS) * VR, Skv, Dv, vec);
  };
  load_t<BQ, NW>(Qt, QS, q + (static_cast<size_t>(b) * S * H + h) * D,
                 static_cast<size_t>(H) * D, q0, S, 0, dp, D);
  if (n_tiles > 0) load_phase(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  scale_t<BQ, NW>(Qt, QS, dp, scale);

  float acc[RL][4 * CC], m[RL], l[RL];
#pragma unroll
  for (int r = 0; r < RL; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * CC; ++c) acc[r][c] = 0.f;
  }
  const int qa = q0 + warp * R;     // the warp's first query row
  const int qr = qa + RL * ry;      // the lane's first query row
  const float* qt = Qt + warp * R + RL * ry;
  const float* pt = Pt + RL * ry;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kv_begin + it * BKV;
    // a tile masked for all R rows of this warp adds nothing to them; rows
    // past S are never stored
    const bool skip = qa >= S || (causal && k0 > qa + R - 1) ||
                      (window > 0 && k0 + BKV - 1 <= qa - window);
    float s[RL][4 * KC];  // S = Q K^T, then p in place
#pragma unroll
    for (int r = 0; r < RL; ++r)
#pragma unroll
      for (int j = 0; j < 4 * KC; ++j) s[r][j] = 0.f;
#pragma unroll
    for (int ph = 0; ph < 2 * NS; ++ph) {
      cp_async_wait<0>();
      // this phase's panel visible to every warp; every warp is done with
      // the other panel (the previous phase), which the next load refills
      __syncthreads();
      if (ph + 1 < 2 * NS)
        load_phase(it, ph + 1);
      else if (it + 1 < n_tiles)
        load_phase(it + 1, 0);
      cp_async_commit();
      if (skip) continue;
      const float* pn = panels + (ph % 2) * PANEL + 4 * kx;
      if (ph < NS) {
        for (int d0 = ph * DS; d0 < min(dp, ph * DS + DS); d0 += 8) {
          const float* qd = qt + d0 * QS;
          const float* kd = pn + (d0 - ph * DS) * KS;
#pragma unroll
          for (int dd = 0; dd < 8; ++dd) {
            // outer product of RL / 4 4-row columns of Q^T and KC 4-key
            // columns of K^T, one LDS.128 each
            float4 a[RL / 4], bk[KC];
#pragma unroll
            for (int i = 0; i < RL / 4; ++i)
              a[i] = *reinterpret_cast<const float4*>(qd + dd * QS + 4 * i);
#pragma unroll
            for (int c = 0; c < KC; ++c)
              bk[c] = *reinterpret_cast<const float4*>(kd + dd * KS + 4 * LKG * c);
#pragma unroll
            for (int r = 0; r < RL; ++r)
#pragma unroll
              for (int j = 0; j < 4 * KC; ++j)
                s[r][j] = fmaf(f4(a[r / 4], r % 4), f4(bk[j / 4], j % 4), s[r][j]);
          }
        }
        if (ph < NS - 1) continue;
        // softcap, masks and the online softmax; a row's keys live in the
        // LKG lanes of its row group
        const bool masked = k0 + BKV > Skv || (causal && k0 + BKV - 1 > qa) ||
                            (window > 0 && k0 <= qa + R - 1 - window);
#pragma unroll
        for (int r = 0; r < RL; ++r) {
          const int qi = qr + r;
          float mx = NEG_INF;
#pragma unroll
          for (int j = 0; j < 4 * KC; ++j) {
            float x = s[r][j];
            if (CAP) x = softcap * tanhf(x / softcap);
            if (masked) {
              const int kp = k0 + 4 * LKG * (j / 4) + 4 * kx + j % 4;
              bool valid = kp < Skv;
              if (causal) valid = valid && kp <= qi;
              if (window > 0) valid = valid && kp > qi - window;
              x = valid ? x : NEG_INF;
            }
            s[r][j] = x;
            mx = fmaxf(mx, x);
          }
#pragma unroll
          for (int o = LKG / 2; o > 0; o >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float m_new = fmaxf(m[r], mx);
          const float corr = fast_exp2((m[r] - m_new) * LOG2E);
          m[r] = m_new;
          // s - m is exactly 0 where both are -1e30 (a row that has seen
          // only masked keys), so p = 1 there, as in the reference
          float psum = 0.f;
#pragma unroll
          for (int j = 0; j < 4 * KC; ++j) {
            s[r][j] = fast_exp2((s[r][j] - m_new) * LOG2E);
            psum += s[r][j];
          }
          l[r] = l[r] * corr + psum;
#pragma unroll
          for (int c = 0; c < 4 * CC; ++c) acc[r][c] *= corr;
        }
      } else {
        for (int pc = 0; pc < VR / PK; ++pc) {
          // keys past Skv, or past every row of the warp under the causal
          // mask, have p = 0 for its rows (each has a valid key by then) or
          // v = 0: they add exactly nothing
          const int key0 = (ph - NS) * VR + pc * PK;  // in the tile
          if (k0 + key0 >= Skv || (causal && k0 + key0 > qa + R - 1)) break;
          // the lanes' p of keys [key0, key0 + PK) into P^T, one RL-row
          // column per key
#pragma unroll
          for (int c = 0; c < KC; ++c) {
            const int key = 4 * LKG * c + 4 * kx - key0;
            if (key >= 0 && key < PK) {
#pragma unroll
              for (int e = 0; e < 4; ++e)
#pragma unroll
                for (int i = 0; i < RL / 4; ++i)
                  *reinterpret_cast<float4*>(Pt + (key + e) * PR + RL * ry + 4 * i) =
                      make_float4(s[4 * i][4 * c + e], s[4 * i + 1][4 * c + e],
                                  s[4 * i + 2][4 * c + e], s[4 * i + 3][4 * c + e]);
            }
          }
          __syncwarp();
          // O += P V: outer products of RL / 4 4-row columns of P^T and CC
          // 4-column pieces of a V row per key
          const float* vp = pn + pc * PK * WD;
#pragma unroll 8
          for (int j = 0; j < PK; ++j) {
            float4 p[RL / 4], vv[CC];
#pragma unroll
            for (int i = 0; i < RL / 4; ++i)
              p[i] = *reinterpret_cast<const float4*>(pt + j * PR + 4 * i);
#pragma unroll
            for (int c = 0; c < CC; ++c)
              vv[c] = *reinterpret_cast<const float4*>(vp + j * WD + 4 * LKG * c);
#pragma unroll
            for (int r = 0; r < RL; ++r)
#pragma unroll
              for (int c = 0; c < 4 * CC; ++c)
                acc[r][c] = fmaf(f4(p[r / 4], r % 4), f4(vv[c / 4], c % 4), acc[r][c]);
          }
          __syncwarp();  // the piece is read before the next one overwrites it
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < RL; ++r) {
#pragma unroll
    for (int o = LKG / 2; o > 0; o >>= 1) l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
    const int qi = qr + r;
    if (qi >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* dst = out + ((static_cast<size_t>(b) * S + qi) * H + h) * Dv;
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      const int col = 4 * LKG * c + 4 * kx;
      const float4 x = make_float4(acc[r][4 * c] / den, acc[r][4 * c + 1] / den,
                                   acc[r][4 * c + 2] / den, acc[r][4 * c + 3] / den);
      if (vec && col < Dv) {
        *reinterpret_cast<float4*>(dst + col) = x;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < Dv) dst[col + e] = f4(x, e);
      }
    }
  }
}

template <class P, bool CAP>
int launch_f32_plan(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
                    int Skv, int KV, int D, int Dv, float scale, int causal, int window,
                    float softcap, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32<P, CAP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = Dv % 4 == 0 && aligned(v) && aligned(out);
  dim3 grid(B * H, (S + P::BQ - 1) / P::BQ);
  flash_fwd_f32<P, CAP><<<grid, P::THREADS, P::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), S, H, Skv, KV, D, Dv, scale, causal, window, softcap, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int WD, bool CAP>
int launch_f32_cap(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
                   int Skv, int KV, int D, int Dv, float scale, int causal, int window,
                   float softcap, cudaStream_t stream) {
  if constexpr (WD <= 128) {
    const long blocks = static_cast<long>((S + F32Full::BQ - 1) / F32Full::BQ) * B * H;
    if (blocks > 132)
      return launch_f32_plan<F32Full, CAP>(q, k, v, out, B, S, H, Skv, KV, D, Dv, scale, causal,
                                           window, softcap, stream);
    return launch_f32_plan<F32Short, CAP>(q, k, v, out, B, S, H, Skv, KV, D, Dv, scale, causal,
                                          window, softcap, stream);
  } else {
    return launch_f32_plan<F32Wide, CAP>(q, k, v, out, B, S, H, Skv, KV, D, Dv, scale, causal,
                                         window, softcap, stream);
  }
}

template <int WD>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
               int Skv, int KV, int D, int Dv, float scale, int causal, int window, float softcap,
               cudaStream_t stream) {
  if (softcap > 0.f)
    return launch_f32_cap<WD, true>(q, k, v, out, B, S, H, Skv, KV, D, Dv, scale, causal, window,
                                    softcap, stream);
  return launch_f32_cap<WD, false>(q, k, v, out, B, S, H, Skv, KV, D, Dv, scale, causal, window,
                                   softcap, stream);
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
// tanh(y) = (1 - e) / (1 + e) with e = exp(-2|y|) in (0, 1]: no overflow,
// absolute error ~2**-22
__device__ __forceinline__ float fast_tanh(float y) {
  const float e = fast_exp2(-2.f * LOG2E * fabsf(y));
  return copysignf(__fdividef(1.f - e, 1.f + e), y);
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
