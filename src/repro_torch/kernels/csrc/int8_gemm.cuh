// int8 x int8 -> exact int32 products for K1 (qmatmul) and K2 (fused
// SwiGLU), with the epilogue applied in registers by a functor.
//
// Replaces the MXU products of src/repro/kernels/qmatmul/qmatmul.py::
// _kernel and src/repro/kernels/fused_mlp/fused_mlp.py::_kernel (int8 ->
// int32).  Operands keep the reference layout: A (M, K) and every B
// (K, N), both row-major int8.  Accumulation is exact in int32 for K <=
// 2**17 (the wrappers assert it), so neither kernel depends on
// summation order and both are bit-exact against their plain versions.
//
// Two shapes, chosen by the launcher from M:
//   * gemm_tc (M > 8), prefill: bound by int8 operations (2*M*N*K at the
//     tensor cores' 1979 TOP/s).  The products run on the tensor cores,
//     mma.sync.m16n8k32 s8 x s8 -> s32, as the TPU kernel runs them on
//     its matrix unit.  A block of 256 threads (2 x 4 warps) owns 128 B
//     columns (K1: 128 of one B; K2: 64 of each of its two, sharing one
//     A tile) and 128 rows, or 64 rows where 128 would leave SMs without
//     two blocks or (K1) K < 4096 does not pay for the taller tile.  K
//     streams in 64-deep tiles through a 4-stage cp.async ring in dynamic
//     shared memory, three tiles loading while one is multiplied, behind
//     one barrier per tile.  The tensor cores want B k-major (4
//     consecutive k of one column per 32-bit word), and ldmatrix .trans
//     moves 16-bit elements only.  So B stays row-major in shared memory
//     and ldmatrix .trans reads it with its lanes' row addresses
//     permuted: matrix 0 of a 16-deep step takes k rows {0,1,4,5,8,9,
//     12,13}, matrix 1 rows {2,3,6,7,...}, so lane (g, t) receives k
//     4t..4t+3 of columns 2g and 2g+1 as b16 pairs, and two __byte_perm
//     make them the B fragments of an "even" and an "odd" 8-column tile.
//     A rows already hold 4 consecutive k per word (plain ldmatrix).
//     Both tiles are swizzled (16-byte chunks XORed by row bits) so that
//     every ldmatrix phase hits distinct banks.
//   * gemm_skinny (M <= 8): decode is a matrix-vector product bound by
//     reading B once (bytes).  A block owns 32 columns and all of K:
//     lanes split k four ways and columns eight ways, warps split K
//     eight ways, and the partial sums meet in shared memory (dp4a on
//     4x4-byte transposes of B).
// NB (1 or 2) is the number of B matrices streamed against one A tile.
//
// The launchers take a group count G (problems of one shape back to
// back, the group on blockIdx.z); K1 and K2 launch G = 1.  The MoE
// experts' grouped products (G1, G2) run on grouped_gemm.cuh, which
// reuses this file's copies, swizzles, ldmatrix and mma steps.
#pragma once

#include "common.cuh"

namespace rq {

template <int NB>
struct BMats {
  const int8_t* b[NB];
};

// bytes k..k+3 of four consecutive columns (w0..w3 = rows k..k+3, each
// holding 4 columns) -> one 32-bit word per column holding its 4 k
__device__ __forceinline__ void transpose4x4(int w0, int w1, int w2, int w3, int p[4]) {
  const int t0 = __byte_perm(w0, w1, 0x5140);
  const int t1 = __byte_perm(w2, w3, 0x5140);
  const int t2 = __byte_perm(w0, w1, 0x7362);
  const int t3 = __byte_perm(w2, w3, 0x7362);
  p[0] = __byte_perm(t0, t1, 0x5410);
  p[1] = __byte_perm(t0, t1, 0x7632);
  p[2] = __byte_perm(t2, t3, 0x5410);
  p[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ int ld32(const int8_t* p) { return *reinterpret_cast<const int*>(p); }

// ---------------------------------------------------------------------------
// gemm_tc: tensor-core tiles for prefill
// ---------------------------------------------------------------------------

constexpr int TC_BK = 64, TC_STAGES = 4, TC_THREADS = 256;
// bytes of one B row in shared memory: NB matrices x 128 / NB columns
constexpr int TC_ROW = 128;
constexpr int TC_B_BYTES = TC_BK * TC_ROW;

// shared memory of the ring for MT m16 tiles per warp (2 x 4 warps)
constexpr int tc_smem_bytes(int mt) { return TC_STAGES * (32 * mt * TC_BK + TC_B_BYTES); }

// byte offsets of 16-byte chunk c of row r in the swizzled tiles
__device__ __forceinline__ int a_off(int r, int c) {  // A: rows x 64 k
  return r * TC_BK + ((c ^ ((r >> 1) & 3)) << 4);
}
__device__ __forceinline__ int b_off(int k, int c) {  // B: 64 k x 128 columns
  return k * TC_ROW + ((c ^ ((k & 1) | ((k >> 1) & 6))) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes of a row with `avail` bytes left in it (<= 0: none), or the
// zero fill; vec: 16-byte aligned rows whose lengths are multiples of 16
// (one cp.async), else four 4-byte copies (K, N multiples of 4)
__device__ __forceinline__ void copy16(int8_t* dst, const int8_t* src, const int8_t* base,
                                       bool row_ok, int avail, bool vec) {
  if (vec) {
    const bool ok = row_ok && avail > 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(ok ? src : base), "r"(ok ? 16 : 0));
  } else {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const bool ok = row_ok && avail > 4 * w;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst + 4 * w)),
                   "l"(ok ? src + 4 * w : base), "r"(ok ? 4 : 0));
    }
  }
}

template <int NB, int MT>
__device__ __forceinline__ void load_stage(int8_t* st, const int8_t* __restrict__ A, BMats<NB> B,
                                           int M, int N, int K, int m0, int n0, int k0, bool vec) {
  constexpr int BM = 32 * MT, BCH = TC_ROW / NB / 16;  // 16-byte chunks of one matrix in a row
  for (int i = threadIdx.x; i < BM * (TC_BK / 16); i += TC_THREADS) {
    const int r = i / (TC_BK / 16), c = i % (TC_BK / 16), m = m0 + r, k = k0 + 16 * c;
    copy16(st + a_off(r, c), A + static_cast<size_t>(m) * K + k, A, m < M, K - k, vec);
  }
  int8_t* bs = st + BM * TC_BK;
  for (int i = threadIdx.x; i < TC_BK * (TC_ROW / 16); i += TC_THREADS) {
    const int r = i / (TC_ROW / 16), c = i % (TC_ROW / 16), k = k0 + r;
    const int n = n0 + 16 * (c % BCH);
    const int8_t* b = c < BCH ? B.b[0] : B.b[NB - 1];
    copy16(bs + b_off(r, c), b + static_cast<size_t>(k) * N + n, b, k < K, N - n, vec);
  }
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
// c += a (16x32, row) * b (32x8, col), s8 in, exact s32 accumulate
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// MT m16 tiles per warp: a block owns 32 * MT rows.  The B fragments of
// 16 columns come from one ldmatrix .trans of the row-major tile: its
// lanes address the k rows {0,1,4,5,8,9,12,13} (+2 for the second
// matrix) of each 16, so that lane (g, t) receives k 4t..4t+3 of
// columns 2g and 2g+1 as two b16 pairs, which __byte_perm splits into
// the fragments of an "even" and an "odd" n8 tile.  Lane (g, t) then
// holds output columns 4t..4t+3 of each 16 (even tile: 4t, 4t+2).
template <int NB, int MT, class Epi>
__global__ void __launch_bounds__(TC_THREADS) gemm_tc(const int8_t* __restrict__ A, BMats<NB> B,
                                                      int M, int N, int K, Epi epi, int vec) {
  constexpr int BM = 32 * MT, BN = TC_ROW / NB, WN = BN / 4, NG = WN / 16;
  constexpr int STAGE = BM * TC_BK + TC_B_BYTES;
  extern __shared__ __align__(128) int8_t tc_smem[];
  const int z = blockIdx.z;  // the group
  A += static_cast<size_t>(z) * M * K;
#pragma unroll
  for (int b = 0; b < NB; ++b) B.b[b] += static_cast<size_t>(z) * K * N;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + TC_BK - 1) / TC_BK;
  // ldmatrix .trans row of this lane within a 32-deep k step
  const int lm = lane / 8, lj = lane % 8;
  const int k_lane = (lm / 2) * 16 + (lj & 1) + ((lj >> 1) << 2) + 2 * (lm & 1);

  int acc[NB][MT][2 * NG][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2 * NG; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[b][mt][nt][e] = 0;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < nk) load_stage<NB, MT>(tc_smem + s * STAGE, A, B, M, N, K, m0, n0, s * TC_BK, vec);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(TC_STAGES - 2));
    // tile kt has landed; every warp is done with tile kt - 1, whose
    // stage the next load refills
    __syncthreads();
    const int nxt = kt + TC_STAGES - 1;
    if (nxt < nk)
      load_stage<NB, MT>(tc_smem + (nxt % TC_STAGES) * STAGE, A, B, M, N, K, m0, n0,
                         nxt * TC_BK, vec);
    asm volatile("cp.async.commit_group;\n" ::);
    const int8_t* as = tc_smem + (kt % TC_STAGES) * STAGE;
    const int8_t* bs = as + BM * TC_BK;
#pragma unroll
    for (int ks = 0; ks < TC_BK / 32; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(af[mt], as + a_off(wm * 16 * MT + mt * 16 + lane % 16, 2 * ks + lane / 16));
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int ng = 0; ng < NG; ++ng) {
          uint32_t r[4];
          ldsm_x4_t(r, bs + b_off(32 * ks + k_lane, b * (BN / 16) + wn * (WN / 16) + ng));
          const uint32_t e0 = __byte_perm(r[0], r[1], 0x6420), o0 = __byte_perm(r[0], r[1], 0x7531);
          const uint32_t e1 = __byte_perm(r[2], r[3], 0x6420), o1 = __byte_perm(r[2], r[3], 0x7531);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_s8(acc[b][mt][2 * ng], af[mt], e0, e1);
            mma_s8(acc[b][mt][2 * ng + 1], af[mt], o0, o1);
          }
        }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // element e of tile (mt, 2 ng + odd): row g (+8 for e >= 2), column
  // 16 ng + 4 (lane % 4) + 2 (e % 2) + odd of the warp's columns
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + wm * 16 * MT + mt * 16 + lane / 4 + (e / 2) * 8;
#pragma unroll
      for (int nt = 0; nt < 2 * NG; ++nt) {
        const int n = n0 + wn * WN + (nt / 2) * 16 + 4 * (lane % 4) + 2 * (e % 2) + nt % 2;
        if (m < M && n < N) epi(z, m, n, acc[0][mt][nt][e], acc[NB - 1][mt][nt][e]);
      }
    }
}

constexpr int SKINNY_MAXM = 8, SKINNY_COLS = 32, SKINNY_WARPS = 8, SKINNY_UNROLL = 4;

template <int NB, class Epi>
__global__ void __launch_bounds__(256) gemm_skinny(const int8_t* __restrict__ A, BMats<NB> B,
                                                   int M, int N, int K, Epi epi) {
  __shared__ int red[NB][SKINNY_WARPS][SKINNY_MAXM][SKINNY_COLS];
  const int z = blockIdx.z;  // the group
  A += static_cast<size_t>(z) * M * K;
#pragma unroll
  for (int b = 0; b < NB; ++b) B.b[b] += static_cast<size_t>(z) * K * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cq = lane & 7, kq = lane >> 3;  // column quad, k quad
  const int n = blockIdx.x * SKINNY_COLS + cq * 4;
  int acc[NB][SKINNY_MAXM][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int m = 0; m < SKINNY_MAXM; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[b][m][j] = 0;

  if (n < N) {
    // each warp step covers 16 rows of k and the 8 warps interleave; the
    // loads of SKINNY_UNROLL steps are issued before any is used, so a
    // thread keeps 4 * NB * SKINNY_UNROLL reads of B in flight (decode
    // is bound by streaming B once)
    constexpr int STEP = SKINNY_WARPS * 16;
    for (int k0 = (warp * 4 + kq) * 4; k0 < K; k0 += SKINNY_UNROLL * STEP) {
      int w[SKINNY_UNROLL][NB][4];
#pragma unroll
      for (int u = 0; u < SKINNY_UNROLL; ++u) {
        const int k = k0 + u * STEP;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const int8_t* src = B.b[b] + static_cast<size_t>(k) * N + n;
#pragma unroll
          for (int r = 0; r < 4; ++r) w[u][b][r] = k < K ? ld32(src + r * N) : 0;
        }
      }
#pragma unroll
      for (int u = 0; u < SKINNY_UNROLL; ++u) {
        const int k = k0 + u * STEP;
        if (k >= K) break;
        int p[NB][4];
#pragma unroll
        for (int b = 0; b < NB; ++b) transpose4x4(w[u][b][0], w[u][b][1], w[u][b][2], w[u][b][3], p[b]);
#pragma unroll
        for (int m = 0; m < SKINNY_MAXM; ++m) {
          if (m < M) {
            const int a = ld32(A + static_cast<size_t>(m) * K + k);
#pragma unroll
            for (int b = 0; b < NB; ++b)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[b][m][j] = __dp4a(a, p[b][j], acc[b][m][j]);
          }
        }
      }
    }
  }
  // sum the four k quads of a column (lane bits 3 and 4)
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int m = 0; m < SKINNY_MAXM; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int v = acc[b][m][j];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[b][m][j] = v;
      }
  if (kq == 0) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int m = 0; m < SKINNY_MAXM; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) red[b][warp][m][cq * 4 + j] = acc[b][m][j];
  }
  __syncthreads();
  const int m = threadIdx.x / SKINNY_COLS, c = threadIdx.x % SKINNY_COLS;  // 8 x 32 outputs
  const int nn = blockIdx.x * SKINNY_COLS + c;
  if (m < M && nn < N) {
    int s[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      s[b] = 0;
#pragma unroll
      for (int w = 0; w < SKINNY_WARPS; ++w) s[b] += red[b][w][m][c];
    }
    epi(z, m, nn, s[0], s[NB - 1]);
  }
}

template <int NB, int MT, class Epi>
int launch_tc(const int8_t* A, BMats<NB> B, int M, int N, int K, int G, Epi epi, bool vec,
              cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gemm_tc<NB, MT, Epi>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         tc_smem_bytes(MT));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int BN = TC_ROW / NB, BM = 32 * MT;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, G);
  gemm_tc<NB, MT, Epi><<<grid, TC_THREADS, tc_smem_bytes(MT), stream>>>(A, B, M, N, K, epi, vec);
  return static_cast<int>(cudaGetLastError());
}

// launch either shape on `stream` for G groups (epi(z, m, n, acc, acc2)
// sees group z's row m); returns the first CUDA error
template <int NB, class Epi>
int launch_int8_gemm(const int8_t* A, BMats<NB> B, int M, int N, int K, int G, Epi epi,
                     cudaStream_t stream) {
  if (M <= SKINNY_MAXM) {
    dim3 grid((N + SKINNY_COLS - 1) / SKINNY_COLS, 1, G);
    gemm_skinny<NB, Epi><<<grid, 256, 0, stream>>>(A, B, M, N, K, epi);
    return static_cast<int>(cudaGetLastError());
  }
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  bool vec = K % 16 == 0 && N % 16 == 0 && aligned(A);
  for (int b = 0; b < NB; ++b) vec = vec && aligned(B.b[b]);
  // 128-row blocks where they give every SM two blocks and (K1) K is deep
  // enough to pay for them; else 64-row blocks
  const long blocks =
      static_cast<long>((N + TC_ROW / NB - 1) / (TC_ROW / NB)) * ((M + 127) / 128) * G;
  if (blocks >= 2 * 132 && (NB == 2 || K >= 4096))
    return launch_tc<NB, 4>(A, B, M, N, K, G, epi, vec, stream);
  return launch_tc<NB, 2>(A, B, M, N, K, G, epi, vec, stream);
}

}  // namespace rq
