// int8 x int8 -> exact int32 products for K1 (qmatmul) and K2 (fused
// SwiGLU), with the epilogue applied in registers by a functor.
//
// Operands keep the reference layout: A (M, K) and every B (K, N),
// both row-major int8.  __dp4a wants four consecutive k of one column,
// so each B tile is transposed 4x4 bytes at a time (__byte_perm) on its
// way into shared memory; A rows already hold four consecutive k per
// 32-bit word.  Accumulation is exact in int32 for K <= 2**17 (the
// wrappers assert it), so neither kernel depends on summation order.
//
// Two shapes, chosen by the wrapper from M:
//   * gemm_tiled  (M > 8): 64x64 output tile per 256-thread block, 4x4
//     outputs per thread, K streamed in 64-deep tiles — prefill;
//   * gemm_skinny (M <= 8): decode is a matrix-vector product bound by
//     reading B once.  A block owns 32 columns and all of K: lanes
//     split k four ways and columns eight ways, warps split K eight
//     ways, and the partial sums meet in shared memory.
// NB (1 or 2) is the number of B matrices streamed against one A tile.
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

constexpr int TILE_M = 64, TILE_N = 64, TILE_K = 64, TILE_KQ = TILE_K / 4, TILE_PAD = 4;

template <int NB, class Epi>
__global__ void __launch_bounds__(256) gemm_tiled(const int8_t* __restrict__ A, BMats<NB> B,
                                                  int M, int N, int K, Epi epi) {
  __shared__ __align__(16) int As[TILE_KQ][TILE_M + TILE_PAD];
  __shared__ __align__(16) int Bs[NB][TILE_KQ][TILE_N + TILE_PAD];
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * TILE_M, n0 = blockIdx.x * TILE_N;
  int acc[NB][4][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[b][i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += TILE_K) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // A tile: 64 rows x 16 words
      const int w = t + r * 256, row = w / TILE_KQ, kq = w % TILE_KQ;
      const int m = m0 + row, k = k0 + kq * 4;
      As[kq][row] = (m < M && k < K) ? ld32(A + static_cast<size_t>(m) * K + k) : 0;
    }
    {  // B tiles: 16 k-quads x 16 column-quads, one task per thread
      const int kq = t / 16, cq = t % 16;
      const int k = k0 + kq * 4, n = n0 + cq * 4;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        int p[4] = {0, 0, 0, 0};
        if (k < K && n < N) {
          const int8_t* src = B.b[b] + static_cast<size_t>(k) * N + n;
          transpose4x4(ld32(src), ld32(src + N), ld32(src + 2 * N), ld32(src + 3 * N), p);
        }
        *reinterpret_cast<int4*>(&Bs[b][kq][cq * 4]) = make_int4(p[0], p[1], p[2], p[3]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kq = 0; kq < TILE_KQ; ++kq) {
      const int4 a4 = *reinterpret_cast<const int4*>(&As[kq][ty * 4]);
      const int av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int4 b4 = *reinterpret_cast<const int4*>(&Bs[b][kq][tx * 4]);
        const int bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[b][i][j] = __dp4a(av[i], bv[j], acc[b][i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (m < M && n < N) epi(m, n, acc[0][i][j], acc[NB - 1][i][j]);
    }
  }
}

constexpr int SKINNY_MAXM = 8, SKINNY_COLS = 32, SKINNY_WARPS = 8, SKINNY_UNROLL = 4;

template <int NB, class Epi>
__global__ void __launch_bounds__(256) gemm_skinny(const int8_t* __restrict__ A, BMats<NB> B,
                                                   int M, int N, int K, Epi epi) {
  __shared__ int red[NB][SKINNY_WARPS][SKINNY_MAXM][SKINNY_COLS];
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
    epi(m, nn, s[0], s[NB - 1]);
  }
}

// launch either shape on `stream`; returns cudaGetLastError()
template <int NB, class Epi>
int launch_int8_gemm(const int8_t* A, BMats<NB> B, int M, int N, int K, Epi epi,
                     cudaStream_t stream) {
  if (M <= SKINNY_MAXM) {
    dim3 grid((N + SKINNY_COLS - 1) / SKINNY_COLS);
    gemm_skinny<NB, Epi><<<grid, 256, 0, stream>>>(A, B, M, N, K, epi);
  } else {
    dim3 grid((N + TILE_N - 1) / TILE_N, (M + TILE_M - 1) / TILE_M);
    gemm_tiled<NB, Epi><<<grid, 256, 0, stream>>>(A, B, M, N, K, epi);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rq
