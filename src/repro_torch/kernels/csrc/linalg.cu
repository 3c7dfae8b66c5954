// C3: the deferred-correction Q-format matmul (paper Listing 3).
//
// Replaces no TPU kernel: the reference computes it in plain JAX
// (src/repro/core/linalg.py::qmatmul_deferred, a scan over K with
// (hi, lo) uint32 limbs).  PyTorch on the card has no integer matmul for
// int32 operands (torch._int_mm is int8 only), so the engine's q16_16
// matmul on a CUDA tensor runs here.
//
// C[m, n] = combine over K tiles t of tile_k (the last one ragged) of
//   low32( (sum_{k in t} A[m,k] * B[k,n] + round) >> frac_bits )
// with the sum in 64-bit two's complement (wrapping mod 2**64, as the
// reference's limbs do), round = 2**(frac_bits-1) or 0, an arithmetic
// shift, and combine = saturating int32 add (or a wrapping one).
//
// Bound on the H100: integer operations.  One 64-bit multiply-add is four
// 32-bit lane operations (low and high product words, a 64-bit add as
// two adds with carry): on the SM's FMA pipe it is one IMAD.WIDE issued
// over two cycles of its 64 lanes.  At M = K = N = 4096 the bytes (A and
// B read once, C written once: 201 MB) take 0.06 ms against ~8 ms of
// operations.
//
// Design (a simple first one): a 64 x 64 block of outputs per 256
// threads, each thread a 4 x 4 register block of uint64 accumulators and
// int32 results; A (transposed) and B staged through shared memory 16
// deep; the k loop runs in stretches between K-tile ends, after each of
// which every accumulator is flushed once (round, shift, truncate,
// combine).
// tile_k, frac_bits, rounding and saturate are runtime arguments, so one
// build serves every tile size.  Products are signed (int64, exact), the
// accumulation unsigned, so overflow is defined and wraps.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
// the A tile is stored k-major with 4 words of padding: 16-byte aligned
// rows for the vector loads, two-way bank conflicts on the transposing store
constexpr int AS_LD = BM + 4;

__device__ __forceinline__ int32_t combine(int32_t c, int32_t t, int saturate) {
  if (!saturate) return rq::wadd(c, t);
  const int64_t s = static_cast<int64_t>(c) + t;
  return static_cast<int32_t>(s > rq::RAW_MAX ? rq::RAW_MAX : (s < rq::RAW_MIN ? rq::RAW_MIN : s));
}

__global__ void __launch_bounds__(THREADS)
deferred_matmul_kernel(const int32_t* __restrict__ A, const int32_t* __restrict__ B,
                       int32_t* __restrict__ C, int M, int N, int K, int tile_k, int frac_bits,
                       int rounding, int saturate) {
  __shared__ __align__(16) int32_t As[BK][AS_LD];
  __shared__ __align__(16) int32_t Bs[BK][BN];
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  uint64_t acc[TM][TN];
  int32_t c[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = 0;
      c[i][j] = 0;
    }
  const uint64_t half = rounding ? (1ull << (frac_bits - 1)) : 0ull;
  int flush_at = tile_k < K ? tile_k : K;  // k (exclusive) that ends this K tile

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < BM * BK / THREADS; ++r) {
      const int idx = threadIdx.x + r * THREADS;
      const int row = idx / BK, kk = idx % BK;
      const int gm = m0 + row, gk = k0 + kk;
      As[kk][row] = (gm < M && gk < K) ? A[static_cast<size_t>(gm) * K + gk] : 0;
    }
#pragma unroll
    for (int r = 0; r < BK * BN / THREADS; ++r) {
      const int idx = threadIdx.x + r * THREADS;
      const int kk = idx / BN, col = idx % BN;
      const int gk = k0 + kk, gn = n0 + col;
      Bs[kk][col] = (gk < K && gn < N) ? B[static_cast<size_t>(gk) * N + gn] : 0;
    }
    __syncthreads();
    const int kend = K - k0 < BK ? K - k0 : BK;
    // runs of k steps between K-tile ends: the multiply-add loop holds no
    // branch, so the accumulators stay in place across its iterations
    for (int kk = 0; kk < kend;) {
      const int stop = flush_at - k0 < kend ? flush_at - k0 : kend;
#pragma unroll 4
      for (; kk < stop; ++kk) {
        const int4 av = *reinterpret_cast<const int4*>(&As[kk][ty * TM]);
        const int4 bv = *reinterpret_cast<const int4*>(&Bs[kk][tx * TN]);
        const int32_t a[TM] = {av.x, av.y, av.z, av.w};
        const int32_t b[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] += static_cast<uint64_t>(static_cast<int64_t>(a[i]) * b[j]);
      }
      if (k0 + kk == flush_at) {
        // one rounding event per output and K tile (paper Eq. 18)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int64_t v = static_cast<int64_t>(acc[i][j] + half) >> frac_bits;
            c[i][j] = combine(c[i][j], static_cast<int32_t>(static_cast<uint32_t>(v)), saturate);
            acc[i][j] = 0;
          }
        flush_at = K - flush_at > tile_k ? flush_at + tile_k : K;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) C[static_cast<size_t>(gm) * N + gn] = c[i][j];
    }
  }
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// A (M,K) int32, B (K,N) int32, C (M,N) int32, all contiguous on the
// device; K >= 1, 1 <= tile_k, 0 < frac_bits < 32.
REPRO_EXPORT int repro_qmatmul_deferred(const int32_t* A, const int32_t* B, int32_t* C, int M,
                                        int N, int K, int tile_k, int frac_bits, int rounding,
                                        int saturate, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || tile_k <= 0 || frac_bits <= 0 || frac_bits >= 32 ||
      (M + BM - 1) / BM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  deferred_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      A, B, C, M, N, K, tile_k, frac_bits, rounding, saturate);
  return static_cast<int>(cudaGetLastError());
}
