// K1: Q-format int8 matmul with ONE deferred power-of-two correction.
//
// Replaces src/repro/kernels/qmatmul/qmatmul.py::_kernel (launched by
// qmatmul_kernel_call).  out[m, n] = epilogue(sum_k A[m,k] B[k,n],
// e = ea + eb[n]) with the reference's three epilogues:
//   0 float: acc * 2**e in f32 (exact power-of-two scale, one rounding
//            in the int -> f32 conversion);
//   1 q16:   Q16.16 shift by s = e + 16: left (wrapping, unsaturated)
//            for s >= 0, round-half-up right shift otherwise, with the
//            reference's shift-count semantics for |s| >= 32;
//   2 int32: the raw accumulator.
// Bound on the H100: bytes for decode (B is read once, 16.8 MB per
// 4096x4096 projection, M <= 8 rows of work per byte), int8 operations
// for prefill (2*M*N*K at 1979 TOP/s).  Design (int8_gemm.cuh): prefill
// on the tensor cores (mma.sync s8 tiles fed by a cp.async ring, B read
// k-major out of its row-major tile by a permuted ldmatrix .trans), decode
// as a dp4a matrix-vector product that streams B once; the epilogue runs
// on the accumulator registers, with the exponents read from device
// memory so that no host sync is needed.
//
// repro_qmatmul is K1 (G = 1).  repro_qmatmul_grouped is G1, the MoE
// experts' down projection on ragged expert groups (not a TPU kernel: the
// reference computes it as an XLA batched dot in src/repro/models/
// moe.py:64, _fused_expert_mlp), on grouped_gemm.cuh's persistent tiles
// over the live rows with 16-byte stores: bound by the live experts'
// weight bytes at decode and by int8 operations at the long prefills
// (grouped_gemm.cuh says what its design does about each).
#include "grouped_gemm.cuh"
#include "int8_gemm.cuh"

namespace {

// Q16.16 by a shift of s = e + 16: left (wrapping, unsaturated) for s >=
// 0, round-half-up right shift otherwise (G1's; K1's epilogue below
// keeps its own copy, so that its compiled tiles stay as measured)
__device__ __forceinline__ int32_t q16_of(int32_t acc, int32_t e) {
  const int32_t s = rq::wadd(e, 16);
  if (s >= 0) return rq::shl(acc, s);
  const int32_t sr = rq::wneg(s);
  const int32_t half = rq::shl(1, sr - 1);
  return rq::sar(rq::wadd(acc, half), sr);
}

struct QmmEpilogue {
  const int32_t* ea;
  const int32_t* eb;
  void* out;
  int M, N;
  int mode;
  __device__ __forceinline__ void operator()(int z, int m, int n, int acc, int) const {
    const int32_t e = rq::wadd(*ea, eb[static_cast<size_t>(z) * N + n]);
    const size_t idx = (static_cast<size_t>(z) * M + m) * N + n;
    if (mode == 0) {
      static_cast<float*>(out)[idx] = __fmul_rn(__int2float_rn(acc), rq::pow2f(e));
    } else if (mode == 1) {
      const int32_t s = rq::wadd(e, 16);
      int32_t r;
      if (s >= 0) {
        r = rq::shl(acc, s);
      } else {
        const int32_t sr = rq::wneg(s);
        const int32_t half = rq::shl(1, sr - 1);
        r = rq::sar(rq::wadd(acc, half), sr);
      }
      static_cast<int32_t*>(out)[idx] = r;
    } else {
      static_cast<int32_t*>(out)[idx] = acc;
    }
  }
};

// G1's epilogue: 4 adjacent columns of a row, 16-byte stores
struct QmmQuad {
  const int32_t* ea;
  const int32_t* eb;
  void* out;
  int M, N;
  int mode;
  __device__ __forceinline__ void quad(int z, int m, int n, int4 a, int4) const {
    const int32_t acc[4] = {a.x, a.y, a.z, a.w};
    const size_t idx = (static_cast<size_t>(z) * M + m) * N + n;
    const int32_t a0 = *ea;
    int32_t e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) e[j] = rq::wadd(a0, eb[static_cast<size_t>(z) * N + n + j]);
    if (mode == 0) {
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = __fmul_rn(__int2float_rn(acc[j]), rq::pow2f(e[j]));
      *reinterpret_cast<float4*>(static_cast<float*>(out) + idx) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
      int32_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = mode == 1 ? q16_of(acc[j], e[j]) : acc[j];
      *reinterpret_cast<int4*>(static_cast<int32_t*>(out) + idx) = make_int4(o[0], o[1], o[2], o[3]);
    }
  }
  __device__ __forceinline__ int zero_consts() const { return 0; }
  __device__ __forceinline__ void zero_quad(int z, int m, int n, int) const {
    quad(z, m, n, make_int4(0, 0, 0, 0), make_int4(0, 0, 0, 0));
  }
};

}  // namespace

REPRO_DEFINE_ERROR_STRING

// A (G,M,K) int8, B (G,K,N) int8, ea (1,) int32, eb (G,N) int32 on the
// device; out (G,M,N) f32 (mode 0) or int32.  K and N multiples of 4 (K1:
// G = 1).
REPRO_EXPORT int repro_qmatmul(const int8_t* A, const int8_t* B, const int32_t* ea,
                               const int32_t* eb, void* out, int G, int M, int N, int K, int mode,
                               void* stream) {
  rq::BMats<1> b{{B}};
  QmmEpilogue epi{ea, eb, out, M, N, mode};
  return rq::launch_int8_gemm<1>(A, b, M, N, K, G, epi, static_cast<cudaStream_t>(stream));
}

// G1: A (G,M,K), B (G,K,N), eb (G,N), out (G,M,N), rows (G,L) int32 on
// the device or null (every row live); M = L * C.
REPRO_EXPORT int repro_qmatmul_grouped(const int8_t* A, const int8_t* B, const int32_t* ea,
                                       const int32_t* eb, void* out, const int32_t* rows, int G,
                                       int M, int N, int K, int L, int mode, void* stream) {
  rq::BMats<1> b{{B}};
  QmmQuad epi{ea, eb, out, M, N, mode};
  return rq::launch_grouped<1>(A, b, G, M, N, K, rq::Ragged{rows, L, M / L}, epi,
                               static_cast<cudaStream_t>(stream));
}
