// K2: fused FAST SwiGLU hidden stage with ONE combined correction.
//
// Replaces src/repro/kernels/fused_mlp/fused_mlp.py::_kernel (launched
// by fused_swiglu_kernel_call).  One streamed int8 x tile feeds two
// exact int32 accumulators (x @ Wg, x @ Wu); the whole swiglu_body_q16
// epilogue runs in registers:
//   1. saturating / round-half-up shift of acc_g into Q16.16 (shift
//      counts clamped to 31);
//   2. the CORDIC sigmoid (hyperbolic rotation + linear divide, shared
//      with K3 through cordic.cuh);
//   3. out = (acc_g * acc_u) * sig * 2**(e_g + e_u - 16) in f32.
// Bound on the H100: bytes of Wg and Wu at decode (2 x 45 MB per layer
// at 4096 x 11008), int8 operations at prefill; the CORDIC epilogue is
// a few hundred integer operations per output, negligible next to K.
// Optional gate/sigmoid outputs expose the integer intermediates so the
// kernel can be held bit-exact against the plain version.
//
// repro_fused_swiglu is K2 (G = 1).  repro_fused_swiglu_grouped is G2,
// the MoE experts' gate and up products with this epilogue on ragged
// expert groups (not a TPU kernel: the reference computes them as XLA
// batched dots and swiglu_body_q16 in src/repro/models/moe.py:64,
// _fused_expert_mlp), on grouped_gemm.cuh's persistent tiles over the
// live rows; its epilogue takes 4 columns a thread through cordic.cuh's
// sigmoid_q16_n.  G2 is bound by the live experts' Wg and Wu bytes at
// decode and by int8 operations (and the CORDIC epilogue's integer
// operations) at the long prefills: grouped_gemm.cuh says what its
// design does about each.
#include "cordic.cuh"
#include "grouped_gemm.cuh"
#include "int8_gemm.cuh"

namespace {

// the gate in Q16.16: acc_g * 2**(e_g + 16), saturating left / round-half-up
// right shift, shift counts clamped to 31 (G2's; K2's epilogue below keeps
// its own copy, so that its compiled tiles stay as measured)
__device__ __forceinline__ int32_t gate_q16(int32_t acc_g, int32_t e_g) {
  using namespace rq;
  const int32_t s = wadd(e_g, 16);
  if (s >= 0) {
    const int32_t sl = imin(s, 31);
    const int32_t lim = RAW_MAX >> sl;
    return acc_g > lim ? RAW_MAX : (acc_g < -lim ? -RAW_MAX : shl(acc_g, sl));
  }
  const int32_t sr = imin(wneg(s), 31);
  const int32_t half = shl(1, sr - 1);
  return sar(wadd(acc_g, half), sr);
}

__device__ __forceinline__ float swiglu_out(int32_t acc_g, int32_t acc_u, int32_t sig, float comb) {
  return __fmul_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc_g), __int2float_rn(acc_u)),
                             __int2float_rn(sig)),
                   comb);
}

struct SwigluEpilogue {
  const int32_t* ea;
  const int32_t* eg;
  const int32_t* eu;
  float* out;
  int32_t* gate_out;  // may be null
  int32_t* sig_out;   // may be null
  int M, N;
  __device__ __forceinline__ void operator()(int z, int m, int n, int acc_g, int acc_u) const {
    using namespace rq;
    const size_t col = static_cast<size_t>(z) * N + n;
    const int32_t e_g = wadd(*ea, eg[col]);
    const int32_t e_u = wadd(*ea, eu[col]);
    const int32_t s = wadd(e_g, 16);
    int32_t gate;
    if (s >= 0) {
      const int32_t sl = imin(s, 31);
      const int32_t lim = RAW_MAX >> sl;
      gate = acc_g > lim ? RAW_MAX : (acc_g < -lim ? -RAW_MAX : shl(acc_g, sl));
    } else {
      const int32_t sr = imin(wneg(s), 31);
      const int32_t half = shl(1, sr - 1);
      gate = sar(wadd(acc_g, half), sr);
    }
    const int32_t sig = sigmoid_q16(gate);
    const float comb = pow2f(wsub(wadd(e_g, e_u), 16));
    const size_t idx = (static_cast<size_t>(z) * M + m) * N + n;
    out[idx] = __fmul_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc_g), __int2float_rn(acc_u)),
                                   __int2float_rn(sig)),
                         comb);
    if (gate_out) gate_out[idx] = gate;
    if (sig_out) sig_out[idx] = sig;
  }
};

// G2's epilogue: 4 adjacent columns of a row, 16-byte stores
struct SwigluQuad {
  const int32_t* ea;
  const int32_t* eg;
  const int32_t* eu;
  float* out;
  int32_t* gate_out;  // may be null
  int32_t* sig_out;   // may be null
  int M, N;

  // the exponents e_g of the 4 columns and their combined scales
  __device__ __forceinline__ void exponents(int z, int n, int32_t (&e_g)[4], float (&comb)[4]) const {
    using namespace rq;
    const int32_t a = *ea;
    const size_t col = static_cast<size_t>(z) * N + n;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      e_g[e] = wadd(a, eg[col + e]);
      comb[e] = pow2f(wsub(wadd(e_g[e], wadd(a, eu[col + e])), 16));
    }
  }
  __device__ __forceinline__ void store(int z, int m, int n, const int32_t (&ag)[4],
                                        const int32_t (&au)[4], const int32_t (&gate)[4],
                                        const int32_t (&sig)[4], const float (&comb)[4]) const {
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = swiglu_out(ag[e], au[e], sig[e], comb[e]);
    const size_t idx = (static_cast<size_t>(z) * M + m) * N + n;
    *reinterpret_cast<float4*>(out + idx) = make_float4(o[0], o[1], o[2], o[3]);
    if (gate_out) *reinterpret_cast<int4*>(gate_out + idx) = make_int4(gate[0], gate[1], gate[2], gate[3]);
    if (sig_out) *reinterpret_cast<int4*>(sig_out + idx) = make_int4(sig[0], sig[1], sig[2], sig[3]);
  }
  __device__ __forceinline__ void quad(int z, int m, int n, int4 a, int4 u) const {
    const int32_t ag[4] = {a.x, a.y, a.z, a.w}, au[4] = {u.x, u.y, u.z, u.w};
    int32_t e_g[4], gate[4], sig[4];
    float comb[4];
    exponents(z, n, e_g, comb);
#pragma unroll
    for (int e = 0; e < 4; ++e) sig[e] = gate[e] = gate_q16(ag[e], e_g[e]);
    rq::sigmoid_q16_n<4>(sig);
    store(z, m, n, ag, au, gate, sig, comb);
  }
  // a zero accumulator's gate is 0 whatever the exponent, so its sigmoid
  // is one constant
  __device__ __forceinline__ int32_t zero_consts() const {
    int32_t s[1] = {0};
    rq::sigmoid_q16_n<1>(s);
    return s[0];
  }
  __device__ __forceinline__ void zero_quad(int z, int m, int n, int32_t sig0) const {
    const int32_t zero[4] = {0, 0, 0, 0}, sig[4] = {sig0, sig0, sig0, sig0};
    int32_t e_g[4];
    float comb[4];
    exponents(z, n, e_g, comb);
    store(z, m, n, zero, zero, zero, sig, comb);
  }
};

}  // namespace

REPRO_DEFINE_ERROR_STRING

// x (G,M,K) int8, wg/wu (G,K,F) int8, ea (1,) and eg/eu (G,F) int32 on
// the device; out (G,M,F) f32; gate/sig (G,M,F) int32 or null (K2: G = 1).
REPRO_EXPORT int repro_fused_swiglu(const int8_t* x, const int8_t* wg, const int8_t* wu,
                                    const int32_t* ea, const int32_t* eg, const int32_t* eu,
                                    float* out, int32_t* gate, int32_t* sig, int G, int M, int F,
                                    int K, void* stream) {
  rq::BMats<2> b{{wg, wu}};
  SwigluEpilogue epi{ea, eg, eu, out, gate, sig, M, F};
  return rq::launch_int8_gemm<2>(x, b, M, F, K, G, epi, static_cast<cudaStream_t>(stream));
}

// G2: x (G,M,K), wg/wu (G,K,F), eg/eu (G,F), out/gate/sig (G,M,F), rows
// (G,L) int32 on the device or null (every row live); M = L * C, K and F
// multiples of 4.
REPRO_EXPORT int repro_fused_swiglu_grouped(const int8_t* x, const int8_t* wg, const int8_t* wu,
                                            const int32_t* ea, const int32_t* eg,
                                            const int32_t* eu, float* out, int32_t* gate,
                                            int32_t* sig, const int32_t* rows, int G, int M,
                                            int F, int K, int L, void* stream) {
  rq::BMats<2> b{{wg, wu}};
  SwigluQuad epi{ea, eg, eu, out, gate, sig, M, F};
  return rq::launch_grouped<2>(x, b, G, M, F, K, rq::Ragged{rows, L, M / L}, epi,
                               static_cast<cudaStream_t>(stream));
}
