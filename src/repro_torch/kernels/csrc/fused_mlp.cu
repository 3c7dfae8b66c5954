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
// The export runs G such hidden stages of one shape in one launch, the
// group on blockIdx.z (int8_gemm.cuh): G = 1 is K2; G = E is the MoE
// experts' gate and up products with this epilogue (not a TPU kernel: the
// reference computes them as XLA batched dots and swiglu_body_q16 in
// src/repro/models/moe.py::_fused_expert_mlp).
#include "cordic.cuh"
#include "int8_gemm.cuh"

namespace {

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

}  // namespace

REPRO_DEFINE_ERROR_STRING

// x (G,M,K) int8, wg/wu (G,K,F) int8, ea (1,) and eg/eu (G,F) int32 on
// the device; out (G,M,F) f32; gate/sig (G,M,F) int32 or null.
REPRO_EXPORT int repro_fused_swiglu(const int8_t* x, const int8_t* wg, const int8_t* wu,
                                    const int32_t* ea, const int32_t* eg, const int32_t* eu,
                                    float* out, int32_t* gate, int32_t* sig, int G, int M, int F,
                                    int K, void* stream) {
  rq::BMats<2> b{{wg, wu}};
  SwigluEpilogue epi{ea, eg, eu, out, gate, sig, M, F};
  return rq::launch_int8_gemm<2>(x, b, M, F, K, G, epi, static_cast<cudaStream_t>(stream));
}
