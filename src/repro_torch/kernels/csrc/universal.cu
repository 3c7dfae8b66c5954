// K5-K7: the universal CORDIC family, elementwise on int32 words.
//
// Replaces the three Pallas TPU kernels of
// src/repro/kernels/cordic/universal.py:
//   K5 _unary_kernel  (universal_kernel_call): Q16.16 sqrt exp log tanh
//      sigmoid, hyperbolic vectoring / rotation on a Q3.29 datapath with
//      the reference's `stages` schedule (repeats at 4, 13, 40, ...);
//   K6 _atan2_kernel  (atan2_kernel_call): circular vectoring, operands
//      normalised to bit 28, `iterations` atan entries in the output
//      format (frac_bits 16 or 24);
//   K7 _div_kernel    (div_kernel_call): full-range Q16.16 division by
//      linear vectoring, div(0, 0) = 0.
// The per-element functions live in cordic.cuh (shared with K2) and are
// the C form of the bodies in src/repro_torch/core/cordic.py, bit for
// bit; every integer operation goes through common.cuh, which gives C
// the reference's (XLA's) wrapping adds and shift semantics.  Every op
// is total on any int32 input (0, RAW_MIN, RAW_MAX, negatives).
//
// The TPU kernel pads to (rows, 128) blocks; here one thread takes one
// element at a time in a grid-stride loop, so there is no padding.
// Bound on the H100: integer operations.  Each element reads 4 or 8
// bytes and writes 4, against 100-300 integer ALU operations (20 stages
// of 2 shifts, 3 adds and a compare, the normalisation cascade and, for
// tanh and sigmoid, a 17-step division): at 2**24 elements the bytes
// take ~0.06 ms and the operations several times that.  The schedule and
// the atanh / atan tables travel by value in the kernel's parameter
// bank (constant memory), so `stages` and `iterations` are the
// caller's, as in the reference.
#include "cordic.cuh"

namespace {

enum UnaryOp { kSqrt = 0, kExp = 1, kLog = 2, kTanh = 3, kSigmoid = 4 };

template <int OP>
__device__ __forceinline__ int32_t unary_one(int32_t w, const rq::HyperParams& h) {
  if (OP == kSqrt) return rq::sqrt_q16(w, h);
  if (OP == kExp) return rq::exp_q16(w, h);
  if (OP == kLog) return rq::log_q16(w, h);
  if (OP == kTanh) return rq::tanh_q16(w, h);
  return rq::sigmoid_q16(w, h);
}

template <int OP>
__global__ void unary_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, int64_t n,
                             rq::HyperParams h) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    out[i] = unary_one<OP>(in[i], h);
}

__global__ void atan2_kernel(const int32_t* __restrict__ y, const int32_t* __restrict__ x,
                             int32_t* __restrict__ out, int64_t n, rq::AtanParams p) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    out[i] = rq::atan2_q(y[i], x[i], p);
}

__global__ void div_kernel(const int32_t* __restrict__ num, const int32_t* __restrict__ den,
                           int32_t* __restrict__ out, int64_t n, int iterations) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    out[i] = rq::div_q16(num[i], den[i], iterations);
}

constexpr int THREADS = 256;

int grid_for(long long n) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  // 132 SMs x 8 resident blocks of 256 threads, a few waves deep
  return static_cast<int>(blocks < 132 * 8 * 4 ? blocks : 132 * 8 * 4);
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// K5.  op: 0 sqrt, 1 exp, 2 log, 3 tanh, 4 sigmoid.  shift / atanh:
// `stages` (<= 64) entries of hyperbolic_schedule(stages) and
// atanh_table(schedule, 29); k_h_inv = hyper_gain_inverse(schedule, 29).
REPRO_EXPORT int repro_universal_unary(const int32_t* in, int32_t* out, long long n, int op,
                                       const int32_t* shift, const int32_t* atanh, int stages,
                                       int k_h_inv, void* stream) {
  if (stages < 0 || stages > rq::MAX_HYPER_STAGES || op < 0 || op > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  rq::HyperParams h{};
  for (int j = 0; j < stages; ++j) {
    h.shift_[j] = shift[j];
    h.atanh_[j] = atanh[j];
  }
  h.stages_ = stages;
  h.k_h_inv_ = k_h_inv;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = grid_for(n);
  switch (op) {
    case kSqrt: unary_kernel<kSqrt><<<g, THREADS, 0, st>>>(in, out, n, h); break;
    case kExp: unary_kernel<kExp><<<g, THREADS, 0, st>>>(in, out, n, h); break;
    case kLog: unary_kernel<kLog><<<g, THREADS, 0, st>>>(in, out, n, h); break;
    case kTanh: unary_kernel<kTanh><<<g, THREADS, 0, st>>>(in, out, n, h); break;
    default: unary_kernel<kSigmoid><<<g, THREADS, 0, st>>>(in, out, n, h); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// K6.  table: `iterations` (<= 32) entries of atan_table(iterations,
// frac_bits); pi: round(pi * 2**frac_bits).
REPRO_EXPORT int repro_universal_atan2(const int32_t* y, const int32_t* x, int32_t* out,
                                       long long n, const int32_t* table, int iterations, int pi,
                                       void* stream) {
  if (iterations < 0 || iterations > 32) return static_cast<int>(cudaErrorInvalidValue);
  rq::AtanParams p{};
  for (int i = 0; i < iterations; ++i) p.table[i] = table[i];
  p.iterations = iterations;
  p.pi = pi;
  if (n == 0) return 0;
  atan2_kernel<<<grid_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(y, x, out, n, p);
  return static_cast<int>(cudaGetLastError());
}

// K7.  iterations <= 32 linear-vectoring steps (17 in the reference).
REPRO_EXPORT int repro_universal_div(const int32_t* num, const int32_t* den, int32_t* out,
                                     long long n, int iterations, void* stream) {
  if (iterations < 0 || iterations > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  div_kernel<<<grid_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(num, den, out, n,
                                                                             iterations);
  return static_cast<int>(cudaGetLastError());
}
