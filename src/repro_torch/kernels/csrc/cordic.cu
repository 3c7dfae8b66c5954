// K3: rotation-mode CORDIC sincos on int32 Q(m.n) angles.
//
// Replaces src/repro/kernels/cordic/cordic.py::_kernel (launched by
// cordic_kernel_call).  Per element: floor-mod reduction of theta + pi
// to [0, 2*pi) (the add wraps in uint32), fold to [-pi/2, pi/2] with a
// sign flip of both outputs, then `iterations` shift-add steps from
// x0 = K^-1.  The FAST RoPE tables fuse the exact phase step in front of
// it (core/cordic.py exact_rope_phase_q16: (pos * f mod 1 turn) * 2*pi in
// Q16.16, uint32/uint64 arithmetic), so positions go in and the tables
// come out in one pass.
//
// Bound on the H100: integer operations (~100 per element: the reduction,
// 16 steps of 2 shifts, a sign and 3 updates, the sign flips) against
// 12 bytes moved.  The design keeps every element's work to that:
//   * the elementwise form (the engine's sin / cos) reduces without a
//     division: the unsigned dividend's quotient by 2*pi comes from a
//     multiply-high by the precomputed reciprocal, low by at most one,
//     so one compare corrects it;
//   * the RoPE form is a 2-D launch (a block takes a run of positions, a
//     lane four frequencies), so no element divides its flat index; its
//     phase lies in [0, 2*pi], which needs one compare, not a remainder;
//   * the 16-iteration (Q16.16) and 24-iteration (Q8.24) schedules are
//     compiled in, the atan constants immediates; a generic loop takes
//     any other `iterations` <= 32;
//   * a thread carries ILP angles through the steps together (16-byte
//     loads and stores), the sign of each step a +-1 factor (IMAD).
#include "cordic.cuh"

namespace {

constexpr int ILP = 4;             // angles a thread steps together
constexpr int THREADS = 256;       // elementwise form
constexpr int ROPE_THREADS = 128;  // RoPE form

struct CordicParams {
  int32_t table[32];
  int32_t iterations, k_inv, pi, half_pi, two_pi;
  uint32_t recip;  // floor(2**32 / two_pi)
  uint32_t wrap;   // 2**31 mod two_pi
};

// floor-mod of theta + pi (wrapping) into [0, two_pi), minus pi.  a =
// (theta + pi) + 2**31 is the dividend as an unsigned word; its quotient
// estimate from the reciprocal is low by at most one, so r < 2 two_pi
// and one compare leaves a mod two_pi; the 2**31 comes off as `wrap`.
__device__ __forceinline__ int32_t reduce_any(int32_t theta, const CordicParams& p) {
  const uint32_t a = (static_cast<uint32_t>(theta) + static_cast<uint32_t>(p.pi)) ^ 0x80000000u;
  const uint32_t T = static_cast<uint32_t>(p.two_pi);
  uint32_t r = a - __umulhi(a, p.recip) * T;
  r = r >= T ? r - T : r;
  const int32_t m = static_cast<int32_t>(r) - static_cast<int32_t>(p.wrap);
  return (m < 0 ? m + p.two_pi : m) - p.pi;
}

// the same for a RoPE phase theta in [0, two_pi]: theta + pi < 2 two_pi
__device__ __forceinline__ int32_t reduce_phase(int32_t theta, const CordicParams& p) {
  const int32_t a = theta + p.pi;
  return (a >= p.two_pi ? a - p.two_pi : a) - p.pi;
}

// fold r in [-pi, pi) to [-pi/2, pi/2]; neg: both outputs change sign
__device__ __forceinline__ void fold(int32_t r, const CordicParams& p, int32_t& z, bool& neg) {
  const bool hi = r > p.half_pi, lo = r < -p.half_pi;
  z = hi ? r - p.pi : (lo ? r + p.pi : r);
  neg = hi || lo;
}

// one step: z >= 0: x -= ys, y += xs, z -= t; z < 0: the opposite
__device__ __forceinline__ void circ_step(int32_t& x, int32_t& y, int32_t& z, int i, int32_t t) {
  const uint32_t sgn = 2u * static_cast<uint32_t>(z >> 31) + 1u;  // +1 or -1
  const int32_t xs = x >> i, ys = y >> i;
  x = static_cast<int32_t>(static_cast<uint32_t>(x) - sgn * static_cast<uint32_t>(ys));
  y = static_cast<int32_t>(static_cast<uint32_t>(y) + sgn * static_cast<uint32_t>(xs));
  z = static_cast<int32_t>(static_cast<uint32_t>(z) - sgn * static_cast<uint32_t>(t));
}

// ITER steps of the compiled-in table of FRAC fraction bits on V angles;
// ITER = 0: p.iterations steps of p.table
template <int FRAC, int ITER, int V>
__device__ __forceinline__ void rotate(int32_t (&x)[V], int32_t (&y)[V], int32_t (&z)[V],
                                       const CordicParams& p) {
  if constexpr (ITER > 0) {
#pragma unroll
    for (int i = 0; i < ITER; ++i) {
      const int32_t t = rq::atan_at(FRAC, i);
#pragma unroll
      for (int e = 0; e < V; ++e) circ_step(x[e], y[e], z[e], i, t);
    }
  } else {
    for (int i = 0; i < p.iterations; ++i) {
      const int32_t t = p.table[i];
#pragma unroll
      for (int e = 0; e < V; ++e) circ_step(x[e], y[e], z[e], i, t);
    }
  }
}

// reduced angles (in z) -> (sin, cos) in place of (z, x)
template <int FRAC, int ITER, int V>
__device__ __forceinline__ void sincos_reduced(int32_t (&r)[V], int32_t (&s)[V], int32_t (&c)[V],
                                               const CordicParams& p) {
  int32_t z[V];
  bool neg[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    fold(r[e], p, z[e], neg[e]);
    c[e] = p.k_inv;
    s[e] = 0;
  }
  rotate<FRAC, ITER, V>(c, s, z, p);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    c[e] = neg[e] ? rq::wneg(c[e]) : c[e];
    s[e] = neg[e] ? rq::wneg(s[e]) : s[e];
  }
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 15) == 0;
}

// elementwise: thread i takes angles [ILP i, ILP i + ILP)
template <int FRAC, int ITER>
__global__ void __launch_bounds__(THREADS) cordic_sincos_kernel(
    const int32_t* __restrict__ theta, int64_t n, int32_t* __restrict__ sin_out,
    int32_t* __restrict__ cos_out, CordicParams p) {
  const int64_t i0 = (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) * ILP;
  if (i0 >= n) return;
  const bool vec = i0 + ILP <= n && aligned16(theta, sin_out, cos_out);
  int32_t r[ILP], s[ILP], c[ILP];
  if (vec) {
    const int4 a = *reinterpret_cast<const int4*>(theta + i0);
    r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
  } else {
#pragma unroll
    for (int e = 0; e < ILP; ++e) r[e] = i0 + e < n ? theta[i0 + e] : 0;
  }
#pragma unroll
  for (int e = 0; e < ILP; ++e) r[e] = reduce_any(r[e], p);
  sincos_reduced<FRAC, ITER, ILP>(r, s, c, p);
  if (vec) {
    *reinterpret_cast<int4*>(sin_out + i0) = make_int4(s[0], s[1], s[2], s[3]);
    *reinterpret_cast<int4*>(cos_out + i0) = make_int4(c[0], c[1], c[2], c[3]);
  } else {
#pragma unroll
    for (int e = 0; e < ILP; ++e)
      if (i0 + e < n) sin_out[i0 + e] = s[e], cos_out[i0 + e] = c[e];
  }
}

// RoPE tables: block (LX, RY) takes RY positions; lane x the frequency
// groups x, x + LX, ... of V frequencies each (V = 4: 16-byte stores)
template <int ITER, int V>
__global__ void __launch_bounds__(ROPE_THREADS) rope_sincos_kernel(
    const int32_t* __restrict__ pos, const uint32_t* __restrict__ fhi,
    const uint32_t* __restrict__ flo, int half, int64_t n_pos, int32_t* __restrict__ sin_out,
    int32_t* __restrict__ cos_out, CordicParams p) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (row >= n_pos) return;
  const uint32_t ps = static_cast<uint32_t>(pos[row]);
  const int64_t out0 = row * half;
  for (int j0 = V * threadIdx.x; j0 < half; j0 += V * blockDim.x) {
    int32_t r[V], s[V], c[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const uint32_t frac = ps * fhi[j0 + e] + __umulhi(ps, flo[j0 + e]);  // Q0.32 turns
      const uint64_t t = static_cast<uint64_t>(frac) * static_cast<uint32_t>(p.two_pi);
      const int32_t th = static_cast<int32_t>(static_cast<uint32_t>(t >> 32) +
                                              static_cast<uint32_t>((t >> 31) & 1u));
      r[e] = reduce_phase(th, p);
    }
    sincos_reduced<16, ITER, V>(r, s, c, p);
    if constexpr (V == 4) {
      *reinterpret_cast<int4*>(sin_out + out0 + j0) = make_int4(s[0], s[1], s[2], s[3]);
      *reinterpret_cast<int4*>(cos_out + out0 + j0) = make_int4(c[0], c[1], c[2], c[3]);
    } else {
      sin_out[out0 + j0] = s[0];
      cos_out[out0 + j0] = c[0];
    }
  }
}

// the compiled-in table of FRAC bits and ITER entries, if the host's is it
template <int FRAC, int ITER>
bool compiled_table(const CordicParams& p) {
  if (p.iterations != ITER) return false;
  for (int i = 0; i < ITER; ++i)
    if (p.table[i] != rq::atan_at(FRAC, i)) return false;
  return true;
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// table: `iterations` (<= 32) atan entries in the angle format; the
// RoPE form passes theta = null with pos (n / half,) int32 and the
// frequency limbs (half,) uint32 (two_pi must then be the Q16.16 2*pi).
REPRO_EXPORT int repro_cordic_sincos(const int32_t* theta, const int32_t* pos,
                                     const uint32_t* fhi, const uint32_t* flo, int half,
                                     long long n, int32_t* sin_out, int32_t* cos_out,
                                     const int32_t* table, int iterations, int k_inv, int pi,
                                     int half_pi, int two_pi, void* stream) {
  if (iterations < 0 || iterations > 32 || two_pi <= 0 || half <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CordicParams p{};
  for (int i = 0; i < iterations; ++i) p.table[i] = table[i];
  p.iterations = iterations;
  p.k_inv = k_inv;
  p.pi = pi;
  p.half_pi = half_pi;
  p.two_pi = two_pi;
  p.recip = static_cast<uint32_t>((uint64_t{1} << 32) / static_cast<uint32_t>(two_pi));
  p.wrap = static_cast<uint32_t>((uint64_t{1} << 31) % static_cast<uint32_t>(two_pi));
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (theta != nullptr) {
    const long long threads = (n + ILP - 1) / ILP;
    const unsigned g = static_cast<unsigned>((threads + THREADS - 1) / THREADS);
    if (compiled_table<16, 16>(p))
      cordic_sincos_kernel<16, 16><<<g, THREADS, 0, st>>>(theta, n, sin_out, cos_out, p);
    else if (compiled_table<24, 24>(p))
      cordic_sincos_kernel<24, 24><<<g, THREADS, 0, st>>>(theta, n, sin_out, cos_out, p);
    else
      cordic_sincos_kernel<0, 0><<<g, THREADS, 0, st>>>(theta, n, sin_out, cos_out, p);
  } else {
    const long long n_pos = n / half;
    const bool vec = half % 4 == 0 && ((reinterpret_cast<uintptr_t>(sin_out) |
                                        reinterpret_cast<uintptr_t>(cos_out)) & 15) == 0;
    const int groups = vec ? half / 4 : half;
    const int lx = groups < ROPE_THREADS ? groups : ROPE_THREADS;
    const dim3 block(lx, ROPE_THREADS / lx);
    const unsigned g = static_cast<unsigned>((n_pos + block.y - 1) / block.y);
    const bool fixed = compiled_table<16, 16>(p);
    if (vec && fixed)
      rope_sincos_kernel<16, 4><<<g, block, 0, st>>>(pos, fhi, flo, half, n_pos, sin_out, cos_out, p);
    else if (vec)
      rope_sincos_kernel<0, 4><<<g, block, 0, st>>>(pos, fhi, flo, half, n_pos, sin_out, cos_out, p);
    else if (fixed)
      rope_sincos_kernel<16, 1><<<g, block, 0, st>>>(pos, fhi, flo, half, n_pos, sin_out, cos_out, p);
    else
      rope_sincos_kernel<0, 1><<<g, block, 0, st>>>(pos, fhi, flo, half, n_pos, sin_out, cos_out, p);
  }
  return static_cast<int>(cudaGetLastError());
}
