// K3: rotation-mode CORDIC sincos on int32 Q(m.n) angles.
//
// Replaces src/repro/kernels/cordic/cordic.py::_kernel (launched by
// cordic_kernel_call).  Per element: floor-mod reduction of theta + pi
// to [0, 2*pi) (the add wraps in uint32 — signed overflow is undefined
// in C — and C's % truncates, so a negative remainder is lifted by one
// turn), fold to [-pi/2, pi/2] with a sign flip of both outputs, then
// `iterations` shift-add steps from x0 = K^-1 with the atan table held
// in the kernel's parameter (constant) bank.
// The FAST RoPE tables fuse the exact phase step in front of it
// (core/cordic.py exact_rope_phase_q16: (pos * f mod 1 turn) * 2*pi in
// Q16.16, uint32/uint64 arithmetic), so positions go in and the tables
// come out in one pass.
// Bound on the H100: bytes (4 B in, 8 B out per element) against ~100
// integer operations per element — neither is near a limit at RoPE
// sizes (S x 64 elements); the kernel is one launch per layer.
#include "common.cuh"

namespace {

struct CordicParams {
  int32_t table[32];
  int32_t iterations, k_inv, pi, half_pi, two_pi;
};

__device__ __forceinline__ void sincos_one(int32_t theta, const CordicParams& p, int32_t& s,
                                           int32_t& c) {
  int32_t r = rq::wadd(theta, p.pi) % p.two_pi;  // truncating remainder
  if (r < 0) r += p.two_pi;                      // -> floor-mod
  r -= p.pi;
  const bool hi = r > p.half_pi, lo = r < -p.half_pi;
  int32_t z = hi ? r - p.pi : (lo ? r + p.pi : r);
  int32_t x = p.k_inv, y = 0;
  for (int i = 0; i < p.iterations; ++i) {
    const int32_t xs = x >> i, ys = y >> i, t = p.table[i];
    if (z >= 0) {
      x = rq::wsub(x, ys);
      y = rq::wadd(y, xs);
      z = rq::wsub(z, t);
    } else {
      x = rq::wadd(x, ys);
      y = rq::wsub(y, xs);
      z = rq::wadd(z, t);
    }
  }
  const bool neg = hi || lo;
  c = neg ? rq::wneg(x) : x;
  s = neg ? rq::wneg(y) : y;
}

// theta given: elementwise.  theta null: element i is the RoPE angle of
// position pos[i / half] and frequency (fhi, flo)[i % half].
__global__ void cordic_sincos_kernel(const int32_t* __restrict__ theta,
                                     const int32_t* __restrict__ pos,
                                     const uint32_t* __restrict__ fhi,
                                     const uint32_t* __restrict__ flo, int half, int64_t n,
                                     int32_t* __restrict__ sin_out,
                                     int32_t* __restrict__ cos_out, CordicParams p) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    int32_t th;
    if (theta != nullptr) {
      th = theta[i];
    } else {
      const uint32_t ps = static_cast<uint32_t>(pos[i / half]);
      const int j = static_cast<int>(i % half);
      const uint32_t frac = ps * fhi[j] + __umulhi(ps, flo[j]);  // Q0.32 turns, mod 1
      const uint64_t t = static_cast<uint64_t>(frac) * static_cast<uint64_t>(p.two_pi);
      th = static_cast<int32_t>(static_cast<uint32_t>(t >> 32) + static_cast<uint32_t>((t >> 31) & 1u));
    }
    int32_t s, c;
    sincos_one(th, p, s, c);
    sin_out[i] = s;
    cos_out[i] = c;
  }
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
  if (iterations < 0 || iterations > 32) return static_cast<int>(cudaErrorInvalidValue);
  CordicParams p{};
  for (int i = 0; i < iterations; ++i) p.table[i] = table[i];
  p.iterations = iterations;
  p.k_inv = k_inv;
  p.pi = pi;
  p.half_pi = half_pi;
  p.two_pi = two_pi;
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks_needed = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(blocks_needed < 4096 ? blocks_needed : 4096);
  cordic_sincos_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      theta, pos, fhi, flo, half, static_cast<int64_t>(n), sin_out, cos_out, p);
  return static_cast<int>(cudaGetLastError());
}
