// CORDIC device functions shared by K2 (fused SwiGLU sigmoid) and K3
// (sincos).  Each function is the C form of the body of the same name in
// src/repro_torch/core/cordic.py (reference: src/repro/core/cordic.py)
// and must match it bit for bit.  The constants are the reference's
// generators evaluated once; tests/test_torch_kernels.py re-derives
// them and compares with this file.
#pragma once

#include "common.cuh"

namespace rq {

constexpr int HFRAC = 29;        // hyperbolic datapath Q3.29
constexpr int32_t U16 = 65536;   // 1.0 in Q16.16
constexpr int HYPER_STAGES = 20;

// hyperbolic_schedule(20): repeats at 4 and 13
__device__ __constant__ int32_t HYPER_SHIFT[HYPER_STAGES] = {
    1, 2, 3, 4, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 13, 14, 15, 16, 17, 18};
// atanh_table(schedule, 29)
__device__ __constant__ int32_t ATANH_Q29[HYPER_STAGES] = {
    294906491, 137123709, 67461703, 33598225, 33598225, 16782681, 8389291,
    4194389,   2097163,   1048577,  524288,   262144,   131072,   65536,
    65536,     32768,     16384,    8192,     4096,     2048};
constexpr int32_t K_H_INV_Q29 = 648270052;   // hyper_gain_inverse(schedule, 29)
constexpr int32_t LN2_Q16 = 45426;
constexpr int32_t INV_LN2_Q16 = 94548;
constexpr int32_t EXP_SAT_HI_Q16 = 681391;     // ln(32768)
constexpr int32_t EXP_FLUSH_LO_Q16 = -772244;  // ln(2**-17)

__device__ __forceinline__ int32_t clamp_raw(int32_t v) { return v < RAW_MIN + 1 ? RAW_MIN + 1 : v; }

// floor(log2(v)) for v >= 1, the reference's 5-step cascade (0 for v < 2)
__device__ __forceinline__ int32_t ilog2(int32_t v) {
  int32_t n = 0;
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    if (v >= (1 << s)) {
      n += s;
      v >>= s;
    }
  }
  return n;
}

// v * 2**-s with a signed count (s < 0 shifts left)
__device__ __forceinline__ int32_t shift_signed(int32_t v, int32_t s) {
  return shl(sar(v, imax(s, 0)), imax(-s, 0));
}

// round-to-nearest arithmetic right shift, count >= 0
__device__ __forceinline__ int32_t round_shift_right(int32_t v, int32_t s) {
  const int32_t half = s > 0 ? shl(1, imax(s - 1, 0)) : 0;
  return sar(wadd(v, half), s);
}

// rotation mode: drive z -> 0 from (x, y, z); results in x, y
__device__ __forceinline__ void hyper_rotation(int32_t& x, int32_t& y, int32_t z) {
#pragma unroll
  for (int j = 0; j < HYPER_STAGES; ++j) {
    const int i = HYPER_SHIFT[j];
    const int32_t xs = x >> i, ys = y >> i, t = ATANH_Q29[j];
    if (z >= 0) {
      x = wadd(x, ys);
      y = wadd(y, xs);
      z = wsub(z, t);
    } else {
      x = wsub(x, ys);
      y = wsub(y, xs);
      z = wadd(z, t);
    }
  }
}

// linear vectoring: num/den in Q16.16 for den > 0, |num| <= den
__device__ __forceinline__ int32_t linear_div_q16(int32_t num, int32_t den) {
  const int32_t b = ilog2(imax(den, 1));
  const int32_t s = HFRAC - b;
  const int32_t x = shift_signed(den, -s);
  int32_t y = shift_signed(num, -s);
  int32_t z = 0;
#pragma unroll
  for (int i = 0; i < 17; ++i) {
    const int32_t xs = x >> i, t = U16 >> i;
    if (y >= 0) {
      y = wsub(y, xs);
      z = wadd(z, t);
    } else {
      y = wadd(y, xs);
      z = wsub(z, t);
    }
  }
  return z;
}

// rounded Q16.16 product (core.qformat.q_mul at its defaults)
__device__ __forceinline__ int32_t q_mul16(int32_t a, int32_t b) {
  const int64_t p = static_cast<int64_t>(a) * static_cast<int64_t>(b) + 32768;
  return static_cast<int32_t>(static_cast<uint32_t>(static_cast<uint64_t>(p) >> 16));
}

__device__ __forceinline__ int32_t exp_q16(int32_t t) {
  if (t <= EXP_FLUSH_LO_Q16) return 0;
  if (t >= EXP_SAT_HI_Q16) return RAW_MAX;
  const int32_t tc = imin(imax(t, EXP_FLUSH_LO_Q16 - U16), EXP_SAT_HI_Q16 + U16);
  const int32_t k = (wadd(q_mul16(tc, INV_LN2_Q16), 1 << 15)) >> 16;
  const int32_t r = wsub(tc, k * LN2_Q16);
  int32_t x = K_H_INV_Q29, y = 0;
  hyper_rotation(x, y, shl(r, HFRAC - 16));
  const int32_t er = wadd(x, y);
  const int32_t sh = (HFRAC - 16) - k;
  const int32_t rs = round_shift_right(er, imax(sh, 0));
  const int32_t sl = imax(-sh, 0);
  return rs <= (RAW_MAX >> imin(sl, 31)) && sl < 32 ? shl(rs, sl) : RAW_MAX;
}

__device__ __forceinline__ int32_t tanh_q16(int32_t t_in) {
  const int32_t t = clamp_raw(t_in);
  const int32_t at = t < 0 ? -t : t;
  int32_t mag;
  if (at <= U16) {
    int32_t x = K_H_INV_Q29, y = 0;
    hyper_rotation(x, y, shl(at, HFRAC - 16));
    mag = linear_div_q16(y >> (HFRAC - 16), imax(x >> (HFRAC - 16), 1));
  } else {
    const int32_t a2 = imin(at, -EXP_FLUSH_LO_Q16);
    const int32_t e = exp_q16(-(a2 << 1));
    mag = linear_div_q16(U16 - e, U16 + e);
  }
  mag = imin(mag, U16);
  return t < 0 ? -mag : mag;
}

__device__ __forceinline__ int32_t sigmoid_q16(int32_t t_in) {
  const int32_t t = clamp_raw(t_in);
  return wadd(tanh_q16(t >> 1), U16 + 1) >> 1;
}

}  // namespace rq
