// CORDIC device functions shared by K2 (fused SwiGLU sigmoid) and K5-K7
// (universal.cu: sqrt exp log tanh sigmoid, atan2, div).  Each function
// is the C form of the body of the same name in
// src/repro_torch/core/cordic.py (reference: src/repro/core/cordic.py)
// and must match it bit for bit.  The constants are the reference's
// generators evaluated once; tests/test_torch_kernels.py re-derives
// them and compares with this file.
//
// The hyperbolic functions are templates over their schedule: K2 uses
// DefaultHyper (the 20-stage schedule in constant memory, unrolled at
// compile time); K5's kernel for any other `stages` the reference
// accepts passes HyperParams by value.  K5's kernels for the default
// schedule and the tests' 13 stages run the lean batch steps at the end
// of this file, with shifts and atanh constants as immediates; the
// circular atan tables of K3 and K6 (16 and 24 entries) are there too.
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

// the default schedule (HYPER_STAGES stages), in constant memory
struct DefaultHyper {
  __device__ __forceinline__ int stages() const { return HYPER_STAGES; }
  // every shift of the default schedule is below 32
  __device__ __forceinline__ int32_t shr(int32_t v, int j) const { return v >> HYPER_SHIFT[j]; }
  __device__ __forceinline__ int32_t atanh(int j) const { return ATANH_Q29[j]; }
  __device__ __forceinline__ int32_t k_h_inv() const { return K_H_INV_Q29; }
};

// any schedule: hyperbolic_schedule(stages), atanh_table(schedule, 29)
// and hyper_gain_inverse(schedule, 29), filled in by the host
constexpr int MAX_HYPER_STAGES = 64;
struct HyperParams {
  int32_t shift_[MAX_HYPER_STAGES];
  int32_t atanh_[MAX_HYPER_STAGES];
  int32_t stages_;
  int32_t k_h_inv_;
  __device__ __forceinline__ int stages() const { return stages_; }
  __device__ __forceinline__ int32_t shr(int32_t v, int j) const { return sar(v, shift_[j]); }
  __device__ __forceinline__ int32_t atanh(int j) const { return atanh_[j]; }
  __device__ __forceinline__ int32_t k_h_inv() const { return k_h_inv_; }
};

// rotation mode: drive z -> 0 from (x, y, z); results in x, y
template <class H>
__device__ __forceinline__ void hyper_rotation(int32_t& x, int32_t& y, int32_t z, const H& h) {
#pragma unroll
  for (int j = 0; j < h.stages(); ++j) {
    const int32_t xs = h.shr(x, j), ys = h.shr(y, j), t = h.atanh(j);
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

// vectoring mode: drive y -> 0 from (x, y, z); results in x, z
template <class H>
__device__ __forceinline__ void hyper_vectoring(int32_t& x, int32_t y, int32_t& z, const H& h) {
#pragma unroll
  for (int j = 0; j < h.stages(); ++j) {
    const int32_t xs = h.shr(x, j), ys = h.shr(y, j), t = h.atanh(j);
    if (y < 0) {
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
__device__ __forceinline__ int32_t linear_div_q16(int32_t num, int32_t den, int iterations = 17) {
  const int32_t b = ilog2(imax(den, 1));
  const int32_t s = HFRAC - b;
  const int32_t x = shift_signed(den, -s);
  int32_t y = shift_signed(num, -s);
  int32_t z = 0;
#pragma unroll 17
  for (int i = 0; i < iterations; ++i) {
    const int32_t xs = sar(x, i), t = sar(U16, i);
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

// rounded Q(m.n) product with a 64-bit intermediate, low 32 bits kept
// (core.qformat.q_mul with rounding, no saturation)
__device__ __forceinline__ int32_t q_mul(int32_t a, int32_t b, int frac_bits) {
  const int64_t p = static_cast<int64_t>(a) * static_cast<int64_t>(b) + (int64_t{1} << (frac_bits - 1));
  return static_cast<int32_t>(static_cast<uint32_t>(static_cast<uint64_t>(p >> frac_bits)));
}
__device__ __forceinline__ int32_t q_mul16(int32_t a, int32_t b) { return q_mul(a, b, 16); }

template <class H>
__device__ __forceinline__ int32_t exp_q16(int32_t t, const H& h) {
  if (t <= EXP_FLUSH_LO_Q16) return 0;
  if (t >= EXP_SAT_HI_Q16) return RAW_MAX;
  const int32_t tc = imin(imax(t, EXP_FLUSH_LO_Q16 - U16), EXP_SAT_HI_Q16 + U16);
  const int32_t k = (wadd(q_mul16(tc, INV_LN2_Q16), 1 << 15)) >> 16;
  const int32_t r = wsub(tc, k * LN2_Q16);
  int32_t x = h.k_h_inv(), y = 0;
  hyper_rotation(x, y, shl(r, HFRAC - 16), h);
  const int32_t er = wadd(x, y);
  const int32_t sh = (HFRAC - 16) - k;
  const int32_t rs = round_shift_right(er, imax(sh, 0));
  const int32_t sl = imax(-sh, 0);
  return rs <= (RAW_MAX >> imin(sl, 31)) && sl < 32 ? shl(rs, sl) : RAW_MAX;
}

template <class H>
__device__ __forceinline__ int32_t tanh_q16(int32_t t_in, const H& h) {
  const int32_t t = clamp_raw(t_in);
  const int32_t at = t < 0 ? -t : t;
  int32_t mag;
  if (at <= U16) {
    int32_t x = h.k_h_inv(), y = 0;
    hyper_rotation(x, y, shl(at, HFRAC - 16), h);
    mag = linear_div_q16(y >> (HFRAC - 16), imax(x >> (HFRAC - 16), 1));
  } else {
    const int32_t a2 = imin(at, -EXP_FLUSH_LO_Q16);
    const int32_t e = exp_q16(-(a2 << 1), h);
    mag = linear_div_q16(U16 - e, U16 + e);
  }
  mag = imin(mag, U16);
  return t < 0 ? -mag : mag;
}

template <class H>
__device__ __forceinline__ int32_t sigmoid_q16(int32_t t_in, const H& h) {
  const int32_t t = clamp_raw(t_in);
  return wadd(tanh_q16(t >> 1, h), U16 + 1) >> 1;
}

// K2's sigmoid: the default schedule
__device__ __forceinline__ int32_t sigmoid_q16(int32_t t_in) { return sigmoid_q16(t_in, DefaultHyper{}); }

// sqrt: w = u * 2**s (s even, u in [0.5, 2)), vectoring of (u + 1/4,
// u - 1/4) gives K_h * sqrt(u); w <= 0 gives 0
template <class H>
__device__ __forceinline__ int32_t sqrt_q16(int32_t w_in, const H& h) {
  const int32_t w = clamp_raw(w_in);
  if (w <= 0) return 0;
  const int32_t s0 = ilog2(w) - 16;
  const int32_t s = (s0 & 1) == 0 ? s0 : s0 + 1;
  const int32_t u29 = shl(shift_signed(w, s), HFRAC - 16);
  const int32_t quarter = 1 << (HFRAC - 2);
  int32_t x = wadd(u29, quarter), z = 0;
  hyper_vectoring(x, wsub(u29, quarter), z, h);
  const int32_t r29 = q_mul(x, h.k_h_inv(), HFRAC);
  return round_shift_right(r29, (HFRAC - 16) - (s >> 1));
}

// log: ln w = 2 * atanh((u - 1) / (u + 1)) + k * ln2, u = w * 2**-k in
// [1, 2); w <= 0 gives Q16.16 min
template <class H>
__device__ __forceinline__ int32_t log_q16(int32_t w_in, const H& h) {
  const int32_t w = clamp_raw(w_in);
  if (w <= 0) return RAW_MIN;
  const int32_t k = ilog2(w) - 16;
  const int32_t u29 = shl(shift_signed(w, k), HFRAC - 16);
  const int32_t one29 = 1 << HFRAC;
  int32_t x = wadd(u29, one29), z = 0;
  hyper_vectoring(x, wsub(u29, one29), z, h);
  const int32_t lnu = wadd(z, 1 << (HFRAC - 18)) >> (HFRAC - 17);
  return wadd(lnu, k * LN2_Q16);
}

// circular vectoring: atan2(y, x) with `iterations` (<= 32) entries of
// the atan table in the output angle format; pi in the same format
struct AtanParams {
  int32_t table[32];
  int32_t iterations, pi;
};

__device__ __forceinline__ int32_t atan2_q(int32_t y_in, int32_t x_in, const AtanParams& p) {
  const int32_t y0 = clamp_raw(y_in), x0 = clamp_raw(x_in);
  if (x0 == 0 && y0 == 0) return 0;
  const bool neg_x = x0 < 0;
  int32_t x = neg_x ? -x0 : x0;
  int32_t y = neg_x ? -y0 : y0;
  const int32_t m = imax(x < 0 ? -x : x, y < 0 ? -y : y);
  const int32_t s = 28 - ilog2(imax(m, 1));
  x = shift_signed(x, -s);
  y = shift_signed(y, -s);
  int32_t z = 0;
  for (int i = 0; i < p.iterations; ++i) {
    const int32_t xs = sar(x, i), ys = sar(y, i), t = p.table[i];
    if (y < 0) {
      x = wsub(x, ys);
      y = wadd(y, xs);
      z = wsub(z, t);
    } else {
      x = wadd(x, ys);
      y = wsub(y, xs);
      z = wadd(z, t);
    }
  }
  return neg_x ? wadd(z, y0 < 0 ? -p.pi : p.pi) : z;
}

// full-range Q16.16 num / den: both operands normalised to bit 29, the
// quotient's exponent applied after; den == 0 saturates, 0 / 0 = 0
__device__ __forceinline__ int32_t div_q16(int32_t num_in, int32_t den_in, int iterations) {
  const int32_t num = clamp_raw(num_in), den = clamp_raw(den_in);
  if (den_in == 0) return num == 0 ? 0 : (num > 0 ? RAW_MAX : RAW_MIN + 1);
  const int32_t an = num < 0 ? -num : num, ad = den < 0 ? -den : den;
  const int32_t bn = ilog2(imax(an, 1)), bd = ilog2(imax(ad, 1));
  const int32_t nn = shift_signed(an, bn - HFRAC);
  const int32_t dd = shift_signed(ad, bd - HFRAC);
  const int32_t z = linear_div_q16(nn, imax(dd, 1), iterations);
  const int32_t e = bn - bd;
  const int32_t zr = round_shift_right(z, imax(-e, 0));
  const int32_t sl = imax(e, 0);
  const int32_t mag = zr <= sar(RAW_MAX, sl) ? shl(zr, sl) : RAW_MAX;
  return (num < 0) != (den < 0) ? wneg(mag) : mag;
}

// ---------------------------------------------------------------------------
// compile-time schedules and lean steps (K5's specialised kernels)
// ---------------------------------------------------------------------------

constexpr int32_t K_H_INV13_Q29 = 648270041;  // hyper_gain_inverse(hyperbolic_schedule(13), 29)

// hyperbolic_schedule(n)[j] for j < 40 (every n shares this prefix up to
// the third repeat, at 40)
__host__ __device__ constexpr int hyper_shift_at(int j) { return j < 4 ? j + 1 : (j < 14 ? j : j - 1); }

// round(atanh(2**-i) * 2**29) for 1 <= i <= 29; from i = 10 on the cubic
// term is below half a unit, so the entry is 2**(29 - i)
__host__ __device__ constexpr int32_t atanh_q29_at(int i) {
  switch (i) {
    case 1: return 294906491;
    case 2: return 137123709;
    case 3: return 67461703;
    case 4: return 33598225;
    case 5: return 16782681;
    case 6: return 8389291;
    case 7: return 4194389;
    case 8: return 2097163;
    case 9: return 1048577;
    default: return int32_t{1} << (29 - i);
  }
}

// One shift-add step on wrapping 32-bit words, in "add" (x += ys, y += xs,
// z -= t) or "sub" (x -= ys, y -= xs, z += t) direction, chosen per
// element without a branch: sgn = +1 (add) or -1 (sub) scales the
// updates (IMAD), so the shifts and the sign stay on the ALU pipe and
// the three updates go to the FMA pipe.
__device__ __forceinline__ void hyper_update(int32_t& x, int32_t& y, int32_t& z, int32_t xs,
                                             int32_t ys, int32_t t, uint32_t sgn) {
  x = static_cast<int32_t>(static_cast<uint32_t>(x) + sgn * static_cast<uint32_t>(ys));
  y = static_cast<int32_t>(static_cast<uint32_t>(y) + sgn * static_cast<uint32_t>(xs));
  z = static_cast<int32_t>(static_cast<uint32_t>(z) - sgn * static_cast<uint32_t>(t));
}

// N stages of the compile-time schedule on ILP independent elements.
// Vectoring: add iff y < 0 (sgn = -(2m + 1), m = y >> 31); rotation: add
// iff z >= 0 (sgn = 2m + 1, m = z >> 31).  Without z (sqrt) the z update
// folds away.
template <int N, int ILP>
__device__ __forceinline__ void hyper_vectoring_n(int32_t (&x)[ILP], int32_t (&y)[ILP],
                                                  int32_t (&z)[ILP]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int s = hyper_shift_at(j);
    const int32_t t = atanh_q29_at(s);
#pragma unroll
    for (int e = 0; e < ILP; ++e) {
      const uint32_t sgn = 0u - (2u * static_cast<uint32_t>(y[e] >> 31) + 1u);
      hyper_update(x[e], y[e], z[e], x[e] >> s, y[e] >> s, t, sgn);
    }
  }
}

template <int N, int ILP>
__device__ __forceinline__ void hyper_rotation_n(int32_t (&x)[ILP], int32_t (&y)[ILP],
                                                 int32_t (&z)[ILP]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int s = hyper_shift_at(j);
    const int32_t t = atanh_q29_at(s);
#pragma unroll
    for (int e = 0; e < ILP; ++e) {
      const uint32_t sgn = 2u * static_cast<uint32_t>(z[e] >> 31) + 1u;
      hyper_update(x[e], y[e], z[e], x[e] >> s, y[e] >> s, t, sgn);
    }
  }
}

// linear_div_q16 (17 steps) on ILP elements with den >= 1.  b = ilog2(den)
// is at most 30, so the normalising shift 29 - b lies in [-1, 29] and
// needs no guard.  z = sum_i d_i 2**(16 - i) with d_i = +1 where y_i >= 0
// and -1 where y_i < 0, i.e. 2c + 2**17 - 1 with c = sum_i m_i 2**(16 - i)
// (m_i = y_i >> 31), which Horner's rule builds one shift-add a step.
template <int ILP>
__device__ __forceinline__ void linear_div_n(const int32_t (&num)[ILP], const int32_t (&den)[ILP],
                                             int32_t (&out)[ILP]) {
  int32_t x[ILP], y[ILP];
  uint32_t c[ILP];
#pragma unroll
  for (int e = 0; e < ILP; ++e) {
    const int s = 29 - (31 - __clz(den[e]));
    x[e] = shift_signed(den[e], -s);
    y[e] = shift_signed(num[e], -s);
    c[e] = 0;
  }
#pragma unroll
  for (int i = 0; i < 17; ++i) {
#pragma unroll
    for (int e = 0; e < ILP; ++e) {
      const int32_t m = y[e] >> 31;
      // y >= 0: y -= xs; y < 0: y += xs
      const uint32_t sgn = 2u * static_cast<uint32_t>(m) + 1u;
      y[e] = static_cast<int32_t>(static_cast<uint32_t>(y[e]) - sgn * static_cast<uint32_t>(x[e] >> i));
      c[e] = 2u * c[e] + static_cast<uint32_t>(m);
    }
  }
#pragma unroll
  for (int e = 0; e < ILP; ++e) out[e] = static_cast<int32_t>(2u * c[e] + ((1u << 17) - 1u));
}

// atan_table(16, 16) and atan_table(24, 24): round(atan(2**-i) * 2**f);
// from i = 6 (f = 16) and 8 (f = 24) on the entry is 2**(f - i)
__host__ __device__ constexpr int32_t atan_at(int frac, int i) {
  if (frac == 16) {
    switch (i) {
      case 0: return 51472;
      case 1: return 30386;
      case 2: return 16055;
      case 3: return 8150;
      case 4: return 4091;
      case 5: return 2047;
      default: return int32_t{1} << (16 - i);
    }
  }
  switch (i) {
    case 0: return 13176795;
    case 1: return 7778716;
    case 2: return 4110060;
    case 3: return 2086331;
    case 4: return 1047214;
    case 5: return 524117;
    case 6: return 262123;
    case 7: return 131069;
    default: return int32_t{1} << (24 - i);
  }
}

// round(pi * 2**f) for the compiled atan tables' formats
__host__ __device__ constexpr int32_t pi_at(int frac) { return frac == 16 ? 205887 : 52707179; }

// ---------------------------------------------------------------------------
// K2's grouped epilogue: sigmoid_q16 on ILP gates, one schedule for all
// ---------------------------------------------------------------------------

// tanh's far path is the exp tail while exp(-2|t|) is not flushed to 0;
// beyond, (U16 - 0) / (U16 + 0) clamps to U16
constexpr int32_t TANH_EXP_END = (-EXP_FLUSH_LO_Q16 + 1) / 2;  // 386122

// sigmoid_q16 (the default schedule) in place, bit for bit, with ONE
// rotation and ONE division for every gate: tanh's near path (|t| <= 1,
// sinh / cosh) and far path (the exp tail) differ only in the rotation's
// angle and the quotient's operands, so both are selected per element
// instead of branched on, and a warp whose lanes mix the paths runs 20
// rotation and 17 division steps, not twice that.  The lean steps above
// (K5's) carry ILP gates at once.
template <int ILP>
__device__ __forceinline__ void sigmoid_q16_n(int32_t (&w)[ILP]) {
  int32_t t[ILP], at[ILP], k[ILP], x[ILP], y[ILP], z[ILP];
#pragma unroll
  for (int e = 0; e < ILP; ++e) {
    t[e] = clamp_raw(w[e]) >> 1;  // tanh's argument
    at[e] = t[e] < 0 ? -t[e] : t[e];
    // far: exp(te), te = -2|t| kept inside exp's live range
    const int32_t te = -(imin(at[e], TANH_EXP_END - 1) << 1);
    k[e] = wadd(q_mul16(te, INV_LN2_Q16), 1 << 15) >> 16;  // in [-17, 0]
    const int32_t zf = shl(wsub(te, k[e] * LN2_Q16), HFRAC - 16);
    z[e] = at[e] <= U16 ? at[e] << (HFRAC - 16) : zf;
    x[e] = K_H_INV_Q29;
    y[e] = 0;
  }
  hyper_rotation_n<HYPER_STAGES>(x, y, z);
  int32_t num[ILP], den[ILP], mag[ILP];
#pragma unroll
  for (int e = 0; e < ILP; ++e) {
    // exp's reconstruction: the shift 13 - k lies in [13, 30]
    const int32_t c = (HFRAC - 16) - k[e];
    const int32_t ex = wadd(wadd(x[e], y[e]), 1 << (c - 1)) >> c;
    const bool near = at[e] <= U16;
    num[e] = near ? y[e] >> (HFRAC - 16) : U16 - ex;
    den[e] = near ? imax(x[e] >> (HFRAC - 16), 1) : U16 + ex;
  }
  linear_div_n(num, den, mag);
#pragma unroll
  for (int e = 0; e < ILP; ++e) {
    const int32_t m = at[e] >= TANH_EXP_END ? U16 : imin(mag[e], U16);
    w[e] = wadd(t[e] < 0 ? -m : m, U16 + 1) >> 1;
  }
}

}  // namespace rq
