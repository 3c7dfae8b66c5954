// K5-K7: the universal CORDIC family, elementwise on int32 words (K6 and
// K7 also on f32 at the engine's float boundary).
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
// K6 and K7 also read and write f32 at the engine's float boundary
// (core.qformat.to_fixed, the kernel, from_fixed, as ops.atan2,
// ops.atan2_24 and ops.div compose them), so an engine op is one pass.
//
// Bound on the H100: integer operations (a live element costs 100-300:
// 16-24 circular or 20 hyperbolic steps of 2 shifts, a sign word and 2-3
// updates, the normalisation and, for tanh and sigmoid, a 17-step
// division); the 8 bytes a K5 element moves take ~0.04 ms at 2**24
// words, the 12 of a K6 or K7 pair ~0.06 ms.
//
// K5's design.  Whether an element needs the CORDIC path depends on its
// value (sqrt / log: w > 0; exp: inside (ln 2**-17, ln 32768); tanh and
// sigmoid: a near path for |t| <= 1, a far one through exp below
// |t| = 5.89, a constant beyond), and callers mix the cases within a
// warp: with a fixed element per thread, a warp carries its dead and
// other-path lanes through the 20 stages.  So a block takes a tile of TILE words
// (16-byte loads), classifies every element, settles the early exits
// there, and queues the live ones per path in shared memory (warp ballots
// for the offsets); each queue then runs dense, ILP elements a thread
// at a time, and the tile leaves through 16-byte stores.  A tile whose
// elements all take one path skips the queues and shared memory.
// The default schedule (20 stages, what the engine and the softcap pass)
// and the tests' 13 run with shifts and atanh constants as immediates
// (cordic.cuh's lean steps); any other `stages` runs the same tiles
// through the per-element functions with the schedule passed by value.
//
// K6's and K7's design.  Every pair but (0, 0) and den == 0 is live, so
// there is nothing to queue: a thread takes V pairs by one 16-byte load
// of each operand, steps them together and stores 16 bytes, with no
// shared memory.  The engine's counts (K6: 16 steps at frac 16, 24 at
// frac 24; K7: 17) run with the atan entries and shifts as immediates,
// a step's direction a +-1 sign word that scales the updates (IMAD), and
// the early exits, the x < 0 fold-back and K7's saturation as selects;
// any other count runs the same tiles through cordic.cuh's per-element
// atan2_q / div_q16 with the count by value.
#include <type_traits>

#include "cordic.cuh"

namespace {

enum UnaryOp { kSqrt = 0, kExp = 1, kLog = 2, kTanh = 3, kSigmoid = 4 };
// what an element needs after classification
enum Path { kDone = 0, kNear = 1, kFar = 2 };

constexpr int THREADS = 256;
constexpr int PER_THREAD = 8;               // two 16-byte vectors a thread
constexpr int TILE = THREADS * PER_THREAD;  // words a block takes
// elements a thread steps together: one, as the card keeps enough warps
// resident to hide a step's dependent chain (two or four interleaved
// took more registers and ran slower in exploratory builds)
constexpr int ILP = 1;

// tanh's far path is the exp tail while exp(-2|t|) is not flushed to 0:
// |t| < ln(2**17) / 2 (the rounded EXP_FLUSH_LO_Q16 halved, rounded up)
constexpr int32_t TANH_FAR_END = (-rq::EXP_FLUSH_LO_Q16 + 1) / 2;  // 386122
// beyond it exp gives 0 and the division (U16 - 0) / (U16 + 0) gives
// 65537, clamped to U16
constexpr int32_t TANH_SAT = rq::U16;

// ---------------------------------------------------------------------------
// classification: the path, and the result of an element that exits early
// ---------------------------------------------------------------------------

// tanh's and sigmoid's argument
template <int OP>
__device__ __forceinline__ int32_t tanh_arg(int32_t w) {
  const int32_t t = rq::clamp_raw(w);
  return OP == kSigmoid ? t >> 1 : t;
}

template <int OP>
__device__ __forceinline__ int classify(int32_t& w) {
  if (OP == kSqrt || OP == kLog) {
    if (w > 0) return kNear;
    w = OP == kSqrt ? 0 : rq::RAW_MIN;
    return kDone;
  }
  if (OP == kExp) {
    if (w > rq::EXP_FLUSH_LO_Q16 && w < rq::EXP_SAT_HI_Q16) return kNear;
    w = w <= rq::EXP_FLUSH_LO_Q16 ? 0 : rq::RAW_MAX;
    return kDone;
  }
  const int32_t t = tanh_arg<OP>(w);
  const int32_t at = t < 0 ? -t : t;
  if (at <= rq::U16) return kNear;
  if (at < TANH_FAR_END) return kFar;
  const int32_t th = t < 0 ? -TANH_SAT : TANH_SAT;
  w = OP == kSigmoid ? rq::wadd(th, rq::U16 + 1) >> 1 : th;
  return kDone;
}

// ---------------------------------------------------------------------------
// live paths, N stages of the compile-time schedule, ILP elements at once
// ---------------------------------------------------------------------------

template <int N>
__host__ __device__ constexpr int32_t k_h_inv() {
  static_assert(N == rq::HYPER_STAGES || N == 13, "compile-time schedules: 20 and 13 stages");
  return N == rq::HYPER_STAGES ? rq::K_H_INV_Q29 : rq::K_H_INV13_Q29;
}

// w = u * 2**s, s even, u in [0.5, 2) (w > 0: s in [-16, 14], u29 < 2**30)
template <int N>
__device__ __forceinline__ void sqrt_live(int32_t (&w)[ILP]) {
  int32_t x[ILP], y[ILP], z[ILP], s[ILP];
#pragma unroll
  for (int e = 0; e < ILP; ++e) {
    const int32_t s0 = (31 - __clz(w[e])) - 16;
    s[e] = s0 + (s0 & 1);
    const int32_t u29 = rq::shift_signed(w[e], s[e]) << (rq::HFRAC - 16);
    x[e] = u29 + (1 << (rq::HFRAC - 2));
    y[e] = u29 - (1 << (rq::HFRAC - 2));
    z[e] = 0;
  }
  rq::hyper_vectoring_n<N>(x, y, z);
#pragma unroll
  for (int e = 0; e < ILP; ++e) {
    const int32_t r29 = rq::q_mul(x[e], k_h_inv<N>(), rq::HFRAC);
    const int c = (rq::HFRAC - 16) - (s[e] >> 1);  // in [6, 21]
    w[e] = rq::wadd(r29, 1 << (c - 1)) >> c;
  }
}

// ln w = 2 atanh((u - 1) / (u + 1)) + k ln 2, u = w * 2**-k in [1, 2)
template <int N>
__device__ __forceinline__ void log_live(int32_t (&w)[ILP]) {
  int32_t x[ILP], y[ILP], z[ILP], k[ILP];
#pragma unroll
  for (int e = 0; e < ILP; ++e) {
    k[e] = (31 - __clz(w[e])) - 16;
    const int32_t u29 = rq::shift_signed(w[e], k[e]) << (rq::HFRAC - 16);
    x[e] = u29 + (1 << rq::HFRAC);
    y[e] = u29 - (1 << rq::HFRAC);
    z[e] = 0;
  }
  rq::hyper_vectoring_n<N>(x, y, z);
#pragma unroll
  for (int e = 0; e < ILP; ++e) {
    const int32_t lnu = rq::wadd(z[e], 1 << (rq::HFRAC - 18)) >> (rq::HFRAC - 17);
    w[e] = rq::wadd(lnu, k[e] * rq::LN2_Q16);
  }
}

// e**t for t in (EXP_FLUSH_LO, EXP_SAT_HI): k in [-17, 15], so the
// final shift 13 - k lies in [-2, 30]
template <int N>
__device__ __forceinline__ void exp_live(int32_t (&t)[ILP]) {
  int32_t x[ILP], y[ILP], z[ILP], k[ILP];
#pragma unroll
  for (int e = 0; e < ILP; ++e) {
    k[e] = rq::wadd(rq::q_mul16(t[e], rq::INV_LN2_Q16), 1 << 15) >> 16;
    z[e] = rq::shl(rq::wsub(t[e], k[e] * rq::LN2_Q16), rq::HFRAC - 16);
    x[e] = k_h_inv<N>();
    y[e] = 0;
  }
  rq::hyper_rotation_n<N>(x, y, z);
#pragma unroll
  for (int e = 0; e < ILP; ++e) {
    const int32_t er = rq::wadd(x[e], y[e]);
    const int32_t sh = (rq::HFRAC - 16) - k[e];
    const int32_t c = rq::imax(sh, 0), sl = rq::imax(-sh, 0);
    const int32_t rs = rq::wadd(er, (1 << c) >> 1) >> c;
    t[e] = rs <= (rq::RAW_MAX >> sl) ? rq::shl(rs, sl) : rq::RAW_MAX;
  }
}

// tanh magnitude, |t| <= 1: sinh / cosh by rotation, then the division
template <int N>
__device__ __forceinline__ void tanh_near(const int32_t (&at)[ILP], int32_t (&mag)[ILP]) {
  int32_t x[ILP], y[ILP], z[ILP];
#pragma unroll
  for (int e = 0; e < ILP; ++e) {
    x[e] = k_h_inv<N>();
    y[e] = 0;
    z[e] = at[e] << (rq::HFRAC - 16);
  }
  rq::hyper_rotation_n<N>(x, y, z);
  int32_t num[ILP], den[ILP];
#pragma unroll
  for (int e = 0; e < ILP; ++e) {
    num[e] = y[e] >> (rq::HFRAC - 16);
    den[e] = rq::imax(x[e] >> (rq::HFRAC - 16), 1);
  }
  rq::linear_div_n(num, den, mag);
}

// tanh magnitude, 1 < |t| < TANH_FAR_END: (1 - e) / (1 + e), e = exp(-2|t|)
template <int N>
__device__ __forceinline__ void tanh_far(const int32_t (&at)[ILP], int32_t (&mag)[ILP]) {
  int32_t ex[ILP], num[ILP], den[ILP];
#pragma unroll
  for (int e = 0; e < ILP; ++e) ex[e] = -(at[e] << 1);
  exp_live<N>(ex);
#pragma unroll
  for (int e = 0; e < ILP; ++e) {
    num[e] = rq::U16 - ex[e];
    den[e] = rq::U16 + ex[e];
  }
  rq::linear_div_n(num, den, mag);
}

// ILP live words of `path` in place; N = 0: the per-element functions of
// cordic.cuh with the schedule in `h`
template <int OP, int N>
__device__ __forceinline__ void run_live(int path, int32_t (&w)[ILP], const rq::HyperParams& h) {
  if constexpr (N == 0) {
#pragma unroll
    for (int e = 0; e < ILP; ++e) {
      if (OP == kSqrt) w[e] = rq::sqrt_q16(w[e], h);
      if (OP == kExp) w[e] = rq::exp_q16(w[e], h);
      if (OP == kLog) w[e] = rq::log_q16(w[e], h);
      if (OP == kTanh) w[e] = rq::tanh_q16(w[e], h);
      if (OP == kSigmoid) w[e] = rq::sigmoid_q16(w[e], h);
    }
  } else if constexpr (OP == kSqrt) {
    sqrt_live<N>(w);
  } else if constexpr (OP == kLog) {
    log_live<N>(w);
  } else if constexpr (OP == kExp) {
    exp_live<N>(w);
  } else {
    int32_t t[ILP], at[ILP], mag[ILP];
#pragma unroll
    for (int e = 0; e < ILP; ++e) {
      t[e] = tanh_arg<OP>(w[e]);
      at[e] = t[e] < 0 ? -t[e] : t[e];
    }
    if (path == kNear) tanh_near<N>(at, mag);
    else tanh_far<N>(at, mag);
#pragma unroll
    for (int e = 0; e < ILP; ++e) {
      const int32_t m = rq::imin(mag[e], rq::U16);
      const int32_t th = t[e] < 0 ? -m : m;
      w[e] = OP == kSigmoid ? rq::wadd(th, rq::U16 + 1) >> 1 : th;
    }
  }
}

// a live input of each path, for the idle slots of a queue's last batch
template <int OP>
__device__ __forceinline__ int32_t filler(int path) {
  if (OP == kTanh || OP == kSigmoid) return path == kNear ? 0 : 3 * rq::U16;
  return OP == kExp ? 0 : rq::U16;
}

// ---------------------------------------------------------------------------
// the kernel: one tile of TILE words per block
// ---------------------------------------------------------------------------

// word j (< PER_THREAD) of thread t sits at 4 * (t + THREADS * (j / 4)) + j % 4
__device__ __forceinline__ int tile_pos(int j) { return 4 * (threadIdx.x + THREADS * (j >> 2)) + (j & 3); }

template <int OP, int N>
__global__ void __launch_bounds__(THREADS) unary_kernel(const int32_t* __restrict__ in,
                                                        int32_t* __restrict__ out, int64_t n,
                                                        rq::HyperParams h) {
  __shared__ __align__(16) int32_t s_val[TILE];  // the tile: inputs, then results
  __shared__ uint16_t s_q[TILE];  // near queue from the front, far queue from the back
  __shared__ int s_len[2];

  const int64_t base = static_cast<int64_t>(blockIdx.x) * TILE;
  const bool full = base + TILE <= n &&
                    ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  int32_t v[PER_THREAD];
  if (full) {
#pragma unroll
    for (int q = 0; q < PER_THREAD / 4; ++q) {
      const int4 a = *reinterpret_cast<const int4*>(in + base + tile_pos(4 * q));
      v[4 * q] = a.x, v[4 * q + 1] = a.y, v[4 * q + 2] = a.z, v[4 * q + 3] = a.w;
    }
  } else {
    // past n a live filler, never stored
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      v[j] = base + tile_pos(j) < n ? in[base + tile_pos(j)] : filler<OP>(kNear);
  }
  int path[PER_THREAD];
  int seen = 0;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    path[j] = classify<OP>(v[j]);
    seen |= 1 << path[j];
  }
  if (threadIdx.x == 0) s_len[0] = s_len[1] = 0;
  const bool near_only = !__syncthreads_or(seen & ~(1 << kNear));
  const bool far_only = !__syncthreads_or(seen & ~(1 << kFar));
  if (near_only || far_only) {
    // one live path for the whole tile: no queues, straight from the
    // registers
#pragma unroll
    for (int q = 0; q < PER_THREAD / ILP; ++q) {
      int32_t w[ILP];
#pragma unroll
      for (int e = 0; e < ILP; ++e) w[e] = v[ILP * q + e];
      run_live<OP, N>(near_only ? kNear : kFar, w, h);
#pragma unroll
      for (int e = 0; e < ILP; ++e) v[ILP * q + e] = w[e];
    }
    if (full) {
#pragma unroll
      for (int q = 0; q < PER_THREAD / 4; ++q)
        *reinterpret_cast<int4*>(out + base + tile_pos(4 * q)) =
            make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j)
        if (base + tile_pos(j) < n) out[base + tile_pos(j)] = v[j];
    }
    return;
  }
  // a mix: the tile and its early exits to shared memory, the live
  // elements' places to their path's queue
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    s_val[tile_pos(j)] = v[j];
#pragma unroll
    for (int p = kNear; p <= kFar; ++p) {
      if ((OP == kSqrt || OP == kLog || OP == kExp) && p == kFar) continue;
      const unsigned mask = __ballot_sync(0xffffffffu, path[j] == p);
      if (mask == 0) continue;
      int at = 0;
      if (lane == 0) at = atomicAdd(&s_len[p - 1], __popc(mask));
      at = __shfl_sync(0xffffffffu, at, 0) + __popc(mask & below);
      if (path[j] == p) s_q[p == kNear ? at : TILE - 1 - at] = static_cast<uint16_t>(tile_pos(j));
    }
  }
  __syncthreads();
  // both queues dense, in batches of ILP entries of one path, the near
  // batches first: the threads share the batches out evenly
  const int len_near = s_len[0], len_far = s_len[1];
  const int nb = (len_near + ILP - 1) / ILP, fb = (len_far + ILP - 1) / ILP;
#pragma unroll 1
  for (int b = threadIdx.x; b < nb + fb; b += THREADS) {
    const int p = b < nb ? kNear : kFar;
    const int q0 = ILP * (b < nb ? b : b - nb), len = b < nb ? len_near : len_far;
    int32_t w[ILP];
    int idx[ILP];
#pragma unroll
    for (int e = 0; e < ILP; ++e) {
      const int q = q0 + e;
      idx[e] = q >= len ? -1 : s_q[p == kNear ? q : TILE - 1 - q];
      w[e] = idx[e] >= 0 ? s_val[idx[e]] : filler<OP>(p);
    }
    run_live<OP, N>(p, w, h);
#pragma unroll
    for (int e = 0; e < ILP; ++e)
      if (idx[e] >= 0) s_val[idx[e]] = w[e];
  }
  __syncthreads();

  if (full) {
#pragma unroll
    for (int q = 0; q < PER_THREAD / 4; ++q)
      *reinterpret_cast<int4*>(out + base + tile_pos(4 * q)) =
          *reinterpret_cast<const int4*>(s_val + tile_pos(4 * q));
  } else {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      if (base + tile_pos(j) < n) out[base + tile_pos(j)] = s_val[tile_pos(j)];
  }
}

// ---------------------------------------------------------------------------
// K6 and K7: V pairs a thread, straight through registers
// ---------------------------------------------------------------------------

// what a kernel reads and writes: int32 words, or f32 at the engine's
// float boundary (Q16.16 words inside; K6 also as the Q8.24 rung, whose
// operands are first normalised by max(|y|, |x|))
enum Io { kWords = 0, kF32 = 1, kF32Norm = 2 };

constexpr int V = 4;  // pairs a thread takes: one 16-byte load of each operand

// core.qformat.to_fixed into a 32-bit format as torch runs it on the card:
// rint(v * 2**f), clamped to [-2**31, 2**31 - 128] (a NaN passes), cast by
// cvt.rzi (NaN gives 0), then RAW_MAX where the rounded value is >= 2**31
// and RAW_MIN where it is < -2**31.  cvt.rni of v * 2**f is that word in
// one instruction: it rounds half to even, saturates out of range and
// gives 0 for NaN (v * 2**f is exact, subnormals included: no fast math).
template <int FRAC>
__device__ __forceinline__ int32_t to_fixed(float v) {
  return __float2int_rn(v * static_cast<float>(1 << FRAC));
}

// core.qformat.from_fixed: int -> f32 (round to nearest), then the exact
// power-of-two scale
template <int FRAC>
__device__ __forceinline__ float from_fixed(int32_t w) {
  return static_cast<float>(w) * (1.0f / static_cast<float>(1 << FRAC));
}

// ops.atan2_24's normalisation: subnormal operands as zero (as XLA runs
// the reference), s = max(|y|, |x|) where that is > 0, else 1
// (torch.maximum propagates a NaN, which then fails m > 0), and the
// IEEE-rounded quotients y / s, x / s.  The larger operand's quotient is
// known without a division: +-1, or itself where s = 1, or NaN where s is
// inf (inf / inf); only the smaller one is divided.
__device__ __forceinline__ void normalise(float& y, float& x) {
  y = fabsf(y) < 1.17549435e-38f ? 0.0f : y;
  x = fabsf(x) < 1.17549435e-38f ? 0.0f : x;
  const float ay = fabsf(y), ax = fabsf(x), m = fmaxf(ay, ax);
  const float s = m > 0.0f && !isnan(ay) && !isnan(ax) ? m : 1.0f;
  const bool y_big = ay >= ax;  // false where either is NaN
  const float big = y_big ? y : x;
  const float q = __fdiv_rn(y_big ? x : y, s);
  const float b = s == 1.0f ? big : (isinf(s) ? __int_as_float(0x7fffffff) : copysignf(1.0f, big));
  y = y_big ? b : q;
  x = y_big ? q : b;
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 15) == 0;
}

// pairs [i0, i0 + V) as Q words of FRAC fraction bits (past n: 0, never
// stored); `full`: the V pairs exist and every pointer is 16-byte aligned
template <int IO, int FRAC>
__device__ __forceinline__ void load_pairs(const void* pa, const void* pb, int64_t i0, int64_t n,
                                           bool full, int32_t (&a)[V], int32_t (&b)[V]) {
  using T = std::conditional_t<IO == kWords, int32_t, float>;
  using T4 = std::conditional_t<IO == kWords, int4, float4>;
  const T* ta = static_cast<const T*>(pa) + i0;
  const T* tb = static_cast<const T*>(pb) + i0;
  T va[V], vb[V];
  if (full) {
    const T4 qa = *reinterpret_cast<const T4*>(ta), qb = *reinterpret_cast<const T4*>(tb);
    va[0] = qa.x, va[1] = qa.y, va[2] = qa.z, va[3] = qa.w;
    vb[0] = qb.x, vb[1] = qb.y, vb[2] = qb.z, vb[3] = qb.w;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      va[e] = i0 + e < n ? ta[e] : T(0);
      vb[e] = i0 + e < n ? tb[e] : T(0);
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    if constexpr (IO == kWords) {
      a[e] = va[e], b[e] = vb[e];
    } else {
      if constexpr (IO == kF32Norm) normalise(va[e], vb[e]);
      a[e] = to_fixed<FRAC>(va[e]), b[e] = to_fixed<FRAC>(vb[e]);
    }
  }
}

template <int IO, int FRAC>
__device__ __forceinline__ void store_results(void* po, int64_t i0, int64_t n, bool full,
                                              const int32_t (&w)[V]) {
  if constexpr (IO == kWords) {
    int32_t* o = static_cast<int32_t*>(po) + i0;
    if (full) {
      *reinterpret_cast<int4*>(o) = make_int4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (i0 + e < n) o[e] = w[e];
    }
  } else {
    float* o = static_cast<float*>(po) + i0;
    float f[V];
#pragma unroll
    for (int e = 0; e < V; ++e) f[e] = from_fixed<FRAC>(w[e]);
    if (full) {
      *reinterpret_cast<float4*>(o) = make_float4(f[0], f[1], f[2], f[3]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (i0 + e < n) o[e] = f[e];
    }
  }
}

// The lean steps keep an SM's two integer pipes evenly loaded: shifts,
// logic and LEA go to the ALU, IMAD to the FMA pipe, 64 lanes each.  A
// step's sign word m = y >> 31 (0 or -1) gives d = 2m + 1 on the ALU and
// -d = m (-2) - 1 on the FMA pipe, and Horner sums over m take c * 2 + m
// there too.  The 2 and -2 come as kernel arguments (Twos): as literals,
// or as one the negation of the other, ptxas turns those multiply-adds
// into ALU shifts and logic.
struct Twos {
  uint32_t two, minus_two;
};

// (v << (30 - b)) >> r for 0 <= v's magnitude < 2**(b + 1), b in [0, 30]:
// v * 2**(30 - b - r) with the reference's floor where that is a right
// shift; the left shift stays inside 31 bits
__device__ __forceinline__ int32_t norm_shift(int32_t v, int32_t b, int r) {
  return static_cast<int32_t>(static_cast<uint32_t>(v) << (30 - b)) >> r;
}

// K6's lean steps: atan2_q with the N = FRAC entries of the atan table of
// FRAC fraction bits compiled in, on V pairs; the result in y.  The (0, 0)
// exit and the x < 0 fold-back are selects.  Entries P.. are 2**(FRAC -
// i), so their part of z is sum_i (2 m_i + 1) 2**(FRAC - i) = TAIL + 4c
// with c = sum_i m_i 2**(N - 1 - i), one Horner step each.
template <int FRAC, int N>
__device__ __forceinline__ void atan2_lean(int32_t (&y)[V], const int32_t (&x_in)[V], Twos k) {
  static_assert(N == FRAC && (FRAC == 16 || FRAC == 24), "compiled tables: (16, 16), (24, 24)");
  constexpr int P = FRAC == 16 ? 6 : 8;
  constexpr uint32_t TAIL = (1u << (FRAC - P + 1)) - 2u;
  int32_t x[V], turn[V];
  uint32_t z[V], c[V];
  bool zero[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int32_t y0 = rq::imax(y[e], rq::RAW_MIN + 1), x0 = rq::imax(x_in[e], rq::RAW_MIN + 1);
    zero[e] = (x0 | y0) == 0;
    // x < 0: reflect through the origin, +-pi back at the end
    const int32_t x1 = x0 < 0 ? -x0 : x0, y1 = x0 < 0 ? -y0 : y0;
    turn[e] = x0 < 0 ? (y0 < 0 ? -rq::pi_at(FRAC) : rq::pi_at(FRAC)) : 0;
    // max(|x|, |y|) to bit 28: v * 2**(28 - b), b = ilog2(max(|x|, |y|, 1))
    const int32_t b = 31 - __clz(rq::imax(rq::imax(x1, y0 < 0 ? -y0 : y0), 1));
    x[e] = norm_shift(x1, b, 2);
    y[e] = norm_shift(y1, b, 2);
    z[e] = 0;
    c[e] = 0;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const uint32_t m = static_cast<uint32_t>(y[e] >> 31);
      const uint32_t d = 2u * m + 1u, nd = m * k.minus_two + ~0u;  // +1 where y >= 0; -d
      const uint32_t xs = static_cast<uint32_t>(x[e] >> i), ys = static_cast<uint32_t>(y[e] >> i);
      x[e] = static_cast<int32_t>(static_cast<uint32_t>(x[e]) + d * ys);
      y[e] = static_cast<int32_t>(static_cast<uint32_t>(y[e]) + nd * xs);
      if (i < P)
        z[e] += d * static_cast<uint32_t>(rq::atan_at(FRAC, i));
      else
        c[e] = c[e] * k.two + m;
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e)
    y[e] = zero[e] ? 0 : static_cast<int32_t>(z[e] + TAIL + 4u * c[e] + static_cast<uint32_t>(turn[e]));
}

// K7's lean steps: div_q16 with N <= 17 linear steps on V pairs, the
// result in num.  Both magnitudes go to bit 29 by their ilog2, so the
// denominator needs no second normalisation; the quotient sum_i d_i
// 2**(16 - i) (d_i = +1 where y_i >= 0) is (2c + 2**N - 1) 2**(17 - N)
// with c = sum_i m_i 2**(N - 1 - i); den == 0, the rounding shift and
// the saturating exponent shift are selects.
template <int N>
__device__ __forceinline__ void div_lean(int32_t (&num)[V], const int32_t (&den_in)[V], Twos k) {
  static_assert(N >= 1 && N <= 17, "the quotient's entries 2**(16 - i) must be whole");
  int32_t x[V], y[V], ex[V];
  uint32_t c[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int32_t nm = rq::imax(num[e], rq::RAW_MIN + 1), dn = rq::imax(den_in[e], rq::RAW_MIN + 1);
    const int32_t an = nm < 0 ? -nm : nm, ad = dn < 0 ? -dn : dn;
    const int32_t bn = 31 - __clz(rq::imax(an, 1)), bd = 31 - __clz(rq::imax(ad, 1));
    y[e] = norm_shift(an, bn, 1);  // an * 2**(29 - bn)
    x[e] = norm_shift(ad, bd, 1);
    ex[e] = bn - bd;  // in [-30, 30]
    c[e] = 0;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const uint32_t m = static_cast<uint32_t>(y[e] >> 31);
      // y >= 0: y -= xs; y < 0: y += xs
      y[e] = static_cast<int32_t>(static_cast<uint32_t>(y[e]) +
                                  (m * k.minus_two + ~0u) * static_cast<uint32_t>(x[e] >> i));
      c[e] = c[e] * k.two + m;
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int32_t q = static_cast<int32_t>((2u * c[e] + ((1u << N) - 1u)) << (17 - N));
    const int32_t nm = rq::imax(num[e], rq::RAW_MIN + 1), dn = den_in[e];
    const int32_t cnt = rq::imax(-ex[e], 0), sl = rq::imax(ex[e], 0);
    const int32_t zr = rq::wadd(q, (1 << cnt) >> 1) >> cnt;
    const int32_t mag = zr <= (rq::RAW_MAX >> sl) ? static_cast<int32_t>(static_cast<uint32_t>(zr) << sl)
                                                  : rq::RAW_MAX;
    const int32_t sat = nm == 0 ? 0 : (nm > 0 ? rq::RAW_MAX : rq::RAW_MIN + 1);
    num[e] = dn == 0 ? sat : ((nm ^ dn) < 0 ? -mag : mag);
  }
}

// the compiled kernels take no table: they cannot load one
struct NoTable {};
template <int N>
using AtanArg = std::conditional_t<N == 0, rq::AtanParams, NoTable>;

// K6: thread t takes pairs [V t, V t + V).  N = 0: atan2_q per pair with
// the table and pi in p (FRAC is then the float boundary's format only)
template <int IO, int FRAC, int N>
__global__ void __launch_bounds__(THREADS) atan2_kernel(const void* __restrict__ y,
                                                        const void* __restrict__ x,
                                                        void* __restrict__ out, int64_t n,
                                                        AtanArg<N> p, Twos k) {
  const int64_t i0 = (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) * V;
  if (i0 >= n) return;
  const bool full = i0 + V <= n && aligned16(y, x, out);
  int32_t a[V], b[V];
  load_pairs<IO, FRAC>(y, x, i0, n, full, a, b);
  if constexpr (N == 0) {
#pragma unroll
    for (int e = 0; e < V; ++e) a[e] = rq::atan2_q(a[e], b[e], p);
  } else {
    atan2_lean<FRAC, N>(a, b, k);
  }
  store_results<IO, FRAC>(out, i0, n, full, a);
}

// K7: as K6; N = 0: div_q16 per pair with `iterations` steps
template <int IO, int N>
__global__ void __launch_bounds__(THREADS) div_kernel(const void* __restrict__ num,
                                                      const void* __restrict__ den,
                                                      void* __restrict__ out, int64_t n,
                                                      int iterations, Twos k) {
  const int64_t i0 = (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) * V;
  if (i0 >= n) return;
  const bool full = i0 + V <= n && aligned16(num, den, out);
  int32_t a[V], b[V];
  load_pairs<IO, 16>(num, den, i0, n, full, a, b);
  if constexpr (N == 0) {
#pragma unroll
    for (int e = 0; e < V; ++e) a[e] = rq::div_q16(a[e], b[e], iterations);
  } else {
    div_lean<N>(a, b, k);
  }
  store_results<IO, 16>(out, i0, n, full, a);
}

constexpr Twos kTwos{2u, 0u - 2u};
// K7's compiled step count: the reference's 17
constexpr int DIV_STEPS = 17;

unsigned pair_blocks(long long n) {
  return static_cast<unsigned>(((n + V - 1) / V + THREADS - 1) / THREADS);
}

// true if (table, iterations, pi) is the compiled atan table of FRAC bits
template <int FRAC>
bool compiled_atan(const rq::AtanParams& p) {
  if (p.iterations != FRAC || p.pi != rq::pi_at(FRAC)) return false;
  for (int i = 0; i < FRAC; ++i)
    if (p.table[i] != rq::atan_at(FRAC, i)) return false;
  return true;
}

// K6 in the form IO: a compiled table (16 entries of frac 16, 24 of frac
// 24; a float form only its own format's) where the host's is one, else
// the table by value
template <int IO>
int launch_atan2(const void* y, const void* x, void* out, long long n, const int32_t* table,
                 int iterations, int pi, void* stream) {
  if (iterations < 0 || iterations > 32) return static_cast<int>(cudaErrorInvalidValue);
  rq::AtanParams p{};
  for (int i = 0; i < iterations; ++i) p.table[i] = table[i];
  p.iterations = iterations;
  p.pi = pi;
  if (n == 0) return 0;
  // the float forms' word format: Q16.16, or Q8.24 for the normalised rung
  constexpr int F = IO == kF32Norm ? 24 : 16;
  const unsigned g = pair_blocks(n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (IO == kWords) {
    if (compiled_atan<16>(p))
      atan2_kernel<IO, 16, 16><<<g, THREADS, 0, st>>>(y, x, out, n, NoTable{}, kTwos);
    else if (compiled_atan<24>(p))
      atan2_kernel<IO, 24, 24><<<g, THREADS, 0, st>>>(y, x, out, n, NoTable{}, kTwos);
    else
      atan2_kernel<IO, F, 0><<<g, THREADS, 0, st>>>(y, x, out, n, p, kTwos);
  } else {
    if (compiled_atan<F>(p))
      atan2_kernel<IO, F, F><<<g, THREADS, 0, st>>>(y, x, out, n, NoTable{}, kTwos);
    else
      atan2_kernel<IO, F, 0><<<g, THREADS, 0, st>>>(y, x, out, n, p, kTwos);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int IO>
int launch_div(const void* num, const void* den, void* out, long long n, int iterations,
               void* stream) {
  if (iterations < 0 || iterations > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const unsigned g = pair_blocks(n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (iterations == DIV_STEPS)
    div_kernel<IO, DIV_STEPS><<<g, THREADS, 0, st>>>(num, den, out, n, iterations, kTwos);
  else
    div_kernel<IO, 0><<<g, THREADS, 0, st>>>(num, den, out, n, iterations, kTwos);
  return static_cast<int>(cudaGetLastError());
}

// true if the host's tables in `h` are the compiled-in schedule of N stages
template <int N>
bool compiled_schedule(const rq::HyperParams& h) {
  if (h.stages_ != N || h.k_h_inv_ != k_h_inv<N>()) return false;
  for (int j = 0; j < N; ++j)
    if (h.shift_[j] != rq::hyper_shift_at(j) || h.atanh_[j] != rq::atanh_q29_at(h.shift_[j]))
      return false;
  return true;
}

template <int OP>
cudaError_t launch_unary(const int32_t* in, int32_t* out, long long n, const rq::HyperParams& h,
                         cudaStream_t st) {
  const unsigned g = static_cast<unsigned>((n + TILE - 1) / TILE);
  if (compiled_schedule<rq::HYPER_STAGES>(h))
    unary_kernel<OP, rq::HYPER_STAGES><<<g, THREADS, 0, st>>>(in, out, n, h);
  else if (compiled_schedule<13>(h))
    unary_kernel<OP, 13><<<g, THREADS, 0, st>>>(in, out, n, h);
  else
    unary_kernel<OP, 0><<<g, THREADS, 0, st>>>(in, out, n, h);
  return cudaGetLastError();
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// K5.  op: 0 sqrt, 1 exp, 2 log, 3 tanh, 4 sigmoid.  shift / atanh:
// `stages` (<= 64) entries of hyperbolic_schedule(stages) and
// atanh_table(schedule, 29); k_h_inv = hyper_gain_inverse(schedule, 29).
// 20 and 13 stages run the kernels with the schedule compiled in.
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
  switch (op) {
    case kSqrt: return static_cast<int>(launch_unary<kSqrt>(in, out, n, h, st));
    case kExp: return static_cast<int>(launch_unary<kExp>(in, out, n, h, st));
    case kLog: return static_cast<int>(launch_unary<kLog>(in, out, n, h, st));
    case kTanh: return static_cast<int>(launch_unary<kTanh>(in, out, n, h, st));
    default: return static_cast<int>(launch_unary<kSigmoid>(in, out, n, h, st));
  }
}

// K6.  table: `iterations` (<= 32) entries of atan_table(iterations,
// frac_bits); pi: round(pi * 2**frac_bits).  16 entries of frac 16 and 24
// of frac 24 run with the table compiled in.
REPRO_EXPORT int repro_universal_atan2(const int32_t* y, const int32_t* x, int32_t* out,
                                       long long n, const int32_t* table, int iterations, int pi,
                                       void* stream) {
  return launch_atan2<kWords>(y, x, out, n, table, iterations, pi, stream);
}

// K6 at the Q16.16 float boundary (ops.atan2): f32 y, x -> f32; table and
// pi as above with frac_bits 16
REPRO_EXPORT int repro_universal_atan2_f32(const float* y, const float* x, float* out,
                                           long long n, const int32_t* table, int iterations,
                                           int pi, void* stream) {
  return launch_atan2<kF32>(y, x, out, n, table, iterations, pi, stream);
}

// K6 as the Q8.24 rung (ops.atan2_24): f32 y, x normalised by max(|y|,
// |x|) -> f32; table and pi with frac_bits 24
REPRO_EXPORT int repro_universal_atan2_24_f32(const float* y, const float* x, float* out,
                                              long long n, const int32_t* table, int iterations,
                                              int pi, void* stream) {
  return launch_atan2<kF32Norm>(y, x, out, n, table, iterations, pi, stream);
}

// K7.  iterations <= 32 linear-vectoring steps; 17 (the reference's) run
// compiled in.
REPRO_EXPORT int repro_universal_div(const int32_t* num, const int32_t* den, int32_t* out,
                                     long long n, int iterations, void* stream) {
  return launch_div<kWords>(num, den, out, n, iterations, stream);
}

// K7 at the Q16.16 float boundary (ops.div): f32 num, den -> f32
REPRO_EXPORT int repro_universal_div_f32(const float* num, const float* den, float* out,
                                         long long n, int iterations, void* stream) {
  return launch_div<kF32>(num, den, out, n, iterations, stream);
}
