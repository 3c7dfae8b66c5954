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
// Bound on the H100: integer operations (a live element costs 100-300:
// 20 stages of 2 shifts, a sign and 2-3 updates, the normalisation and,
// for tanh and sigmoid, a 17-step division); the 8 bytes an element
// moves take ~0.04 ms at 2**24 words.
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

int grid_for(long long n) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  // 132 SMs x 8 resident blocks of 256 threads, a few waves deep
  return static_cast<int>(blocks < 132 * 8 * 4 ? blocks : 132 * 8 * 4);
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
