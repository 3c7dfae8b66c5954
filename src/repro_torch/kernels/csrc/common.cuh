// Shared helpers for the port's hand-written Hopper kernels.
//
// Integer semantics follow the reference (XLA) exactly and are spelled
// out here because C leaves them undefined:
//   * add/sub/neg wrap modulo 2**32 (done in uint32);
//   * a left shift by 32 or more gives 0, an arithmetic right shift by
//     32 or more gives the sign fill (0 or -1).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// every library exports its error-string accessor for the Python side
#define REPRO_DEFINE_ERROR_STRING                                   \
  REPRO_EXPORT const char* repro_error_string(int code) {           \
    return cudaGetErrorString(static_cast<cudaError_t>(code));      \
  }

namespace rq {

constexpr int32_t RAW_MAX = 2147483647;
constexpr int32_t RAW_MIN = -2147483647 - 1;

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wneg(int32_t a) {
  return static_cast<int32_t>(0u - static_cast<uint32_t>(a));
}
// shift counts are >= 0 at every call site
__device__ __forceinline__ int32_t shl(int32_t v, int32_t s) {
  return s >= 32 ? 0 : static_cast<int32_t>(static_cast<uint32_t>(v) << s);
}
__device__ __forceinline__ int32_t sar(int32_t v, int32_t s) {
  return s >= 32 ? (v < 0 ? -1 : 0) : (v >> s);
}
__device__ __forceinline__ int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }
__device__ __forceinline__ int32_t imin(int32_t a, int32_t b) { return a < b ? a : b; }

// exact 2**e as f32 for the exponents the epilogues see (ldexpf is
// exact; exp2f is not under fast math)
__device__ __forceinline__ float pow2f(int32_t e) { return ldexpf(1.0f, e); }

}  // namespace rq
