// Semiring operations as the kernels take them: integer codes, the same as
// combblas_tpu_torch/semiring.py ADD_CODES / MUL_CODES.
#pragma once

#include <cstdint>

namespace cbt {

// mul codes: 0 times, 1 plus, 2 second, 3 first, 4 and
__device__ __forceinline__ float sr_mul(int code, float a, float b) {
  switch (code) {
    case 0: return a * b;
    case 1: return a + b;
    case 2: return b;
    case 3: return a;
    default: return (a != 0.0f && b != 0.0f) ? 1.0f : 0.0f;
  }
}

// add codes: 0 sum, 1 min, 2 max
__device__ __forceinline__ float sr_add(int code, float a, float b) {
  switch (code) {
    case 0: return a + b;
    case 1: return b < a ? b : a;
    default: return b > a ? b : a;
  }
}

template <typename K> __device__ __forceinline__ K key_sentinel();
template <> __device__ __forceinline__ int32_t key_sentinel<int32_t>() {
  return INT32_MAX;
}
template <> __device__ __forceinline__ int64_t key_sentinel<int64_t>() {
  return INT64_MAX;
}

}  // namespace cbt
