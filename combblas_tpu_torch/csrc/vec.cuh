// 16-byte (float4) or scalar loads and stores of float rows, for the SpMM
// kernels (ell.cu, spmm_coo.cu): VEC = 4 needs 16-byte aligned addresses.
#pragma once

#include <cuda_runtime.h>

namespace cbt {

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// float4 rows need d % 4 == 0 and 16-byte aligned bases.
inline bool rows_vec4(const void* x, const void* y, long long d) {
  return d % 4 == 0 && reinterpret_cast<unsigned long long>(x) % 16 == 0 &&
         reinterpret_cast<unsigned long long>(y) % 16 == 0;
}

}  // namespace cbt
