// SpMM over a row-sorted COO stream: Y = A X, plus-times, float32.
//
// Replaces: combblas_tpu/ops/pallas/spmm_kernel.py spmm_pallas (_spmm_kernel,
// K8).
//
// Bound on the H100: bytes.  Counted once, the function reads the row
// pointer, the (col, val) stream and X and writes Y; each entry is one
// multiply-add per column of X.  As in the ELL kernel, each entry gathers a
// whole row of X (d*4 bytes), so the kernel sits above that bound, in the
// gathers.
//
// Design: the TPU kernel streamed 1024-entry tiles, folded row runs inside
// each 8-entry group with a rolled prefix combine, and carried the open run
// across groups and tiles in scratch (its grid runs in order).  None of that
// carries to Hopper, where blocks run in no order.  The wrapper hands the
// row pointer of the sorted stream instead: T lanes own one row (32 / T
// rows per warp), sum the row's val * X[col] in registers, 16 bytes a lane
// (float4 when d % 4 == 0), and write the row of Y once; a row with no
// entries gets 0.  No atomics, no carry.  The float32 products accumulate
// in double, so a hub row's long sum rounds once, at the store.
#include <cuda_runtime.h>

#include <cstdint>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;

template <int T, int VEC>
__global__ void __launch_bounds__(kThreads)
spmm_coo_kernel(const int64_t* __restrict__ row_ptr,  // (m + 1)
                const int32_t* __restrict__ col,
                const float* __restrict__ val, int64_t m,
                const float* __restrict__ x, int64_t d,
                float* __restrict__ y) {               // (m, d)
  constexpr int kUnroll = 4;
  const int64_t team = (static_cast<int64_t>(blockIdx.x) * kThreads +
                        threadIdx.x) / T;
  const int64_t nteams = static_cast<int64_t>(gridDim.x) * kThreads / T;
  const int sub = threadIdx.x % T;
  for (int64_t r = team; r < m; r += nteams) {
    const int64_t s = row_ptr[r];
    const int64_t e = row_ptr[r + 1];
    for (int64_t c0 = sub * VEC; c0 < d; c0 += T * VEC) {
      double acc[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = 0.0;
      const float* xc = x + c0;
      int64_t i = s;
      // kUnroll entries at a time: their gathers are in flight together
      for (; i + kUnroll <= e; i += kUnroll) {
        float xv[kUnroll][VEC];
        float v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          v[u] = __ldg(val + i + u);
          cbt::load_vec<VEC>(xc + static_cast<int64_t>(__ldg(col + i + u)) * d,
                        xv[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            acc[j] += static_cast<double>(v[u] * xv[u][j]);
      }
      for (; i < e; ++i) {
        float xv[VEC];
        const float v = __ldg(val + i);
        cbt::load_vec<VEC>(xc + static_cast<int64_t>(__ldg(col + i)) * d, xv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] += static_cast<double>(v * xv[j]);
      }
      float out[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) out[j] = static_cast<float>(acc[j]);
      cbt::store_vec<VEC>(y + r * d + c0, out);
    }
  }
}

template <int VEC>
int launch(const int64_t* rp, const int32_t* col, const float* val,
           int64_t m, const float* x, int64_t d, float* y,
           cudaStream_t stream) {
  // lanes per row: enough 16-byte vectors to cover d, from 4 to 32
  const int64_t nvec = (d + VEC - 1) / VEC;
  const int t = nvec >= 32 ? 32 : nvec >= 16 ? 16 : nvec >= 8 ? 8 : 4;
  int64_t blocks = (m * t + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (t == 32)
    spmm_coo_kernel<32, VEC><<<grid, kThreads, 0, stream>>>(rp, col, val, m,
                                                            x, d, y);
  else if (t == 16)
    spmm_coo_kernel<16, VEC><<<grid, kThreads, 0, stream>>>(rp, col, val, m,
                                                            x, d, y);
  else if (t == 8)
    spmm_coo_kernel<8, VEC><<<grid, kThreads, 0, stream>>>(rp, col, val, m,
                                                           x, d, y);
  else
    spmm_coo_kernel<4, VEC><<<grid, kThreads, 0, stream>>>(rp, col, val, m,
                                                           x, d, y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cbt_spmm_coo(const void* row_ptr, const void* col,
                            const void* val, int64_t m, const void* x,
                            int64_t d, void* y, void* stream) {
  const auto* rp = static_cast<const int64_t*>(row_ptr);
  const auto* c = static_cast<const int32_t*>(col);
  const auto* v = static_cast<const float*>(val);
  const auto* xx = static_cast<const float*>(x);
  auto* yy = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (cbt::rows_vec4(x, y, d)) return launch<4>(rp, c, v, m, xx, d, yy, st);
  return launch<1>(rp, c, v, m, xx, d, yy, st);
}
