// Degree-sorted ELL-8 fold: Y = A (.) X with a sum, or a max from 0.
//
// Replaces: combblas_tpu/ops/pallas/spmm_ell.py _spmm_ell_call (_ell_kernel,
// K6: one column block, sum) and combblas_tpu/ops/pallas/spmm_ell_blocked.py
// _ell_blocked_call (_ell_blocked_kernel, K7: nb x nb blocks, sum or max).
// The ELL-8 plan of K6 is the blocked plan with nb = 1, so one kernel serves
// both, as one template per fold.
//
// Bound on the H100: bytes.  Each position p holds 8 (col, val) pairs, one
// per row of its group; each pair costs a multiply and a fold on one row of
// X.  Counted once, the function moves the plan, X and Y; but the gathers
// read a row of X for every one of the 8*P pairs (d*4 bytes each), so the
// kernel sits far above that bound, in the gathers.
//
// Design: both TPU kernels walked positions in grid order and carried the
// (8, d) accumulator across grid steps (K6 in 4 unrolled slots, K7 with a
// read-modify-write into a zeroed output block at each run's flush).  Blocks
// on Hopper run in no order, so nothing carries here.  One warp owns one
// 8-row group: it walks the group's runs over column blocks cb = 0..nb-1 in
// order (start and length from the plan's run table), keeps the 8 rows'
// accumulators in registers, and writes its 8 rows of Y once: no atomics,
// no read-modify-write, no zero-fill pass.  Lanes split the d columns in
// 16-byte vectors (float4 when d % 4 == 0): with T lanes per row, a warp
// holds 32 / T row slots and each lane 8 / (32 / T) rows; d wider than
// T * 4 is walked in column tiles.  Padding slots (col 0, val 0) fold
// 0 * X[cb*bs_c] as on the TPU.  The sum accumulates the float32 products
// in double, so a hub group's tens of thousands of terms still round once,
// at the store; the card's double adds are far below the gather time.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 32;

template <bool kMax, int T, int VEC>
__global__ void __launch_bounds__(kThreads)
ell_kernel(const int32_t* __restrict__ cols,       // (P, 8)
           const float* __restrict__ vals,         // (P, 8)
           const int32_t* __restrict__ run_start,  // (groups, nb)
           const int32_t* __restrict__ run_len,    // (groups, nb)
           int64_t groups, int nb, int64_t bs_c,
           const float* __restrict__ x, int64_t d,
           float* __restrict__ y) {                // (groups * 8, d)
  constexpr int kSlots = 32 / T;       // row slots per warp
  constexpr int kRows = 8 / kSlots;    // rows per lane
  const int lane = threadIdx.x & 31;
  const int slot = lane / T;
  const int sub = lane % T;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t g = warp; g < groups; g += nwarps) {
    for (int64_t c0 = 0; c0 < d; c0 += T * VEC) {
      const int64_t col = c0 + sub * VEC;
      const bool on = col < d;
      using Acc = std::conditional_t<kMax, float, double>;
      Acc acc[kRows][VEC];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[k][j] = Acc(0);
      for (int cb = 0; cb < nb; ++cb) {
        const int64_t s = run_start[g * nb + cb];
        const int64_t e = s + run_len[g * nb + cb];
        const float* xb = x + cb * bs_c * d + col;
        for (int64_t p = s; p < e; ++p) {
          int32_t c[kRows];
          float v[kRows];
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            c[k] = __ldg(cols + p * 8 + slot + k * kSlots);
            v[k] = __ldg(vals + p * 8 + slot + k * kSlots);
          }
          if (!on) continue;
          float xv[kRows][VEC];
#pragma unroll
          for (int k = 0; k < kRows; ++k)
            cbt::load_vec<VEC>(xb + static_cast<int64_t>(c[k]) * d, xv[k]);
#pragma unroll
          for (int k = 0; k < kRows; ++k)
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              const float t = v[k] * xv[k][j];
              if constexpr (kMax)
                acc[k][j] = fmaxf(acc[k][j], t);
              else
                acc[k][j] += static_cast<double>(t);
            }
        }
      }
      if (on) {
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          float out[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j) out[j] = static_cast<float>(acc[k][j]);
          cbt::store_vec<VEC>(y + (g * 8 + slot + k * kSlots) * d + col, out);
        }
      }
    }
  }
}

template <bool kMax, int VEC>
int launch_fold(const int32_t* cols, const float* vals, const int32_t* rs,
                const int32_t* rl, int64_t groups, int nb, int64_t bs_c,
                const float* x, int64_t d, float* y, cudaStream_t stream) {
  int64_t blocks = (groups + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const unsigned grid = static_cast<unsigned>(blocks);
  // lanes per row: enough 16-byte vectors to cover d, at least 4 (a warp
  // holds at most 8 row slots)
  const int64_t nvec = (d + VEC - 1) / VEC;
  if (nvec >= 32) {
    ell_kernel<kMax, 32, VEC><<<grid, kThreads, 0, stream>>>(
        cols, vals, rs, rl, groups, nb, bs_c, x, d, y);
  } else if (nvec >= 16) {
    ell_kernel<kMax, 16, VEC><<<grid, kThreads, 0, stream>>>(
        cols, vals, rs, rl, groups, nb, bs_c, x, d, y);
  } else if (nvec >= 8) {
    ell_kernel<kMax, 8, VEC><<<grid, kThreads, 0, stream>>>(
        cols, vals, rs, rl, groups, nb, bs_c, x, d, y);
  } else {
    ell_kernel<kMax, 4, VEC><<<grid, kThreads, 0, stream>>>(
        cols, vals, rs, rl, groups, nb, bs_c, x, d, y);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kMax>
int launch_op(const int32_t* cols, const float* vals, const int32_t* rs,
              const int32_t* rl, int64_t groups, int nb, int64_t bs_c,
              const float* x, int64_t d, float* y, cudaStream_t stream) {
  if (cbt::rows_vec4(x, y, d))
    return launch_fold<kMax, 4>(cols, vals, rs, rl, groups, nb, bs_c, x, d,
                                y, stream);
  return launch_fold<kMax, 1>(cols, vals, rs, rl, groups, nb, bs_c, x, d, y,
                              stream);
}

}  // namespace

// op: 0 = sum, 1 = max from 0.
extern "C" int cbt_ell_fold(const void* cols, const void* vals,
                            const void* run_start, const void* run_len,
                            int64_t groups, int64_t nb, int64_t bs_c,
                            const void* x, int64_t d, int32_t op, void* y,
                            void* stream) {
  const auto* c = static_cast<const int32_t*>(cols);
  const auto* v = static_cast<const float*>(vals);
  const auto* rs = static_cast<const int32_t*>(run_start);
  const auto* rl = static_cast<const int32_t*>(run_len);
  const auto* xx = static_cast<const float*>(x);
  auto* yy = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  const int n_blocks = static_cast<int>(nb);
  if (op == 1)
    return launch_op<true>(c, v, rs, rl, groups, n_blocks, bs_c, xx, d, yy,
                           st);
  return launch_op<false>(c, v, rs, rl, groups, n_blocks, bs_c, xx, d, yy,
                          st);
}
