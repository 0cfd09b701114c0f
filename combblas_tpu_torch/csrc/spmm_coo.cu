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
// across tiles in scratch (its grid runs in order).  None of that carries to
// Hopper, where blocks run in no order.  Here the entry stream is cut into
// fixed ranges of L entries, [t*L, (t+1)*L), and a team of T lanes takes
// range t (grid-stride), finds the row holding its first entry by binary
// search in the row pointer, and walks the rows from there (skipping runs
// of empty rows by a galloping search):
//   - a row of at most L entries is summed whole, in registers, by the team
//     whose range holds its first entry (it may run past the range's end by
//     less than L entries), and written to Y once;
//   - a row of more than L entries (a hub: 62.5k entries at scale 21) is cut
//     at the range bounds: each team sums the row's entries inside its range
//     into a float64 partial, slot 2t for the row holding the range's first
//     entry, slot 2t+1 for a long row that starts inside the range.
// Pass 2 gives each row a team again: it sums a long row's partials in range
// order and writes the row, and writes 0 to a row with no entries.  So the
// hub row is spread over its 245 ranges instead of one team, no host sync or
// table is needed (the ranges follow from L), there are no atomics, and the
// sum still rounds once, at the store.  T lanes own one row at a time (32 / T
// rows per warp), 16 bytes a lane (float4 when d % 4 == 0); a team keeps 8
// entries' gathers in flight, as the ELL kernel keeps 4 positions': the
// bulk of short rows is bound by the loads in flight, not by bandwidth.
#include <cuda_runtime.h>

#include <cstdint>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;

// Sum val[i] * X[col[i], c0 .. c0 + VEC) over i in [i0, i1) into acc.
template <int VEC>
__device__ __forceinline__ void sum_entries(const int32_t* __restrict__ col,
                                            const float* __restrict__ val,
                                            int64_t i0, int64_t i1,
                                            const float* __restrict__ xc,
                                            int64_t d, double (&acc)[VEC]) {
  constexpr int kUnroll = 8;
  int64_t i = i0;
  // kUnroll entries at a time: their gathers are in flight together
  for (; i + kUnroll <= i1; i += kUnroll) {
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
  for (; i < i1; ++i) {
    float xv[VEC];
    const float v = __ldg(val + i);
    cbt::load_vec<VEC>(xc + static_cast<int64_t>(__ldg(col + i)) * d, xv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] += static_cast<double>(v * xv[j]);
  }
}

// The row r >= lo with row_ptr[r] <= a < row_ptr[r + 1], given row_ptr[lo]
// <= a < row_ptr[m]: a galloping search from lo, so that a row next to lo
// costs one load and a run of k empty rows log2(k).
__device__ __forceinline__ int64_t row_holding(
    const int64_t* __restrict__ row_ptr, int64_t lo, int64_t m, int64_t a) {
  int64_t step = 1;
  int64_t hi = lo + 1;
  while (hi < m && row_ptr[hi] <= a) {
    lo = hi;
    step *= 2;
    hi = lo + step;
  }
  if (hi > m) hi = m;
  while (hi - lo > 1) {
    const int64_t mid = (lo + hi) / 2;
    if (row_ptr[mid] <= a)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

// Pass 1: one team of T lanes per range of L entries, held to 64 registers
// a thread so that 4 blocks (32 warps) stay resident on an SM.
template <int T, int VEC>
__global__ void __launch_bounds__(kThreads, 4)
spmm_coo_kernel(const int64_t* __restrict__ row_ptr,  // (m + 1)
                const int32_t* __restrict__ col,
                const float* __restrict__ val, int64_t m, int64_t piece,
                const float* __restrict__ x, int64_t d,
                double* __restrict__ part,             // (2 * ranges, d)
                float* __restrict__ y) {               // (m, d)
  const int64_t team = (static_cast<int64_t>(blockIdx.x) * kThreads +
                        threadIdx.x) / T;
  const int64_t nteams = static_cast<int64_t>(gridDim.x) * kThreads / T;
  const int sub = threadIdx.x % T;
  const int64_t nnz = row_ptr[m];
  for (int64_t t = team; t * piece < nnz; t += nteams) {
    const int64_t a = t * piece;
    const int64_t b = a + piece < nnz ? a + piece : nnz;
    // the row holding entry a: a binary search over all rows
    int64_t r = 0, hi = m;
    while (hi - r > 1) {
      const int64_t mid = (r + hi) / 2;
      if (row_ptr[mid] <= a)
        r = mid;
      else
        hi = mid;
    }
    for (int64_t s = row_ptr[r];;) {
      const int64_t e = row_ptr[r + 1];
      const bool cut = e - s > piece;
      if (cut || (s >= a && e > s)) {
        const int64_t i0 = cut && s < a ? a : s;
        const int64_t i1 = cut && e > b ? b : e;
        double* dst = part + (2 * t + (s > a)) * d;
        for (int64_t c0 = sub * VEC; c0 < d; c0 += T * VEC) {
          double acc[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] = 0.0;
          sum_entries<VEC>(col, val, i0, i1, x + c0, d, acc);
          if (cut) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) dst[c0 + j] = acc[j];
          } else {
            float out[VEC];
#pragma unroll
            for (int j = 0; j < VEC; ++j) out[j] = static_cast<float>(acc[j]);
            cbt::store_vec<VEC>(y + r * d + c0, out);
          }
        }
      }
      if (e >= b) break;
      r = row_holding(row_ptr, r + 1, m, e);   // past any empty rows
      s = e;
    }
  }
}

// Pass 2: a long row's partials summed in range order; an empty row is 0.
template <int T, int VEC>
__global__ void __launch_bounds__(kThreads)
spmm_coo_combine_kernel(const int64_t* __restrict__ row_ptr, int64_t m,
                        int64_t piece, int64_t d,
                        const double* __restrict__ part,
                        float* __restrict__ y) {
  const int64_t team = (static_cast<int64_t>(blockIdx.x) * kThreads +
                        threadIdx.x) / T;
  const int64_t nteams = static_cast<int64_t>(gridDim.x) * kThreads / T;
  const int sub = threadIdx.x % T;
  for (int64_t r = team; r < m; r += nteams) {
    const int64_t s = row_ptr[r];
    const int64_t e = row_ptr[r + 1];
    if (e > s && e - s <= piece) continue;   // written whole by pass 1
    const int64_t t0 = s / piece;
    const int64_t t1 = e > s ? (e - 1) / piece : t0 - 1;
    for (int64_t c0 = sub * VEC; c0 < d; c0 += T * VEC) {
      double acc[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = 0.0;
      // range t0 holds the row's start: slot 2*t0 if the row starts the
      // range, else 2*t0 + 1; every later range begins inside the row
      for (int64_t t = t0; t <= t1; ++t) {
        const double* q = part + (2 * t + (t == t0 && s > t0 * piece)) * d;
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] += q[c0 + j];
      }
      float out[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) out[j] = static_cast<float>(acc[j]);
      cbt::store_vec<VEC>(y + r * d + c0, out);
    }
  }
}

unsigned grid_for(int64_t teams, int t) {
  int64_t blocks = (teams * t + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

template <int T, int VEC>
int launch_t(const int64_t* rp, const int32_t* col, const float* val,
             int64_t m, int64_t ranges, int64_t piece, const float* x,
             int64_t d, double* part, float* y, cudaStream_t stream) {
  spmm_coo_kernel<T, VEC><<<grid_for(ranges, T), kThreads, 0, stream>>>(
      rp, col, val, m, piece, x, d, part, y);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  spmm_coo_combine_kernel<T, VEC><<<grid_for(m, T), kThreads, 0, stream>>>(
      rp, m, piece, d, part, y);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int launch(const int64_t* rp, const int32_t* col, const float* val,
           int64_t m, int64_t ranges, int64_t piece, const float* x,
           int64_t d, double* part, float* y, cudaStream_t stream) {
  // lanes per row: enough 16-byte vectors to cover d, from 4 to 32
  const int64_t nvec = (d + VEC - 1) / VEC;
  if (nvec >= 32)
    return launch_t<32, VEC>(rp, col, val, m, ranges, piece, x, d, part, y,
                             stream);
  if (nvec >= 16)
    return launch_t<16, VEC>(rp, col, val, m, ranges, piece, x, d, part, y,
                             stream);
  if (nvec >= 8)
    return launch_t<8, VEC>(rp, col, val, m, ranges, piece, x, d, part, y,
                            stream);
  return launch_t<4, VEC>(rp, col, val, m, ranges, piece, x, d, part, y,
                          stream);
}

}  // namespace

// ranges = ceil(entries / piece_len) for any entries >= row_ptr[m]; part:
// float64 (2 * ranges, d).
extern "C" int cbt_spmm_coo(const void* row_ptr, const void* col,
                            const void* val, int64_t m, int64_t ranges,
                            int64_t piece_len, const void* x, int64_t d,
                            void* part, void* y, void* stream) {
  const auto* rp = static_cast<const int64_t*>(row_ptr);
  const auto* c = static_cast<const int32_t*>(col);
  const auto* v = static_cast<const float*>(val);
  const auto* xx = static_cast<const float*>(x);
  auto* pp = static_cast<double*>(part);
  auto* yy = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (cbt::rows_vec4(x, y, d))
    return launch<4>(rp, c, v, m, ranges, piece_len, xx, d, pp, yy, st);
  return launch<1>(rp, c, v, m, ranges, piece_len, xx, d, pp, yy, st);
}
