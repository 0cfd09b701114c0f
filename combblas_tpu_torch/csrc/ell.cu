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
// kernel sits far above that bound, in the gathers and their latency.
//
// Design: both TPU kernels walked positions in grid order and carried the
// (8, d) accumulator across grid steps.  Blocks on Hopper run in no order,
// so nothing carries here.  A group's runs over the column blocks, laid end
// to end, are cut into pieces of at most L positions (the piece table,
// ops/kernels/ell.py:ell_pieces; one row per piece: run = g*nb + cb of its
// first position, start, len, out).  Pass 1: W warps take one piece (8 / W
// rows each), grid-stride over the table, longest pieces first, and walk
// its positions into the group's later runs; the rows' accumulators stay in
// registers.  A group of one piece writes its 8 rows of Y directly (out <
// 0); a group cut into k > 1 pieces writes k partial (8, d) tiles to scratch
// (out = tile), float64 for the sum and float32 for the max.  Pass 2 folds
// each split group's tiles in piece order, and writes 0 for a group with no
// piece.  So a hub group (62,517 positions at scale 21) no longer runs on
// one warp while the rest of the card idles, and the sum still rounds once,
// at the store, with no atomics: the result does not depend on the schedule.
//
// Latency: each position costs two dependent round trips, the (col, val)
// load and then the gathers of X, and the bulk of short groups is bound by
// how many of those are in flight, not by bandwidth.  A warp loads four
// positions' pairs and has all four positions' gathers in flight before it
// folds them.  Lanes split the d columns in 16-byte vectors (float4 when
// d % 4 == 0): with T lanes per row a warp holds 32 / T row slots; d wider
// than T * 4 is walked in column tiles.  At d = 128 (T = 32) two warps share
// a piece, 4 rows each, so a lane holds 16 double accumulators, not 32, and
// the pass is held to 80 registers a thread (ptxas, sum and max), so 3
// blocks, 24 warps, stay resident on an SM (at 86 registers only 2 fit).
// At d = 8 (T = 4) one warp takes a piece: 78 registers for the sum (24
// warps an SM), 92 for the max (16 warps).  Pass 2 takes 32.  Padding slots
// (col 0, val 0) fold 0 * X[cb*bs_c] as on the TPU.  The sum accumulates the
// float32 products in double; the card's double adds are far below the
// gather time.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 32;
// Positions whose (col, val) loads, then gathers, a warp has in flight.
constexpr int kInFlight = 4;

template <bool kMax>
using Acc = std::conditional_t<kMax, float, double>;

// Fold N positions from p on: load their (col, val) pairs, then gather all
// of their rows of X, then fold, so N positions' loads are in flight at once.
template <bool kMax, int N, int kRows, int kSlots, int VEC>
__device__ __forceinline__ void fold_step(const int32_t* __restrict__ cols,
                                          const float* __restrict__ vals,
                                          int64_t p, int row0,
                                          const float* __restrict__ xb,
                                          int64_t d,
                                          Acc<kMax> (&acc)[kRows][VEC]) {
  int32_t c[N][kRows];
  float v[N][kRows];
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      c[u][k] = __ldg(cols + (p + u) * 8 + row0 + k * kSlots);
      v[u][k] = __ldg(vals + (p + u) * 8 + row0 + k * kSlots);
    }
  float xv[N][kRows][VEC];
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      cbt::load_vec<VEC>(xb + static_cast<int64_t>(c[u][k]) * d, xv[u][k]);
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int k = 0; k < kRows; ++k)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float t = v[u][k] * xv[u][k][j];
        if constexpr (kMax)
          acc[k][j] = fmaxf(acc[k][j], t);
        else
          acc[k][j] += static_cast<double>(t);
      }
}

// Pass 1: W warps per piece, each folding 8 / W of the group's rows.  At
// T = 32 the registers are held to 80 a thread, so that 3 blocks (24 warps)
// stay resident on an SM.
template <bool kMax, int T, int VEC, int W>
__global__ void __launch_bounds__(kThreads, T == 32 ? 3 : 1)
ell_kernel(const int32_t* __restrict__ cols,       // (P, 8)
           const float* __restrict__ vals,         // (P, 8)
           const int32_t* __restrict__ run_start,  // (groups * nb)
           const int32_t* __restrict__ run_len,    // (groups * nb)
           const int4* __restrict__ pieces,        // (n_pieces): run, start,
           int64_t n_pieces, int nb, int64_t bs_c, //   len, out
           const float* __restrict__ x, int64_t d,
           float* __restrict__ y,                  // (groups * 8, d)
           Acc<kMax>* __restrict__ part) {         // (tiles, 8, d)
  constexpr int kSlots = 32 / T;             // row slots per warp
  constexpr int kRowsPerWarp = 8 / W;
  constexpr int kRows = kRowsPerWarp / kSlots;   // rows per lane
  static_assert(kRows >= 1, "a warp holds at most 8 / W row slots");
  const int lane = threadIdx.x & 31;
  const int slot = lane / T;
  const int sub = lane % T;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t it = warp; it < n_pieces * W; it += nwarps) {
    const int4 pc = pieces[it / W];
    const int row0 = static_cast<int>(it % W) * kRowsPerWarp + slot;
    for (int64_t c0 = 0; c0 < d; c0 += T * VEC) {
      const int64_t col = c0 + sub * VEC;
      if (col >= d) continue;
      Acc<kMax> acc[kRows][VEC];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[k][j] = Acc<kMax>(0);
      int run = pc.x;
      int64_t p = pc.y;
      int64_t left = pc.z;
      int64_t end = static_cast<int64_t>(run_start[run]) + run_len[run];
      while (true) {
        const int64_t stop = end < p + left ? end : p + left;
        const float* xb = x + (run % nb) * bs_c * d + col;
        left -= stop - p;
        for (; p + kInFlight <= stop; p += kInFlight)
          fold_step<kMax, kInFlight, kRows, kSlots, VEC>(cols, vals, p, row0,
                                                         xb, d, acc);
        for (; p < stop; ++p)
          fold_step<kMax, 1, kRows, kSlots, VEC>(cols, vals, p, row0, xb, d,
                                                 acc);
        if (left <= 0) break;
        ++run;   // the piece goes on in the group's next run
        p = run_start[run];
        end = p + run_len[run];
      }
      const int64_t g = pc.x / nb;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int64_t r = row0 + k * kSlots;
        if (pc.w < 0) {
          float out[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j) out[j] = static_cast<float>(acc[k][j]);
          cbt::store_vec<VEC>(y + (g * 8 + r) * d + col, out);
        } else {
          Acc<kMax>* dst = part + (int64_t{pc.w} * 8 + r) * d + col;
#pragma unroll
          for (int j = 0; j < VEC; ++j) dst[j] = acc[k][j];
        }
      }
    }
  }
}

// Pass 2: the 8 rows of each group with other than one piece, a block per
// group: its partial tiles folded in piece order (none: 0).
template <bool kMax>
__global__ void __launch_bounds__(kThreads)
ell_combine_kernel(const int32_t* __restrict__ folds,  // (n_folds, 3): group,
                   int64_t n_folds, int64_t d,         //   first tile, tiles
                   const Acc<kMax>* __restrict__ part,
                   float* __restrict__ y) {
  const int64_t tile = 8 * d;
  for (int64_t f = blockIdx.x; f < n_folds; f += gridDim.x) {
    const int32_t* fo = folds + f * 3;
    const Acc<kMax>* q = part + int64_t{fo[1]} * tile;
    float* out = y + int64_t{fo[0]} * tile;
    const int n = fo[2];
    for (int64_t e = threadIdx.x; e < tile; e += kThreads) {
      Acc<kMax> acc = 0;
      for (int j = 0; j < n; ++j) {
        if constexpr (kMax)
          acc = fmaxf(acc, q[j * tile + e]);
        else
          acc += q[j * tile + e];
      }
      out[e] = static_cast<float>(acc);
    }
  }
}

int64_t grid_for(int64_t units, int64_t per_block) {
  int64_t blocks = (units + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  return blocks > kMaxBlocks ? kMaxBlocks : blocks;
}

struct Args {
  const int32_t* cols;
  const float* vals;
  const int32_t* rs;
  const int32_t* rl;
  const int4* pieces;
  int64_t n_pieces;
  const int32_t* folds;
  int64_t n_folds;
  int nb;
  int64_t bs_c;
  const float* x;
  int64_t d;
  void* part;
  float* y;
  cudaStream_t stream;
};

template <bool kMax, int T, int VEC>
void launch_pieces(const Args& a) {
  // two warps per piece while a warp would hold all 8 rows in fewer than
  // 8 row slots: half the accumulators per lane
  constexpr int W = 32 / T * 2 <= 8 ? 2 : 1;
  const auto grid =
      static_cast<unsigned>(grid_for(a.n_pieces * W, kWarpsPerBlock));
  ell_kernel<kMax, T, VEC, W><<<grid, kThreads, 0, a.stream>>>(
      a.cols, a.vals, a.rs, a.rl, a.pieces, a.n_pieces, a.nb, a.bs_c, a.x,
      a.d, a.y, static_cast<Acc<kMax>*>(a.part));
}

template <bool kMax, int VEC>
int launch_fold(const Args& a) {
  // lanes per row: enough 16-byte vectors to cover d, at least 4 (a warp
  // holds at most 8 row slots)
  const int64_t nvec = (a.d + VEC - 1) / VEC;
  if (nvec >= 32)
    launch_pieces<kMax, 32, VEC>(a);
  else if (nvec >= 16)
    launch_pieces<kMax, 16, VEC>(a);
  else if (nvec >= 8)
    launch_pieces<kMax, 8, VEC>(a);
  else
    launch_pieces<kMax, 4, VEC>(a);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || a.n_folds == 0) return err;
  const auto grid = static_cast<unsigned>(grid_for(a.n_folds, 1));
  ell_combine_kernel<kMax><<<grid, kThreads, 0, a.stream>>>(
      a.folds, a.n_folds, a.d, static_cast<const Acc<kMax>*>(a.part), a.y);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMax>
int launch_op(const Args& a) {
  if (cbt::rows_vec4(a.x, a.y, a.d)) return launch_fold<kMax, 4>(a);
  return launch_fold<kMax, 1>(a);
}

}  // namespace

// op: 0 = sum (part float64), 1 = max from 0 (part float32).
extern "C" int cbt_ell_fold(const void* cols, const void* vals,
                            const void* run_start, const void* run_len,
                            const void* pieces, int64_t n_pieces,
                            const void* folds, int64_t n_folds, int64_t nb,
                            int64_t bs_c, const void* x, int64_t d, int32_t op,
                            void* part, void* y, void* stream) {
  const Args a{static_cast<const int32_t*>(cols),
               static_cast<const float*>(vals),
               static_cast<const int32_t*>(run_start),
               static_cast<const int32_t*>(run_len),
               static_cast<const int4*>(pieces),
               n_pieces,
               static_cast<const int32_t*>(folds),
               n_folds,
               static_cast<int>(nb),
               bs_c,
               static_cast<const float*>(x),
               d,
               part,
               static_cast<float*>(y),
               static_cast<cudaStream_t>(stream)};
  return op == 1 ? launch_op<true>(a) : launch_op<false>(a);
}
