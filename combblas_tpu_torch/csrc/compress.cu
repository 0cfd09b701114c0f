// Compress a key-sorted stream: fold each run of equal keys with the
// semiring add (in f32), drop sentinel keys wherever they stand, compact to
// (key, val) and count the survivors.
//
// Replaces: combblas_tpu/ops/pallas/compress_kernel.py
// compress_sorted_packed_pallas (_compress_kernel, K2: int32 keys) and
// compress_sorted_wide_pallas (_compress_wide_kernel, K4: the (row, col)
// pair, here one int64 key row*(n+1)+col).
//
// Bound on the H100: bytes.  One read of every (key, val) pair plus one
// write per survivor, with one add per element.
//
// Design: the TPU kernel walks the tiles in grid order and carries the open
// run's key and partial value from one grid step to the next in SMEM.
// Hopper blocks run in no order, so nothing can carry.  Instead:
//   (a) head_count_kernel: each block flags the run heads of its tile (a
//       real key differing from its left neighbour) and writes its count;
//   (b) the wrapper takes an exclusive scan of the per-block counts;
//   (c) emit_kernel: the thread at each run head walks its run to the end
//       (past the tile edge if need be) and writes the fold at its offset:
//       block offset + the head's rank inside the tile (a block scan built
//       from warp ballots).
// A run is read by its head thread only, so runs crossing block edges need
// no carry.  Reads are coalesced (consecutive threads on consecutive keys);
// survivors past `cap` are counted but not written, so the count saturates
// in the wrapper as the retry signal.
#include <cuda_runtime.h>

#include <cstdint>

#include "semiring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int64_t kTile = static_cast<int64_t>(kThreads) * kItems;

template <typename K>
__device__ __forceinline__ bool is_head(const K* __restrict__ key, int64_t i) {
  const K k = key[i];
  return k != cbt::key_sentinel<K>() && (i == 0 || key[i - 1] != k);
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
head_count_kernel(const K* __restrict__ key, int64_t n,
                  int64_t* __restrict__ counts) {
  __shared__ int warp_counts[kWarps];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  int c = 0;
  for (int r = 0; r < kItems; ++r) {
    const int64_t i = base + r * kThreads + threadIdx.x;
    if (i < n && is_head(key, i)) ++c;
  }
  for (int d = 16; d > 0; d >>= 1) c += __shfl_down_sync(0xffffffffu, c, d);
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int64_t total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_counts[w];
    counts[blockIdx.x] = total;
  }
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
emit_kernel(const K* __restrict__ key, const float* __restrict__ val,
            int64_t n, const int64_t* __restrict__ block_offs, int add_code,
            K* __restrict__ out_key, float* __restrict__ out_val,
            int64_t cap) {
  __shared__ int warp_counts[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  int64_t running = block_offs[blockIdx.x];
  for (int r = 0; r < kItems; ++r) {
    if (running >= cap) break;  // uniform across the block
    const int64_t i = base + r * kThreads + threadIdx.x;
    const bool h = i < n && is_head(key, i);
    const unsigned ballot = __ballot_sync(0xffffffffu, h);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int x = warp_counts[w];
      total += x;
      if (w < warp) before += x;
    }
    __syncthreads();
    if (h) {
      const int64_t pos =
          running + before + __popc(ballot & ((1u << lane) - 1u));
      if (pos < cap) {
        const K k = key[i];
        float acc = val[i];
        for (int64_t j = i + 1; j < n && key[j] == k; ++j)
          acc = cbt::sr_add(add_code, acc, val[j]);
        out_key[pos] = k;
        out_val[pos] = acc;
      }
    }
    running += total;
  }
}

inline unsigned num_blocks(int64_t n) {
  return static_cast<unsigned>((n + kTile - 1) / kTile);
}

template <typename K>
int count(const void* key, int64_t n, void* counts, void* stream) {
  head_count_kernel<K><<<num_blocks(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const K*>(key), n, static_cast<int64_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int emit(const void* key, const void* val, int64_t n, const void* block_offs,
         int32_t add_code, void* out_key, void* out_val, int64_t cap,
         void* stream) {
  emit_kernel<K><<<num_blocks(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const K*>(key), static_cast<const float*>(val), n,
      static_cast<const int64_t*>(block_offs), add_code,
      static_cast<K*>(out_key), static_cast<float*>(out_val), cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int64_t cbt_compress_tile() { return kTile; }

extern "C" int cbt_compress_count_i32(const void* key, int64_t n,
                                      void* counts, void* stream) {
  return count<int32_t>(key, n, counts, stream);
}

extern "C" int cbt_compress_count_i64(const void* key, int64_t n,
                                      void* counts, void* stream) {
  return count<int64_t>(key, n, counts, stream);
}

extern "C" int cbt_compress_emit_i32(const void* key, const void* val,
                                     int64_t n, const void* block_offs,
                                     int32_t add_code, void* out_key,
                                     void* out_val, int64_t cap,
                                     void* stream) {
  return emit<int32_t>(key, val, n, block_offs, add_code, out_key, out_val,
                       cap, stream);
}

extern "C" int cbt_compress_emit_i64(const void* key, const void* val,
                                     int64_t n, const void* block_offs,
                                     int32_t add_code, void* out_key,
                                     void* out_val, int64_t cap,
                                     void* stream) {
  return emit<int64_t>(key, val, n, block_offs, add_code, out_key, out_val,
                       cap, stream);
}
