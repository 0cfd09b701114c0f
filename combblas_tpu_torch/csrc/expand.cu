// ESC expansion: every product a_ik (x) b_kj of A's live entries with B's
// rows, in A-entry order, compacted or chunk-padded.
//
// Replaces: combblas_tpu/ops/pallas/expand_kernel.py expand_chunks_compact
// (_expand_compact_kernel, K1: int32 keys, stride 0 on seg2's windowed
// slabs), expand_chunks_compact_wide (_expand_compact_wide_kernel, K3: row
// and column as two int32 streams) and expand_chunks (_expand_kernel, K5:
// the chunk-padded stream).  K3 is the int64 instance here: the pair
// (row, col) orders exactly as row*(n+1)+col, so one int64 key stream
// replaces the two int32 streams.
//
// Bound on the H100: bytes.  Each product reads one B (col, val) pair
// (8 B) and writes one key and one value (8 B, or 12 B with int64 keys) for a
// single multiply: far below the card's flop/byte balance point.  K5 also
// writes every pad slot of its chunks (the wrapper's sentinel fill).
//
// Design: the TPU kernels cut the work into 128-lane chunks fed by DMAs and a
// chunk table (build_chunk_meta) and compacted through a VMEM staging buffer.
// Here the wrapper's exclusive scan of per-entry counts gives every A entry
// its write offset directly, so there is no chunk table and no staging: one
// warp per A entry (grid-stride over entries) walks its B row with the 32
// lanes on consecutive B entries, so both the B reads and the writes are
// coalesced.  Compacted (kChunked false): `offs` scans the product counts and
// entry e writes from offs[e].  Chunk-padded (kChunked true, K5): `offs`
// scans the chunk counts ceil(cnt/128) and entry e writes from 128*offs[e],
// its product count read from B's row pointer.  Slots no product reaches
// keep the wrapper's sentinel / 0 fill; writes past `cap` are dropped.
#include <cuda_runtime.h>

#include <cstdint>

#include "semiring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 64;
constexpr int64_t kChunk = 128;  // slots per chunk of K5's stream

template <typename K, bool kChunked>
__global__ void __launch_bounds__(kThreads)
expand_kernel(const int32_t* __restrict__ a_row,
              const int32_t* __restrict__ a_col,
              const float* __restrict__ a_val,
              const int64_t* __restrict__ offs, int64_t n_a,
              const int64_t* __restrict__ b_rp,
              const int32_t* __restrict__ b_col,
              const float* __restrict__ b_val, int64_t stride, int mul_code,
              K* __restrict__ out_key, float* __restrict__ out_val,
              int64_t cap) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t e = warp; e < n_a; e += nwarps) {
    if (offs[e + 1] == offs[e]) continue;  // dead entry or empty B row
    const int64_t bs = b_rp[a_col[e]];
    const int64_t o0 = kChunked ? offs[e] * kChunk : offs[e];
    const int64_t len = kChunked ? b_rp[a_col[e] + 1] - bs
                                 : offs[e + 1] - offs[e];
    const K base = static_cast<K>(a_row[e]) * static_cast<K>(stride);
    const float av = a_val[e];
    for (int64_t j = lane; j < len; j += 32) {
      const int64_t p = o0 + j;
      if (p >= cap) break;
      out_key[p] = base + static_cast<K>(b_col[bs + j]);
      out_val[p] = cbt::sr_mul(mul_code, av, b_val[bs + j]);
    }
  }
}

template <typename K, bool kChunked>
int launch(const void* a_row, const void* a_col, const void* a_val,
           const void* offs, int64_t n_a, const void* b_rp, const void* b_col,
           const void* b_val, int64_t stride, int32_t mul_code, void* out_key,
           void* out_val, int64_t cap, void* stream) {
  int64_t blocks = (n_a + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  expand_kernel<K, kChunked><<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a_row), static_cast<const int32_t*>(a_col),
      static_cast<const float*>(a_val), static_cast<const int64_t*>(offs), n_a,
      static_cast<const int64_t*>(b_rp), static_cast<const int32_t*>(b_col),
      static_cast<const float*>(b_val), stride, mul_code,
      static_cast<K*>(out_key), static_cast<float*>(out_val), cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cbt_expand_i32(const void* a_row, const void* a_col,
                              const void* a_val, const void* offs, int64_t n_a,
                              const void* b_rp, const void* b_col,
                              const void* b_val, int64_t stride,
                              int32_t mul_code, void* out_key, void* out_val,
                              int64_t cap, void* stream) {
  return launch<int32_t, false>(a_row, a_col, a_val, offs, n_a, b_rp, b_col,
                                b_val, stride, mul_code, out_key, out_val, cap,
                                stream);
}

extern "C" int cbt_expand_i64(const void* a_row, const void* a_col,
                              const void* a_val, const void* offs, int64_t n_a,
                              const void* b_rp, const void* b_col,
                              const void* b_val, int64_t stride,
                              int32_t mul_code, void* out_key, void* out_val,
                              int64_t cap, void* stream) {
  return launch<int64_t, false>(a_row, a_col, a_val, offs, n_a, b_rp, b_col,
                                b_val, stride, mul_code, out_key, out_val, cap,
                                stream);
}

extern "C" int cbt_expand_chunks_i32(const void* a_row, const void* a_col,
                                     const void* a_val, const void* ch_offs,
                                     int64_t n_a, const void* b_rp,
                                     const void* b_col, const void* b_val,
                                     int64_t stride, int32_t mul_code,
                                     void* out_key, void* out_val,
                                     int64_t cap, void* stream) {
  return launch<int32_t, true>(a_row, a_col, a_val, ch_offs, n_a, b_rp, b_col,
                               b_val, stride, mul_code, out_key, out_val, cap,
                               stream);
}
