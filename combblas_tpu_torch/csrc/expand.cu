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
// (8 B) and every slot of the stream, pads included, is written once with a
// key and a value (8 B, or 12 B with int64 keys), for a single multiply: far
// below the card's flop/byte balance point.  A's entries and B's row
// pointer are read once.  The B rows are read in A-entry order, so each
// entry's row is a random gather of ~8 (col, val) pairs; whole 32-byte
// sectors are fetched for it, more bytes than the bound counts.
//
// K1/K3, product-slot driven.  The first design gave each A entry one warp,
// which idled 24 of 32 lanes on degree-8 B rows, spent a warp trip on every
// dead entry or empty B row, and hung each warp on the load chain
// offs -> a_col -> b_rp -> b_col; the wrapper also prefilled the whole
// stream, so every slot was written twice.  Now:
//   (a) count_kernel writes each entry's product count and B row start in
//       A-entry order (the wrapper scans the counts into write offsets), so
//       no later kernel gathers b_rp behind a_col;
//   (b) the grid covers the merged sequence of the entries' end offsets
//       offs[1..n_a] and the slots 0..cap-1 (merge path) in tiles of kTile
//       items; split_kernel finds where each tile's diagonal crosses the two
//       lists (one binary search over offs per tile), so a tile holds at
//       most kTile entries and kTile slots however many dead entries or
//       empty rows lie between live ones;
//   (c) expand_kernel stages its entries' end offsets, B row starts, rows
//       and values in shared memory, then each thread takes kSlots
//       consecutive slots, finds their entries by binary searches in shared
//       memory, issues all its b_col / b_val loads at once (consecutive
//       addresses within an entry) and writes keys and values with 16-byte
//       stores where the slots are the tile's own.
// Slots at or past the product count hold the key sentinel and 0 from the
// same kernel, so the wrapper allocates the stream with torch.empty.  Each
// value is still one sr_mul, bit for bit the plain version's.
//
// K5, chunk-padded (expand_chunks_kernel, the first design kept): one warp
// per A entry walks its B row with the 32 lanes; `offs` scans the chunk
// counts ceil(cnt/128) and entry e writes from 128*offs[e].  Slots no
// product reaches keep the wrapper's sentinel / 0 fill; writes past `cap`
// are dropped.
#include <cuda_runtime.h>

#include <cstdint>

#include "semiring.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int64_t kTile = 1024;  // merge items (entries + slots) per tile
constexpr int kSlots = 8;        // consecutive slots per thread
// K5 (expand_chunks_kernel), unchanged: a warp per A entry
constexpr int kChunkThreads = 256;
constexpr int kWarpsPerBlock = kChunkThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 64;
constexpr int64_t kChunk = 128;  // slots per chunk of K5's stream

// Merge-path split at `diag` of the entries' end offsets a[i] = offs[i+1]
// (i < n_a) against the slot ids b[j] = j (j < cap): the number of entries
// consumed first.  Slot j comes before the end of entry i iff j < offs[i+1].
__device__ __forceinline__ int64_t merge_split(const int64_t* __restrict__ offs,
                                               int64_t n_a, int64_t cap,
                                               int64_t diag) {
  int64_t lo = diag > cap ? diag - cap : 0;
  int64_t hi = diag < n_a ? diag : n_a;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (offs[mid + 1] <= diag - mid - 1) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
split_kernel(const int64_t* __restrict__ offs, int64_t n_a, int64_t cap,
             int64_t tiles, int64_t* __restrict__ splits) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t > tiles) return;
  const int64_t total = n_a + cap;
  const int64_t diag = t * kTile < total ? t * kTile : total;
  splits[t] = merge_split(offs, n_a, cap, diag);
}

// First staged entry i in [lo, ne) whose (tile-relative) end exceeds r, or
// ne if none.
__device__ __forceinline__ int find_entry(const int* __restrict__ rel_end,
                                          int lo, int ne, int r) {
  int hi = ne;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rel_end[mid] > r) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

template <typename K>
__device__ __forceinline__ void store_keys(K* p, const K (&k)[kSlots]);

template <>
__device__ __forceinline__ void store_keys<int32_t>(
    int32_t* p, const int32_t (&k)[kSlots]) {
  #pragma unroll
  for (int u = 0; u < kSlots; u += 4) {
    *reinterpret_cast<int4*>(p + u) = make_int4(k[u], k[u + 1], k[u + 2],
                                                k[u + 3]);
  }
}

template <>
__device__ __forceinline__ void store_keys<int64_t>(
    int64_t* p, const int64_t (&k)[kSlots]) {
  #pragma unroll
  for (int u = 0; u < kSlots; u += 2) {
    *reinterpret_cast<longlong2*>(p + u) = make_longlong2(k[u], k[u + 1]);
  }
}

// offs[0] = 0 and offs[e + 1] = the products of A entry e (0 if dead); the
// wrapper's inclusive scan of offs[1:] then makes offs the write offsets.
// bstart[e] = the start of entry e's B row, so that expand_kernel reads it
// in A-entry order instead of gathering b_rp[a_col[e]] behind a_col.
__global__ void __launch_bounds__(kThreads)
count_kernel(const int32_t* __restrict__ a_col,
             const bool* __restrict__ a_valid, int64_t n_a,
             const int64_t* __restrict__ b_rp, int64_t* __restrict__ offs,
             int64_t* __restrict__ bstart) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e == 0) offs[0] = 0;
  if (e >= n_a) return;
  int64_t c = 0, s = 0;
  if (a_valid[e]) {
    const int32_t k = a_col[e];
    s = b_rp[k];
    c = b_rp[k + 1] - s;
  }
  offs[e + 1] = c;
  bstart[e] = s;
}

template <typename K>
__global__ void __launch_bounds__(kThreads, 6)
expand_kernel(const int32_t* __restrict__ a_row,
              const float* __restrict__ a_val,
              const int64_t* __restrict__ offs, int64_t n_a,
              const int64_t* __restrict__ bstart,
              const int32_t* __restrict__ b_col,
              const float* __restrict__ b_val, int64_t stride, int mul_code,
              const int64_t* __restrict__ splits, K* __restrict__ out_key,
              float* __restrict__ out_val, int64_t cap) {
  // a tile holds at most kTile + 1 entries: the kTile whose ends it
  // consumes and the one its last slots belong to
  __shared__ int rel_end[kTile + 1];    // min(end, y1) - y0
  __shared__ int64_t delta[kTile + 1];  // B index of slot j: j + delta
  __shared__ int row[kTile + 1];
  __shared__ float aval[kTile + 1];

  const int64_t t = blockIdx.x;
  const int64_t total = n_a + cap;
  const int64_t d0 = t * kTile;
  const int64_t d1 = d0 + kTile < total ? d0 + kTile : total;
  const int64_t x0 = splits[t];
  const int64_t x1 = splits[t + 1];
  const int64_t y0 = d0 - x0;
  const int64_t y1 = d1 - x1;
  const int64_t last = x1 < n_a - 1 ? x1 : n_a - 1;
  const int ne = static_cast<int>(last - x0 + 1 > 0 ? last - x0 + 1 : 0);

  for (int i = threadIdx.x; i < ne; i += kThreads) {
    const int64_t e = x0 + i;
    const int64_t lo = offs[e];
    const int64_t hi = offs[e + 1];
    rel_end[i] = static_cast<int>((hi < y1 ? hi : y1) - y0);
    if (hi > lo) {  // dead entries and empty B rows own no slot
      delta[i] = bstart[e] - lo;
      row[i] = a_row[e];
      aval[i] = a_val[e];
    }
  }
  __syncthreads();

  if (y1 <= y0) return;
  const K sent = cbt::key_sentinel<K>();
  const K kstride = static_cast<K>(stride);
  const int64_t g_lo = y0 / kSlots;
  const int64_t g_hi = (y1 - 1) / kSlots;  // inclusive
  for (int64_t g = g_lo + threadIdx.x; g <= g_hi; g += kThreads) {
    const int64_t j0 = g * kSlots;
    // every slot's entry first (shared memory only), then all the B loads
    // together, so a thread has 2 * kSlots loads in flight
    int ent[kSlots];
    int64_t bi[kSlots];
    bool ok[kSlots];
    int e = -1;
    #pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const int64_t j = j0 + u;
      ok[u] = false;
      ent[u] = 0;
      bi[u] = 0;
      if (j < y0 || j >= y1) continue;
      const int r = static_cast<int>(j - y0);
      if (e < 0 || e >= ne || rel_end[e] <= r) {
        e = find_entry(rel_end, e < 0 ? 0 : e, ne, r);
      }
      if (e < ne) {
        ok[u] = true;
        ent[u] = e;
        bi[u] = j + delta[e];
      }
    }
    int32_t bc[kSlots];
    float bv[kSlots];
    #pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      bc[u] = ok[u] ? __ldg(b_col + bi[u]) : 0;
      bv[u] = ok[u] ? __ldg(b_val + bi[u]) : 0.0f;
    }
    K keys[kSlots];
    float vals[kSlots];
    #pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      keys[u] = ok[u] ? static_cast<K>(row[ent[u]]) * kstride +
                            static_cast<K>(bc[u])
                      : sent;
      vals[u] = ok[u] ? cbt::sr_mul(mul_code, aval[ent[u]], bv[u]) : 0.0f;
    }
    if (j0 >= y0 && j0 + kSlots <= y1) {
      store_keys<K>(out_key + j0, keys);
      #pragma unroll
      for (int u = 0; u < kSlots; u += 4) {
        *reinterpret_cast<float4*>(out_val + j0 + u) =
            make_float4(vals[u], vals[u + 1], vals[u + 2], vals[u + 3]);
      }
    } else {
      #pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        const int64_t j = j0 + u;
        if (j >= y0 && j < y1) {
          out_key[j] = keys[u];
          out_val[j] = vals[u];
        }
      }
    }
  }
}

template <typename K>
int launch(const void* a_row, const void* a_val, const void* offs,
           int64_t n_a, const void* bstart, const void* b_col,
           const void* b_val, int64_t stride, int32_t mul_code, void* splits,
           void* out_key, void* out_val, int64_t cap, void* stream) {
  if (reinterpret_cast<uintptr_t>(out_key) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out_val) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (n_a + cap + kTile - 1) / kTile;
  const int64_t split_blocks = (tiles + 1 + kThreads - 1) / kThreads;
  split_kernel<<<static_cast<unsigned>(split_blocks), kThreads, 0, s>>>(
      static_cast<const int64_t*>(offs), n_a, cap, tiles,
      static_cast<int64_t*>(splits));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  expand_kernel<K><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      static_cast<const int32_t*>(a_row), static_cast<const float*>(a_val),
      static_cast<const int64_t*>(offs), n_a,
      static_cast<const int64_t*>(bstart), static_cast<const int32_t*>(b_col),
      static_cast<const float*>(b_val), stride, mul_code,
      static_cast<const int64_t*>(splits), static_cast<K*>(out_key),
      static_cast<float*>(out_val), cap);
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(kChunkThreads)
expand_chunks_kernel(const int32_t* __restrict__ a_row,
                     const int32_t* __restrict__ a_col,
                     const float* __restrict__ a_val,
                     const int64_t* __restrict__ ch_offs, int64_t n_a,
                     const int64_t* __restrict__ b_rp,
                     const int32_t* __restrict__ b_col,
                     const float* __restrict__ b_val, int64_t stride,
                     int mul_code, int32_t* __restrict__ out_key,
                     float* __restrict__ out_val, int64_t cap) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t e = warp; e < n_a; e += nwarps) {
    if (ch_offs[e + 1] == ch_offs[e]) continue;  // dead entry or empty B row
    const int64_t bs = b_rp[a_col[e]];
    const int64_t o0 = ch_offs[e] * kChunk;
    const int64_t len = b_rp[a_col[e] + 1] - bs;
    const int32_t base = a_row[e] * static_cast<int32_t>(stride);
    const float av = a_val[e];
    for (int64_t j = lane; j < len; j += 32) {
      const int64_t p = o0 + j;
      if (p >= cap) break;
      out_key[p] = base + b_col[bs + j];
      out_val[p] = cbt::sr_mul(mul_code, av, b_val[bs + j]);
    }
  }
}

}  // namespace

extern "C" int64_t cbt_expand_tile() { return kTile; }

extern "C" int cbt_expand_counts(const void* a_col, const void* a_valid,
                                 int64_t n_a, const void* b_rp, void* offs,
                                 void* bstart, void* stream) {
  const int64_t blocks = n_a / kThreads + 1;  // offs[0] even when n_a = 0
  count_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a_col), static_cast<const bool*>(a_valid),
      n_a, static_cast<const int64_t*>(b_rp), static_cast<int64_t*>(offs),
      static_cast<int64_t*>(bstart));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cbt_expand_i32(const void* a_row, const void* a_val,
                              const void* offs, int64_t n_a,
                              const void* bstart, const void* b_col,
                              const void* b_val, int64_t stride,
                              int32_t mul_code, void* splits, void* out_key,
                              void* out_val, int64_t cap, void* stream) {
  return launch<int32_t>(a_row, a_val, offs, n_a, bstart, b_col, b_val, stride,
                         mul_code, splits, out_key, out_val, cap, stream);
}

extern "C" int cbt_expand_i64(const void* a_row, const void* a_val,
                              const void* offs, int64_t n_a,
                              const void* bstart, const void* b_col,
                              const void* b_val, int64_t stride,
                              int32_t mul_code, void* splits, void* out_key,
                              void* out_val, int64_t cap, void* stream) {
  return launch<int64_t>(a_row, a_val, offs, n_a, bstart, b_col, b_val, stride,
                         mul_code, splits, out_key, out_val, cap, stream);
}

extern "C" int cbt_expand_chunks_i32(const void* a_row, const void* a_col,
                                     const void* a_val, const void* ch_offs,
                                     int64_t n_a, const void* b_rp,
                                     const void* b_col, const void* b_val,
                                     int64_t stride, int32_t mul_code,
                                     void* out_key, void* out_val,
                                     int64_t cap, void* stream) {
  int64_t blocks = (n_a + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  expand_chunks_kernel<<<static_cast<unsigned>(blocks), kChunkThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a_row), static_cast<const int32_t*>(a_col),
      static_cast<const float*>(a_val), static_cast<const int64_t*>(ch_offs),
      n_a, static_cast<const int64_t*>(b_rp),
      static_cast<const int32_t*>(b_col), static_cast<const float*>(b_val),
      stride, mul_code, static_cast<int32_t*>(out_key),
      static_cast<float*>(out_val), cap);
  return static_cast<int>(cudaGetLastError());
}
