// Compress a key-sorted stream: fold each run of equal keys with the
// semiring add (in f32), drop sentinel keys wherever they stand, compact to
// (key, val) and count the survivors.
//
// Replaces: combblas_tpu/ops/pallas/compress_kernel.py
// compress_sorted_packed_pallas (_compress_kernel, K2: int32 keys) and
// compress_sorted_wide_pallas (_compress_wide_kernel, K4: the (row, col)
// pair, here one int64 key row*(n+1)+col).
//
// Bound on the H100: bytes.  One read of every (key, val) pair and one
// write of every output slot, survivors and pads, with one add per element.
//
// The first design ran two kernels around a torch.cumsum: one read the keys
// to count each tile's run heads, the other read keys and values again and
// let the thread at each run head walk its run alone (uncoalesced and
// divergent: one long run held its warp), in 8 rounds a tile with two
// barriers each; the wrapper prefilled every output slot and summed the
// counts.  Now one pass (compress_kernel), after the TPU kernel's
// segmented-scan fold (compress_kernel.py:104-119):
//   (a) each block takes the next tile id from an atomic counter (so every
//       tile it may wait on is already running), loads its kTile keys and
//       values with 16-byte loads into shared memory, and each thread takes
//       kItems consecutive items;
//   (b) each thread flags its run heads (a key differing from its left
//       neighbour) and folds its items' runs in registers, left to right; a
//       block-wide segmented scan (warp shuffles, then the warps' aggregates
//       in shared memory) gives every thread the fold of the run open at its
//       first item and the number of real (non-sentinel) heads before it;
//   (c) a run is written by the thread that meets the next head, at its
//       head's rank, into shared memory; the tile's last run, which may go
//       on past the tile edge, belongs to the tile that holds its head: one
//       warp folds its continuation in order (a run of many tiles is thus
//       read by one warp); a tile skips the items before its first head;
//   (d) the tile's write offset comes from a decoupled look-back over one
//       64-bit status word per tile (flag in the top two bits, the count
//       below: aggregate or inclusive prefix); the staged survivors are then
//       written coalesced, those past `cap` counted but dropped;
//   (e) the last tile stores nnz = min(count, cap) on the device, and
//       pad_kernel, a second launch, fills [nnz, cap) with the sentinel and
//       0 (16-byte stores) without a host sync, so the wrapper allocates
//       with torch.empty.
// The fold order is fixed and no value goes through an atomic, so results
// are bit-identical from run to run; min and max are exact.
#include <cuda_runtime.h>

#include <cstdint>

#include "semiring.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;

constexpr unsigned long long kFlagAggregate = 1ull << 62;
constexpr unsigned long long kFlagPrefix = 2ull << 62;
constexpr unsigned long long kValueMask = (1ull << 62) - 1;

// state[0]: tile counter; state[1]: nnz; state[2 + t]: tile t's status
constexpr int kStatusBase = 2;

// (flag, value) of a segmented fold: `f` is whether a run head lies in the
// span; `v` is the fold from the span's last head (or its start) to its end.
struct Seg {
  bool f;
  float v;
};

// the span `a` followed by the span `b`
__device__ __forceinline__ Seg seg_join(int add_code, Seg a, Seg b) {
  return Seg{a.f || b.f, b.f ? b.v : cbt::sr_add(add_code, a.v, b.v)};
}

template <typename K>
__device__ __forceinline__ void load_vec(K* dst, const K* src, int units);

template <>
__device__ __forceinline__ void load_vec<int32_t>(int32_t* dst,
                                                  const int32_t* src,
                                                  int units) {
  for (int u = 0; u < units; u += 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(src + u));
    dst[u] = q.x;
    dst[u + 1] = q.y;
    dst[u + 2] = q.z;
    dst[u + 3] = q.w;
  }
}

template <>
__device__ __forceinline__ void load_vec<int64_t>(int64_t* dst,
                                                  const int64_t* src,
                                                  int units) {
  for (int u = 0; u < units; u += 2) {
    const longlong2 q = __ldg(reinterpret_cast<const longlong2*>(src + u));
    dst[u] = q.x;
    dst[u + 1] = q.y;
  }
}

template <typename K>
__device__ __forceinline__ void store4(K* p, const K (&k)[4]);

template <>
__device__ __forceinline__ void store4<int32_t>(int32_t* p,
                                                const int32_t (&k)[4]) {
  *reinterpret_cast<int4*>(p) = make_int4(k[0], k[1], k[2], k[3]);
}

template <>
__device__ __forceinline__ void store4<int64_t>(int64_t* p,
                                                const int64_t (&k)[4]) {
  reinterpret_cast<longlong2*>(p)[0] = make_longlong2(k[0], k[1]);
  reinterpret_cast<longlong2*>(p)[1] = make_longlong2(k[2], k[3]);
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
compress_kernel(const K* __restrict__ key, const float* __restrict__ val,
                int64_t n, int add_code, K* __restrict__ out_key,
                float* __restrict__ out_val, int64_t cap, int64_t tiles,
                unsigned long long* __restrict__ state, int vec) {
  __shared__ __align__(16) K skey[kTile];
  __shared__ __align__(16) float sval[kTile];
  __shared__ int warp_cnt[kWarps];
  __shared__ Seg warp_seg[kWarps];
  __shared__ int64_t s_tile;
  __shared__ int64_t s_offset;
  __shared__ K s_last_key;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const K sent = cbt::key_sentinel<K>();
  if (threadIdx.x == 0) {
    s_tile = static_cast<int64_t>(atomicAdd(state, 1ull));
  }
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t b = tile * kTile;
  const int64_t len = n - b < kTile ? n - b : kTile;

  // (a) load, 16 bytes a thread where the tile is whole and aligned; items
  // past n read as the sentinel, which ends the stream's last run
  if (vec && len == kTile) {
    constexpr int kKeyUnits = kTile * static_cast<int>(sizeof(K)) / 16;
    for (int u = threadIdx.x; u < kKeyUnits; u += kThreads) {
      reinterpret_cast<int4*>(skey)[u] =
          __ldg(reinterpret_cast<const int4*>(key + b) + u);
    }
    for (int u = threadIdx.x; u < kTile / 4; u += kThreads) {
      reinterpret_cast<float4*>(sval)[u] =
          __ldg(reinterpret_cast<const float4*>(val + b) + u);
    }
  } else {
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      skey[i] = i < len ? key[b + i] : sent;
      sval[i] = i < len ? val[b + i] : 0.0f;
    }
  }
  // the left neighbour of the tile; item 0 of the stream is a head unless it
  // is the sentinel
  const K prev_tile = b > 0 ? key[b - 1] : sent;
  __syncthreads();

  K k[kItems];
  float v[kItems];
  const int i0 = threadIdx.x * kItems;
  #pragma unroll
  for (int i = 0; i < kItems; ++i) {
    k[i] = skey[i0 + i];
    v[i] = sval[i0 + i];
  }
  const K prev0 = threadIdx.x > 0 ? skey[i0 - 1] : prev_tile;
  if (threadIdx.x == kThreads - 1) s_last_key = k[kItems - 1];

  // (b) heads, the thread's count of real heads and its fold
  unsigned heads = 0;
  int cnt = 0;
  Seg agg{false, 0.0f};
  #pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool h = k[i] != (i > 0 ? k[i - 1] : prev0);
    if (h) {
      heads |= 1u << i;
      if (k[i] != sent) ++cnt;
      agg = Seg{true, v[i]};
    } else {
      agg.v = i > 0 ? cbt::sr_add(add_code, agg.v, v[i]) : v[i];
    }
  }
  // warp inclusive scan of (cnt, seg)
  int c_inc = cnt;
  Seg s_inc = agg;
  #pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int c_up = __shfl_up_sync(0xffffffffu, c_inc, d);
    const bool f_up = __shfl_up_sync(0xffffffffu, s_inc.f, d);
    const float v_up = __shfl_up_sync(0xffffffffu, s_inc.v, d);
    if (lane >= d) {
      c_inc += c_up;
      s_inc = seg_join(add_code, Seg{f_up, v_up}, s_inc);
    }
  }
  if (lane == 31) {
    warp_cnt[warp] = c_inc;
    warp_seg[warp] = s_inc;
  }
  __syncthreads();  // every item is in registers from here on
  int c_ex = 0;
  Seg s_ex{false, 0.0f};
  bool have_ex = false;
  int tile_cnt = 0;
  Seg tile_seg{false, 0.0f};
  #pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const Seg ws = warp_seg[w];
    if (w < warp) {
      c_ex += warp_cnt[w];
      s_ex = have_ex ? seg_join(add_code, s_ex, ws) : ws;
      have_ex = true;
    }
    tile_cnt += warp_cnt[w];
    tile_seg = w > 0 ? seg_join(add_code, tile_seg, ws) : ws;
  }
  {
    const int c_up = __shfl_up_sync(0xffffffffu, c_inc, 1);
    const bool f_up = __shfl_up_sync(0xffffffffu, s_inc.f, 1);
    const float v_up = __shfl_up_sync(0xffffffffu, s_inc.v, 1);
    if (lane > 0) {
      c_ex += c_up;
      s_ex = have_ex ? seg_join(add_code, s_ex, Seg{f_up, v_up})
                     : Seg{f_up, v_up};
      have_ex = true;
    }
  }

  // (c) runs closed inside the tile, staged at their rank (skey / sval are
  // free: every item is in registers)
  {
    bool open = have_ex && s_ex.f;  // a run with its head in this tile
    bool open_real = open && prev0 != sent;
    float acc = s_ex.v;
    int r = c_ex;  // real heads before the current item
    #pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (heads & (1u << i)) {
        if (open_real) {
          skey[r - 1] = i > 0 ? k[i - 1] : prev0;
          sval[r - 1] = acc;
        }
        open = true;
        open_real = k[i] != sent;
        acc = v[i];
        if (open_real) ++r;
      } else if (open) {
        acc = cbt::sr_add(add_code, acc, v[i]);
      }
    }
  }
  const K last_key = s_last_key;
  const bool last_real = tile_seg.f && last_key != sent;

  // (d) the tile's offset: decoupled look-back by warp 0
  if (warp == 0) {
    unsigned long long* status = state + kStatusBase;
    int64_t excl = 0;
    if (tile == 0) {
      if (lane == 0) {
        atomicExch(status, kFlagPrefix | static_cast<unsigned long long>(
                                              tile_cnt));
      }
    } else {
      if (lane == 0) {
        atomicExch(status + tile, kFlagAggregate |
                                      static_cast<unsigned long long>(
                                          tile_cnt));
      }
      int64_t pred = tile - 1;
      while (true) {
        const int64_t idx = pred - lane;
        unsigned long long s = kFlagPrefix;  // before tile 0: a prefix of 0
        if (idx >= 0) {
          s = *reinterpret_cast<volatile unsigned long long*>(status + idx);
        }
        if (__any_sync(0xffffffffu, (s >> 62) == 0)) {
          __nanosleep(32);
          continue;
        }
        const unsigned pmask = __ballot_sync(0xffffffffu, (s >> 62) == 2);
        const int first_p = pmask ? __ffs(pmask) - 1 : 32;
        int64_t part = lane <= first_p ? static_cast<int64_t>(s & kValueMask)
                                       : 0;
        #pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
          part += __shfl_down_sync(0xffffffffu, part, d);
        }
        excl += __shfl_sync(0xffffffffu, part, 0);
        if (pmask) break;
        pred -= 32;
      }
      if (lane == 0) {
        atomicExch(status + tile, kFlagPrefix |
                                      static_cast<unsigned long long>(
                                          excl + tile_cnt));
      }
    }
    if (lane == 0) {
      s_offset = excl;
      if (tile == tiles - 1) {
        const int64_t nnz = excl + tile_cnt;
        state[1] = static_cast<unsigned long long>(nnz < cap ? nnz : cap);
      }
    }
  } else if (warp == kWarps - 1 && last_real) {
    // the tile's last run goes on past the tile edge while the key holds:
    // 8 consecutive items a lane, 256 a step, folded in order
    float acc = tile_seg.v;
    int64_t j = b + kTile;
    bool done = j >= n || key[j] != last_key;  // most runs end at the edge
    while (!done) {
      const int64_t base = j + lane * kItems;
      K kk[kItems];
      float vv[kItems];
      if (vec && base + kItems <= n) {
        load_vec<K>(kk, key + base, kItems);
        const float4 a = __ldg(reinterpret_cast<const float4*>(val + base));
        const float4 c = __ldg(reinterpret_cast<const float4*>(val + base) +
                               1);
        vv[0] = a.x; vv[1] = a.y; vv[2] = a.z; vv[3] = a.w;
        vv[4] = c.x; vv[5] = c.y; vv[6] = c.z; vv[7] = c.w;
      } else {
        #pragma unroll
        for (int u = 0; u < kItems; ++u) {
          const bool in = base + u < n;
          kk[u] = in ? key[base + u] : sent;
          vv[u] = in ? val[base + u] : 0.0f;
        }
      }
      int stop = kItems;
      #pragma unroll
      for (int u = kItems - 1; u >= 0; --u) {
        if (base + u >= n || kk[u] != last_key) stop = u;
      }
      float part = vv[0];
      #pragma unroll
      for (int u = 1; u < kItems; ++u) {
        if (u < stop) part = cbt::sr_add(add_code, part, vv[u]);
      }
      const unsigned ends = __ballot_sync(0xffffffffu, stop < kItems);
      const int first = ends ? __ffs(ends) - 1 : 32;
      bool has = lane < first || (lane == first && stop > 0);
      #pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const bool h2 = __shfl_xor_sync(0xffffffffu, has, d);
        const float p2 = __shfl_xor_sync(0xffffffffu, part, d);
        if (h2) {
          // the lower lane's partial first, so every lane folds alike
          part = has ? ((lane & d) ? cbt::sr_add(add_code, p2, part)
                                   : cbt::sr_add(add_code, part, p2))
                     : p2;
          has = true;
        }
      }
      if (has) acc = cbt::sr_add(add_code, acc, part);
      done = ends != 0;
      j += kThreads / kWarps * kItems;
    }
    if (lane == 0) {
      skey[tile_cnt - 1] = last_key;
      sval[tile_cnt - 1] = acc;
    }
  }
  __syncthreads();

  // the staged survivors, coalesced; past cap they are dropped
  const int64_t off = s_offset;
  for (int r = threadIdx.x; r < tile_cnt; r += kThreads) {
    const int64_t pos = off + r;
    if (pos < cap) {
      out_key[pos] = skey[r];
      out_val[pos] = sval[r];
    }
  }
}

// Slots [nnz, cap) get the sentinel and 0; nnz is read on the device.
// Whole groups of 4 aligned slots take 16-byte stores, the ragged ends
// single ones.
template <typename K>
__global__ void __launch_bounds__(kThreads)
pad_kernel(const unsigned long long* __restrict__ state,
           K* __restrict__ out_key, float* __restrict__ out_val, int64_t cap) {
  const int64_t nnz = static_cast<int64_t>(state[1]);
  const K sent = cbt::key_sentinel<K>();
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t q_lo = (nnz + 3) / 4;  // first whole group
  const int64_t q_hi = cap / 4;        // past the last whole group
  if (q_lo >= q_hi) {
    for (int64_t p = nnz + tid; p < cap; p += step) {
      out_key[p] = sent;
      out_val[p] = 0.0f;
    }
    return;
  }
  if (tid < 4 * q_lo - nnz) {
    out_key[nnz + tid] = sent;
    out_val[nnz + tid] = 0.0f;
  }
  if (tid < cap - 4 * q_hi) {
    out_key[4 * q_hi + tid] = sent;
    out_val[4 * q_hi + tid] = 0.0f;
  }
  const K ks[4] = {sent, sent, sent, sent};
  for (int64_t q = q_lo + tid; q < q_hi; q += step) {
    store4<K>(out_key + 4 * q, ks);
    *reinterpret_cast<float4*>(out_val + 4 * q) =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

template <typename K>
int run(const void* key, const void* val, int64_t n, int32_t add_code,
        void* out_key, void* out_val, int64_t cap, void* state,
        void* stream) {
  if (reinterpret_cast<uintptr_t>(out_key) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out_val) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int vec = reinterpret_cast<uintptr_t>(key) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(val) % 16 == 0;
  compress_kernel<K><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      static_cast<const K*>(key), static_cast<const float*>(val), n, add_code,
      static_cast<K*>(out_key), static_cast<float*>(out_val), cap, tiles,
      static_cast<unsigned long long*>(state), vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t blocks = (cap / 4 + kThreads - 1) / kThreads + 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  pad_kernel<K><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const unsigned long long*>(state), static_cast<K*>(out_key),
      static_cast<float*>(out_val), cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int64_t cbt_compress_tile() { return kTile; }

extern "C" int cbt_compress_i32(const void* key, const void* val, int64_t n,
                                int32_t add_code, void* out_key,
                                void* out_val, int64_t cap, void* state,
                                void* stream) {
  return run<int32_t>(key, val, n, add_code, out_key, out_val, cap, state,
                      stream);
}

extern "C" int cbt_compress_i64(const void* key, const void* val, int64_t n,
                                int32_t add_code, void* out_key,
                                void* out_val, int64_t cap, void* state,
                                void* stream) {
  return run<int64_t>(key, val, n, add_code, out_key, out_val, cap, state,
                      stream);
}
