// Stable window sort of the row-classed digest (K10): each row's products,
// read from the expansion stream (K1, int32 column keys), sorted by key into
// its window of the class buffer, windows laid out class after class, each
// window's lanes past its products at the key sentinel and 0.
//
// Replaces no TPU kernel: combblas_tpu/ops/spgemm_seg.py:_seg_slab_digest_step
// leaves this to XLA (`_class_windows`' gathers, then one
// `jnp.sort(axis=1)` a class), as the port's plain version (the same
// function's `torch.sort(dim=1, stable=True)` and value gather) does.
//
// Bound on the H100: bytes.  The least a slab can move is one read of each
// live (key, value) pair and one write of each padded slot.  The library
// path moved ~150 B a padded slot: an int64 index, two `where`s, a segmented
// radix sort of all 32 key bits with an int64 permutation, a value gather;
// it gave each window one thread block, so a class of 41 windows of 4M ran
// on 41 of the 132 SMs.
//
// Design: the stream keeps each row's products together, so a window is a
// contiguous segment of it; the wrapper's window table gives each window
// its stream start, live length, offset in the class buffer and width, in
// class order (so one class width is one contiguous range of windows).
// Only the key bits B's columns need are sorted (`bits`), in ceil(bits/8)
// stable passes of at most 8 bits, low digit first; the payload is the
// 4-byte value itself.  Ranks inside a block come from warp-private digit
// counters in shared memory (counted with shared atomics, then offset by a
// scan over digits and warps) and, in the scatter, from the warp's lanes of
// equal digit (a ballot a digit bit), so items keep their stream order
// within a digit: the sort is stable.
//   - narrow windows (width <= kNarrowMax, whole in shared memory): one
//     block a window (narrow_kernel, three instances by width) loads the
//     live lanes once, runs every pass in shared memory and writes the whole
//     window once, sentinel tail included;
//   - wide windows: a tiled LSD radix sort over the whole card.  Each
//     window's live lanes are cut into kTile-item tiles, and every pass
//     spreads all wide tiles over all SMs, however few windows a class has:
//     hist_kernel counts each tile's digits into a table laid out window by
//     window, digit by digit, tile by tile; scan_kernel's one exclusive scan
//     of that table (decoupled look-back) gives every (tile, digit) its
//     stable offset in its window; scatter_kernel ranks the tile in shared
//     memory and writes each digit's run to its offset.  The first pass
//     reads the stream, the last writes the window's slot of the class
//     buffer; between them the passes ping-pong between the wrapper's
//     scratch and the wide windows' own lanes of the stream (the stream is
//     not needed after the sort).  tail_kernel writes the wide windows'
//     sentinel tails (and dead windows) in fixed chunks over all SMs.
// Every slot of the class buffer is written once, so the wrapper allocates
// it with torch.empty; nothing syncs with the host.
//
// Keyed by row (cbt_winsort_rows): the same sort for the kernel routes'
// compacted expansion streams (K1's packed int32 keys, K3's int64 keys,
// row * stride + column), which the port sorted with one library sort of
// the whole stream: 8-bit digit passes over all 64 key bits, each moving
// the key and an int64 permutation, then a value gather, ~5x the bytes the
// order needs.  Each row's products lie together in the stream, rows
// ascending, so a stable sort of each row's window by key - row * stride
// (the column, `bits` of it) is the whole stream's stable sort.  The
// wrapper finds the windows in the stream itself (a binary search for each
// row's first key, row * stride); they stay in place, one a row:
// row_part_kernel lists the rows of 2 to 16384 products by width range and
// the wider ones as a window table (warp-aggregated atomics, no host
// sync); row_narrow_kernel sorts each listed row in shared memory (one
// read and one write of its slots), its blocks taking a range's windows in
// turn, as many as fit the card at once; the wide rows take the tiled
// passes above, at least two, the first reading the stream's keys less the
// row's base and the last writing base + column back in place, the scratch
// between them 4-byte columns and values.  Rows of one product and the
// sentinel tail are not touched.  The launch shapes are bounds from the
// stream's and the table's sizes.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int32_t kSent = INT32_MAX;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBins = 256;
constexpr int kMaxDigitBits = 8;
constexpr int kNarrowMax = 16384;

// wide regime: tiles of kTile items, kWideWarps warps of kWideRounds items
// a lane
constexpr int kWideWarps = 32;
constexpr int kWideRounds = 16;
constexpr int kTile = kWideWarps * 32 * kWideRounds;
constexpr int kHistThreads = 256;
constexpr int kScanThreads = 256;
constexpr int kScanItems = 16;
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kTailThreads = 256;
constexpr int64_t kTailChunk = 16384;
constexpr int kPrepThreads = 1024;

constexpr unsigned long long kFlagAggregate = 1ull << 62;
constexpr unsigned long long kFlagPrefix = 2ull << 62;
constexpr unsigned long long kValueMask = (1ull << 62) - 1;

// passes = ceil(bits / 8); the first bits % passes of them one bit wider
__host__ __device__ inline int num_passes(int bits) {
  return (bits + kMaxDigitBits - 1) / kMaxDigitBits;
}

__host__ __device__ inline void pass_digit(int bits, int passes, int p,
                                           int* shift, int* nbits) {
  const int base = bits / passes;
  const int extra = bits % passes;
  *shift = p * base + (p < extra ? p : extra);
  *nbits = base + (p < extra ? 1 : 0);
}

__device__ __forceinline__ unsigned digit_of(int32_t key, int shift,
                                             unsigned mask) {
  return (static_cast<uint32_t>(key) >> shift) & mask;
}

// The live lanes of the warp whose digit equals this lane's: one ballot a
// digit bit (cheaper than __match_any_sync over up to 32 distinct values).
__device__ __forceinline__ unsigned match_digit(unsigned dig, int nbits,
                                                unsigned live) {
  unsigned peers = live;
  #pragma unroll
  for (int b = 0; b < kMaxDigitBits; ++b) {
    if (b < nbits) {
      const bool bit = (dig >> b) & 1u;
      const unsigned m = __ballot_sync(kFull, bit);
      peers &= bit ? m : ~m;
    }
  }
  return peers;
}

// The block's items: lane l of warp w holds in k[r] / v[r], r < rd, the item
// at position (w * rd + r) * 32 + l; positions at or past n are absent.
// Writes them to skey / sval [0, n) stably sorted by their digit, and leaves
// in tot[d] the first position of digit d.  cnt holds WARPS x kMaxBins
// counters.
template <int WARPS, int R>
__device__ __forceinline__ void rank_scatter(const int32_t (&k)[R],
                                             const uint32_t (&v)[R], int n,
                                             int rd, int shift, int nbits,
                                             int* cnt, int* tot,
                                             int32_t* skey, uint32_t* sval) {
  constexpr int kThreads = WARPS * 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nb = 1 << nbits;
  const unsigned mask = nb - 1;
  for (int i = threadIdx.x; i < WARPS * kMaxBins; i += kThreads) cnt[i] = 0;
  __syncthreads();
  int* wc = cnt + warp * kMaxBins;
  #pragma unroll
  for (int r = 0; r < R; ++r) {
    const int pos = (warp * rd + r) * 32 + lane;
    if (r < rd && pos < n) atomicAdd(&wc[digit_of(k[r], shift, mask)], 1);
  }
  __syncthreads();
  // per digit: the warps' exclusive prefixes and the digit's total
  for (int d = threadIdx.x; d < nb; d += kThreads) {
    int run = 0;
    #pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = cnt[w * kMaxBins + d];
      cnt[w * kMaxBins + d] = run;
      run += c;
    }
    tot[d] = run;
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the totals over the digits
    const int per = (nb + 31) >> 5;
    const int d0 = lane * per;
    int s = 0;
    for (int i = 0; i < per; ++i) {
      if (d0 + i < nb) s += tot[d0 + i];
    }
    int inc = s;
    #pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += u;
    }
    int run = inc - s;
    for (int i = 0; i < per; ++i) {
      if (d0 + i < nb) {
        const int c = tot[d0 + i];
        tot[d0 + i] = run;
        run += c;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < WARPS * nb; i += kThreads) {
    const int d = i % nb;
    cnt[(i / nb) * kMaxBins + d] += tot[d];
  }
  __syncthreads();
  // in position order: a warp's rounds in turn, lanes of equal digit ranked
  // by lane
  #pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < rd) {
      const int pos = (warp * rd + r) * 32 + lane;
      const bool live = pos < n;
      const unsigned dig = live ? digit_of(k[r], shift, mask) : 0u;
      const unsigned peers = match_digit(dig, nbits,
                                         __ballot_sync(kFull, live));
      const int base = live ? wc[dig] : 0;
      __syncwarp();
      if (live) {
        const int at = base + __popc(peers & ((1u << lane) - 1u));
        skey[at] = k[r];
        sval[at] = v[r];
        if (lane == __ffs(peers) - 1) wc[dig] = base + __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

template <int WARPS, int R>
constexpr size_t narrow_smem() {
  return sizeof(int) * (WARPS * kMaxBins + kMaxBins) +
         (sizeof(int32_t) + sizeof(uint32_t)) * WARPS * 32 * R;
}

// Every pass of a narrow window over the block's items (as rank_scatter
// holds them); leaves them sorted in skey / sval [0, n).
template <int WARPS, int R>
__device__ __forceinline__ void smem_passes(int32_t (&k)[R], uint32_t (&v)[R],
                                            int n, int rd, int bits,
                                            int* cnt, int* tot,
                                            int32_t* skey, uint32_t* sval) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int passes = num_passes(bits);
  for (int p = 0; p < passes; ++p) {
    int shift, nbits;
    pass_digit(bits, passes, p, &shift, &nbits);
    rank_scatter<WARPS, R>(k, v, n, rd, shift, nbits, cnt, tot, skey, sval);
    if (p + 1 < passes) {
      #pragma unroll
      for (int r = 0; r < R; ++r) {
        const int pos = (warp * rd + r) * 32 + lane;
        if (r < rd && pos < n) {
          k[r] = skey[pos];
          v[r] = sval[pos];
        }
      }
      __syncthreads();
    }
  }
}

// One block a window of at most WARPS * 32 * R slots (pointers offset to the
// launch's first window).
template <int WARPS, int R>
__global__ void __launch_bounds__(WARPS * 32)
narrow_kernel(const int32_t* __restrict__ col,
              const uint32_t* __restrict__ val,
              const int64_t* __restrict__ start,
              const int64_t* __restrict__ len,
              const int64_t* __restrict__ dest,
              const int64_t* __restrict__ width, int bits,
              int32_t* __restrict__ out_k, uint32_t* __restrict__ out_v) {
  constexpr int kThreads = WARPS * 32;
  constexpr int kCap = kThreads * R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* cnt = reinterpret_cast<int*>(smem_raw);
  int* tot = cnt + WARPS * kMaxBins;
  int32_t* skey = reinterpret_cast<int32_t*>(tot + kMaxBins);
  uint32_t* sval = reinterpret_cast<uint32_t*>(skey + kCap);

  const int64_t w = blockIdx.x;
  const int n = static_cast<int>(len[w]);
  const int64_t s = start[w];
  const int64_t d = dest[w];
  const int L = static_cast<int>(width[w]);
  if (n <= 1) {  // nothing to sort: a copy and the tail
    for (int i = threadIdx.x; i < L; i += kThreads) {
      const bool live = i < n;
      out_k[d + i] = live ? col[s + i] : kSent;
      out_v[d + i] = live ? val[s + i] : 0u;
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rd = (n + kThreads - 1) / kThreads;
  int32_t k[R];
  uint32_t v[R];
  #pragma unroll
  for (int r = 0; r < R; ++r) {
    const int pos = (warp * rd + r) * 32 + lane;
    const bool live = r < rd && pos < n;
    k[r] = live ? col[s + pos] : 0;
    v[r] = live ? val[s + pos] : 0u;
  }
  smem_passes<WARPS, R>(k, v, n, rd, bits, cnt, tot, skey, sval);
  for (int i = threadIdx.x; i < L; i += kThreads) {
    const bool live = i < n;
    out_k[d + i] = live ? skey[i] : kSent;
    out_v[d + i] = live ? sval[i] : 0u;
  }
}

// Keyed by row: each listed row's window of the stream sorted in place by
// key - row * stride (its column), WARPS * 32 * R slots at most; the
// blocks take the list's count windows in turn.
template <int WARPS, int R, typename K>
__global__ void __launch_bounds__(WARPS * 32)
row_narrow_kernel(K* key, uint32_t* val, const int64_t* __restrict__ bounds,
                  const int32_t* __restrict__ rows,
                  const unsigned long long* __restrict__ count,
                  int64_t stride, int bits) {
  constexpr int kThreads = WARPS * 32;
  constexpr int kCap = kThreads * R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* cnt = reinterpret_cast<int*>(smem_raw);
  int* tot = cnt + WARPS * kMaxBins;
  int32_t* skey = reinterpret_cast<int32_t*>(tot + kMaxBins);
  uint32_t* sval = reinterpret_cast<uint32_t*>(skey + kCap);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t windows = static_cast<int64_t>(*count);
  for (int64_t w = blockIdx.x; w < windows; w += gridDim.x) {
    const int64_t row = rows[w];
    const int64_t s = bounds[row];
    const int n = static_cast<int>(bounds[row + 1] - s);
    const K base = static_cast<K>(row * stride);
    const int rd = (n + kThreads - 1) / kThreads;
    int32_t k[R];
    uint32_t v[R];
    #pragma unroll
    for (int r = 0; r < R; ++r) {
      const int pos = (warp * rd + r) * 32 + lane;
      const bool live = r < rd && pos < n;
      k[r] = live ? static_cast<int32_t>(key[s + pos] - base) : 0;
      v[r] = live ? val[s + pos] : 0u;
    }
    smem_passes<WARPS, R>(k, v, n, rd, bits, cnt, tot, skey, sval);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      key[s + i] = base + static_cast<K>(skey[i]);
      val[s + i] = sval[i];
    }
    __syncthreads();
  }
}

// Keyed by row: rows of 2 to 16384 products (row r's at [bounds[r],
// bounds[r + 1]) of the stream) listed by width range (rows[g * n_rows +
// i], counts[g], g < 3: up to 512, 4096, 16384), the wider ones as a
// window table (wstart, wlen, wbase: the row's first slot, products and
// row * stride) of counts[3] windows.  Warp-aggregated atomics: the order
// within a list is arbitrary, the sort's result is not.
__global__ void __launch_bounds__(256)
row_part_kernel(const int64_t* __restrict__ bounds, int64_t n_rows,
                int64_t stride, unsigned long long* __restrict__ counts,
                int32_t* __restrict__ rows, int64_t* __restrict__ wstart,
                int64_t* __restrict__ wlen, int64_t* __restrict__ wbase) {
  const int lane = threadIdx.x & 31;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x;
       b < n_rows; b += step) {
    const int64_t r = b + threadIdx.x;
    int64_t n = 0;
    int g = -1;
    if (r < n_rows) {
      n = bounds[r + 1] - bounds[r];
      g = n <= 1 ? -1 : n <= 512 ? 0 : n <= 4096 ? 1 : n <= kNarrowMax ? 2 : 3;
    }
    #pragma unroll
    for (int gg = 0; gg < 4; ++gg) {
      const unsigned m = __ballot_sync(kFull, g == gg);
      if (m == 0) continue;
      const int leader = __ffs(m) - 1;
      unsigned long long first = 0;
      if (lane == leader) {
        first = atomicAdd(&counts[gg],
                          static_cast<unsigned long long>(__popc(m)));
      }
      first = __shfl_sync(kFull, first, leader);
      if (g != gg) continue;
      const int64_t at = static_cast<int64_t>(first) +
                         __popc(m & ((1u << lane) - 1u));
      if (gg < 3) {
        rows[gg * n_rows + at] = static_cast<int32_t>(r);
      } else {
        wstart[at] = bounds[r];
        wlen[at] = n;
        wbase[at] = r * stride;
      }
    }
  }
}

// One block: each wide window's tile count and tail chunk count, their
// exclusive scans over the windows (tile_cum, tail_cum; entry n_wide is the
// total) and the map from each tile and tail chunk to its window.
__global__ void __launch_bounds__(kPrepThreads)
wide_prep_kernel(const int64_t* __restrict__ len,
                 const int64_t* __restrict__ width, int64_t n_wide,
                 int64_t* __restrict__ tile_cum,
                 int64_t* __restrict__ tail_cum,
                 int32_t* __restrict__ tile_win,
                 int32_t* __restrict__ tail_win) {
  constexpr int kWarps = kPrepThreads / 32;
  __shared__ int64_t warp_a[kWarps];
  __shared__ int64_t warp_b[kWarps];
  __shared__ int64_t carry_a;
  __shared__ int64_t carry_b;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    carry_a = 0;
    carry_b = 0;
  }
  __syncthreads();
  for (int64_t base = 0; base < n_wide; base += kPrepThreads) {
    const int64_t w = base + threadIdx.x;
    int64_t a = 0;
    int64_t b = 0;
    if (w < n_wide) {
      const int64_t n = len[w];
      a = (n + kTile - 1) / kTile;
      b = (width[w] - n + kTailChunk - 1) / kTailChunk;
    }
    int64_t ia = a;
    int64_t ib = b;
    #pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t ua = __shfl_up_sync(kFull, ia, o);
      const int64_t ub = __shfl_up_sync(kFull, ib, o);
      if (lane >= o) {
        ia += ua;
        ib += ub;
      }
    }
    if (lane == 31) {
      warp_a[warp] = ia;
      warp_b[warp] = ib;
    }
    __syncthreads();
    int64_t ea = carry_a + ia - a;
    int64_t eb = carry_b + ib - b;
    for (int x = 0; x < warp; ++x) {
      ea += warp_a[x];
      eb += warp_b[x];
    }
    if (w < n_wide) {
      tile_cum[w] = ea;
      tail_cum[w] = eb;
      for (int64_t j = 0; j < a; ++j) tile_win[ea + j] = static_cast<int32_t>(w);
      for (int64_t j = 0; j < b; ++j) tail_win[eb + j] = static_cast<int32_t>(w);
    }
    __syncthreads();
    if (threadIdx.x == kPrepThreads - 1) {
      carry_a = ea + a;
      carry_b = eb + b;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    tile_cum[n_wide] = carry_a;
    tail_cum[n_wide] = carry_b;
  }
}

// The wide windows' slots past their products: kTailChunk slots a chunk,
// the chunks spread over the grid (the outputs 16-byte aligned).
__global__ void __launch_bounds__(kTailThreads)
tail_kernel(const int64_t* __restrict__ len,
            const int64_t* __restrict__ dest,
            const int64_t* __restrict__ width, int64_t n_wide,
            const int64_t* __restrict__ tail_cum,
            const int32_t* __restrict__ tail_win,
            int32_t* __restrict__ out_k, uint32_t* __restrict__ out_v) {
  const int64_t chunks = tail_cum[n_wide];
  for (int64_t c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int w = tail_win[c];
    const int64_t lo = dest[w] + len[w] + (c - tail_cum[w]) * kTailChunk;
    const int64_t end = dest[w] + width[w];
    const int64_t hi = lo + kTailChunk < end ? lo + kTailChunk : end;
    // 16-byte stores over the whole groups of 4 slots, single ones at the
    // ragged ends
    const int64_t q_lo = (lo + 3) / 4;
    const int64_t q_hi = hi / 4;
    if (q_lo >= q_hi) {
      for (int64_t p = lo + threadIdx.x; p < hi; p += kTailThreads) {
        out_k[p] = kSent;
        out_v[p] = 0u;
      }
      continue;
    }
    if (threadIdx.x < 4 * q_lo - lo) {
      out_k[lo + threadIdx.x] = kSent;
      out_v[lo + threadIdx.x] = 0u;
    }
    if (threadIdx.x < hi - 4 * q_hi) {
      out_k[4 * q_hi + threadIdx.x] = kSent;
      out_v[4 * q_hi + threadIdx.x] = 0u;
    }
    for (int64_t q = q_lo + threadIdx.x; q < q_hi; q += kTailThreads) {
      reinterpret_cast<int4*>(out_k)[q] = make_int4(kSent, kSent, kSent,
                                                    kSent);
      reinterpret_cast<uint4*>(out_v)[q] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Where tile g lies: its window, the window's first tile and tile count,
// its first item in the window and its item count.
struct TileAt {
  int w;
  int64_t t0;
  int64_t ntw;
  int64_t j;
  int64_t lo;
  int nt;
};

__device__ __forceinline__ TileAt tile_at(int64_t g,
                                          const int64_t* __restrict__ len,
                                          const int64_t* __restrict__ tile_cum,
                                          const int32_t* __restrict__ tile_win) {
  TileAt t;
  t.w = tile_win[g];
  t.t0 = tile_cum[t.w];
  t.ntw = tile_cum[t.w + 1] - t.t0;
  t.j = g - t.t0;
  t.lo = t.j * kTile;
  const int64_t rest = len[t.w] - t.lo;
  t.nt = static_cast<int>(rest < kTile ? rest : kTile);
  return t;
}

// A window's sort key: the source key, less the window's base when the
// source holds keys by row (kRebase).
template <bool kRebase, typename KS>
__device__ __forceinline__ int32_t sort_key(KS key,
                                            const int64_t* __restrict__ base,
                                            int w) {
  if constexpr (kRebase) {
    return static_cast<int32_t>(key - static_cast<KS>(base[w]));
  } else {
    return static_cast<int32_t>(key);
  }
}

// Each tile's digit counts into hist, laid out window by window, then digit
// by digit, then tile by tile: entry (w, d, j) at tile_cum[w] * nb + d *
// (tiles of w) + j.  KS / kRebase: the source's key type, and whether its
// keys are row * stride + column, window w's base[w] subtracted.
template <typename KS, bool kRebase>
__global__ void __launch_bounds__(kHistThreads)
hist_kernel(const KS* __restrict__ src_k,
            const int64_t* __restrict__ start,
            const int64_t* __restrict__ base,
            const int64_t* __restrict__ len, int64_t n_wide,
            const int64_t* __restrict__ tile_cum,
            const int32_t* __restrict__ tile_win, int shift, int nbits,
            int32_t* __restrict__ hist) {
  __shared__ int h[kMaxBins];
  const int nb = 1 << nbits;
  const unsigned mask = nb - 1;
  const int64_t tiles = tile_cum[n_wide];
  for (int64_t g = blockIdx.x; g < tiles; g += gridDim.x) {
    for (int i = threadIdx.x; i < nb; i += kHistThreads) h[i] = 0;
    __syncthreads();
    const TileAt t = tile_at(g, len, tile_cum, tile_win);
    const KS* src = src_k + start[t.w] + t.lo;
    for (int i = threadIdx.x; i < t.nt; i += kHistThreads) {
      atomicAdd(&h[digit_of(sort_key<kRebase>(src[i], base, t.w), shift,
                            mask)], 1);
    }
    __syncthreads();
    int32_t* out = hist + t.t0 * nb + t.j;
    for (int d = threadIdx.x; d < nb; d += kHistThreads) out[d * t.ntw] = h[d];
    __syncthreads();
  }
}

// In-place exclusive scan of hist[0, tiles * nb), kScanTile entries a block,
// the blocks' offsets from a decoupled look-back (state[0]: tile counter,
// state[1 + t]: tile t's status, as csrc/compress.cu).  Entry (w, d, j)
// becomes the items of every earlier window plus those of window w before
// tile j's digit-d items in the stable order.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int32_t* __restrict__ data, const int64_t* __restrict__ tile_cum,
            int64_t n_wide, int nb, unsigned long long* __restrict__ state) {
  constexpr int kWarps = kScanThreads / 32;
  __shared__ int32_t s[kScanTile];
  __shared__ int64_t warp_sum[kWarps];
  __shared__ int64_t s_tile;
  __shared__ int64_t s_prefix;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = static_cast<int64_t>(atomicAdd(state, 1ull));
  }
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t n = tile_cum[n_wide] * nb;
  const int64_t b = tile * kScanTile;
  if (b >= n) return;  // past the end: no tile waits on this one
  const int len = static_cast<int>(n - b < kScanTile ? n - b : kScanTile);
  for (int i = threadIdx.x; i < kScanTile; i += kScanThreads) {
    s[i] = i < len ? data[b + i] : 0;
  }
  __syncthreads();
  const int i0 = threadIdx.x * kScanItems;
  int64_t sum = 0;
  #pragma unroll
  for (int i = 0; i < kScanItems; ++i) sum += s[i0 + i];
  int64_t inc = sum;
  #pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t u = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  int64_t ex = inc - sum;
  int64_t total = 0;
  #pragma unroll
  for (int x = 0; x < kWarps; ++x) {
    if (x < warp) ex += warp_sum[x];
    total += warp_sum[x];
  }
  if (warp == 0) {
    unsigned long long* status = state + 1;
    int64_t excl = 0;
    if (tile == 0) {
      if (lane == 0) {
        atomicExch(status, kFlagPrefix |
                               static_cast<unsigned long long>(total));
      }
    } else {
      if (lane == 0) {
        atomicExch(status + tile,
                   kFlagAggregate | static_cast<unsigned long long>(total));
      }
      int64_t pred = tile - 1;
      while (true) {
        const int64_t idx = pred - lane;
        unsigned long long st = kFlagPrefix;  // before tile 0: a prefix of 0
        if (idx >= 0) {
          st = *reinterpret_cast<volatile unsigned long long*>(status + idx);
        }
        if (__any_sync(kFull, (st >> 62) == 0)) {
          __nanosleep(32);
          continue;
        }
        const unsigned pmask = __ballot_sync(kFull, (st >> 62) == 2);
        const int first_p = pmask ? __ffs(pmask) - 1 : 32;
        int64_t part =
            lane <= first_p ? static_cast<int64_t>(st & kValueMask) : 0;
        #pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          part += __shfl_down_sync(kFull, part, o);
        }
        excl += __shfl_sync(kFull, part, 0);
        if (pmask) break;
        pred -= 32;
      }
      if (lane == 0) {
        atomicExch(status + tile,
                   kFlagPrefix |
                       static_cast<unsigned long long>(excl + total));
      }
    }
    if (lane == 0) s_prefix = excl;
  }
  __syncthreads();
  int64_t run = s_prefix + ex;
  #pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int32_t c = s[i0 + i];
    s[i0 + i] = static_cast<int32_t>(run);
    run += c;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += kScanThreads) data[b + i] = s[i];
}

constexpr size_t scatter_smem() {
  return sizeof(int64_t) * kMaxBins +
         sizeof(int) * (kWideWarps * kMaxBins + kMaxBins) +
         (sizeof(int32_t) + sizeof(uint32_t)) * kTile;
}

// Each tile ranked by its digit in shared memory, then each digit's run
// written to its offset from the scanned hist: dst_base[w] plus the run's
// place in the window.  KS, KD / kRebaseIn, kRebaseOut: the source's and
// the destination's key types, and whether each holds row * stride +
// column (window w's base[w] subtracted on the read, added on the write).
template <typename KS, typename KD, bool kRebaseIn, bool kRebaseOut>
__global__ void __launch_bounds__(kWideWarps * 32)
scatter_kernel(const KS* __restrict__ src_k,
               const uint32_t* __restrict__ src_v,
               const int64_t* __restrict__ start,
               const int64_t* __restrict__ base,
               const int64_t* __restrict__ len,
               const int64_t* __restrict__ dst_base, int64_t n_wide,
               const int64_t* __restrict__ tile_cum,
               const int32_t* __restrict__ tile_win, int shift, int nbits,
               const int32_t* __restrict__ scanned,
               KD* __restrict__ dst_k, uint32_t* __restrict__ dst_v) {
  constexpr int kThreads = kWideWarps * 32;
  constexpr int R = kWideRounds;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int64_t* gbase = reinterpret_cast<int64_t*>(smem_raw);
  int* cnt = reinterpret_cast<int*>(gbase + kMaxBins);
  int* tot = cnt + kWideWarps * kMaxBins;
  int32_t* skey = reinterpret_cast<int32_t*>(tot + kMaxBins);
  uint32_t* sval = reinterpret_cast<uint32_t*>(skey + kTile);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nb = 1 << nbits;
  const unsigned mask = nb - 1;
  const int64_t tiles = tile_cum[n_wide];
  for (int64_t g = blockIdx.x; g < tiles; g += gridDim.x) {
    const TileAt t = tile_at(g, len, tile_cum, tile_win);
    const int64_t s = start[t.w] + t.lo;
    const int rd = (t.nt + kThreads - 1) / kThreads;
    int32_t k[R];
    uint32_t v[R];
    #pragma unroll
    for (int r = 0; r < R; ++r) {
      const int pos = (warp * rd + r) * 32 + lane;
      const bool live = r < rd && pos < t.nt;
      k[r] = live ? sort_key<kRebaseIn>(src_k[s + pos], base, t.w) : 0;
      v[r] = live ? src_v[s + pos] : 0u;
    }
    rank_scatter<kWideWarps, R>(k, v, t.nt, rd, shift, nbits, cnt, tot, skey,
                                sval);
    const int32_t* hw = scanned + t.t0 * nb;
    const int32_t window_first = hw[0];
    for (int d = threadIdx.x; d < nb; d += kThreads) {
      gbase[d] = dst_base[t.w] +
                 static_cast<int64_t>(hw[d * t.ntw + t.j] - window_first) -
                 tot[d];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < t.nt; i += kThreads) {
      const int32_t key = skey[i];
      const int64_t o = gbase[digit_of(key, shift, mask)] + i;
      if constexpr (kRebaseOut) {
        dst_k[o] = static_cast<KD>(base[t.w]) + static_cast<KD>(key);
      } else {
        dst_k[o] = key;
      }
      dst_v[o] = sval[i];
    }
    __syncthreads();
  }
}

int sm_count() {
  int dev = 0;
  int sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

template <int WARPS, int R>
int launch_narrow(const int32_t* col, const uint32_t* val,
                  const int64_t* start, const int64_t* len,
                  const int64_t* dest, const int64_t* width, int64_t n_win,
                  int bits, int32_t* out_k, uint32_t* out_v,
                  cudaStream_t s) {
  constexpr size_t smem = narrow_smem<WARPS, R>();
  cudaError_t err = cudaFuncSetAttribute(
      narrow_kernel<WARPS, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  narrow_kernel<WARPS, R><<<static_cast<unsigned>(n_win), WARPS * 32, smem,
                            s>>>(col, val, start, len, dest, width, bits,
                                 out_k, out_v);
  return static_cast<int>(cudaGetLastError());
}

template <int WARPS, int R, typename K>
int launch_row_narrow(K* key, uint32_t* val, const int64_t* bounds,
                      const int32_t* rows, const unsigned long long* count,
                      int64_t bound, int64_t stride, int bits, int sms,
                      cudaStream_t s) {
  if (bound <= 0) return 0;
  constexpr size_t smem = narrow_smem<WARPS, R>();
  auto* kernel = row_narrow_kernel<WARPS, R, K>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      WARPS * 32, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t resident = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  const int64_t grid = bound < resident ? bound : resident;
  kernel<<<static_cast<unsigned>(grid), WARPS * 32, smem, s>>>(
      key, val, bounds, rows, count, stride, bits);
  return static_cast<int>(cudaGetLastError());
}

// One pass of the wide sort: the tiles' digit counts, their scan, the
// scatter from (sk, sv) to (dk, dv).
template <typename KS, typename KD, bool kRebaseIn, bool kRebaseOut>
int wide_pass(const KS* sk, const uint32_t* sv, KD* dk, uint32_t* dv,
              const int64_t* st, const int64_t* base, const int64_t* ln,
              const int64_t* dst_base, int64_t n_wide, const int64_t* tcum,
              const int32_t* twin, int shift, int nbits, int32_t* h,
              unsigned long long* state, int64_t max_tiles,
              int64_t max_scan_tiles, int sms, cudaStream_t s) {
  constexpr size_t smem = scatter_smem();
  auto* scatter = scatter_kernel<KS, KD, kRebaseIn, kRebaseOut>;
  cudaError_t err = cudaFuncSetAttribute(
      scatter, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, scatter, kWideWarps * 32, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t scatter_cap = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) *
                              sms;
  const int64_t scatter_grid =
      max_tiles < scatter_cap ? max_tiles : scatter_cap;
  const int64_t hist_grid = max_tiles < 8LL * sms ? max_tiles : 8LL * sms;
  hist_kernel<KS, kRebaseIn>
      <<<static_cast<unsigned>(hist_grid), kHistThreads, 0, s>>>(
          sk, st, base, ln, n_wide, tcum, twin, shift, nbits, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<static_cast<unsigned>(max_scan_tiles), kScanThreads, 0, s>>>(
      h, tcum, n_wide, 1 << nbits, state);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter<<<static_cast<unsigned>(scatter_grid), kWideWarps * 32, smem, s>>>(
      sk, sv, st, base, ln, dst_base, n_wide, tcum, twin, shift, nbits, h, dk,
      dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int64_t cbt_winsort_tile() { return kTile; }
extern "C" int64_t cbt_winsort_tail_chunk() { return kTailChunk; }
extern "C" int64_t cbt_winsort_scan_tile() { return kScanTile; }
extern "C" int64_t cbt_winsort_narrow_max() { return kNarrowMax; }

// Windows [0, n_win) of the pointers (offset by the caller to the launch's
// first window), each at most `cap` wide: 512, 4096 or 16384 (kNarrowMax).
extern "C" int cbt_winsort_narrow(const void* col, const void* val,
                                  const void* start, const void* len,
                                  const void* dest, const void* width,
                                  int64_t n_win, int64_t cap, int32_t bits,
                                  void* out_k, void* out_v, void* stream) {
  if (n_win <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const int32_t*>(col);
  const auto* v = static_cast<const uint32_t*>(val);
  const auto* st = static_cast<const int64_t*>(start);
  const auto* ln = static_cast<const int64_t*>(len);
  const auto* de = static_cast<const int64_t*>(dest);
  const auto* wd = static_cast<const int64_t*>(width);
  auto* ok = static_cast<int32_t*>(out_k);
  auto* ov = static_cast<uint32_t*>(out_v);
  switch (cap) {
    case 512:
      return launch_narrow<4, 4>(c, v, st, ln, de, wd, n_win, bits, ok, ov, s);
    case 4096:
      return launch_narrow<8, 16>(c, v, st, ln, de, wd, n_win, bits, ok, ov,
                                  s);
    case kNarrowMax:
      return launch_narrow<16, 32>(c, v, st, ln, de, wd, n_win, bits, ok, ov,
                                   s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The n_wide wide windows of the pointers (offset to the first of them).
// col / val: the stream, whose wide windows' lanes are overwritten when
// there are three passes or more; scratch_k / scratch_v: the stream's
// length (unused with one pass); tile_cum / tail_cum: int64[n_wide + 1];
// tile_win: int32[max_tiles]; tail_win: int32[max_chunks]; hist:
// int32[max_tiles * 256]; state: uint64[passes * (1 + max_scan_tiles)],
// zeroed.
extern "C" int cbt_winsort_wide(
    void* col, void* val, const void* start, const void* len,
    const void* dest, const void* width, int64_t n_wide, int32_t bits,
    void* scratch_k, void* scratch_v, void* tile_cum, void* tail_cum,
    void* tile_win, void* tail_win, int64_t max_tiles, int64_t max_chunks,
    void* hist, void* state, int64_t max_scan_tiles, void* out_k,
    void* out_v, void* stream) {
  if (n_wide <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(out_k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out_v) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* st = static_cast<const int64_t*>(start);
  const auto* ln = static_cast<const int64_t*>(len);
  const auto* de = static_cast<const int64_t*>(dest);
  const auto* wd = static_cast<const int64_t*>(width);
  auto* tcum = static_cast<int64_t*>(tile_cum);
  auto* ccum = static_cast<int64_t*>(tail_cum);
  auto* twin = static_cast<int32_t*>(tile_win);
  auto* cwin = static_cast<int32_t*>(tail_win);
  auto* h = static_cast<int32_t*>(hist);
  auto* ok = static_cast<int32_t*>(out_k);
  auto* ov = static_cast<uint32_t*>(out_v);
  const int sms = sm_count();

  wide_prep_kernel<<<1, kPrepThreads, 0, s>>>(ln, wd, n_wide, tcum, ccum,
                                               twin, cwin);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (max_chunks > 0) {
    const int64_t grid = max_chunks < 8LL * sms ? max_chunks : 8LL * sms;
    tail_kernel<<<static_cast<unsigned>(grid), kTailThreads, 0, s>>>(
        ln, de, wd, n_wide, ccum, cwin, ok, ov);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (max_tiles <= 0) return 0;

  int32_t* buf_k[2] = {static_cast<int32_t*>(col),
                       static_cast<int32_t*>(scratch_k)};
  uint32_t* buf_v[2] = {static_cast<uint32_t*>(val),
                        static_cast<uint32_t*>(scratch_v)};
  const int passes = num_passes(bits);
  for (int p = 0; p < passes; ++p) {
    int shift, nbits;
    pass_digit(bits, passes, p, &shift, &nbits);
    const bool last = p + 1 == passes;
    err = static_cast<cudaError_t>(wide_pass<int32_t, int32_t, false, false>(
        buf_k[p % 2], buf_v[p % 2], last ? ok : buf_k[(p + 1) % 2],
        last ? ov : buf_v[(p + 1) % 2], st, nullptr, ln, last ? de : st,
        n_wide, tcum, twin, shift, nbits, h,
        static_cast<unsigned long long*>(state) + p * (1 + max_scan_tiles),
        max_tiles, max_scan_tiles, sms, s));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

namespace {

// The keyed-by-row sort of one stream's windows (cbt_winsort_rows), K its
// key type.
template <typename K>
int winsort_rows(K* key, uint32_t* val, const int64_t* bounds,
                 int64_t n_rows, int64_t stream_len, int64_t stride, int bits,
                 const int64_t* narrow_bound,
                 int64_t max_wide, int64_t max_tiles, int64_t max_scan_tiles,
                 unsigned long long* zeroed, int32_t* rows, int32_t* tile_win,
                 int32_t* hist, int64_t* cums, int32_t* scratch_k,
                 uint32_t* scratch_v, cudaStream_t s) {
  if (n_rows <= 0) return 0;
  const int sms = sm_count();
  unsigned long long* counts = zeroed;
  auto* wstart = reinterpret_cast<int64_t*>(zeroed + 4);
  int64_t* wlen = wstart + max_wide;
  int64_t* wbase = wlen + max_wide;
  auto* state = reinterpret_cast<unsigned long long*>(wbase + max_wide);
  const int64_t part_blocks = (n_rows + 255) / 256;
  row_part_kernel<<<static_cast<unsigned>(
                        part_blocks < 8LL * sms ? part_blocks : 8LL * sms),
                    256, 0, s>>>(bounds, n_rows, stride, counts, rows, wstart,
                                 wlen, wbase);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int e = launch_row_narrow<4, 4, K>(key, val, bounds, rows, counts,
                                     narrow_bound[0], stride, bits, sms, s);
  if (e != 0) return e;
  e = launch_row_narrow<8, 16, K>(key, val, bounds, rows + n_rows,
                                  counts + 1, narrow_bound[1], stride, bits,
                                  sms, s);
  if (e != 0) return e;
  e = launch_row_narrow<16, 32, K>(key, val, bounds, rows + 2 * n_rows,
                                   counts + 2, narrow_bound[2], stride, bits,
                                   sms, s);
  if (e != 0) return e;
  if (max_wide <= 0 || max_tiles <= 0) return 0;
  // windows past the count have no lanes: no tiles, no tail
  int64_t* tcum = cums;
  int64_t* ccum = cums + max_wide + 1;
  wide_prep_kernel<<<1, kPrepThreads, 0, s>>>(wlen, wlen, max_wide, tcum,
                                               ccum, tile_win, tile_win);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // in place: the stream, then scratch a and b in turn, then the stream
  // again; at least two passes, so no pass reads what it writes
  const int passes = num_passes(bits) > 2 ? num_passes(bits) : 2;
  int32_t* buf_k[2] = {scratch_k, scratch_k + stream_len};
  uint32_t* buf_v[2] = {scratch_v, scratch_v + stream_len};
  for (int p = 0; p < passes; ++p) {
    int shift, nbits;
    pass_digit(bits, passes, p, &shift, &nbits);
    unsigned long long* st = state + p * (1 + max_scan_tiles);
    int32_t* dk = buf_k[p % 2];
    uint32_t* dv = buf_v[p % 2];
    const int32_t* sk = buf_k[(p + 1) % 2];
    const uint32_t* sv = buf_v[(p + 1) % 2];
    if (p == 0) {
      e = wide_pass<K, int32_t, true, false>(
          key, val, dk, dv, wstart, wbase, wlen, wstart, max_wide, tcum,
          tile_win, shift, nbits, hist, st, max_tiles, max_scan_tiles, sms, s);
    } else if (p + 1 == passes) {
      e = wide_pass<int32_t, K, false, true>(
          sk, sv, key, val, wstart, wbase, wlen, wstart, max_wide, tcum,
          tile_win, shift, nbits, hist, st, max_tiles, max_scan_tiles, sms, s);
    } else {
      e = wide_pass<int32_t, int32_t, false, false>(
          sk, sv, dk, dv, wstart, wbase, wlen, wstart, max_wide, tcum,
          tile_win, shift, nbits, hist, st, max_tiles, max_scan_tiles, sms, s);
    }
    if (e != 0) return e;
  }
  return 0;
}

}  // namespace

// Keyed by row: every row's window of a compacted expansion stream (keys
// row * stride + column, the rows ascending, each row's products together)
// sorted in place by column, stably, as a stable sort of the whole stream
// orders it; the slots past the rows' products are left as they are.
// key: int32 or int64 (key64) [stream_len]; val: 4-byte [stream_len];
// bounds: int64[n_rows + 1], row r's products at [bounds[r], bounds[r + 1]);
// narrow_bound0..2: bounds on the rows of 2-512, 513-4096 and 4097-16384
// products; max_wide / max_tiles: bounds on the wider rows and on their
// tiles; zeroed: uint64[4 + 3 * max_wide + passes * (1 + max_scan_tiles)],
// zeros; rows: int32[3 * n_rows]; tile_win: int32[max_tiles]; hist:
// int32[max_tiles * 256]; cums: int64[2 * (max_wide + 1)]; scratch_k /
// scratch_v: int32 / uint32[2 * stream_len] (unused without wide rows).
extern "C" int cbt_winsort_rows(
    void* key, int32_t key64, void* val, const void* bounds, int64_t n_rows,
    int64_t stream_len, int64_t stride, int32_t bits, int64_t narrow_bound0,
    int64_t narrow_bound1, int64_t narrow_bound2, int64_t max_wide,
    int64_t max_tiles,
    int64_t max_scan_tiles, void* zeroed, void* rows, void* tile_win,
    void* hist, void* cums, void* scratch_k, void* scratch_v, void* stream) {
  const int64_t bound[3] = {narrow_bound0, narrow_bound1, narrow_bound2};
  const auto* b = static_cast<const int64_t*>(bounds);
  auto* z = static_cast<unsigned long long*>(zeroed);
  auto* rw = static_cast<int32_t*>(rows);
  auto* tw = static_cast<int32_t*>(tile_win);
  auto* h = static_cast<int32_t*>(hist);
  auto* c = static_cast<int64_t*>(cums);
  auto* sk = static_cast<int32_t*>(scratch_k);
  auto* sv = static_cast<uint32_t*>(scratch_v);
  auto* v = static_cast<uint32_t*>(val);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key64) {
    return winsort_rows<int64_t>(static_cast<int64_t*>(key), v, b, n_rows,
                                 stream_len, stride, bits, bound, max_wide,
                                 max_tiles, max_scan_tiles, z, rw, tw, h, c,
                                 sk, sv, s);
  }
  return winsort_rows<int32_t>(static_cast<int32_t*>(key), v, b, n_rows,
                               stream_len, stride, bits, bound, max_wide,
                               max_tiles, max_scan_tiles, z, rw, tw, h, c, sk,
                               sv, s);
}
