// One-hop ring push of block stacks: every block's buffer goes to its ring
// neighbour's slot, dst[o, (r+1) % ring, q] = src[o, r, q], for up to
// kMaxArrays arrays in one launch.
//
// Replaces: combblas_tpu/parallel/rma.py _ring_shift_kernel (K9), the
// Pallas RDMA push with which the device at index d along a mesh axis
// receives the (rows, 128) buffer of index (d-1) mod size; the ring SUMMA
// (summa_spgemm_rma) shifts A along 'c' and B along 'r' after every stage
// but the last.  In one process the whole (pr, pc) block stack lies on one
// card, so the push is a copy between two stacks in device memory; within
// one stream the launch order is the rendezvous, so there is no
// counterpart of the send/recv semaphores.
//
// Across processes (a pod, parallel/exchange.py) each process holds an
// (outer, ring, inner) share of the stack and the ring continues in the
// next process: a block that leaves the end of this process's ring is
// written to `dst_wrap`, the next process's receive slot mapped into this
// one by CUDA IPC, at the position it takes there (ring index 0), which is
// the TPU kernel's remote copy.  Every other block lands in `dst`, this
// process's own slot.  Where the whole ring is local, dst_wrap == dst and
// the hop is the one-process push.  The rendezvous is outside the kernel:
// the caller synchronises its stream and meets its peers at a barrier, and
// the kernel never waits on a peer's write.
//
// Bound on the H100: bytes.  Every word is read once and written once, no
// arithmetic: 2 x the stacks' bytes over 3.35 TB/s.
//
// Design: the payload is raw 4-byte words, so one kernel serves int32,
// float32 and int64 (two words) arrays, and one launch moves a whole
// operand, row ids, column ids, values and nnz together, from a small table
// of arrays passed by value.  Each array has its own geometry: a stack of
// outer x ring x inner blocks of `words` words, shifted along `ring` ('c':
// outer = pr, ring = pc, inner = 1; 'r': outer = 1, ring = pr, inner = pc).
// grid.y walks the blocks and grid.z the arrays; grid.x and the threads
// stride over a block's words, 16 bytes a thread when the block length is a
// multiple of 4 words and both bases are 16-byte aligned (so every block
// start is), 4 bytes a thread otherwise.  The TPU's 128-lane padding and
// (rows, 128) reshape are gone.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxArrays = 8;
constexpr int64_t kMaxTiles = 1024;

struct RingArgs {
  const uint32_t* src[kMaxArrays];
  uint32_t* dst[kMaxArrays];
  uint32_t* dst_wrap[kMaxArrays];  // where a block past the ring's end goes
  int64_t words[kMaxArrays];  // per block
  int64_t outer[kMaxArrays];
  int64_t ring[kMaxArrays];
  int64_t inner[kMaxArrays];
  int vec4[kMaxArrays];
};

__global__ void __launch_bounds__(kThreads) ring_shift_kernel(RingArgs args) {
  const int a = blockIdx.z;
  const int64_t inner = args.inner[a];
  const int64_t ring = args.ring[a];
  const int64_t nblocks = args.outer[a] * ring * inner;
  const int64_t b = blockIdx.y;
  if (b >= nblocks) return;
  const int64_t q = b % inner;
  const int64_t r = (b / inner) % ring;
  const int64_t o = b / (inner * ring);
  const int64_t to = (o * ring + (r + 1) % ring) * inner + q;
  const int64_t w = args.words[a];
  const uint32_t* __restrict__ src = args.src[a] + b * w;
  uint32_t* __restrict__ dst =
      (r + 1 == ring ? args.dst_wrap[a] : args.dst[a]) + to * w;
  const int64_t start =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  if (args.vec4[a]) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int64_t v = start; v < w / 4; v += step) d4[v] = __ldg(s4 + v);
  } else {
    for (int64_t v = start; v < w; v += step) dst[v] = __ldg(src + v);
  }
}

}  // namespace

// table: n_arrays rows of 7 int64 (src, dst, dst_wrap, words per block,
// outer, ring, inner), in host memory.
extern "C" int cbt_ring_shift(const int64_t* table, int32_t n_arrays,
                              void* stream) {
  if (n_arrays < 1 || n_arrays > kMaxArrays) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RingArgs args = {};
  int64_t max_blocks = 1, max_units = 1;
  for (int a = 0; a < n_arrays; ++a) {
    const int64_t* row = table + 7 * a;
    args.src[a] = reinterpret_cast<const uint32_t*>(row[0]);
    args.dst[a] = reinterpret_cast<uint32_t*>(row[1]);
    args.dst_wrap[a] = reinterpret_cast<uint32_t*>(row[2]);
    args.words[a] = row[3];
    args.outer[a] = row[4];
    args.ring[a] = row[5];
    args.inner[a] = row[6];
    args.vec4[a] = row[3] % 4 == 0 && row[0] % 16 == 0 &&
                   row[1] % 16 == 0 && row[2] % 16 == 0;
    const int64_t nb = row[4] * row[5] * row[6];
    const int64_t units = args.vec4[a] ? row[3] / 4 : row[3];
    if (nb > max_blocks) max_blocks = nb;
    if (units > max_units) max_units = units;
  }
  if (max_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int64_t tiles = (max_units + kThreads - 1) / kThreads;
  if (tiles > kMaxTiles) tiles = kMaxTiles;
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(max_blocks),
                  static_cast<unsigned>(n_arrays));
  ring_shift_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      args);
  return static_cast<int>(cudaGetLastError());
}
