// CUDA IPC for the exchanges between the processes of a pod
// (parallel/exchange.py): device buffers that one process allocates and
// exports once, and that its peers map once and keep for the life of the
// group, plus the copy that reads a peer's mapped buffer.  No kernel: the
// exchanges' copies are cudaMemcpyAsync on the caller's stream, and the
// one kernel that writes into a peer's buffer is K9's push (ring.cu).
//
// Each process of one card, or of one host, has its own CUDA context;
// cudaIpcOpenMemHandle maps another process's allocation into this one,
// on the same card or on a peer card (cudaIpcMemLazyEnablePeerAccess).
// An allocation is cudaMalloc's own, so the mapped pointer is its start.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

// The size of the handle that travels between processes.
extern "C" int64_t cbt_ipc_handle_bytes() {
  return static_cast<int64_t>(sizeof(cudaIpcMemHandle_t));
}

// Allocate `bytes` on `device`; writes the pointer to *ptr_out and the
// handle (cbt_ipc_handle_bytes() bytes) to handle_out.
extern "C" int cbt_ipc_alloc(int32_t device, int64_t bytes, void* ptr_out,
                             void* handle_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* ptr = nullptr;
  err = cudaMalloc(&ptr, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t handle;
  err = cudaIpcGetMemHandle(&handle, ptr);
  if (err != cudaSuccess) {
    cudaFree(ptr);
    return static_cast<int>(err);
  }
  *static_cast<void**>(ptr_out) = ptr;
  std::memcpy(handle_out, &handle, sizeof(handle));
  return 0;
}

// Map a peer's allocation; writes the pointer to *ptr_out.
extern "C" int cbt_ipc_open(int32_t device, const void* handle,
                            void* ptr_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  void* ptr = nullptr;
  err = cudaIpcOpenMemHandle(&ptr, h, cudaIpcMemLazyEnablePeerAccess);
  if (err != cudaSuccess) return static_cast<int>(err);
  *static_cast<void**>(ptr_out) = ptr;
  return 0;
}

extern "C" int cbt_ipc_close(int32_t device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

extern "C" int cbt_ipc_free(int32_t device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFree(ptr));
}

// `bytes` from src to dst, either of them a peer's mapped buffer, in
// stream order.
extern "C" int cbt_copy(void* dst, const void* src, int64_t bytes,
                        void* stream) {
  return static_cast<int>(
      cudaMemcpyAsync(dst, src, static_cast<size_t>(bytes), cudaMemcpyDefault,
                      static_cast<cudaStream_t>(stream)));
}
