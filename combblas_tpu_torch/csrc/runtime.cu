// Error reporting for the ctypes wrappers (ops/kernels/_build.py).
#include <cuda_runtime.h>

extern "C" const char* cbt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
