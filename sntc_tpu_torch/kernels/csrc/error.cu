// The CUDA runtime's message for an error code, for the Python wrappers'
// exceptions (they receive the code from each launch entry point).

#include <cuda_runtime.h>

extern "C" const char* sntc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
