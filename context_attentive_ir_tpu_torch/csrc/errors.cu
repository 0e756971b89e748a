// The message of a cudaError_t returned by one of the library's launchers,
// so the Python wrappers can raise with the CUDA runtime's own words.

#include <cuda_runtime.h>

extern "C" const char* cair_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
