// Shared by every kernel of the library: the text of a CUDA error code
// that a launcher returned.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
