// C helpers shared by every kernel entry point of the library.
#include <cuda_runtime.h>

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
