// Shared entry point of the port's kernel library: error text for the codes
// that every n2m_* launch function returns (its cudaGetLastError()).
#include <cuda_runtime.h>

extern "C" const char* n2m_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
