// Error text for the cudaError_t codes the C entry points return.
#include "common.cuh"

MPA_EXPORT const char* mpa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
