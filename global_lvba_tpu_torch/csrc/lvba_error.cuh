// The one C helper every kernel library exports besides its launcher.
#pragma once

#include <cuda_runtime.h>

// cudaGetErrorString behind a C name, for the Python wrappers' messages.
extern "C" const char* lvba_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
