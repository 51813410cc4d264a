// Shared by every kernel library of spf_tpu_torch: the error-string
// export that the ctypes bindings (kernels/build.py) use to report a
// failed launch.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* spf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch's own error, or the first error of the calls before it.
static inline int spf_last_error() {
  return static_cast<int>(cudaGetLastError());
}
