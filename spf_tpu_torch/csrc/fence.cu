// A contiguous f32 copy.
//
// Replaces the Pallas kernel spf_tpu/ops/phase_rot.py::fence (:242), the
// identity copy that pins the hoisted per-step phase factors outside the
// blind-rotation loop on the TPU (XLA cannot rematerialize through a
// custom call). Eager PyTorch recomputes nothing, so the copy has no
// optimization job here; it stays on the path as the port of that kernel.
// Its plain version is `clone`.
//
// What bounds it on an H100: memory, 8 bytes moved per element (~42 MB
// per call for the [213, 3, 32, 256] factor planes, ~12.5 us at 3.35 TB/s).
// Design: one grid-stride loop, neighbouring threads on neighbouring
// elements.

#include "common.cuh"

namespace {

__global__ void copy_kernel(const float* __restrict__ src, float* __restrict__ dst, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    dst[i] = src[i];
}

}  // namespace

// dst[i] = src[i] for i < n
extern "C" int spf_fence(const float* src, float* dst, int n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  copy_kernel<<<blocks < 65535 ? blocks : 65535, threads, 0, (cudaStream_t)stream>>>(src, dst, n);
  return spf_last_error();
}
