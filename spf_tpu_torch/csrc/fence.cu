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
//
// Design: 16-byte vectors, read once and written once with streaming cache
// hints (loads not kept in L1, with a 256-byte L2 prefetch hint; __stcs
// stores: nothing is read again). A grid of a whole number of blocks per SM
// (as many as one pass needs, at most a full SM) walks the vectors with a
// grid-stride loop, UNROLL independent vectors in flight per thread, all
// loads issued before the stores. Any start and length in one
// launch: the first (0-3) elements up to a 16-byte boundary of dst and the
// last (0-3) elements go through scalar copies by the first threads; when
// src sits at another offset within 16 bytes than dst (a view such as
// x[1:]), each vector is assembled from the two aligned source vectors
// that hold it (the shift is a template argument, so the loop has no
// branch).

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;
constexpr int BLOCKS_PER_SM = 8;  // 2048 threads: a full SM

// A 16-byte read-once load: not kept in L1, and a hint to L2 to fetch the
// whole 256-byte block around it from memory (ld.global.nc with
// L1::no_allocate and L2::256B: ~1% faster than __ldcs on an H100 at the
// fence's shapes).
__device__ __forceinline__ float4 load_once(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// the 4 floats at element offset S (0-3) of the aligned pair (a, b)
template <int S>
__device__ __forceinline__ float4 shifted(const float4& a, const float4& b) {
  if constexpr (S == 0) {
    return a;
  } else if constexpr (S == 1) {
    return make_float4(a.y, a.z, a.w, b.x);
  } else if constexpr (S == 2) {
    return make_float4(a.z, a.w, b.x, b.y);
  } else {
    return make_float4(a.w, b.x, b.y, b.z);
  }
}

// dst[head + 4v .. +3] = src[head + 4v .. +3] for v < nv, where dst + head
// is 16-byte aligned and src + head sits S floats past a 16-byte boundary
// (vsrc = that boundary); plus the head and the tail (< 4 each) as scalars.
template <int S>
__global__ void __launch_bounds__(THREADS)
    copy_kernel(const float* __restrict__ src, float* __restrict__ dst,
                const float4* __restrict__ vsrc, int nv, int head, int tail, int n) {
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  float4* vdst = reinterpret_cast<float4*>(dst + head);
  if (tid < head) dst[tid] = src[tid];
  if (tid < tail) dst[n - tail + tid] = src[n - tail + tid];
  for (long long v0 = tid; v0 < nv; v0 += UNROLL * stride) {
    float4 x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long v = v0 + u * stride;
      if (v < nv) {
        if constexpr (S == 0) {
          x[u] = load_once(vsrc + v);
        } else {
          x[u] = shifted<S>(load_once(vsrc + v), load_once(vsrc + v + 1));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long v = v0 + u * stride;
      if (v < nv) __stcs(vdst + v, x[u]);
    }
  }
}

template <int S>
int launch(const float* src, float* dst, int n, int head, int sms, cudaStream_t stream) {
  const int nv = (n - head) / 4;
  const int tail = n - head - 4 * nv;
  const uintptr_t at = reinterpret_cast<uintptr_t>(src + head) & ~uintptr_t{15};
  const long long per_sm = (long long)sms * THREADS * UNROLL;
  long long waves = (nv + per_sm - 1) / per_sm;  // blocks per SM that each take UNROLL vectors
  waves = waves < 1 ? 1 : (waves > BLOCKS_PER_SM ? BLOCKS_PER_SM : waves);
  copy_kernel<S><<<(int)(sms * waves), THREADS, 0, stream>>>(
      src, dst, reinterpret_cast<const float4*>(at), nv, head, tail, n);
  return spf_last_error();
}

// The SM count of the current device (queried once per device).
int sm_count(int* sms) {
  static int by_device[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (by_device[dev] == 0) {
    err = cudaDeviceGetAttribute(&by_device[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *sms = by_device[dev];
  return 0;
}

}  // namespace

// dst[i] = src[i] for i < n; src and dst 4-byte aligned, at any offset
extern "C" int spf_fence(const float* src, float* dst, int n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst), s = reinterpret_cast<uintptr_t>(src);
  if ((d | s) & 3) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  if (const int err = sm_count(&sms)) return err;
  const int lead = (int)(((16 - (d & 15)) & 15) / 4);  // floats up to dst's next 16-byte boundary
  const int head = lead < n ? lead : n;
  cudaStream_t st = (cudaStream_t)stream;
  switch (((s + 4 * head) & 15) / 4) {
    case 0: return launch<0>(src, dst, n, head, sms, st);
    case 1: return launch<1>(src, dst, n, head, sms, st);
    case 2: return launch<2>(src, dst, n, head, sms, st);
    default: return launch<3>(src, dst, n, head, sms, st);
  }
}
