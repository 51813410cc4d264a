// Accumulate and decompose: acc <- acc + round(prod) mod 2^64, then the
// signed gadget digits of the new acc as f32 planes.
//
// Replaces the Pallas kernel
// spf_tpu/ops/rot_decomp_pallas.py::accumulate_decompose (:147). The
// torus is a plain uint64_t here (the TPU kernel carried u32 limb pairs
// because Mosaic has no 64-bit integers). Bit for bit with the plain
// version (spf_tpu_torch/ops/rot_decomp.py, torus.from_ds/decompose):
// the same exact f32 reductions, rintf (round half to even, as
// torch.round and jnp.round), and each rounded residue saturated at the
// i32 range as the reference's f32 -> i32 casts are.
//
// What bounds it on an H100: memory. Per element it reads 8 + 4 + 4 bytes
// and writes 8 + 4 * count bytes (~34 MB a call at [2, 2048, 256], count
// 2: ~10 us at 3.35 TB/s) for a few dozen integer and f32 operations.
// Design: one thread per element, grid-stride, every access coalesced.

#include <cstdint>

#include "common.cuh"

namespace {

__device__ __forceinline__ long long round_to_i32(float r) {
  long long v = (long long)rintf(r);  // |r| <= 2^31: exact in int64
  return v > 2147483647LL ? 2147483647LL : (v < -2147483648LL ? -2147483648LL : v);
}

// round(vh + vl) mod 2^64 (port of limb32.from_ds)
__device__ __forceinline__ uint64_t from_ds(float vh, float vl) {
  vh = vh - rintf(vh * 0x1p-64f) * 0x1p64f;  // |vh| <= 2^63, exact
  vl = vl - rintf(vl * 0x1p-64f) * 0x1p64f;
  const float t1 = rintf(vh * 0x1p-32f);
  const float r1 = vh - t1 * 0x1p32f;  // exact; |r1| <= 2^31
  const float t2 = rintf(vl * 0x1p-32f);
  const float r2 = vl - t2 * 0x1p32f;
  const long long carry = (long long)t1 + (long long)t2;
  return ((uint64_t)carry << 32) + (uint64_t)(round_to_i32(r1) + round_to_i32(r2));
}

__global__ void accumulate_decompose_kernel(const uint64_t* __restrict__ acc,
                                            const float* __restrict__ ph,
                                            const float* __restrict__ pl,
                                            uint64_t* __restrict__ acc_out,
                                            float* __restrict__ digits, int e, int count,
                                            int log_b) {
  const int shift = 64 - count * log_b;
  const uint64_t mask = (1ull << log_b) - 1;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < e; i += gridDim.x * blockDim.x) {
    const uint64_t a = acc[i] + from_ds(ph[i], pl[i]);
    acc_out[i] = a;
    // the rounded top count*log_b bits, LSB-aligned
    uint64_t v = shift == 0 ? a : (a >> shift) + ((a >> (shift - 1)) & 1ull);
    for (int d = count - 1; d >= 0; --d) {
      const uint64_t dd = v & mask;
      v >>= log_b;
      const uint64_t carry = dd >> (log_b - 1);
      v += carry;
      const int digit = (int)((long long)dd - (long long)(carry << log_b));
      digits[(size_t)d * e + i] = (float)digit;
    }
  }
}

}  // namespace

// acc u64 [E], prod ds pair f32 [E] -> acc_out u64 [E], digits f32 [count, E]
extern "C" int spf_accumulate_decompose(const void* acc, const float* ph, const float* pl,
                                        void* acc_out, float* digits, int e, int count,
                                        int log_b, void* stream) {
  if (e < 1 || count < 1 || log_b < 1 || log_b > 31 || count * log_b > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int blocks = (int)(((long long)e + threads - 1) / threads);
  accumulate_decompose_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint64_t*>(acc), ph, pl, static_cast<uint64_t*>(acc_out), digits, e,
      count, log_b);
  return spf_last_error();
}
