// The coefficient-domain half of a blind-rotation step: fold the last
// step's product into the torus accumulator and/or rotate it by X^t, and
// emit the signed gadget digits of the result as f32 planes.
//
// Replaces the Pallas kernels of spf_tpu/ops/rot_decomp_pallas.py:
//
//   accumulate_decompose (:147)      acc' = acc + round(prod); digits of acc'
//   rotate_sub_decompose (:182)      digits of acc·X^t − acc
//   rotate_sub_decompose_acc (:98)   acc' = acc + round(prod); digits of
//                                    acc'·X^t − acc'
//
// with t per batch column. The torus is a plain uint64_t here (the TPU
// kernels carried u32 limb pairs because Mosaic has no 64-bit integers).
// Bit for bit with the plain versions (spf_tpu_torch/ops/rot_decomp.py:
// torus.from_ds, torus.monomial_mul, torus.decompose): the same exact f32
// reductions, rintf (round half to even, as torch.round and jnp.round),
// and each rounded residue saturated at the i32 range as the reference's
// f32 -> i32 casts are.
//
// What bounds them on an H100: memory. Per element of [k+1, N, B] they
// read 8 bytes of acc (+ 8 of prod) and write 4 * count bytes of digits
// (+ 8 of acc'); at [2, 2048, 256], count 2: ~16.8 MB (~5.0 us at
// 3.35 TB/s) for rotate_sub_decompose and ~33.5 MB (~10.0 us) for the
// other two. A few dozen integer and f32 operations per element.
//
// Design: one thread per element, grid-stride, neighbouring threads on
// neighbouring batch columns, so acc, prod, acc' and the digits are read
// and written coalesced. The rotation is a gather: output (j, column c)
// reads source s = (j − t_c) mod 2N, +acc[s] if s < N, else −acc[s − N].
// t differs per column, so the 32 threads of a warp read 32 different
// rows: each gathered 8-byte read costs a 32-byte sector. The accumulator
// (8.4 MB at the main path's shapes) stays in the 50 MB L2, so the extra
// sectors are L2 traffic, not device-memory traffic. In the _acc variant
// each thread recomputes acc'[s] = acc[s] + round(prod[s]) from the
// inputs: it never reads acc_out, which other blocks of the same launch
// write.

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

// Signed gadget digits of a (most significant first) into
// digits[d * e + i], d < count (port of limb32.decompose).
__device__ __forceinline__ void write_digits(uint64_t a, float* __restrict__ digits, int e, int i,
                                             int count, int log_b) {
  const int shift = 64 - count * log_b;
  const uint64_t mask = (1ull << log_b) - 1;
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

// The flat index of the source of element i under X^t (t of column i % b)
// and whether it is negated.
__device__ __forceinline__ int rotation_source(int i, const long long* __restrict__ t, int n,
                                               int b, bool* neg) {
  const int c = i % b;
  const int j = (i / b) % n;
  const long long two_n = 2LL * n;
  long long tt = t[c] % two_n;
  if (tt < 0) tt += two_n;
  long long s = (long long)j - tt;
  if (s < 0) s += two_n;
  *neg = s >= n;
  const int src = (int)(*neg ? s - n : s);
  return i + (src - j) * b;
}

__global__ void accumulate_decompose_kernel(const uint64_t* __restrict__ acc,
                                            const float* __restrict__ ph,
                                            const float* __restrict__ pl,
                                            uint64_t* __restrict__ acc_out,
                                            float* __restrict__ digits, int e, int count,
                                            int log_b) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < e; i += gridDim.x * blockDim.x) {
    const uint64_t a = acc[i] + from_ds(ph[i], pl[i]);
    acc_out[i] = a;
    write_digits(a, digits, e, i, count, log_b);
  }
}

__global__ void rotate_sub_decompose_kernel(const uint64_t* __restrict__ acc,
                                            const long long* __restrict__ t,
                                            float* __restrict__ digits, int e, int n, int b,
                                            int count, int log_b) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < e; i += gridDim.x * blockDim.x) {
    bool neg;
    const uint64_t x = acc[rotation_source(i, t, n, b, &neg)];
    const uint64_t rot = neg ? 0ull - x : x;
    write_digits(rot - acc[i], digits, e, i, count, log_b);
  }
}

__global__ void rotate_sub_decompose_acc_kernel(const uint64_t* __restrict__ acc,
                                                const float* __restrict__ ph,
                                                const float* __restrict__ pl,
                                                const long long* __restrict__ t,
                                                uint64_t* __restrict__ acc_out,
                                                float* __restrict__ digits, int e, int n, int b,
                                                int count, int log_b) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < e; i += gridDim.x * blockDim.x) {
    const uint64_t a = acc[i] + from_ds(ph[i], pl[i]);
    acc_out[i] = a;
    bool neg;
    const int si = rotation_source(i, t, n, b, &neg);
    const uint64_t x = acc[si] + from_ds(ph[si], pl[si]);  // acc'[s], from the inputs
    const uint64_t rot = neg ? 0ull - x : x;
    write_digits(rot - a, digits, e, i, count, log_b);
  }
}

bool bad_radix(int count, int log_b) {
  return count < 1 || log_b < 1 || log_b > 31 || count * log_b > 64;
}

int blocks_for(int e, int threads) { return (int)(((long long)e + threads - 1) / threads); }

}  // namespace

// acc u64 [E], prod ds pair f32 [E] -> acc_out u64 [E], digits f32 [count, E]
extern "C" int spf_accumulate_decompose(const void* acc, const float* ph, const float* pl,
                                        void* acc_out, float* digits, int e, int count,
                                        int log_b, void* stream) {
  if (e < 1 || bad_radix(count, log_b)) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  accumulate_decompose_kernel<<<blocks_for(e, threads), threads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint64_t*>(acc), ph, pl, static_cast<uint64_t*>(acc_out), digits, e,
      count, log_b);
  return spf_last_error();
}

// acc u64 [E = P * N * B], t int64 [B] -> digits f32 [count, E]
extern "C" int spf_rotate_sub_decompose(const void* acc, const void* t, float* digits, int e,
                                        int n, int b, int count, int log_b, void* stream) {
  if (e < 1 || n < 1 || b < 1 || e % (n * b) != 0 || bad_radix(count, log_b))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  rotate_sub_decompose_kernel<<<blocks_for(e, threads), threads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint64_t*>(acc), static_cast<const long long*>(t), digits, e, n, b, count,
      log_b);
  return spf_last_error();
}

// acc u64 [E = P * N * B], prod ds pair f32 [E], t int64 [B]
// -> acc_out u64 [E], digits f32 [count, E]
extern "C" int spf_rotate_sub_decompose_acc(const void* acc, const float* ph, const float* pl,
                                            const void* t, void* acc_out, float* digits, int e,
                                            int n, int b, int count, int log_b, void* stream) {
  if (e < 1 || n < 1 || b < 1 || e % (n * b) != 0 || bad_radix(count, log_b))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  rotate_sub_decompose_acc_kernel<<<blocks_for(e, threads), threads, 0,
                                    (cudaStream_t)stream>>>(
      static_cast<const uint64_t*>(acc), ph, pl, static_cast<const long long*>(t),
      static_cast<uint64_t*>(acc_out), digits, e, n, b, count, log_b);
  return spf_last_error();
}
