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
// Design. accumulate_decompose: one thread per element, grid-stride,
// neighbouring threads on neighbouring batch columns, so every read and
// write is coalesced.
//
// The rotation kernels stage a column tile in shared memory, so their
// gather never touches device memory. Output (j, column c) reads source
// s = (j - t_c) mod 2N: +acc'[s] if s < N, else -acc'[s - N]. t differs per
// column, so a gather from device memory reads one row per lane (a 32-byte
// sector for 8 bytes). Here a block owns BC = 8 whole columns of one
// polynomial: it reads all N rows of them, 64 bytes a row, two whole
// sectors, into a tile [N][BC] of shared memory (128 KB at N = 2048), a
// thread two neighbouring columns of a row at a time (16 bytes where B is
// even): the plain kernel with cp.async, straight from the L2 without
// registers; _acc through registers, adding round(ph + pl) on the way in
// (acc' = acc + from_ds(ph, pl), once an element a block). After one
// barrier each output reads tile[s][c] and tile[j][c] there and writes
// its digits: BC x 4 = 32 bytes a row of a plane, one whole sector. No
// global gather; t_c mod 2N once a thread (a thread keeps one column in
// this phase); no division by a runtime value per element.
//
// The tile is row-major with no padding. A warp holds 4 consecutive output
// rows x 8 columns; the 64-bit reads of a half-warp (2 rows x 8 columns)
// hit banks 16 (s mod 2) + 2c (+1), and the two rows of one column have
// sources of opposite parity for any t_c (N even), so no two lanes share a
// bank (tests/test_torch_rot_tiles.py checks this map).
//
// At P = 2, B = 256 there are 64 tiles for 132 SMs, so a tile's output rows
// are split between `splits` blocks (splits = SMs / tiles, at most 8; 2
// there): each stages all N rows (the second read of a tile hits the L2)
// and writes only its share of the rows. In _acc each block forms acc' for
// every row from the inputs and writes acc_out only for its own rows: no
// block reads acc_out, which other blocks of the same launch write.
//
// Chosen on an H100 by the time inside the single-bit PBS as well as alone
// (PERF.md): 1024 threads (512: 1.2-1.5x slower); the split (one
// block a tile: 1.1-1.4x slower); over 2-8-block clusters that stage a
// share of the rows each and gather from one another's shared memory
// (1.1-2.2x slower) or copy the other block's rows over before the gather
// (1.1-1.4x); over 4 columns a block (half-sector stores: 1.2-1.9x).

#include <algorithm>
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

// the rotation kernels' column tile: BC whole columns, all N rows
constexpr int BC = 8;
constexpr int ROT_THREADS = 1024;  // a multiple of BC: a thread keeps one column
constexpr int MAX_SPLITS = 8;

// global -> shared without registers (cp.async): 8 bytes through L1, 16 bytes
// straight from the L2
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

// acc' of the columns c0 + pc, c0 + pc + 1 (those below b) at element i
// (column c0 + pc), into tile[at], tile[at + 1]; ACC: acc + from_ds(ph, pl),
// also to acc_out when `own`. 16-byte accesses where B is even.
template <bool ACC>
__device__ __forceinline__ void stage_pair(const uint64_t* __restrict__ acc,
                                           const float* __restrict__ ph,
                                           const float* __restrict__ pl,
                                           uint64_t* __restrict__ acc_out, uint64_t* tile, int at,
                                           int i, int cols, bool vec, bool own) {
  if (vec && cols == 2) {
    ulonglong2 a = *reinterpret_cast<const ulonglong2*>(acc + i);
    if constexpr (ACC) {
      const float2 h = *reinterpret_cast<const float2*>(ph + i);
      const float2 l = *reinterpret_cast<const float2*>(pl + i);
      a.x += from_ds(h.x, l.x);
      a.y += from_ds(h.y, l.y);
      if (own) *reinterpret_cast<ulonglong2*>(acc_out + i) = a;
    }
    *reinterpret_cast<ulonglong2*>(tile + at) = a;
    return;
  }
  for (int c = 0; c < cols; ++c) {
    uint64_t a = acc[i + c];
    if constexpr (ACC) {
      a += from_ds(ph[i + c], pl[i + c]);
      if (own) acc_out[i + c] = a;
    }
    tile[at + c] = a;
  }
}

// digits of acc'·X^t − acc' for the output rows [lo, hi) of one column tile;
// ACC: acc' = acc + from_ds(ph, pl), written to acc_out for those rows;
// else acc' = acc. Block: (polynomial p, tile, split), split fastest.
template <bool ACC>
__global__ void __launch_bounds__(ROT_THREADS)
    rotate_sub_decompose_kernel(const uint64_t* __restrict__ acc, const float* __restrict__ ph,
                                const float* __restrict__ pl, const long long* __restrict__ t,
                                uint64_t* __restrict__ acc_out, float* __restrict__ digits,
                                int e, int n, int b, int tiles, int splits, int count,
                                int log_b) {
  extern __shared__ __align__(16) uint64_t tile[];  // [n][BC], row-major
  const int split = blockIdx.x % splits;
  const int pt = blockIdx.x / splits;
  const int c0 = pt % tiles * BC;
  const int p0 = (pt / tiles) * n * b;  // element (p, 0, 0)
  const int lo = (int)((long long)split * n / splits);
  const int hi = (int)((long long)(split + 1) * n / splits);

  {  // staging: a thread takes two neighbouring columns of a row
    constexpr int PAIR_ROWS = ROT_THREADS / (BC / 2);
    const int pc = 2 * (threadIdx.x % (BC / 2));
    const int cols = min(2, b - c0 - pc);
    const bool vec = b % 2 == 0 && (((uintptr_t)acc | (uintptr_t)acc_out) & 15) == 0 &&
                     (((uintptr_t)ph | (uintptr_t)pl) & 7) == 0;
    if constexpr (ACC) {
#pragma unroll 4
      for (int j = threadIdx.x / (BC / 2); j < n; j += PAIR_ROWS)
        if (cols > 0)
          stage_pair<ACC>(acc, ph, pl, acc_out, tile, j * BC + pc, p0 + j * b + c0 + pc, cols,
                          vec, j >= lo && j < hi);
    } else {
      for (int j = threadIdx.x / (BC / 2); j < n; j += PAIR_ROWS) {
        const int at = j * BC + pc, i = p0 + j * b + c0 + pc;
        if (vec && cols == 2) {
          cp_async16(tile + at, acc + i);
        } else {
          for (int c = 0; c < cols; ++c) cp_async8(tile + at + c, acc + i + c);
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
  }
  __syncthreads();
  constexpr int ROWS = ROT_THREADS / BC;  // rows a pass of the block covers
  const int col = threadIdx.x % BC;
  const int r0 = threadIdx.x / BC;
  if (c0 + col >= b) return;  // the last tile may be partial
  const int base = p0 + c0 + col;  // element (p, 0, c0 + col)

  const int two_n = 2 * n;
  long long tt = t[c0 + col] % two_n;
  const int tc = (int)(tt < 0 ? tt + two_n : tt);
#pragma unroll 4
  for (int j = lo + r0; j < hi; j += ROWS) {
    int s = j - tc;  // in (-2N, N)
    if (s < 0) s += two_n;
    const bool neg = s >= n;
    const uint64_t x = tile[(neg ? s - n : s) * BC + col];
    const uint64_t rot = neg ? 0ull - x : x;
    write_digits(rot - tile[j * BC + col], digits, e, base + j * b, count, log_b);
  }
}

bool bad_radix(int count, int log_b) {
  return count < 1 || log_b < 1 || log_b > 31 || count * log_b > 64;
}

int blocks_for(int e, int threads) { return (int)(((long long)e + threads - 1) / threads); }

// One launch of a rotation kernel over acc [P, N, B]. Refuses an N whose
// tile does not fit in a block's shared memory. The card's SM count and
// shared-memory limit, and the kernel's opt-in to that limit, are read
// once a device.
template <bool ACC>
int launch_rotation(const void* acc, const float* ph, const float* pl, const void* t,
                    void* acc_out, float* digits, int e, int n, int b, int count, int log_b,
                    void* stream) {
  constexpr int MAX_DEVICES = 64;
  static int sms_of[MAX_DEVICES], smem_max_of[MAX_DEVICES];  // 0: not read yet
  int dev;
  if (cudaGetDevice(&dev) != cudaSuccess) return spf_last_error();
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms_of[dev] == 0) {
    int sms, smem_max;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess)
      return spf_last_error();
    const cudaError_t attr = cudaFuncSetAttribute(
        rotate_sub_decompose_kernel<ACC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    smem_max_of[dev] = smem_max;
    sms_of[dev] = sms;
  }
  const int sms = sms_of[dev];
  const size_t smem = (size_t)n * BC * sizeof(uint64_t);
  if (smem > (size_t)smem_max_of[dev]) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (b + BC - 1) / BC;
  const long long blocks = (long long)(e / (n * b)) * tiles;  // P * tiles
  // the SMs a tile can have, within [1, MAX_SPLITS] and at most one a row
  const int splits = (int)std::max(1LL, std::min<long long>({sms / blocks, MAX_SPLITS, n}));
  if (blocks * splits > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rotate_sub_decompose_kernel<ACC>
      <<<(unsigned)(blocks * splits), ROT_THREADS, smem, (cudaStream_t)stream>>>(
          static_cast<const uint64_t*>(acc), ph, pl, static_cast<const long long*>(t),
          static_cast<uint64_t*>(acc_out), digits, e, n, b, tiles, splits, count, log_b);
  return spf_last_error();
}

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
  return launch_rotation<false>(acc, nullptr, nullptr, t, nullptr, digits, e, n, b, count, log_b,
                                stream);
}

// acc u64 [E = P * N * B], prod ds pair f32 [E], t int64 [B]
// -> acc_out u64 [E], digits f32 [count, E]
extern "C" int spf_rotate_sub_decompose_acc(const void* acc, const float* ph, const float* pl,
                                            const void* t, void* acc_out, float* digits, int e,
                                            int n, int b, int count, int log_b, void* stream) {
  if (e < 1 || n < 1 || b < 1 || e % (n * b) != 0 || bad_radix(count, log_b))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_rotation<true>(acc, ph, pl, t, acc_out, digits, e, n, b, count, log_b, stream);
}
