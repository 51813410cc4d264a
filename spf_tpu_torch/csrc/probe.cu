// Probes of the card's raw rates: the kernels of
// spf_tpu_torch/scripts/vpu_probe.py, which hold each against its plain
// PyTorch version there.
//
// Replaces the Pallas kernels of scripts/vpu_probe.py:
//
//   chain_kernel (:44)   a dependent chain of `iters` element-wise ops per
//                        element, resident on chip; 11 bodies: f32 mul, add,
//                        mul+add, 2mul+1add, mul/select (:75-82) and i32
//                        mul, add, mul+add, shift, and, "fermat" (:127-135)
//   fma_probe (:94)      e = a·b − p with p = a·b: 0 unless the compiler
//                        contracts it to an fma, which gives the exact error
//   roll_run (:178)      `iters` steps of roll(v, 8, axis=0) + 1.0
//
// What bounds them on an H100: the chains and the roll are bounded by the
// card's peak rate for the instructions of their step, on the pipes that can
// take them (spf_tpu_torch/scripts/__init__.py, steps_per_clock): a 1-op f32
// chain at [1024, 512], 400 steps, is 2.1e8 operations at 128 a clock per SM,
// ~6.3 us at 132 SMs and ~1.98 GHz, against ~1.25 us for its 4 MiB of device
// memory traffic. fma_probe moves 6 MiB: ~1.9 us.
//
// Design. chain: one thread per element, its value in a register for all
// steps. The f32 constants are the f32 roundings of the script's Python
// floats (1.000001, 1e-7, 2e-7), as JAX's weak typing gives them; with
// -fmad=false and no fast-math the compiler may neither contract nor
// re-associate, so each step's ops are issued as written. The i32 bodies run
// on uint32_t (signed overflow is undefined in C++; JAX and PyTorch int32
// wrap) and shift arithmetically, as jnp's and torch's >> do. Each integer
// op is emitted as its own gated PTX op (below), so that neither NVVM nor
// ptxas can fold the chain into a closed form (v + 3 four hundred times
// into v + 1200) or merge two ops into one instruction; chip_smoke.py's
// build phase counts each chain kernel's SASS opcodes.
// fma_probe: two entry points, `a*b - p` as written (0 under -fmad=false)
// and __fmaf_rn(a, b, -p) (the exact error term).
// roll: a roll only permutes, and every element takes the same `iters` adds
// of 1.0f in the same order wherever it sits, so out[r, c] is
// x[(r − iters·shift) mod rows, c] followed by those adds: the roll is
// carried in the index. On the flat index e = r·cols + c the source is
// (e − off·cols) mod rows·cols, off = iters·shift mod rows (reduced in
// 64-bit, so iters·shift may exceed 2^31). A thread loads ROLL_CHAINS
// elements ROLL_THREADS apart (each warp load 128 contiguous bytes but at
// the wrap), runs their chains interleaved in registers, ROLL_UNROLL steps
// a loop iteration, and stores each once: no shared memory, no barrier. At
// [1024, 512] that is 1024 blocks of 256 threads, one wave on 132 SMs (62
// warps an SM, two chains each). Two chains of 16 steps an iteration timed
// fastest; 1, 4 or 8 chains, or 4 or 8 steps, 1-9% slower (PERF.md).
// Without fast-math the adds of one chain can be neither merged nor
// reordered (chip_smoke.py's build phase counts the loop's FADDs).

#include <cstdint>

#include "common.cuh"

namespace {

// the f32 roundings of 1.000001, 0.0000001 and 0.0000002
constexpr float C1 = 0x1.00001p+0f;
constexpr float C2 = 0x1.ad7f2ap-24f;
constexpr float C3 = 0x1.ad7f2ap-23f;

// The i32 chains. ptxas folds a chain of PTX ops on an immediate (four
// multiplies by 3 into one by 81) as freely as NVVM folds one in C++, drops
// a repeated `and` with the same register, and pairs two dependent adds into
// one three-input IADD3 (a mul and an add into one IMAD). So every op is an
// asm volatile PTX op on register operands (the constants 3, 0xFFFF and 16
// arrive as kernel arguments), predicated on one of two gates that are
// always true but that ptxas cannot see: two neighbouring ops never share a
// gate, and no rewrite that merges them is valid without knowing both.
struct iconst {
  uint32_t k, mask, shift;
  uint32_t gate[2];  // both nonzero
};

#define SPF_GATED_OP(NAME, OP)                                                  \
  __device__ __forceinline__ void NAME(uint32_t& x, uint32_t b, uint32_t gate) { \
    asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %2, 0;\n\t@p " OP      \
                 " %0, %0, %1;\n\t}"                                            \
                 : "+r"(x)                                                      \
                 : "r"(b), "r"(gate));                                          \
  }
SPF_GATED_OP(imul, "mul.lo.u32")
SPF_GATED_OP(iadd, "add.u32")
SPF_GATED_OP(isub, "sub.u32")
SPF_GATED_OP(isra, "shr.s32")
SPF_GATED_OP(iand, "and.b32")
#undef SPF_GATED_OP

// bodies 0-4: f32; 5-10: i32 (in the order of vpu_probe.py's BODIES)
template <int BODY>
__device__ __forceinline__ float fstep(float v) {
  if constexpr (BODY == 0) return v * C1;
  else if constexpr (BODY == 1) return v + C2;
  else if constexpr (BODY == 2) return v * C1 + C2;
  else if constexpr (BODY == 3) return (v * C1) + (v * C3);
  else return v > 0.0f ? v * C1 : v + C2;
}

// one step of an i32 body; g and h are the two gates, swapped every step
template <int BODY>
__device__ __forceinline__ uint32_t istep(uint32_t v, const iconst& c, uint32_t g, uint32_t h) {
  if constexpr (BODY == 5) {
    imul(v, c.k, g);
  } else if constexpr (BODY == 6) {
    iadd(v, c.k, g);
  } else if constexpr (BODY == 7) {
    imul(v, c.k, g);
    iadd(v, c.k, h);
  } else if constexpr (BODY == 8) {
    isra(v, c.shift, g);
  } else if constexpr (BODY == 9) {
    iand(v, c.mask, g);
  } else {  // (v & mask) - (v >> shift) + v * k
    uint32_t a = v, b = v, m = v;
    iand(a, c.mask, g);
    isra(b, c.shift, h);
    imul(m, c.k, g);
    isub(a, b, g);
    iadd(a, m, h);
    v = a;
  }
  return v;
}

template <int BODY>
__global__ void chain_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int n,
                             int iters, iconst c) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  if constexpr (BODY < 5) {
    float v = __uint_as_float(x[e]);
    for (int i = 0; i < iters; ++i) v = fstep<BODY>(v);
    out[e] = __float_as_uint(v);
  } else {
    uint32_t v = x[e];
    int i = 0;
    for (; i + 1 < iters; i += 2) {
      v = istep<BODY>(v, c, c.gate[0], c.gate[1]);
      v = istep<BODY>(v, c, c.gate[1], c.gate[0]);
    }
    if (i < iters) v = istep<BODY>(v, c, c.gate[0], c.gate[1]);
    out[e] = v;
  }
}

template <int BODY>
int launch_chain(const uint32_t* x, uint32_t* out, int n, int iters, cudaStream_t s) {
  chain_kernel<BODY><<<(n + 255) / 256, 256, 0, s>>>(x, out, n, iters, iconst{3u, 0xFFFFu, 16u, {1u, 1u}});
  return spf_last_error();
}

__global__ void fma_probe_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                 float* __restrict__ e, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float p = a[i] * b[i];
  e[i] = a[i] * b[i] - p;
}

__global__ void fma_probe_fma_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                     float* __restrict__ e, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float p = a[i] * b[i];
  e[i] = __fmaf_rn(a[i], b[i], -p);
}

constexpr int ROLL_THREADS = 256;
constexpr int ROLL_CHAINS = 2;   // independent elements a thread
constexpr int ROLL_UNROLL = 16;  // steps a loop iteration

// n = rows·cols elements; back = off·cols, in [0, n)
__global__ void __launch_bounds__(ROLL_THREADS)
    roll_kernel(const float* __restrict__ x, float* __restrict__ out, long long n, long long back,
                int iters) {
  const long long base = (long long)blockIdx.x * (ROLL_THREADS * ROLL_CHAINS) + threadIdx.x;
  float v[ROLL_CHAINS];
#pragma unroll
  for (int i = 0; i < ROLL_CHAINS; ++i) {
    const long long e = base + i * ROLL_THREADS;
    v[i] = e < n ? __ldg(x + (e >= back ? e - back : e - back + n)) : 0.0f;
  }
  int s = 0;
  for (; s + ROLL_UNROLL <= iters; s += ROLL_UNROLL) {
#pragma unroll
    for (int u = 0; u < ROLL_UNROLL; ++u)
#pragma unroll
      for (int i = 0; i < ROLL_CHAINS; ++i) v[i] += 1.0f;
  }
  for (; s < iters; ++s)
#pragma unroll
    for (int i = 0; i < ROLL_CHAINS; ++i) v[i] += 1.0f;
#pragma unroll
  for (int i = 0; i < ROLL_CHAINS; ++i) {
    const long long e = base + i * ROLL_THREADS;
    if (e < n) out[e] = v[i];
  }
}

}  // namespace

// x, out: n 32-bit elements (f32 for bodies 0-4, i32 for 5-10)
extern "C" int spf_chain(const void* x, void* out, int n, int iters, int body, void* stream) {
  if (n < 1 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xi = static_cast<const uint32_t*>(x);
  auto* oi = static_cast<uint32_t*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (body) {
    case 0: return launch_chain<0>(xi, oi, n, iters, s);
    case 1: return launch_chain<1>(xi, oi, n, iters, s);
    case 2: return launch_chain<2>(xi, oi, n, iters, s);
    case 3: return launch_chain<3>(xi, oi, n, iters, s);
    case 4: return launch_chain<4>(xi, oi, n, iters, s);
    case 5: return launch_chain<5>(xi, oi, n, iters, s);
    case 6: return launch_chain<6>(xi, oi, n, iters, s);
    case 7: return launch_chain<7>(xi, oi, n, iters, s);
    case 8: return launch_chain<8>(xi, oi, n, iters, s);
    case 9: return launch_chain<9>(xi, oi, n, iters, s);
    case 10: return launch_chain<10>(xi, oi, n, iters, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// e = a*b - p, p = a*b, as written: 0 without contraction
extern "C" int spf_fma_probe(const float* a, const float* b, float* e, int n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  fma_probe_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(a, b, e, n);
  return spf_last_error();
}

// e = fma(a, b, -p), p = a*b: the exact error of the product
extern "C" int spf_fma_probe_fma(const float* a, const float* b, float* e, int n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  fma_probe_fma_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(a, b, e, n);
  return spf_last_error();
}

// x, out f32 [rows, cols]; out = `iters` steps of roll(v, shift, 0) + 1.0,
// shift in [0, rows)
extern "C" int spf_roll(const float* x, float* out, int rows, int cols, int shift, int iters,
                        void* stream) {
  if (rows < 1 || cols < 1 || shift < 0 || shift >= rows || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = (long long)rows * cols;
  const long long off = (long long)(iters % rows) * shift % rows;
  const long long per_block = ROLL_THREADS * ROLL_CHAINS;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  roll_kernel<<<(unsigned)blocks, ROLL_THREADS, 0, (cudaStream_t)stream>>>(x, out, n, off * cols,
                                                                          iters);
  return spf_last_error();
}
