// Multi-bit MAD + Horner subset phases, the frequency-domain half of a
// blind-rotation step, with the step's (phase - 1) factors formed inside.
//
// Replaces the Pallas kernel spf_tpu/ops/mad_pallas.py::mad_horner_fused
// (:94) together with the per-bit phase combine that XLA fuses around it
// on the TPU (spf_tpu/ops/multibit.py:213-245). For every (bin, batch
// column) it forms the per-bit factors u_j from the step's hoisted
// outer-product halves, as combine_phase_minus_one does
// (spf_tpu_torch/ops/phase_rot.py):
//
//   u_j = cmul(hi[j][bin / Klo], lo[j][bin % Klo]), then -1 on the real part
//
// then the 2^g - 1 subset MADs of the l*(k+1) digit spectra with that
// subset's bootstrap-key row, then their Horner-factored sum:
//
//   R(j, base) = u_j (x) (M[base|2^j] + R(j+1, base|2^j)) + R(j+1, base)
//
// in the evaluation order of _mad_horner_body (mad_pallas.py:51-90), so it
// agrees with the plain version (combine_phase_minus_one per bit, freq_mad
// per subset, nested_subset_sum) bit for bit. It takes any B and any
// K = Klo * Khi up to 65,535, not only multiples of 128. Built for g = 3
// (the multi-bit PBS), g = 2 (the multi-bit rotation inside circuit
// bootstrapping, l = 4) and g = 1 (the single-bit phase_rot step: one MAD
// times (phase - 1), the order of bootstrap_u32.py:278-280). g = 0 is the
// plain MAD of one key row with no phase (freq_mad, bootstrap_u32.py:161;
// XLA glue on the TPU), the frequency-domain half of the single-bit plain
// and fuse_rot steps. k+1 = 2 (DEFAULT_128 and every 128-bit set but one)
// has its own instances, below. Any other k+1 (the test sets' 3 and 4,
// GLWE_5_256_128's 6) runs mad_plane_kernel: k+1 is a runtime loop bound
// there and a block computes one output plane, so its registers do not grow
// with k+1 (the accumulators of all k+1 planes at k+1 = 6, g = 3 would be
// 168 floats). Each output plane's sums run in the same order as in the
// k+1 = 2 instances, so the bits are the same.
//
// What bounds it on an H100: f32 instruction issue. At the main path's
// shapes (g = 3, k+1 = 2, l = 2, K = 1024, B = 256) it moves ~27 MB (~8 us
// at 3.35 TB/s) but issues 4 * 14 * (58 + 22) + 2 * (7 * 58 + 6 * 22) +
// 3 * 69 = 5,763 f32 instructions per (bin, column) (a ds complex multiply
// is 58 with the fma TwoProd, an add 22, a combine 69): 1.5 G, ~45 us at
// 128 a clock per SM. Almost all are single FADD / FMUL, one result per
// lane and clock, so the flop rate (which counts an FFMA twice) halves
// this bound. Tensor cores cannot help: ds32 needs exact f32 products,
// which TF32 and bf16 do not give.
//
// Design: the instruction count first. TwoProd is one fma (ds.cuh), 2
// instructions where the Veltkamp split took 17; the combine costs 69 per
// bit in registers instead of a 12.6 MB intermediate and ~60 eager
// operators a bit. A block is up to 128 columns of one bin (grid: column
// tiles x bins). It stages the bin's key rows in shared memory as 16-byte
// (re hi, re lo, im hi, im lo) entries, so each key read of the MAD is one
// broadcast 16-byte shared load at a fixed offset instead of four
// warp-broadcast global loads and their 64-bit address arithmetic. One
// thread per (bin, column): the 2^g - 1 subset accumulators of both output
// planes (56 floats at g = 3) and the g factors live in registers, with no
// spills; neighbouring threads take neighbouring columns (coalesced
// spectra, halves and outputs). At g = 3 the (i, j) loop of the MAD stays
// rolled: unrolled over i, the kernel's code (~4k instructions) outgrows
// the instruction cache, which cost 12% on an H100; at g <= 2 the unrolled
// form is the faster one.

#include "common.cuh"
#include "ds.cuh"

namespace {

constexpr int THREADS = 128;
// multiply-adds per (i, j) above which the (i, j) loop stays rolled
constexpr int ROLL_ABOVE = 8;

struct Planes4 {
  const float *rh, *rl, *ih, *il;
  __device__ __forceinline__ dsc load(size_t i) const {
    return {__ldg(rh + i), __ldg(rl + i), __ldg(ih + i), __ldg(il + i)};
  }
};

// The step's (phase - 1) factor of each bit j < G at (bin, col):
// u_j = cmul(hi[j][bin / Klo], lo[j][bin % Klo]) - 1 (combine_phase_minus_one)
template <int G>
__device__ __forceinline__ void step_factors(const Planes4& lo, const Planes4& hi, int bin,
                                             int col, int k, int b, int klo, dsc* uu) {
  const int khi = k / klo;
  const size_t lo_at = (size_t)(bin % klo) * b + col;
  const size_t hi_at = (size_t)(bin / klo) * b + col;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const dsc f = cmul(hi.load((size_t)j * khi * b + hi_at), lo.load((size_t)j * klo * b + lo_at));
    const ds2 re = ds_add(f.rh, f.rl, -1.0f, 0.0f);
    uu[j] = {re.h, re.l, f.ih, f.il};
  }
}

// R(J, BASE) over the subset MADs M[0 .. 2^G - 2] of one output plane
template <int G, int J, int BASE>
struct Horner {
  static __device__ __forceinline__ dsc eval(const dsc* m, const dsc* u) {
    constexpr int WITH = BASE | (1 << J);
    if constexpr (J + 1 == G) {
      return cmul(m[WITH - 1], u[J]);
    } else {
      const dsc t = cadd(m[WITH - 1], Horner<G, J + 1, WITH>::eval(m, u));
      const dsc term = cmul(t, u[J]);
      return cadd(term, Horner<G, J + 1, BASE>::eval(m, u));
    }
  }
};

template <int KP1, int G>
__global__ void __launch_bounds__(THREADS)
    mad_horner_kernel(Planes4 dfft, Planes4 row, Planes4 lo, Planes4 hi, float* __restrict__ orh,
                      float* __restrict__ orl, float* __restrict__ oih, float* __restrict__ oil,
                      int l, int k, int b, int klo) {
  constexpr int NS = G == 0 ? 1 : (1 << G) - 1;
  constexpr int PER_IJ = NS * KP1;  // key-row values per (input plane, digit level)
  extern __shared__ float4 key[];   // [l][k+1][NS][k+1]: this bin's key rows
  const int bin = blockIdx.y;
  const int col = blockIdx.x * THREADS + threadIdx.x;

  // the block's bin's key rows, row[m, i, j, o] -> key[(j * KP1 + i) * PER_IJ + m * KP1 + o]
  for (int e = threadIdx.x; e < PER_IJ * KP1 * l; e += THREADS) {
    const int o = e % KP1, m = e / KP1 % NS, i = e / PER_IJ % KP1, j = e / (PER_IJ * KP1);
    const dsc r = row.load((size_t)(((m * KP1 + i) * l + j) * KP1 + o) * k + bin);
    key[e] = make_float4(r.rh, r.rl, r.ih, r.il);
  }
  __syncthreads();
  if (col >= b) return;
  const size_t plane = (size_t)k * b;
  const size_t idx = (size_t)bin * b + col;

  dsc uu[G == 0 ? 1 : G];
  if constexpr (G > 0) step_factors<G>(lo, hi, bin, col, k, b, klo, uu);

  dsc mads[NS][KP1];
#pragma unroll
  for (int m = 0; m < NS; ++m)
#pragma unroll
    for (int o = 0; o < KP1; ++o) mads[m][o] = {0.f, 0.f, 0.f, 0.f};

  // MAD: for each input plane i, digit level j: acc[m][o] += d[j, i] * row[m, i, j, o]
  const auto step = [&](int i, int j) {
    const dsc d = dfft.load((size_t)(j * KP1 + i) * plane + idx);
    const float4* kij = key + (j * KP1 + i) * PER_IJ;
#pragma unroll
    for (int m = 0; m < NS; ++m) {
#pragma unroll
      for (int o = 0; o < KP1; ++o) {
        const float4 r = kij[m * KP1 + o];  // one broadcast 16-byte shared load
        mads[m][o] = cadd(mads[m][o], cmul(d, {r.x, r.y, r.z, r.w}));
      }
    }
  };
  if constexpr (NS * KP1 > ROLL_ABOVE) {
    // one loop body of NS * KP1 multiply-adds: unrolled over i, the kernel's
    // code outgrows the instruction cache
#pragma unroll 1
    for (int ij = 0; ij < KP1 * l; ++ij) step(ij / l, ij % l);
  } else {
#pragma unroll
    for (int i = 0; i < KP1; ++i)
      for (int j = 0; j < l; ++j) step(i, j);
  }

#pragma unroll
  for (int o = 0; o < KP1; ++o) {
    dsc v;
    if constexpr (G == 0) {
      v = mads[0][o];
    } else {
      dsc mo[NS];
#pragma unroll
      for (int m = 0; m < NS; ++m) mo[m] = mads[m][o];
      v = Horner<G, 0, 0>::eval(mo, uu);
    }
    const size_t out = (size_t)o * plane + idx;
    orh[out] = v.rh;
    orl[out] = v.rl;
    oih[out] = v.ih;
    oil[out] = v.il;
  }
}

// The MAD for any k+1: one output plane o = blockIdx.z a block, the input
// planes i a runtime loop; otherwise mad_horner_kernel's steps in its order.
template <int G>
__global__ void __launch_bounds__(THREADS)
    mad_plane_kernel(Planes4 dfft, Planes4 row, Planes4 lo, Planes4 hi, float* __restrict__ orh,
                     float* __restrict__ orl, float* __restrict__ oih, float* __restrict__ oil,
                     int kp1, int l, int k, int b, int klo) {
  constexpr int NS = G == 0 ? 1 : (1 << G) - 1;
  extern __shared__ float4 key[];  // [k+1][l][NS]: this bin's key rows into plane o
  const int bin = blockIdx.y;
  const int o = blockIdx.z;
  const int col = blockIdx.x * THREADS + threadIdx.x;

  // row[m, i, j, o] -> key[(i * l + j) * NS + m]
  for (int e = threadIdx.x; e < NS * kp1 * l; e += THREADS) {
    const int m = e % NS, ij = e / NS;
    const dsc r = row.load((size_t)(((m * kp1 + ij / l) * l + ij % l) * kp1 + o) * k + bin);
    key[e] = make_float4(r.rh, r.rl, r.ih, r.il);
  }
  __syncthreads();
  if (col >= b) return;
  const size_t plane = (size_t)k * b;
  const size_t idx = (size_t)bin * b + col;

  dsc uu[G == 0 ? 1 : G];
  if constexpr (G > 0) step_factors<G>(lo, hi, bin, col, k, b, klo, uu);

  dsc mads[NS];
#pragma unroll
  for (int m = 0; m < NS; ++m) mads[m] = {0.f, 0.f, 0.f, 0.f};
  // for each input plane i, digit level j (i outer): acc[m] += d[j, i] * row[m, i, j, o]
#pragma unroll 1
  for (int ij = 0; ij < kp1 * l; ++ij) {
    const dsc d = dfft.load((size_t)(ij % l * kp1 + ij / l) * plane + idx);
    const float4* kij = key + ij * NS;
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      const float4 r = kij[m];
      mads[m] = cadd(mads[m], cmul(d, {r.x, r.y, r.z, r.w}));
    }
  }

  dsc v;
  if constexpr (G == 0) {
    v = mads[0];
  } else {
    v = Horner<G, 0, 0>::eval(mads, uu);
  }
  const size_t out = (size_t)o * plane + idx;
  orh[out] = v.rh;
  orl[out] = v.rl;
  oih[out] = v.ih;
  oil[out] = v.il;
}

template <int G>
int launch_planes(const Planes4& d, const Planes4& r, const Planes4& lo, const Planes4& hi,
                  float* o0, float* o1, float* o2, float* o3, int kp1, int l, int k, int b,
                  int klo, cudaStream_t stream) {
  constexpr int NS = G == 0 ? 1 : (1 << G) - 1;
  const size_t smem = sizeof(float4) * NS * kp1 * l;
  if (k > 65535 || kp1 > 65535 || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((b + THREADS - 1) / THREADS, k, kp1);
  mad_plane_kernel<G><<<grid, THREADS, smem, stream>>>(d, r, lo, hi, o0, o1, o2, o3, kp1, l, k,
                                                       b, klo);
  return spf_last_error();
}

template <int KP1, int G>
int launch(const Planes4& d, const Planes4& r, const Planes4& lo, const Planes4& hi, float* o0,
           float* o1, float* o2, float* o3, int l, int k, int b, int klo, cudaStream_t stream) {
  constexpr int NS = G == 0 ? 1 : (1 << G) - 1;
  const size_t smem = sizeof(float4) * NS * KP1 * KP1 * l;
  if (k > 65535 || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((b + THREADS - 1) / THREADS, k);
  mad_horner_kernel<KP1, G><<<grid, THREADS, smem, stream>>>(d, r, lo, hi, o0, o1, o2, o3, l, k, b,
                                                            klo);
  return spf_last_error();
}

}  // namespace

// dfft 4 x [l, k+1, K, B]; row 4 x [2^g-1, k+1, l, k+1, K]; the step's
// phase factor halves lo 4 x [g, Klo, B] and hi 4 x [g, K / Klo, B]
// -> out 4 x [k+1, K, B]. g = 0: row 4 x [k+1, l, k+1, K], lo and hi unread.
extern "C" int spf_mad_horner(const float* d0, const float* d1, const float* d2, const float* d3,
                              const float* r0, const float* r1, const float* r2, const float* r3,
                              const float* lo0, const float* lo1, const float* lo2,
                              const float* lo3, const float* hi0, const float* hi1,
                              const float* hi2, const float* hi3, float* o0, float* o1, float* o2,
                              float* o3, int kp1, int l, int g, int k, int b, int klo,
                              void* stream) {
  if (kp1 < 1 || l < 1 || k < 1 || b < 1 || (long long)k * b >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (g > 0 && (klo < 1 || k % klo != 0)) return static_cast<int>(cudaErrorInvalidValue);
  const Planes4 d{d0, d1, d2, d3}, r{r0, r1, r2, r3}, lo{lo0, lo1, lo2, lo3},
      hi{hi0, hi1, hi2, hi3};
  cudaStream_t s = (cudaStream_t)stream;
  if (kp1 == 2) {
    switch (g) {
      case 0: return launch<2, 0>(d, r, lo, hi, o0, o1, o2, o3, l, k, b, klo, s);
      case 1: return launch<2, 1>(d, r, lo, hi, o0, o1, o2, o3, l, k, b, klo, s);
      case 2: return launch<2, 2>(d, r, lo, hi, o0, o1, o2, o3, l, k, b, klo, s);
      case 3: return launch<2, 3>(d, r, lo, hi, o0, o1, o2, o3, l, k, b, klo, s);
      default: break;
    }
  } else {
    switch (g) {
      case 0: return launch_planes<0>(d, r, lo, hi, o0, o1, o2, o3, kp1, l, k, b, klo, s);
      case 1: return launch_planes<1>(d, r, lo, hi, o0, o1, o2, o3, kp1, l, k, b, klo, s);
      case 2: return launch_planes<2>(d, r, lo, hi, o0, o1, o2, o3, kp1, l, k, b, klo, s);
      case 3: return launch_planes<3>(d, r, lo, hi, o0, o1, o2, o3, kp1, l, k, b, klo, s);
      default: break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
