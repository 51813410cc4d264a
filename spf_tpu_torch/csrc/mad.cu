// Multi-bit MAD + Horner subset phases, the frequency-domain half of a
// blind-rotation step.
//
// Replaces the Pallas kernel spf_tpu/ops/mad_pallas.py::mad_horner_fused
// (:94). For every (bin, batch column) it forms the 2^g - 1 subset MADs
// of the l*(k+1) digit spectra with that subset's bootstrap-key row, then
// their Horner-factored sum with the per-bit (phase - 1) factors u_j:
//
//   R(j, base) = u_j (x) (M[base|2^j] + R(j+1, base|2^j)) + R(j+1, base)
//
// in the evaluation order of _mad_horner_body (mad_pallas.py:51-90), so
// it agrees with the plain version (freq_mad per subset +
// nested_subset_sum) bit for bit. Unlike the TPU kernel it takes any K and
// B, not only multiples of 128. Built for k+1 = 2 (every parameter set's
// blind rotation has k = 1) and g = 3 (the multi-bit PBS), g = 2 (the
// multi-bit rotation inside circuit bootstrapping, l = 4) and g = 1 (the
// single-bit phase_rot step: one MAD times (phase - 1), the order of
// bootstrap_u32.py:278-280). g = 0 is the plain MAD of one key row with
// no phase (freq_mad, bootstrap_u32.py:161; XLA glue on the TPU), the
// frequency-domain half of the single-bit plain and fuse_rot steps.
//
// What bounds it on an H100: f32 throughput. At the main path's shapes (g = 3,
// k+1 = 2, l = 2, K = 1024, B = 256) it moves ~39 MB but needs
// 7 * 2 * 2 * 2 * 84 + 2 * (7 * 62 + 6 * 22) ~ 5.8k f32 operations per
// element (a ds complex multiply with an fma TwoProd is 62, an add 22;
// ~1.5 GFLOP, ~23 us at 67 TFLOP/s vs ~12 us of memory). The Veltkamp
// TwoProd used here does about 1.7x that work for the same bits. Design:
// one thread per (bin, column); the 2^g - 1 subset accumulators of both
// output planes live in registers; neighbouring threads take neighbouring
// columns (coalesced spectra, phases and outputs) and share one bin, so
// the key-row reads are warp broadcasts.

#include "common.cuh"
#include "ds.cuh"

namespace {

struct Planes4 {
  const float *rh, *rl, *ih, *il;
  __device__ __forceinline__ dsc load(size_t i) const { return {rh[i], rl[i], ih[i], il[i]}; }
};

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
__global__ void mad_horner_kernel(Planes4 dfft, Planes4 row, Planes4 u, float* __restrict__ orh,
                                  float* __restrict__ orl, float* __restrict__ oih,
                                  float* __restrict__ oil, int l, int k, int b) {
  constexpr int NS = G == 0 ? 1 : (1 << G) - 1;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;  // bin * B + column
  if (idx >= k * b) return;
  const int bin = idx / b;
  const size_t plane = (size_t)k * b;

  dsc mads[NS][KP1];
#pragma unroll
  for (int m = 0; m < NS; ++m)
#pragma unroll
    for (int o = 0; o < KP1; ++o) mads[m][o] = {0.f, 0.f, 0.f, 0.f};

  // MAD: for each input plane i, digit level j: acc[m][o] += d[j, i] * row[m, i, j, o]
#pragma unroll
  for (int i = 0; i < KP1; ++i) {
    for (int j = 0; j < l; ++j) {
      const dsc d = dfft.load((size_t)(j * KP1 + i) * plane + idx);
#pragma unroll
      for (int m = 0; m < NS; ++m) {
#pragma unroll
        for (int o = 0; o < KP1; ++o) {
          const size_t r = ((((size_t)m * KP1 + i) * l + j) * KP1 + o) * k + bin;
          mads[m][o] = cadd(mads[m][o], cmul(d, row.load(r)));
        }
      }
    }
  }

  dsc uu[G == 0 ? 1 : G];
#pragma unroll
  for (int j = 0; j < G; ++j) uu[j] = u.load((size_t)j * plane + idx);

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

template <int KP1, int G>
int launch(const Planes4& d, const Planes4& r, const Planes4& u, float* o0, float* o1, float* o2,
           float* o3, int l, int k, int b, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (int)(((long long)k * b + threads - 1) / threads);
  mad_horner_kernel<KP1, G><<<blocks, threads, 0, stream>>>(d, r, u, o0, o1, o2, o3, l, k, b);
  return spf_last_error();
}

}  // namespace

// dfft 4 x [l, k+1, K, B]; row 4 x [2^g-1, k+1, l, k+1, K]; u 4 x [g, K, B]
// -> out 4 x [k+1, K, B]. g = 0: row 4 x [k+1, l, k+1, K], u unread.
extern "C" int spf_mad_horner(const float* d0, const float* d1, const float* d2, const float* d3,
                              const float* r0, const float* r1, const float* r2, const float* r3,
                              const float* u0, const float* u1, const float* u2, const float* u3,
                              float* o0, float* o1, float* o2, float* o3, int kp1, int l, int g,
                              int k, int b, void* stream) {
  if (l < 1 || k < 1 || b < 1 || (long long)k * b >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const Planes4 d{d0, d1, d2, d3}, r{r0, r1, r2, r3}, u{u0, u1, u2, u3};
  cudaStream_t s = (cudaStream_t)stream;
  if (kp1 == 2) {
    switch (g) {
      case 0: return launch<2, 0>(d, r, u, o0, o1, o2, o3, l, k, b, s);
      case 1: return launch<2, 1>(d, r, u, o0, o1, o2, o3, l, k, b, s);
      case 2: return launch<2, 2>(d, r, u, o0, o1, o2, o3, l, k, b, s);
      case 3: return launch<2, 3>(d, r, u, o0, o1, o2, o3, l, k, b, s);
      default: break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
