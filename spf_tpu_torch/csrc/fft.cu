// The ds32 negacyclic FFT, forward and inverse, in bit-reversed order.
//
// Replaces the Pallas kernels spf_tpu/ops/fft_pallas.py::fwd_ds (:258)
// and inv_ds (:294). Same transform, bit for bit with the plain version
// (spf_tpu_torch/ops/fft.py): the forward folds the N reals of a
// polynomial into K = N/2 complex values, twists them and runs log2(K)
// radix-2 DIF stages (natural order in, bit-reversed out); the inverse
// runs DIT stages from bit-reversed order, untwists (with 1/K) and
// unfolds. Twiddles come from the same host-built table as the plain
// version's ([C, K]: per stage an is_a channel and 4 twiddle channels,
// then 4 twist channels).
//
// What bounds it on an H100: at the main path's shapes (4 polynomials of
// N = 2048 per batch column, B = 256) a forward call moves ~34 MB and needs
// ~(62 K + 53 K log2 K) f32 operations per polynomial (with an fma TwoProd;
// ~0.62 GFLOP), so memory (~10 us at 3.35 TB/s) and f32 throughput (~9 us
// at 67 TFLOP/s) are about even. The Veltkamp TwoProd used here does about
// 1.5x that work for the same bits. Design: one block per (polynomial, BC
// batch columns) keeps its BC ds-complex polynomials (16 KB each at K = 1024) in shared memory
// through every stage, so device memory is read once and written once;
// neighbouring threads take neighbouring batch columns, so those reads and
// writes coalesce. Each thread computes whole butterflies in place.

#include "common.cuh"
#include "ds.cuh"

namespace {

constexpr int BC = 4;   // batch columns per block (threadIdx.x)
constexpr int TY = 64;  // butterfly rows per pass (threadIdx.y)

struct Planes {
  float *rh, *rl, *ih, *il;
  __device__ __forceinline__ dsc load(int i) const { return {rh[i], rl[i], ih[i], il[i]}; }
  __device__ __forceinline__ void store(int i, const dsc& v) const {
    rh[i] = v.rh;
    rl[i] = v.rl;
    ih[i] = v.ih;
    il[i] = v.il;
  }
};

__device__ __forceinline__ Planes smem_planes(float* sm, int k) {
  return {sm, sm + k * BC, sm + 2 * k * BC, sm + 3 * k * BC};
}

__device__ __forceinline__ dsc table(const float* consts, int chan, int k, int r) {
  return {consts[chan * k + r], consts[(chan + 1) * k + r], consts[(chan + 2) * k + r],
          consts[(chan + 3) * k + r]};
}

__global__ void fwd_ds_kernel(const float* __restrict__ hi, const float* __restrict__ lo,
                              const float* __restrict__ consts, float* __restrict__ orh,
                              float* __restrict__ orl, float* __restrict__ oih,
                              float* __restrict__ oil, int k, int log_k, int b) {
  extern __shared__ float sm[];
  const Planes s = smem_planes(sm, k);
  const int x = threadIdx.x, y = threadIdx.y;
  const int col = blockIdx.x * BC + x;
  const bool valid = col < b;
  const size_t in_base = (size_t)blockIdx.y * 2 * k * b;
  const size_t out_base = (size_t)blockIdx.y * k * b;
  const int tb = 5 * log_k;

  // fold z = x[:K] + i x[K:], then twist
  for (int r = y; r < k; r += TY) {
    dsc z = {0.f, 0.f, 0.f, 0.f};
    if (valid) {
      const size_t lo_i = in_base + (size_t)r * b + col;
      const size_t hi_i = in_base + (size_t)(r + k) * b + col;
      z = {hi[lo_i], lo[lo_i], hi[hi_i], lo[hi_i]};
    }
    s.store(r * BC + x, cmul(z, table(consts, tb, k, r)));
  }
  __syncthreads();

  // DIF stages, half = K/2 .. 1: a: x_a + x_b ; b: (x_a - x_b) * w[r_b]
  for (int st = 0; st < log_k; ++st) {
    const int lh = log_k - 1 - st;
    const int half = 1 << lh;
    for (int q = y; q < k / 2; q += TY) {
      const int ra = ((q >> lh) << (lh + 1)) + (q & (half - 1));
      const int rb = ra + half;
      const dsc xa = s.load(ra * BC + x);
      const dsc xb = s.load(rb * BC + x);
      s.store(ra * BC + x, cadd(xa, xb));
      s.store(rb * BC + x, cmul(csub(xa, xb), table(consts, 5 * st + 1, k, rb)));
    }
    __syncthreads();
  }

  if (valid) {
    for (int r = y; r < k; r += TY) {
      const dsc v = s.load(r * BC + x);
      const size_t o = out_base + (size_t)r * b + col;
      orh[o] = v.rh;
      orl[o] = v.rl;
      oih[o] = v.ih;
      oil[o] = v.il;
    }
  }
}

__global__ void inv_ds_kernel(const float* __restrict__ rh, const float* __restrict__ rl,
                              const float* __restrict__ ih, const float* __restrict__ il,
                              const float* __restrict__ consts, float* __restrict__ ohi,
                              float* __restrict__ olo, int k, int log_k, int b) {
  extern __shared__ float sm[];
  const Planes s = smem_planes(sm, k);
  const int x = threadIdx.x, y = threadIdx.y;
  const int col = blockIdx.x * BC + x;
  const bool valid = col < b;
  const size_t in_base = (size_t)blockIdx.y * k * b;
  const size_t out_base = (size_t)blockIdx.y * 2 * k * b;
  const int tb = 5 * log_k;

  for (int r = y; r < k; r += TY) {
    dsc v = {0.f, 0.f, 0.f, 0.f};
    if (valid) {
      const size_t i = in_base + (size_t)r * b + col;
      v = {rh[i], rl[i], ih[i], il[i]};
    }
    s.store(r * BC + x, v);
  }
  __syncthreads();

  // DIT stages, half = 1 .. K/2: t = x_b * w[r_b] ; a: x_a + t ; b: x_a - t
  for (int st = 0; st < log_k; ++st) {
    const int lh = st;
    const int half = 1 << lh;
    for (int q = y; q < k / 2; q += TY) {
      const int ra = ((q >> lh) << (lh + 1)) + (q & (half - 1));
      const int rb = ra + half;
      const dsc xa = s.load(ra * BC + x);
      const dsc t = cmul(s.load(rb * BC + x), table(consts, 5 * st + 1, k, rb));
      s.store(ra * BC + x, cadd(xa, t));
      s.store(rb * BC + x, csub(xa, t));
    }
    __syncthreads();
  }

  // untwist (and 1/K), unfold: hi = [re_hi ; im_hi], lo = [re_lo ; im_lo]
  if (valid) {
    for (int r = y; r < k; r += TY) {
      const dsc v = cmul(s.load(r * BC + x), table(consts, tb, k, r));
      const size_t o0 = out_base + (size_t)r * b + col;
      const size_t o1 = out_base + (size_t)(r + k) * b + col;
      ohi[o0] = v.rh;
      olo[o0] = v.rl;
      ohi[o1] = v.ih;
      olo[o1] = v.il;
    }
  }
}

int log2_exact(int k) {
  int l = 0;
  while ((1 << l) < k) ++l;
  return (1 << l) == k ? l : -1;
}

// Checks the shape and raises the kernel's shared-memory limit; returns 0
// or a cudaError_t.
template <typename Kernel>
int prepare(Kernel kernel, int p, int k, int b, int* log_k, size_t* smem) {
  *log_k = log2_exact(k);
  if (*log_k < 1 || p < 1 || p > 65535 || b < 1) return static_cast<int>(cudaErrorInvalidValue);
  *smem = (size_t)4 * k * BC * sizeof(float);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*smem)));
}

}  // namespace

// hi, lo [P, 2K, B] -> 4 planes [P, K, B]
extern "C" int spf_fwd_ds(const float* hi, const float* lo, const float* consts, float* orh,
                          float* orl, float* oih, float* oil, int p, int k, int b,
                          void* stream) {
  int log_k;
  size_t smem;
  if (int err = prepare(fwd_ds_kernel, p, k, b, &log_k, &smem)) return err;
  const dim3 grid((b + BC - 1) / BC, p), block(BC, TY);
  fwd_ds_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(hi, lo, consts, orh, orl, oih, oil,
                                                             k, log_k, b);
  return spf_last_error();
}

// 4 planes [P, K, B] -> hi, lo [P, 2K, B]
extern "C" int spf_inv_ds(const float* rh, const float* rl, const float* ih, const float* il,
                          const float* consts, float* ohi, float* olo, int p, int k, int b,
                          void* stream) {
  int log_k;
  size_t smem;
  if (int err = prepare(inv_ds_kernel, p, k, b, &log_k, &smem)) return err;
  const dim3 grid((b + BC - 1) / BC, p), block(BC, TY);
  inv_ds_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(rh, rl, ih, il, consts, ohi, olo, k,
                                                             log_k, b);
  return spf_last_error();
}
