// Double-single (f32 pair) arithmetic for the kernels, in exactly the
// order of operations of spf_tpu_torch/ops/ds.py (itself that of
// spf_tpu/ops/ds.py and fft_ds32_t._cadd/_csub/_cmul), so that a kernel
// and the plain PyTorch version agree bit for bit.
//
// Every source is compiled with -fmad=false and without fast-math: a
// contracted a*b - p, or an fma in ds_mul's cross terms, would change the
// roundings the error-free transforms depend on. The one fma is explicit:
// TwoProd's error is __fmaf_rn(a, b, -p), the exact a*b - p rounded once
// (an intrinsic, so -fmad=false leaves it alone). The plain version rounds
// the same exact value once through f64, so the two agree everywhere,
// subnormals included; the reference's Veltkamp split gives the same bits
// wherever no partial product underflows, in 2 instructions instead of 17.
#pragma once

struct ds2 {
  float h, l;
};

// a complex ds value: (re_hi, re_lo, im_hi, im_lo)
struct dsc {
  float rh, rl, ih, il;
};

__device__ __forceinline__ ds2 two_sum(float a, float b) {
  float s = a + b;
  float bb = s - a;
  float err = (a - (s - bb)) + (b - bb);
  return {s, err};
}

__device__ __forceinline__ ds2 quick_two_sum(float a, float b) {
  float s = a + b;
  float err = b - (s - a);
  return {s, err};
}

__device__ __forceinline__ ds2 two_prod(float a, float b) {
  float p = a * b;
  return {p, __fmaf_rn(a, b, -p)};
}

__device__ __forceinline__ ds2 ds_add(float ahi, float alo, float bhi, float blo) {
  ds2 s = two_sum(ahi, bhi);
  float e = s.l + (alo + blo);
  return quick_two_sum(s.h, e);
}

__device__ __forceinline__ ds2 ds_sub(float ahi, float alo, float bhi, float blo) {
  return ds_add(ahi, alo, -bhi, -blo);
}

__device__ __forceinline__ ds2 ds_mul(float ahi, float alo, float bhi, float blo) {
  ds2 p = two_prod(ahi, bhi);
  float e = p.l + (ahi * blo + alo * bhi);
  return quick_two_sum(p.h, e);
}

__device__ __forceinline__ dsc cadd(const dsc& a, const dsc& b) {
  ds2 r = ds_add(a.rh, a.rl, b.rh, b.rl);
  ds2 i = ds_add(a.ih, a.il, b.ih, b.il);
  return {r.h, r.l, i.h, i.l};
}

__device__ __forceinline__ dsc csub(const dsc& a, const dsc& b) {
  ds2 r = ds_sub(a.rh, a.rl, b.rh, b.rl);
  ds2 i = ds_sub(a.ih, a.il, b.ih, b.il);
  return {r.h, r.l, i.h, i.l};
}

__device__ __forceinline__ dsc cmul(const dsc& a, const dsc& b) {
  ds2 pr = ds_mul(a.rh, a.rl, b.rh, b.rl);
  ds2 qr = ds_mul(a.ih, a.il, b.ih, b.il);
  ds2 r = ds_sub(pr.h, pr.l, qr.h, qr.l);
  ds2 pi = ds_mul(a.rh, a.rl, b.ih, b.il);
  ds2 qi = ds_mul(a.ih, a.il, b.rh, b.rl);
  ds2 i = ds_add(pi.h, pi.l, qi.h, qi.l);
  return {r.h, r.l, i.h, i.l};
}
