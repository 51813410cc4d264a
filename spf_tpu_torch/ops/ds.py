"""Double-single (f32 pair) arithmetic: error-free transformations.

A ds number `hi + lo` (|lo| <= ulp(hi)/2) carries about 48 mantissa
bits. Every function keeps the order of operations of `spf_tpu/ops/ds.py`
and of `fft_ds32_t._cadd/_csub/_cmul`, so that the port's results are
bit-identical to the reference's run op by op. Nothing here may be
rewritten into an algebraically equal form: the error terms depend on
the exact sequence of f32 roundings (and on no fused multiply-add, which
PyTorch's elementwise operators never introduce across operators).

The one exception is TwoProd's error term, which is defined by its value,
not by a sequence of roundings: the exact a*b - p rounded once to f32.
The port computes it through f64 (`two_prod`), the kernels with one fma
(`csrc/ds.cuh`); both round the same exact value once, subnormals
included. The reference's Veltkamp split gives the same bits wherever no
partial product underflows.

Complex ds values are 4-tuples of f32 tensors (re_hi, re_lo, im_hi,
im_lo).
"""

from __future__ import annotations

import numpy as np
import torch


def two_sum(a, b):
    """Exact sum: s + err == a + b."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """Exact sum assuming |a| >= |b|."""
    s = a + b
    err = b - (s - a)
    return s, err


def two_prod(a, b):
    """Exact product: p + err == a * b. A product of two f32 values and
    its difference from p are exact in f64, so `err` is rounded once, as
    the kernels' fma(a, b, -p) rounds it."""
    p = a * b
    err = (a.double() * b - p).float()  # b and p promoted to f64 inside the operators
    return p, err


def add(ahi, alo, bhi, blo):
    s, e = two_sum(ahi, bhi)
    e = e + (alo + blo)
    return quick_two_sum(s, e)


def sub(ahi, alo, bhi, blo):
    return add(ahi, alo, -bhi, -blo)


def neg(ahi, alo):
    return -ahi, -alo


def mul(ahi, alo, bhi, blo):
    p, e = two_prod(ahi, bhi)
    e = e + (ahi * blo + alo * bhi)
    return quick_two_sum(p, e)


# 2**12 + 1, the Veltkamp split constant for f32 (exact in f32, so a
# product with an f32 tensor stays f32)
_SPLIT = 4097.0


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def mul_wsplit(ahi, alo, bhi, blo, bhh, bhl):
    """ds multiply where b's hi component ships with its Veltkamp halves
    (bhh + bhl == bhi exactly, 12-bit mantissas; `presplit_f32`): the
    reference's formula term for term, a's runtime split and f32 products,
    no fused multiply-add."""
    p = ahi * bhi
    ah, al = _split(ahi)
    err = ((ah * bhh - p) + ah * bhl + al * bhh) + al * bhl
    e = err + (ahi * blo + alo * bhi)
    return quick_two_sum(p, e)


def presplit_f32(x):
    """Veltkamp halves of an f32 numpy array (host-side, exact)."""
    x = np.asarray(x, dtype=np.float32)
    t = np.float32(_SPLIT) * x
    hi = t - (t - x)
    lo = x - hi
    return hi.astype(np.float32), lo.astype(np.float32)


def mul_f32(ahi, alo, b):
    """Multiply a ds number by a plain f32."""
    p, e = two_prod(ahi, b)
    e = e + alo * b
    return quick_two_sum(p, e)


def from_f64_array(x):
    """Split f64 numpy values into ds (hi, lo) f32 numpy pairs (for
    constant tables)."""
    x = np.asarray(x, dtype=np.float64)
    hi = np.asarray(x, dtype=np.float32)
    lo = np.asarray(x - hi.astype(np.float64), dtype=np.float32)
    return hi, lo


def from_i64(x):
    """i64 values (|x| < 2^63) -> ds pairs capturing the top ~48 bits
    (`spf_tpu/ops/ds.py::from_i64`, the same bits). The hi component is
    clamped below +2^63: f32(2^63 - 1) rounds up to 2^63, which no i64
    holds, so the residual is taken against the stored hi (2^63 - 2^40 is
    exact in f32)."""
    hi = torch.clamp(x.to(torch.float32), max=2.0**63 - 2.0**40)
    lo = (x - hi.to(torch.int64)).to(torch.float32)
    return hi, lo


def to_u64_mod_q(hi, lo):
    """Round a ds value to the nearest integer mod q = 2**64, as wrapping
    int64 (`spf_tpu/ops/ds.py::to_u64_mod_q`, the same bits; the ds analog
    of `vector_mod_pow2_q_f64`). hi and k*2^64 share an ulp grid, so the
    reduction is exact; the reduced hi and the rounded lo are cast to i64
    and added with wraparound."""
    q = 2.0**64
    k = torch.round(hi / q)
    r_hi = hi - k * q  # exact: both operands are multiples of ulp(hi)
    # r_hi is in [-q/2, q/2]; only the +q/2 endpoint would overflow i64
    r_hi = torch.where(r_hi >= 2.0**63, r_hi - q, r_hi)
    return r_hi.to(torch.int64) + torch.round(lo).to(torch.int64)


def cadd(a, b):
    rh, rl = add(a[0], a[1], b[0], b[1])
    ih, il = add(a[2], a[3], b[2], b[3])
    return (rh, rl, ih, il)


def csub(a, b):
    rh, rl = sub(a[0], a[1], b[0], b[1])
    ih, il = sub(a[2], a[3], b[2], b[3])
    return (rh, rl, ih, il)


def cmul(a, b):
    pr = mul(a[0], a[1], b[0], b[1])
    qr = mul(a[2], a[3], b[2], b[3])
    rh, rl = sub(pr[0], pr[1], qr[0], qr[1])
    pi = mul(a[0], a[1], b[2], b[3])
    qi = mul(a[2], a[3], b[0], b[1])
    ih, il = add(pi[0], pi[1], qi[0], qi[1])
    return (rh, rl, ih, il)
