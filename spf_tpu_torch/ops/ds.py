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
    err = (a.double() * b.double() - p.double()).float()
    return p, err


def add(ahi, alo, bhi, blo):
    s, e = two_sum(ahi, bhi)
    e = e + (alo + blo)
    return quick_two_sum(s, e)


def sub(ahi, alo, bhi, blo):
    return add(ahi, alo, -bhi, -blo)


def mul(ahi, alo, bhi, blo):
    p, e = two_prod(ahi, bhi)
    e = e + (ahi * blo + alo * bhi)
    return quick_two_sum(p, e)


def from_f64_array(x):
    """Split f64 numpy values into ds (hi, lo) f32 numpy pairs (for
    constant tables)."""
    x = np.asarray(x, dtype=np.float64)
    hi = np.asarray(x, dtype=np.float32)
    lo = np.asarray(x - hi.astype(np.float64), dtype=np.float32)
    return hi, lo


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
