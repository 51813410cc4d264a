"""The least time of a launch of the batched-row MAD (`mad_batched_kernel`
of `csrc/mad.cu`, the CMux's and the external product's frequency-domain
product), as `PERF.md`'s table of kernels reckons it: each distinct GGSW
row the launch reads (4 f32 planes [k+1, l, k+1, K]), the digit spectra
(4 planes [l, k+1, K, B]) and the output (4 planes [k+1, K, B]) once, and
the slot indices (int32 [B]); the f32 instructions of its complex
multiply-adds. Rates and instruction counts are `frozen/roofline.py`'s."""

from __future__ import annotations

from tfhe_bench.frozen import roofline as rf


def mad_batched_bytes(kp1: int, l: int, k: int, b: int, distinct: int) -> int:
    row = 16 * kp1 * l * kp1 * k
    return distinct * row + 16 * (l * kp1 + kp1) * k * b + 4 * b


def mad_batched_ops(kp1: int, l: int, k: int, b: int) -> int:
    return k * b * kp1 * l * kp1 * (rf.CMUL + rf.CADD)


def mad_batched_bound_s(kp1: int, l: int, k: int, b: int, distinct: int) -> float:
    """Seconds: the larger of the bytes over the HBM rate and the
    instructions over the f32 issue rate (the bytes, at every B)."""
    ms, _ = rf.bound_ms(mad_batched_bytes(kp1, l, k, b, distinct), mad_batched_ops(kp1, l, k, b))
    return ms / 1e3
