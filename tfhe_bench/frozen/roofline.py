"""Roofline arithmetic of the benchmark's per-layer metrics.

A frozen copy of `chip_smoke.py` at commit
3b95a350bce56f9bff529063c275e4a2c34f9859: the card's rates
(`HBM_BYTES_PER_S`, the f32 issue rate), the f32 instruction counts of the
ds32 primitives, `bound_ms`, `mad_bytes`, `mad_ops`, `fft_ops`, the FFT's
byte count of `fft_cases` (`nbytes=p * b * (2 * n * 4 + 4 * k * 4)`).
`F32_ISSUE_PER_S` is `chain_peak_per_s(1, {"fma": 1}, hw)`
at the card's maximum SM clock: 132 SMs x 128 f32 results a clock x
1980 MHz (`PERF.md`, "device"). Later changes to the program do not
change this yardstick.
"""

from __future__ import annotations

import re

# NVIDIA H100 SXM data sheet: HBM3 rate; roofline bounds are stated
# against the rate
HBM_BYTES_PER_S = 3.35e12
# f32 instructions a second: 132 SMs x 128 a clock x 1.98e9 clocks
F32_ISSUE_PER_S = 132 * 128 * 1.98e9

# f32 instructions of the ds32 primitives in the cheapest form that gives
# the same bits: add 11, complex add 22, subtract 22, multiply 58; the
# phase combine (cmul, then -1 on the real part) 69
CADD, CSUB, CMUL, DS_ADD = 22, 22, 58, 11
COMBINE = CMUL + DS_ADD

def bound_ms(nbytes: float, ops: float, ops_per_s: float = F32_ISSUE_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mad_bytes(group: int, kp1: int, l: int, k: int, b: int, k_halves: int) -> int:
    """Bytes a MAD call moves: the digit spectra, the key rows, the phase
    factor halves (Klo + Khi bins a bit) and the output, 4 f32 planes each."""
    ns = max(1, (1 << group) - 1)
    return 4 * 4 * (l * kp1 * k * b + ns * kp1 * l * kp1 * k + group * k_halves * b + kp1 * k * b)


def mad_ops(group: int, kp1: int, l: int, k: int, b: int) -> int:
    """f32 instructions of a MAD call in the cheapest form with the same bits:
    the subset MADs, the Horner sum and the g (phase - 1) combines."""
    ns = max(1, (1 << group) - 1)
    horner = kp1 * (ns * CMUL + (ns - 1) * CADD) + group * COMBINE if group else 0
    return k * b * (ns * kp1 * l * kp1 * (CMUL + CADD) + horner)


def fft_ops(p: int, k: int, b: int) -> int:
    """f32 instructions of one ds32 FFT call: the twist (or untwist), then
    log2(K) stages of K/2 butterflies (a complex add, subtract, multiply)."""
    return p * b * (CMUL * k + (CADD + CSUB + CMUL) * (k // 2) * (k.bit_length() - 1))


def fft_bytes(p: int, k: int, b: int) -> int:
    """Bytes one ds32 FFT call moves: P polynomials of N = 2K reals as a
    ds pair of f32 planes on one side, 4 f32 planes of K bins on the other."""
    n = 2 * k
    return p * b * (2 * n * 4 + 4 * k * 4)


def phase_halves(k: int) -> int:
    """Klo + Khi: the bins of a step's (phase - 1) factor halves that a MAD
    of K bins reads a bit (Klo = 2^floor(log2(K) / 2), Khi = K / Klo)."""
    j = k.bit_length() - 1
    klo = 1 << (j // 2)
    return klo + k // klo


def mad_bound_s(group: int, kp1: int, l: int, k: int, b: int) -> float:
    """The least time of one MAD launch, seconds."""
    ms, _ = bound_ms(mad_bytes(group, kp1, l, k, b, phase_halves(k)), mad_ops(group, kp1, l, k, b))
    return ms / 1e3


def fft_bound_s(p: int, k: int, b: int) -> float:
    """The least time of one ds32 FFT launch (either direction), seconds."""
    ms, _ = bound_ms(fft_bytes(p, k, b), fft_ops(p, k, b))
    return ms / 1e3


_NAME = re.compile(r"^(?:void\s+)?(?:\(anonymous namespace\)::)?([A-Za-z_][A-Za-z0-9_]*)"
                   r"(?:<([^>]*)>)?")


def kernel_base(name: str) -> str:
    """A profiled kernel's name without `void`, its template arguments and
    its parameter list."""
    m = _NAME.match(name.strip())
    return m.group(1) if m else name


def template_args(name: str) -> tuple:
    """The integer template arguments of a profiled kernel's name, () if
    none: `mad_horner_kernel<2, 3>(...)` -> (2, 3)."""
    m = _NAME.match(name.strip())
    if not m or m.group(2) is None:
        return ()
    try:
        return tuple(int(x) for x in m.group(2).split(","))
    except ValueError:
        return ()
