"""Torus arithmetic on wrapping int64 tensors.

A torus element x in Z_{2^64} is one `torch.int64` whose two's-complement
bits are x's u64 bits: add, subtract, negate and left shifts wrap mod
2^64 as they must. Right shifts of int64 are arithmetic in PyTorch, so
every logical right shift here masks (`_shr`).

This is the port of `spf_tpu/ops/limb32.py`, whose u32 limb pairs exist
only because the TPU's kernel compiler has no 64-bit integers. The
results are bit-identical, including where `limb32` clamps a float at
+2^31 on its way to i32 (`from_ds`, `to_ds`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import TORUS_BITS, RadixDecomposition

I64 = torch.int64
F32 = torch.float32

_I32_MIN = -(1 << 31)
_I32_MAX = (1 << 31) - 1
_U32_MASK = (1 << 32) - 1


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; a CUDA device without a card
    raises rather than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain versions on the CPU"
        )
    return device


def from_u64_np(x, device=None) -> torch.Tensor:
    """numpy u64 array -> int64 tensor with the same bits."""
    x = np.ascontiguousarray(np.asarray(x, dtype=np.uint64))
    return torch.from_numpy(x.view(np.int64).copy()).to(device)


def to_u64_np(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy u64 array with the same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def add(a, b):
    return a + b


def sub(a, b):
    return a - b


def neg(a):
    return -a


def _shr(x, n: int):
    """Logical right shift of the u64 bits by n in [0, 64)."""
    if n == 0:
        return x
    return (x >> n) & ((1 << (TORUS_BITS - n)) - 1)


def add_small(a, c: int):
    """a + c for a Python int c, any value mod 2^64 (≙ `limb32.add_small`,
    which takes c as its (hi, lo) limbs)."""
    return a + _signed(c)


def shr_round(a, n: int):
    """(x >> n) + bit_{n-1}(x) on the u64 bits, n in [0, 64) (≙
    `limb32.shr_round`)."""
    if n == 0:
        return a
    return _shr(a, n) + (_shr(a, n - 1) & 1)


def encode_const(val: int, plain_bits: int) -> int:
    """val << (64 - plain_bits) mod 2^64, as the Python int in the int64
    range with the same bits (≙ `limb32.encode_const`, which returns the
    (hi, lo) limbs)."""
    return _signed(val << (TORUS_BITS - plain_bits))


def _signed(x: int) -> int:
    x %= 1 << TORUS_BITS
    return x - (1 << TORUS_BITS) if x >> (TORUS_BITS - 1) else x


def monomial_mul(a, t):
    """a int64 [..., N, B] times X^t, per batch column t int64 [B] (any
    value; X^(2N) = 1), negacyclic: out[j] = a[s] if s < N else -a[s - N],
    with s = (j - t) mod 2N (≙ `bootstrap_u32.monomial_mul_u32`)."""
    n = a.shape[-2]
    j = torch.arange(n, device=a.device)[:, None]
    s = torch.remainder(j - t[None, :], 2 * n)  # [N, B]
    src = torch.where(s < n, s, s - n).expand(a.shape)
    g = torch.gather(a, -2, src)
    return torch.where(s >= n, -g, g)


def modulus_switch(a, log_chi: int, log_v: int, log_modulus: int):
    """Round x << log_chi to log_modulus - log_v bits, shifted up by
    log_v, mod 2^32 (≙ `limb32.modulus_switch`, whose u32 result wraps).
    Returns int64 values below 2^min(32, log_modulus + log_v)."""
    assert log_modulus <= 32
    x = a << log_chi if log_chi else a
    shift = TORUS_BITS - (log_modulus - log_v)
    assert shift >= 33, "log_modulus - log_v must be < 32"
    rbit = _shr(x, shift - 1) & 1
    return (((_shr(x, shift) + rbit) & ((1 << log_modulus) - 1)) << log_v) & _U32_MASK


def decompose(a, radix: RadixDecomposition):
    """Signed gadget decomposition -> int32 digit stack [count, ...];
    out[j] pairs with GLEV row j (most significant first), digit values
    in [-B/2, B/2) (≙ `limb32.decompose`)."""
    log_b = radix.radix_log
    shift = TORUS_BITS - log_b * radix.count
    # the rounded top count*log_b bits, LSB-aligned
    v = a if shift == 0 else _shr(a, shift) + (_shr(a, shift - 1) & 1)
    mask = (1 << log_b) - 1
    digits = []
    for _ in range(radix.count):
        d = v & mask
        v = _shr(v, log_b)
        carry = d >> (log_b - 1)
        v = v + carry
        digits.append(d - (carry << log_b))
    return torch.stack(digits[::-1], dim=0).to(torch.int32)


def _round_to_i32(x):
    """round-half-even f32 -> int64, saturated to the i32 range as
    limb32's f32 -> i32 casts are (f32 +2^31 becomes 2^31 - 1)."""
    return torch.round(x).to(I64).clamp_(_I32_MIN, _I32_MAX)


def to_ds(a):
    """int64 torus values -> ds (hi, lo) f32 pair carrying the top ~48
    bits of the SIGNED (centered) value (≙ `limb32.to_ds`)."""
    from . import ds

    hi_i = a >> 32  # arithmetic: the hi limb reinterpreted as i32
    lo_u = a & 0xFFFFFFFF
    # f32(2^31 - 1) rounds up to 2^31: clamp below it, as limb32 does
    ah = torch.clamp(hi_i.to(F32), max=2147483392.0)
    al = (hi_i - ah.to(I64)).to(F32)  # exact residual (<= 2^8)
    bh = (lo_u >> 16).to(F32)  # exact: < 2^16
    bl = (lo_u & 0xFFFF).to(F32)  # exact: < 2^16
    s, e = ds.two_sum(ah * 4294967296.0, bh * 65536.0)
    e = e + (al * 4294967296.0 + bl)
    return ds.quick_two_sum(s, e)


def from_ds(vh, vl):
    """Round a ds value to the nearest integer mod 2^64 (≙
    `limb32.from_ds`, for inverse-FFT outputs that can reach ~2^85).

    Each component is reduced mod 2^64 and split into a carry t (a
    multiple of 2^32) and a residue |r| <= 2^31, all exactly. The value
    is (t1 + t2) * 2^32 + round(r1) + round(r2) mod 2^64, where each
    rounded residue saturates at the i32 range as in the reference."""
    vh = vh - torch.round(vh * 2.0**-64) * 2.0**64  # |vh| <= 2^63
    vl = vl - torch.round(vl * 2.0**-64) * 2.0**64
    t1 = torch.round(vh * 2.0**-32)
    r1 = vh - t1 * 4294967296.0  # exact; |r1| <= 2^31
    t2 = torch.round(vl * 2.0**-32)
    r2 = vl - t2 * 4294967296.0
    carry = (t1.to(I64) + t2.to(I64)) << 32
    return carry + (_round_to_i32(r1) + _round_to_i32(r2))
