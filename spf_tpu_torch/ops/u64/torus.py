"""Torus Z_q (q = 2**64) element operations on wrapping int64 tensors.

Port of `spf_tpu/ops/torus.py` (≙ the reference's `Torus<u64>`,
`sunscreen_tfhe/src/math/torus.rs:284-300`). Right shifts are logical
(`ops.torus._shr` masks), so every decode and rounding sees the u64 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ...params import TORUS_BITS
from ..torus import _shr, _signed, from_u64_np, resolve_device, shr_round  # noqa: F401

I64 = torch.int64


def u64(x, device=None) -> torch.Tensor:
    """A Python int (any value mod 2^64), a u64 numpy array or an integer
    tensor -> an int64 tensor with the same u64 bits."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device, dtype=I64)
    if isinstance(x, int):
        return torch.tensor(_signed(x), dtype=I64, device=device)
    return from_u64_np(np.asarray(x).astype(np.uint64), device)


def place(x=None, device=None) -> torch.device:
    """The device an op makes its tensors on: the one asked for, else the
    input tensor's, else the card (`resolve_device`, which raises without
    one)."""
    if device is not None:
        return resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    return resolve_device("cuda")


def encode(val, plain_bits: int):
    """val << (64 - plain_bits) mod 2^64 (`torus.rs:284-290`): a Python
    int in the int64 range for an int, else an int64 tensor."""
    assert 0 < plain_bits < TORUS_BITS
    if isinstance(val, int):
        return _signed(val << (TORUS_BITS - plain_bits))
    return u64(val) << (TORUS_BITS - plain_bits)


def decode(x, plain_bits: int) -> torch.Tensor:
    """Round-and-mask decode (`torus.rs:293-300`)."""
    assert 0 < plain_bits < TORUS_BITS
    x = u64(x)
    round_bit = _shr(x, TORUS_BITS - plain_bits - 1) & 1
    return (_shr(x, TORUS_BITS - plain_bits) + round_bit) & ((1 << plain_bits) - 1)


def switch_modulus_smaller(x, target_bits: int) -> torch.Tensor:
    """Scale down to a power-of-two modulus by truncation (`torus.rs:304-313`)."""
    return _shr(u64(x), TORUS_BITS - target_bits)


def neg(x) -> torch.Tensor:
    """Wrapping negation mod 2**64."""
    return -u64(x)


def to_signed_f64(x) -> torch.Tensor:
    """The centered value in [-q/2, q/2) as f64 (the int64 reading of the
    u64 bits; `entities/polynomial.rs:264-268`)."""
    return u64(x).to(torch.float64)


def f64_to_torus(x: torch.Tensor) -> torch.Tensor:
    """Reduce integer-valued f64 mod q = 2**64 into [-q/2, q/2), in f64,
    before the cast to int64 (`simd/scalar.rs:75-119` `vector_mod_pow2_q_f64`).
    The cast then never sees an out-of-range value, whose result PyTorch
    leaves to the device (the CPU and CUDA differ)."""
    q = 2.0**64
    r = x - torch.trunc(x / q) * q
    r = torch.where(r >= 2.0**63, r - q, r)
    r = torch.where(r < -(2.0**63), r + q, r)
    return r.to(I64)
