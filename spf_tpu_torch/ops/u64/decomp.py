"""Signed gadget (radix) decomposition on int64 torus tensors.

Port of `spf_tpu/ops/decomp.py` (≙ `sunscreen_tfhe/src/math/radix.rs:35-46,
155-161`): round to the top count * radix_log bits, then digits in
[-B/2, B/2) with carries. The digits come from `ops.torus.decompose`,
the port's one implementation (unsigned shifts and compares throughout);
`decompose` returns them row-aligned, out[j] pairing with GLEV row j.
"""

from __future__ import annotations

import torch

from ...params import TORUS_BITS, RadixDecomposition
from .. import torus as _torus
from .torus import u64


def radix_round(x, radix: RadixDecomposition) -> torch.Tensor:
    """The top count * radix_log bits of x, rounded, LSB-aligned (`radix.rs:155-161`)."""
    return _torus.shr_round(u64(x), TORUS_BITS - radix.radix_log * radix.count)


def decompose(x, radix: RadixDecomposition) -> torch.Tensor:
    """Row-aligned signed digits int64 [count, ...]: out[j] has gadget
    factor q/B^(j+1)."""
    return _torus.decompose(u64(x), radix).to(torch.int64)


def decompose_lsb_first(x, radix: RadixDecomposition) -> list:
    """The same digits, least significant first, as a list of int64 tensors."""
    return list(decompose(x, radix).flip(0).unbind(0))


def decomposition_factor(j: int, radix: RadixDecomposition) -> int:
    """q / B^(j+1) = 2**(64 - radix_log*(j+1)) as a Python int (`radix.rs:144-152`)."""
    return 1 << (TORUS_BITS - radix.radix_log * (j + 1))


def recompose(digits_row_aligned: torch.Tensor, radix: RadixDecomposition) -> torch.Tensor:
    """sum_j d_j * q/B^(j+1) mod q (`radix.rs:118-140`); a multiply by a
    power of two is a wrapping left shift."""
    acc = torch.zeros_like(digits_row_aligned[0], dtype=torch.int64)
    for j in range(radix.count):
        acc = acc + (digits_row_aligned[j].to(torch.int64)
                     << (TORUS_BITS - radix.radix_log * (j + 1)))
    return acc
