"""Homomorphic automorphisms and the trace (u64 API).

Port of `spf_tpu/ops/automorphism.py` (≙ `sunscreen_tfhe/src/ops/
automorphisms/mod.rs:18-85`).
"""

from __future__ import annotations

import torch

from ...params import GlweDef, RadixDecomposition
from .fft import C128
from .fft_ops import keyswitch_glwe_to_glwe
from .poly import pow_k
from .torus import u64


def glwe_pow_k(ct, k_exp: int) -> torch.Tensor:
    """X -> X^k on every polynomial of a GLWE (a signed permutation)."""
    return pow_k(u64(ct), k_exp)


def trace(ct, auto_keys_fft, glwe: GlweDef, radix: RadixDecomposition, be=C128) -> torch.Tensor:
    """Zero every coefficient but the constant term, which is multiplied
    by N (`automorphisms/mod.rs:53-85`): for i in 1..=log2 N, with
    k = N/2^(i-1) + 1, out += glwe_keyswitch(pow_k(out, k), key_i).
    `auto_keys_fft`: complex [log2 N, k, l, k+1, N/2]; leading batch dims
    on ct."""
    out = u64(ct)
    for i in range(1, glwe.log_degree + 1):
        mapped = glwe_pow_k(out, glwe.degree // (1 << (i - 1)) + 1)
        out = out + keyswitch_glwe_to_glwe(mapped, auto_keys_fft[i - 1], glwe, radix, be)
    return out
