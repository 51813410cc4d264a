"""Ciphertext-level operations: GLWE/LWE add/sub/negate, sample
extraction, modulus switching, rotations.

Port of `spf_tpu/ops/ciphertext.py` (≙ `sunscreen_tfhe/src/ops/ciphertext/
{glwe,lwe}_ciphertext_ops.rs`). Ciphertexts are int64 tensors, so the
linear ops are wrapping tensor arithmetic. All take leading batch dims.
"""

from __future__ import annotations

import torch

from ...params import TORUS_BITS, GlweDef
from .. import torus as _torus
from .torus import u64


def glwe_add(a, b):
    """(`glwe_ciphertext_ops.rs:79`)"""
    return u64(a) + u64(b)


def glwe_sub(a, b):
    """(`glwe_ciphertext_ops.rs:121`)"""
    return u64(a) - u64(b)


def glwe_negate(a):
    return -u64(a)


lwe_add = glwe_add
lwe_sub = glwe_sub
lwe_negate = glwe_negate


def lwe_rotate(ct, plaintext_torus):
    """Add a plaintext constant: b += m (`ops/homomorphisms/lwe.rs:9`)."""
    out = u64(ct).clone()
    out[..., -1] += plaintext_torus
    return out


def glwe_rotate(ct, plaintext_torus):
    """Add a plaintext constant to every message coefficient: B += m
    (`glwe_ciphertext_ops.rs:285`)."""
    out = u64(ct).clone()
    out[..., -1, :] += plaintext_torus
    return out


def sample_extract(glwe_ct: torch.Tensor, h: int, glwe: GlweDef) -> torch.Tensor:
    """Coefficient h of a GLWE as an LWE under the flattened key
    (`glwe_ciphertext_ops.rs:31-77`): a_lwe[N*i + j] = a_i[h - j] for
    j <= h, -a_i[h - j + N] for j > h; b_lwe = b[h]."""
    n = glwe.degree
    glwe_ct = u64(glwe_ct)
    a, b = glwe_ct[..., :-1, :], glwe_ct[..., -1, :]
    j = torch.arange(n, device=glwe_ct.device)
    gathered = a[..., torch.remainder(h - j, n)]
    a_lwe = torch.where(j > h, -gathered, gathered)
    a_flat = a_lwe.reshape(*a_lwe.shape[:-2], glwe.size * n)
    return torch.cat([a_flat, b[..., h:h + 1]], dim=-1)


def modulus_switch(x, log_chi: int, log_v: int, log_modulus: int) -> torch.Tensor:
    """Generalized modulus switch (`lwe_ciphertext_ops.rs:130-142`): drop
    log_chi MSBs, round to log_modulus - log_v bits, append log_v zero
    LSBs (0xDEADBEEF_BEEFDEAD -> 0b11_0111_1011 for (0, 0, 10)). The same
    bits as `ops.torus.modulus_switch` where both are defined (results
    below 2^32); this one keeps all 64 bits."""
    x = u64(x)
    if log_chi:
        x = x << log_chi
    shift = TORUS_BITS - (log_modulus - log_v)
    rnd = _torus._shr(x, shift - 1) & 1
    mask = (1 << log_modulus) - 1 if log_modulus < TORUS_BITS else -1
    return ((_torus._shr(x, shift) + rnd) & mask) << log_v


def lwe_modulus_switch(ct, log_chi: int, log_v: int, log_modulus: int) -> torch.Tensor:
    """`modulus_switch` on every component (`lwe_ciphertext_ops.rs:97-128`)."""
    return modulus_switch(ct, log_chi, log_v, log_modulus)


def glwe_mod_switch_and_expand_pow_2(ct, log_q_prime: int) -> torch.Tensor:
    """Switch to q' = q/2^log_q_prime and back: a shift right with rounding
    per coefficient (`glwe_ciphertext_ops.rs:268-281`)."""
    return _torus.shr_round(u64(ct), log_q_prime)
