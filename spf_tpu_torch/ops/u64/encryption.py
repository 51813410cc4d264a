"""LWE / GLWE / GLEV / GGSW encryption and decryption (u64 layouts).

Port of `spf_tpu/ops/encryption.py` (≙ `sunscreen_tfhe/src/ops/encryption/`):
b = sum a_i (*) s_i + m + e; decryption m + e = b - sum a_i (*) s_i.
Secret keys are binary, so every key product is the port's exact binary
product (`ops.encryption.negacyclic_mul_binary`, `lwe_dot_binary`), and
sampling and the batched encryptions are `ops.encryption`'s: each
function takes a `torch.Generator` where the reference takes a jax key,
and makes its tensors on the generator's device.

Layouts (leading batch dims allowed): LWE [n+1]; GLWE [k+1, N]; GLEV
[l, k+1, N] (row j encrypts m * q/B^(j+1)); GGSW [k+1, l, k+1, N] (row
i < k: GLEV(-s_i m), row k: GLEV(m)).
"""

from __future__ import annotations

import torch

from ...params import TORUS_BITS, GlweDef, LweDef, RadixDecomposition
from .. import encryption as _enc
from ..torus import _shr
from . import rng
from .torus import place, u64


def generate_lwe_sk(generator: torch.Generator, lwe: LweDef) -> torch.Tensor:
    """Binary LWE secret key int64 [n] (`high_level.rs:95`)."""
    return _enc.generate_lwe_sk(lwe, generator)


def generate_glwe_sk(generator: torch.Generator, glwe: GlweDef) -> torch.Tensor:
    """Binary GLWE secret key int64 [k, N] (`high_level.rs:154`)."""
    return _enc.generate_glwe_sk(glwe, generator)


def glwe_sk_to_lwe_sk(glwe_sk: torch.Tensor) -> torch.Tensor:
    """The GLWE key as an LWE key of dimension k*N (`to_lwe_secret_key`)."""
    return glwe_sk.reshape(-1)


def _key_product(a: torch.Tensor, sk: torch.Tensor, glwe: GlweDef) -> torch.Tensor:
    """sum_i a_i (*) s_i for a [..., k, N] and a binary key [k, N]."""
    out = torch.zeros(a.shape[:-2] + (glwe.degree,), dtype=torch.int64, device=a.device)
    for i in range(glwe.size):
        out = out + _enc.negacyclic_mul_binary(a[..., i, :], sk[i].to(a.device))
    return out


# --- LWE ---


def encrypt_lwe(generator, msg_torus, sk: torch.Tensor, lwe: LweDef) -> torch.Tensor:
    """[a, b] with b = <a, s> + m + e (`lwe_encryption.rs:36-59`)."""
    msgs = u64(msg_torus, generator.device)
    a = rng.uniform_torus(generator, (*msgs.shape, lwe.dim))
    b = _enc.lwe_dot_binary(a, sk) + msgs + rng.normal_torus(generator, lwe.std, msgs.shape)
    return torch.cat([a, b[..., None]], dim=-1)


def trivial_lwe(msg_torus, lwe: LweDef, device=None) -> torch.Tensor:
    """a = 0, b = m (`lwe_encryption.rs:20-32`), on `device`, else the
    message tensor's, else the card."""
    msgs = u64(msg_torus, place(msg_torus, device))
    a = torch.zeros((*msgs.shape, lwe.dim), dtype=torch.int64, device=msgs.device)
    return torch.cat([a, msgs[..., None]], dim=-1)


def decrypt_lwe(ct, sk: torch.Tensor, lwe: LweDef) -> torch.Tensor:
    """m + e = b - <a, s> (no decode)."""
    ct = u64(ct, sk.device)
    return ct[..., -1] - _enc.lwe_dot_binary(ct[..., :-1], sk)


# --- GLWE ---


def encrypt_glwe(generator, msg_torus_poly, sk: torch.Tensor, glwe: GlweDef) -> torch.Tensor:
    """Torus polynomials [..., N] -> GLWE [..., k+1, N] (`glwe_encryption.rs:22-63`)."""
    msgs = u64(msg_torus_poly, generator.device)
    a = rng.uniform_torus(generator, (*msgs.shape[:-1], glwe.size, glwe.degree))
    b = _key_product(a, sk, glwe) + msgs + rng.normal_torus(generator, glwe.std, msgs.shape)
    return torch.cat([a, b[..., None, :]], dim=-2)


def trivial_glwe(msg_torus_poly, glwe: GlweDef, device=None) -> torch.Tensor:
    """a = 0, b = m (`glwe_encryption.rs:79-98`), placed as `trivial_lwe`."""
    msgs = u64(msg_torus_poly, place(msg_torus_poly, device))
    msgs = msgs.expand(*msgs.shape[:-1], glwe.degree) if msgs.dim() else msgs.expand(glwe.degree)
    a = torch.zeros((*msgs.shape[:-1], glwe.size, glwe.degree), dtype=torch.int64,
                    device=msgs.device)
    return torch.cat([a, msgs[..., None, :]], dim=-2)


def decrypt_glwe(ct, sk: torch.Tensor, glwe: GlweDef) -> torch.Tensor:
    """m + e = b - sum a_i (*) s_i (`glwe_encryption.rs:104-126`)."""
    ct = u64(ct, sk.device)
    return ct[..., -1, :] - _key_product(ct[..., :-1, :], sk, glwe)


# --- GLEV ---


def _levels(msg_poly: torch.Tensor, radix: RadixDecomposition) -> torch.Tensor:
    """msg * q/B^(j+1) for each level j (a wrapping shift), stacked at -2."""
    return torch.stack([msg_poly << (TORUS_BITS - radix.radix_log * (j + 1))
                        for j in range(radix.count)], dim=-2)


def encrypt_glev(generator, msg_poly, sk: torch.Tensor, glwe: GlweDef,
                 radix: RadixDecomposition) -> torch.Tensor:
    """GLEV of small-integer polynomials [..., N] -> [..., l, k+1, N]
    (`glev_encryption.rs:64-100`)."""
    return encrypt_glwe(generator, _levels(u64(msg_poly, generator.device), radix), sk, glwe)


def trivial_glev(msg_poly, glwe: GlweDef, radix: RadixDecomposition, device=None):
    msgs = u64(msg_poly, place(msg_poly, device))
    return trivial_glwe(_levels(msgs, radix), glwe)


def decrypt_glev_at(ct, sk: torch.Tensor, glwe: GlweDef, radix: RadixDecomposition,
                    index: int) -> torch.Tensor:
    """Row `index` decrypted and its gadget factor divided out with
    rounding (`glev_encryption.rs:163-200`)."""
    noisy = decrypt_glwe(u64(ct)[..., index, :, :], sk, glwe)
    shift = TORUS_BITS - radix.radix_log * (index + 1)
    mask = (1 << radix.radix_log) - 1
    if shift == 0:
        return noisy & mask
    return (_shr(noisy, shift) + (_shr(noisy, shift - 1) & 1)) & mask


# --- GGSW ---


def encrypt_ggsw(generator, msg_poly, sk: torch.Tensor, glwe: GlweDef,
                 radix: RadixDecomposition) -> torch.Tensor:
    """GGSW [k+1, l, k+1, N]: row i < k GLEV(-s_i (*) m), row k GLEV(m)
    (`ggsw_encryption.rs:30-71`)."""
    msg = u64(msg_poly, generator.device)
    rows = [-_enc.negacyclic_mul_binary(msg, sk[i]) for i in range(glwe.size)] + [msg]
    return encrypt_glev(generator, torch.stack(rows, dim=-2), sk, glwe, radix)


def trivial_ggsw(msg_poly, glwe: GlweDef, radix: RadixDecomposition, device=None):
    """Rows i < k GLEV(0) under the trivial key, row k GLEV(m)."""
    msg = u64(msg_poly, place(msg_poly, device))
    rows = [torch.zeros_like(msg)] * glwe.size + [msg]
    return trivial_glev(torch.stack(rows, dim=-2), glwe, radix)


def encrypt_ggsw_scalar(generator, msg_scalar, sk: torch.Tensor, glwe: GlweDef,
                        radix: RadixDecomposition) -> torch.Tensor:
    """GGSW of degree-0 messages [...] -> [..., k+1, l, k+1, N]
    (`ggsw_encryption.rs:122-146`): `ops.encryption.encrypt_ggsw_scalar`."""
    m = u64(msg_scalar, generator.device)
    out = _enc.encrypt_ggsw_scalar(m.reshape(-1), sk, glwe, radix, generator)
    return out.reshape(*m.shape, *out.shape[1:])


def decrypt_ggsw(ct, sk: torch.Tensor, glwe: GlweDef, radix: RadixDecomposition):
    """The message polynomial from the last row's level 0."""
    return decrypt_glev_at(u64(ct)[..., glwe.size, :, :, :], sk, glwe, radix, 0)


# --- RLWE public-key encryption (k == 1) ---


def rlwe_generate_public_key(generator, sk: torch.Tensor, glwe: GlweDef) -> torch.Tensor:
    """An encryption of zero, int64 [2, N] (`rlwe_encryption.rs:47-60`)."""
    assert glwe.size == 1
    zero = torch.zeros(glwe.degree, dtype=torch.int64, device=generator.device)
    return encrypt_glwe(generator, zero, sk, glwe)


def rlwe_encrypt_public(generator, msg_torus_poly, public_key: torch.Tensor,
                        glwe: GlweDef) -> torch.Tensor:
    """(p0 (*) u + e0, m + p1 (*) u + e1) for a binary u and Gaussian e0,
    e1 (`rlwe_encryption.rs:88-130`)."""
    assert glwe.size == 1
    msg = u64(msg_torus_poly, generator.device)
    u = rng.binary(generator, (glwe.degree,))
    e0 = rng.normal_torus(generator, glwe.std, (glwe.degree,))
    e1 = rng.normal_torus(generator, glwe.std, (glwe.degree,))
    pk = public_key.to(generator.device)
    a = _enc.negacyclic_mul_binary(pk[0], u) + e0
    b = msg + _enc.negacyclic_mul_binary(pk[1], u) + e1
    return torch.stack([a, b], dim=0)
