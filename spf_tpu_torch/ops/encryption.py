"""Keys and encryption for the multi-bit PBS, on int64 torus tensors.

Port of `spf_tpu/ops/encryption_u32.py` (binary secret keys, the exact
negacyclic product with a binary key, GLWE/GLEV/GGSW encryption, the
multi-bit bootstrap key) and of the host LWE encryption of
`spf_tpu/utils/host_crypto.py` / `bench.py`.

Randomness comes from an explicit `torch.Generator`; tensors are made on
the generator's device, so keygen runs on the card when the generator
lives there. The port's random numbers differ from jax.random's: tests
hand both packages the same numpy keys instead.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..params import TORUS_BITS, GlweDef, LweDef, RadixDecomposition
from .multibit import multibit_key_products_np

# rows of the product a (*) s per f64 matmul (bounds its memory)
_MUL_CHUNK = 2048


def generate_lwe_sk(lwe: LweDef, generator: torch.Generator) -> torch.Tensor:
    """Uniform binary LWE key, int64 [n]."""
    return torch.randint(0, 2, (lwe.dim,), generator=generator,
                         dtype=torch.int64, device=generator.device)


def generate_glwe_sk(glwe: GlweDef, generator: torch.Generator) -> torch.Tensor:
    """Uniform binary GLWE key, int64 [k, N]."""
    return torch.randint(0, 2, (glwe.size, glwe.degree), generator=generator,
                         dtype=torch.int64, device=generator.device)


def uniform_torus(shape, generator: torch.Generator) -> torch.Tensor:
    """Uniform torus elements (all 64 bits), int64."""
    def half():
        return torch.randint(0, 1 << 32, shape, generator=generator,
                             dtype=torch.int64, device=generator.device)
    return (half() << 32) | half()


def normal_torus(std: float, shape, generator: torch.Generator) -> torch.Tensor:
    """round(N(0, std) * 2^64) as wrapping int64 (sampled in float64)."""
    z = torch.randn(shape, generator=generator, dtype=torch.float64,
                    device=generator.device)
    return torch.round(z * (std * 2.0**TORUS_BITS)).to(torch.int64)


@functools.lru_cache(maxsize=4)
def _nega_index_sign(n: int):
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    return np.mod(j - i, n), np.where(j < i, -1.0, 1.0)


def _signed_circulant(s: torch.Tensor) -> torch.Tensor:
    """Binary poly [N] -> signed negacyclic circulant f64 [N, N] with
    (a (*) s)[j] = sum_i a[i] * S[i, j]."""
    idx, sign = _nega_index_sign(s.shape[-1])
    idx = torch.from_numpy(idx).to(s.device)
    return s.to(torch.float64)[idx] * torch.from_numpy(sign).to(s.device)


def negacyclic_mul_binary(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Exact (a (*) s) mod 2^64 for int64 a [..., N] and a BINARY s [N]:
    four 16-bit planes of a times the signed circulant of s as f64
    matmuls (exact: |partial sums| <= N * 2^16 < 2^53), recombined with
    wrapping shifts."""
    n = s.shape[-1]
    circ = _signed_circulant(s)
    flat = a.reshape(-1, n)
    out = torch.empty_like(flat)
    for r0 in range(0, flat.shape[0], _MUL_CHUNK):
        x = flat[r0:r0 + _MUL_CHUNK]
        planes = torch.stack([(x >> (16 * p)) & 0xFFFF for p in range(4)]).to(torch.float64)
        q = torch.matmul(planes, circ).to(torch.int64)  # [4, rows, N]
        out[r0:r0 + _MUL_CHUNK] = q[0] + (q[1] << 16) + (q[2] << 32) + (q[3] << 48)
    return out.reshape(a.shape)


def encrypt_glwe(msgs: torch.Tensor, glwe_sk: torch.Tensor, glwe: GlweDef,
                 generator: torch.Generator) -> torch.Tensor:
    """Torus messages int64 [..., N] -> GLWE ciphertexts int64
    [..., k+1, N]: b = sum_i a_i (*) s_i + m + e."""
    n = glwe.degree
    lead = msgs.shape[:-1]
    m = msgs.reshape(-1, n)
    a = uniform_torus((m.shape[0], glwe.size, n), generator)
    b = m + normal_torus(glwe.std, (m.shape[0], n), generator)
    for i in range(glwe.size):
        b = b + negacyclic_mul_binary(a[:, i], glwe_sk[i])
    return torch.cat([a, b[:, None]], dim=1).reshape(*lead, glwe.size + 1, n)


def encrypt_glev(msgs: torch.Tensor, glwe_sk: torch.Tensor, glwe: GlweDef,
                 radix: RadixDecomposition, generator: torch.Generator) -> torch.Tensor:
    """GLEVs of small-integer polynomials int64 [..., N]: level j encrypts
    msg * q/B^(j+1) (a wrapping shift). Returns int64 [..., l, k+1, N]."""
    levels = torch.stack(
        [msgs << (TORUS_BITS - radix.radix_log * (j + 1)) for j in range(radix.count)], -2
    )
    return encrypt_glwe(levels, glwe_sk, glwe, generator)


def encrypt_ggsw_scalar(bits: torch.Tensor, glwe_sk: torch.Tensor, glwe: GlweDef,
                        radix: RadixDecomposition, generator: torch.Generator) -> torch.Tensor:
    """GGSWs of scalar messages int64 [G] (binary): rows i < k encrypt
    GLEV(-s_i * m), row k GLEV(m). Returns int64 [G, k+1, l, k+1, N]."""
    k, n = glwe.size, glwe.degree
    m = bits.to(torch.int64)[:, None]
    rows = [-(m * glwe_sk[i][None]) for i in range(k)]  # -(m X^0) (*) s_i
    x0 = torch.zeros((m.shape[0], n), dtype=torch.int64, device=m.device)
    x0[:, 0] = m[:, 0]
    rows.append(x0)
    return encrypt_glev(torch.stack(rows, 1), glwe_sk, glwe, radix, generator)


def generate_multibit_bsk(lwe_sk, glwe_sk: torch.Tensor, glwe: GlweDef,
                          radix: RadixDecomposition, group: int,
                          generator: torch.Generator) -> torch.Tensor:
    """Multi-bit bootstrap key in the coefficient domain: int64
    [n_groups, 2^g-1, k+1, l, k+1, N], one fresh GGSW of
    prod_{j in S} s_j per group and subset S."""
    sk = lwe_sk.cpu().numpy() if isinstance(lwe_sk, torch.Tensor) else np.asarray(lwe_sk)
    prods = multibit_key_products_np(sk, group)
    ng, ns = prods.shape
    bits = torch.from_numpy(prods.reshape(-1).astype(np.int64)).to(glwe_sk.device)
    rows = encrypt_ggsw_scalar(bits, glwe_sk, glwe, radix, generator)
    return rows.reshape(ng, ns, *rows.shape[1:])


def encrypt_lwe_np(rng: np.random.Generator, msgs_torus, lwe_sk, lwe: LweDef) -> np.ndarray:
    """Host LWE encryption of torus messages u64 [B] -> u64 [B, n+1]
    (the input encryption of `bench.py`)."""
    msgs_torus = np.asarray(msgs_torus, dtype=np.uint64)
    sk = np.asarray(lwe_sk, dtype=np.uint64)
    batch = msgs_torus.shape[0]
    a = rng.integers(0, 1 << 64, size=(batch, lwe.dim), dtype=np.uint64)
    e = np.round(rng.normal(0.0, lwe.std * 2.0**64, size=batch)).astype(np.int64).astype(np.uint64)
    b = (a * sk[None, :]).sum(axis=1, dtype=np.uint64) + msgs_torus + e
    return np.concatenate([a, b[:, None]], axis=1)


def lwe_phase_np(ct, lwe_sk) -> np.ndarray:
    """b - <a, s> mod 2^64 of LWE ciphertexts u64 [B, n+1]."""
    ct = np.asarray(ct, dtype=np.uint64)
    sk = np.asarray(lwe_sk, dtype=np.uint64)
    return ct[:, -1] - (ct[:, :-1] * sk[None, :]).sum(axis=1, dtype=np.uint64)
