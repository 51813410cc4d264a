"""Host-side (pure numpy) GLWE/LWE crypto: the encryption and
decryption of program inputs and outputs.

A copy of `spf_tpu/utils/host_crypto.py` (u64 wrapping arithmetic is
exact in numpy; ≙ `glwe_encryption.rs:22-126`). The port's executors take
and return these u64 arrays (GLWE [k+1, N], LWE [n+1]).
"""

from __future__ import annotations

import numpy as np

from ..params import GlweDef, LweDef

U64 = np.uint64


def negacyclic_mul_binary_np(a: np.ndarray, s_binary: np.ndarray) -> np.ndarray:
    """u64[N] (*) binary[N] negacyclic product, exact mod 2^64."""
    n = a.shape[-1]
    con = np.zeros(2 * n, dtype=U64)
    for t in np.nonzero(s_binary)[0]:
        con[t : t + n] += a
    return con[:n] - con[n:]


def encrypt_glwe_np(rng: np.random.Generator, msg_torus: np.ndarray,
                    glwe_sk: np.ndarray, glwe: GlweDef) -> np.ndarray:
    """u64[N] torus message -> u64[k+1, N] under the binary GLWE key."""
    n = glwe.degree
    a = rng.integers(0, 1 << 64, size=(glwe.size, n), dtype=U64)
    e = np.round(rng.normal(0.0, glwe.std * 2.0**64, size=n)).astype(
        np.int64
    ).astype(U64)
    a_s = np.zeros(n, dtype=U64)
    for i in range(glwe.size):
        a_s += negacyclic_mul_binary_np(a[i], np.asarray(glwe_sk[i]))
    b = a_s + np.asarray(msg_torus, dtype=U64) + e
    return np.concatenate([a, b[None]], axis=0)


def decrypt_glwe_np(ct: np.ndarray, glwe_sk: np.ndarray, glwe: GlweDef) -> np.ndarray:
    """m + e = b - sum a_i (*) s_i."""
    a, b = ct[:-1], ct[-1]
    a_s = np.zeros(glwe.degree, dtype=U64)
    for i in range(glwe.size):
        a_s += negacyclic_mul_binary_np(a[i], np.asarray(glwe_sk[i]))
    return b - a_s


def encrypt_glwe_bit_np(rng, bit: int, glwe_sk, glwe: GlweDef) -> np.ndarray:
    """1-bit message in coefficient 0 (the GLWE-bit convention)."""
    msg = np.zeros(glwe.degree, dtype=U64)
    msg[0] = U64(int(bit) & 1) << U64(63)
    return encrypt_glwe_np(rng, msg, glwe_sk, glwe)


def decrypt_glwe_bit_np(ct: np.ndarray, glwe_sk, glwe: GlweDef) -> int:
    phase = int(decrypt_glwe_np(ct, glwe_sk, glwe)[0])
    return ((phase >> 63) + ((phase >> 62) & 1)) & 1


def encrypt_ggsw_scalar_np(rng, m: int, glwe_sk, glwe: GlweDef, radix):
    """GGSW of a degree-0 message: rows i < k encrypt GLEV(-s_i * m),
    row k GLEV(m); GLEV level j scales by q/B^(j+1) — numpy mirror of
    `ops/encryption.encrypt_ggsw_scalar` (≙ `ggsw_encryption.rs:30-71`).
    Returns u64 [k+1, count, k+1, N]."""
    k, n = glwe.size, glwe.degree
    msg = np.zeros(n, dtype=U64)
    msg[0] = U64(int(m))
    rows = []
    for i in range(k + 1):
        if i < k:
            row_msg = U64(0) - negacyclic_mul_binary_np(
                msg, np.asarray(glwe_sk[i])
            )
        else:
            row_msg = msg
        levs = []
        for j in range(radix.count):
            factor = U64((1 << (64 - radix.radix_log * (j + 1))) % (1 << 64))
            levs.append(encrypt_glwe_np(rng, row_msg * factor, glwe_sk, glwe))
        rows.append(np.stack(levs))
    return np.stack(rows)


def encrypt_uint_bits_np(rng, value: int, width: int, glwe_sk,
                         glwe: GlweDef) -> list:
    """LSB-first GLWE bit list (the processor's CtVal layout)."""
    return [
        encrypt_glwe_bit_np(rng, (value >> i) & 1, glwe_sk, glwe)
        for i in range(width)
    ]


def decrypt_uint_bits_np(cts: list, glwe_sk, glwe: GlweDef) -> int:
    v = 0
    for i, ct in enumerate(cts):
        v |= decrypt_glwe_bit_np(np.asarray(ct), glwe_sk, glwe) << i
    return v


def encrypt_lwe_np(rng, msg_torus: int, lwe_sk: np.ndarray,
                   lwe: LweDef) -> np.ndarray:
    a = rng.integers(0, 1 << 64, size=lwe.dim, dtype=U64)
    e = U64(np.int64(round(rng.normal(0.0, lwe.std * 2.0**64))))
    b = (a * np.asarray(lwe_sk, dtype=U64)).sum(dtype=U64) + U64(msg_torus) + e
    return np.concatenate([a, np.array([b], dtype=U64)])
