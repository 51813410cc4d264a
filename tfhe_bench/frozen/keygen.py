"""Keygen, input encryption and LUT polynomials of the benchmark.

A frozen copy, so that the yardstick stays when the program changes:

- `generate_lwe_sk` ... `generate_lwe_keyswitch_key` and `encrypt_lwe`:
  `spf_tpu_torch/ops/encryption.py` at commit 3b95a350bce56f9bff529063c275e4a2c34f9859;
- `multibit_key_products_np`: `spf_tpu_torch/ops/multibit.py`, same commit;
- `generate_lut_np`: `spf_tpu_torch/ops/lut.py`, same commit.

The code is as it was there, with the parameter objects read by their
attributes only (`dim`, `std`; `size`, `degree`, `log_degree`, `std`;
`count`, `radix_log`), so that nothing here imports the program.

Torus elements are wrapping int64 (q = 2^64). Randomness comes from an
explicit `torch.Generator`; tensors are made on the generator's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

TORUS_BITS = 64

# rows of the product a (*) s per f64 matmul (bounds its memory)
_MUL_CHUNK = 2048


def generate_lwe_sk(lwe, generator: torch.Generator) -> torch.Tensor:
    """Uniform binary LWE key, int64 [n]."""
    return torch.randint(0, 2, (lwe.dim,), generator=generator,
                         dtype=torch.int64, device=generator.device)


def generate_glwe_sk(glwe, generator: torch.Generator) -> torch.Tensor:
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


def lwe_dot_binary(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Exact <a, s> mod 2^64 for int64 a [..., n] and a BINARY s [n]: four
    16-bit planes of a times s as f64 matrix-vector products (exact:
    |partial sums| <= n * 2^16 < 2^53), recombined with wrapping shifts."""
    n = s.shape[-1]
    flat = a.reshape(-1, n)
    sf = s.to(torch.float64)
    out = torch.empty(flat.shape[0], dtype=torch.int64, device=a.device)
    for r0 in range(0, flat.shape[0], _MUL_CHUNK):
        x = flat[r0:r0 + _MUL_CHUNK]
        planes = torch.stack([(x >> (16 * p)) & 0xFFFF for p in range(4)]).to(torch.float64)
        q = torch.matmul(planes, sf).to(torch.int64)  # [4, rows]
        out[r0:r0 + _MUL_CHUNK] = q[0] + (q[1] << 16) + (q[2] << 32) + (q[3] << 48)
    return out.reshape(a.shape[:-1])


def encrypt_lwe(msgs: torch.Tensor, lwe_sk: torch.Tensor, lwe,
                generator: torch.Generator) -> torch.Tensor:
    """Torus messages int64 [...] -> LWE ciphertexts int64 [..., n+1]:
    b = <a, s> + m + e."""
    a = uniform_torus((*msgs.shape, lwe.dim), generator)
    b = lwe_dot_binary(a, lwe_sk) + msgs + normal_torus(lwe.std, msgs.shape, generator)
    return torch.cat([a, b[..., None]], dim=-1)


def encrypt_glwe(msgs: torch.Tensor, glwe_sk: torch.Tensor, glwe,
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


def encrypt_glev(msgs: torch.Tensor, glwe_sk: torch.Tensor, glwe, radix,
                 generator: torch.Generator) -> torch.Tensor:
    """GLEVs of small-integer polynomials int64 [..., N]: level j encrypts
    msg * q/B^(j+1) (a wrapping shift). Returns int64 [..., l, k+1, N]."""
    levels = torch.stack(
        [msgs << (TORUS_BITS - radix.radix_log * (j + 1)) for j in range(radix.count)], -2
    )
    return encrypt_glwe(levels, glwe_sk, glwe, generator)


def encrypt_ggsw_scalar(bits: torch.Tensor, glwe_sk: torch.Tensor, glwe, radix,
                        generator: torch.Generator) -> torch.Tensor:
    """GGSWs of scalar messages int64 [G] (binary): rows i < k encrypt
    GLEV(-s_i * m), row k GLEV(m). Returns int64 [G, k+1, l, k+1, N]."""
    k, n = glwe.size, glwe.degree
    m = bits.to(torch.int64)[:, None]
    rows = [-(m * glwe_sk[i][None]) for i in range(k)]  # -(m X^0) (*) s_i
    x0 = torch.zeros((m.shape[0], n), dtype=torch.int64, device=m.device)
    x0[:, 0] = m[:, 0]
    rows.append(x0)
    return encrypt_glev(torch.stack(rows, 1), glwe_sk, glwe, radix, generator)


def n_groups(n0: int, group: int) -> int:
    return -(-n0 // group)


def multibit_key_products_np(lwe_sk_np, group: int) -> np.ndarray:
    """Subset products of key bits per group: u64 [n_groups, 2^g - 1],
    column m-1 = prod_{j: bit j of m} s[t*g + j]; key padded with zeros
    to a multiple of g."""
    sk = np.asarray(lwe_sk_np, dtype=np.uint64)
    ng = n_groups(len(sk), group)
    pad = ng * group - len(sk)
    if pad:
        sk = np.concatenate([sk, np.zeros(pad, np.uint64)])
    bits = sk.reshape(ng, group)
    out = np.ones((ng, (1 << group) - 1), dtype=np.uint64)
    for m in range(1, 1 << group):
        for j in range(group):
            if m & (1 << j):
                out[:, m - 1] *= bits[:, j]
    return out


def generate_multibit_bsk(lwe_sk, glwe_sk: torch.Tensor, glwe, radix, group: int,
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


def pow_k_binary(s: torch.Tensor, k_exp: int) -> torch.Tensor:
    """s(X^k) for binary polynomials s int64 [..., N] (negacyclic): int64
    coefficients in {0, 1, -1}."""
    n = s.shape[-1]
    j = np.arange(n)
    dest = torch.from_numpy((j * k_exp) % n).to(s.device)
    sign = torch.from_numpy(1 - 2 * (((j * k_exp) // n) % 2)).to(s.device)
    out = torch.zeros_like(s)
    out[..., dest] = s * sign
    return out


def generate_automorphism_keys(glwe_sk: torch.Tensor, glwe, radix,
                               generator: torch.Generator) -> torch.Tensor:
    """The log2(N) GLWE keyswitch keys of the homomorphic trace: int64
    [log2 N, k, l, k+1, N]; round i (1-based) holds GLEV(s_r(X^k)) for
    k = N/2^(i-1) + 1 under s."""
    n = glwe.degree
    msgs = torch.stack([pow_k_binary(glwe_sk, n // (1 << (i - 1)) + 1)
                        for i in range(1, glwe.log_degree + 1)])  # [log2 N, k, N]
    return encrypt_glev(msgs, glwe_sk, glwe, radix, generator)


def generate_scheme_switch_key(glwe_sk: torch.Tensor, glwe, radix,
                               generator: torch.Generator) -> torch.Tensor:
    """GLEV(s_i (*) s_j) for i, j < k: int64 [k, k, l, k+1, N]."""
    k = glwe.size
    msgs = torch.stack([
        torch.stack([negacyclic_mul_binary(glwe_sk[min(i, j)], glwe_sk[max(i, j)])
                     for j in range(k)])
        for i in range(k)
    ])  # [k, k, N]
    return encrypt_glev(msgs, glwe_sk, glwe, radix, generator)


def generate_lwe_keyswitch_key(old_sk: torch.Tensor, new_sk: torch.Tensor, new_lwe, radix,
                               generator: torch.Generator) -> torch.Tensor:
    """LWE keyswitch key int64 [n_old, l, n_new+1]: row i, level j =
    LWE_new(s_old_i * q/B^(j+1))."""
    shifts = [TORUS_BITS - radix.radix_log * (j + 1) for j in range(radix.count)]
    msgs = torch.stack([old_sk.to(torch.int64) << sh for sh in shifts], dim=-1)  # [n_old, l]
    return encrypt_lwe(msgs, new_sk, new_lwe, generator)


def generate_lut_np(maps, glwe, plaintext_bits: int) -> np.ndarray:
    """LUT GLWE (trivial, u64 [k+1, N]) for the functions `maps` on
    `plaintext_bits`-bit messages; several maps interleave by
    coefficient (multi-output PBS)."""
    p = 1 << plaintext_bits
    n = glwe.degree
    v = len(maps)
    ceil_v = 1 << (v - 1).bit_length()
    assert n >= p
    stride = n // p
    delta = 64 - plaintext_bits
    c = np.zeros(n, dtype=np.uint64)
    for j in range(p):
        for kk in range(stride):
            fn_id = kk % ceil_v
            if fn_id < v:
                p_i = int(maps[fn_id](j))
                assert 0 <= p_i < p, f"map produced {j} -> {p_i} out of range"
                c[j * stride + kk] = np.uint64(p_i) << np.uint64(delta)
    c[: stride // 2] = np.uint64(0) - c[: stride // 2]
    c = np.roll(c, -(stride // 2))
    lut = np.zeros((glwe.size + 1, n), dtype=np.uint64)
    lut[-1] = c
    return lut
