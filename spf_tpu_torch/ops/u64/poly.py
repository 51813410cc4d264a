"""Exact negacyclic polynomial arithmetic over Z_q[X]/(X^N+1), q = 2**64.

Port of `spf_tpu/ops/poly.py`: the exact products of the encryption and
keygen paths (≙ `sunscreen_tfhe/src/math/polynomial.rs:114-154`) and the
monomial and automorphism permutations (`ops/polynomial/mod.rs:19-91`).
All functions take leading batch dims.

PyTorch has no int64 matrix product on the card, so the exact product
cuts both operands into 16-bit planes and sums the plane products that
reach below 2^64 as f64 products, exact while the <= 4 products of one
weight sum below 2^53 (4 * N * 2^32, so N <= 2^18). A product with a binary key is cheaper
through `ops.encryption.negacyclic_mul_binary`, which the u64 encryption
uses.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import torus as _torus
from .torus import u64


@functools.lru_cache(maxsize=8)
def _negacyclic_index_sign(n: int):
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    return np.mod(j - i, n), j < i  # wrapped terms pick up a minus sign


def negacyclic_matrix(p: torch.Tensor) -> torch.Tensor:
    """M[..., i, j] with (a (*) p)[j] = sum_i a[i] * M[i, j] mod 2**64:
    p[j - i] if j >= i else -p[N + j - i]."""
    p = u64(p)
    idx, sign_neg = _negacyclic_index_sign(p.shape[-1])
    m = p[..., torch.from_numpy(idx).to(p.device)]
    return torch.where(torch.from_numpy(sign_neg).to(p.device), -m, m)


def _planes(x: torch.Tensor) -> list:
    return [((x >> (16 * k)) & 0xFFFF).to(torch.float64) for k in range(4)]


def negacyclic_mul_by_matrix(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """a [..., N] times a negacyclic matrix [..., N, N], exact mod 2**64."""
    pa, pm = _planes(u64(a)[..., None, :]), _planes(u64(m))
    out = None
    for s in range(4):  # plane sums of weight 2^(16 s) (higher ones vanish mod 2^64)
        part = sum(torch.matmul(pa[i], pm[s - i]) for i in range(s + 1))
        term = part.to(torch.int64) << (16 * s)
        out = term if out is None else out + term
    return out[..., 0, :]


def negacyclic_mul_exact(a, p) -> torch.Tensor:
    """Exact wrapping negacyclic product a (*) p (both [..., N])."""
    return negacyclic_mul_by_matrix(a, negacyclic_matrix(p))


def monomial_mul_batch(a: torch.Tensor, t) -> torch.Tensor:
    """a [..., N] times X^t mod (X^N + 1), one t per leading-batch element
    (t [...] broadcast against a's leading dims, any value; X^(2N) = 1):
    out[j] = a[u] if u < N else -a[u - N], u = (j - t) mod 2N. Runs
    `ops.torus.monomial_mul` on the batch-last view."""
    a = u64(a)
    t = torch.as_tensor(t, dtype=torch.int64, device=a.device)
    n = a.shape[-1]
    lead = torch.broadcast_shapes(a.shape[:-1], t.shape)
    cols = a.expand(*lead, n).reshape(-1, n).t()
    out = _torus.monomial_mul(cols, t.expand(lead).reshape(-1))
    return out.t().reshape(*lead, n)


def monomial_mul(a: torch.Tensor, t) -> torch.Tensor:
    """a [..., N] times X^t, one t for all (`glwe_ciphertext_ops.rs:285`)."""
    return monomial_mul_batch(a, torch.as_tensor(t, dtype=torch.int64))


def pow_k(a: torch.Tensor, k: int) -> torch.Tensor:
    """The automorphism X -> X^k (k odd): coefficient i moves to i*k mod N
    with sign (-1)^floor(i*k / N) (`ops/polynomial/mod.rs` `polynomial_pow_k`)."""
    a = u64(a)
    n = a.shape[-1]
    assert k % 2 == 1, "automorphism requires odd k"
    i = np.arange(n)
    dest = (i * k) % n
    src = np.zeros(n, dtype=np.int64)
    src[dest] = i
    neg = np.zeros(n, dtype=bool)
    neg[dest] = ((i * k) // n) % 2 == 1
    out = a[..., torch.from_numpy(src).to(a.device)]
    return torch.where(torch.from_numpy(neg).to(a.device), -out, out)


def shr_round_poly(a, bits: int) -> torch.Tensor:
    """Per-coefficient shift right with rounding (`polynomial_shr_round`)."""
    return _torus.shr_round(u64(a), bits)
