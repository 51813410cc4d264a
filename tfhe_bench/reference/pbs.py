"""A plain multi-bit programmable bootstrap in PyTorch.

Written from the scheme, not from the program, and importing nothing of
it: it takes the benchmark's coefficient-domain bootstrap key (the
layout of `frozen/keygen.generate_multibit_bsk`: bsk[t, m-1] is the GGSW
of prod_{j: bit j of m} s[t*g + j], row i < k GLEV(-s_i * m), row k
GLEV(m), level j at q / B^(j+1)), the LUT polynomial and LWE
ciphertexts, and returns the extracted LWE ciphertexts.

    ct -> modulus switch to 2N -> acc = X^(-b) * LUT
       -> per group t: acc += sum_S c_S * ExtProd(BSK[t, S], acc),
          c_S = prod_{j in S} (X^(a_j) - 1)
       -> sample extract (coefficient 0)

The polynomial products run in the frequency domain of a negacyclic FFT
of length N (a twist by exp(-i pi j / N), then a complex DFT) in the
complex type of `dtype`: the key's coefficients are cut into four
16-bit pieces, each product is rounded back to integers and the pieces
recombined mod 2^64. In float64 the rounded products are exact at the
sizes of DEFAULT_128 but for rare ties; in float32 they are not, which
makes it the control: the same bootstrap one precision below the ds32
(about 48-bit) arithmetic that the configuration states.
"""

from __future__ import annotations

import math

import torch

_PIECES = 4
_PIECE_BITS = 16


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of the u64 bits of int64 x."""
    return (x >> n) & ((1 << (64 - n)) - 1) if n else x


def modulus_switch(x: torch.Tensor, log_2n: int) -> torch.Tensor:
    """round(x * 2N / 2^64) mod 2N."""
    shift = 64 - log_2n
    return (_shr(x, shift) + (_shr(x, shift - 1) & 1)) & ((1 << log_2n) - 1)


def monomial_mul(p: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """X^e * p negacyclic: p int64 [..., N], e int64 [B] in [0, 2N) ->
    [B, ..., N]."""
    n = p.shape[-1]
    j = torch.arange(n, device=p.device)
    src = torch.remainder(j[None, :] - e[:, None], 2 * n)  # [B, N]
    g = p[..., torch.where(src < n, src, src - n)]  # [..., B, N]
    g = torch.where(src >= n, -g, g)
    return g.movedim(-2, 0)


def decompose(x: torch.Tensor, count: int, log_b: int) -> torch.Tensor:
    """Signed gadget digits of int64 x: [count, ...], digit j pairs with
    level j (q / B^(j+1)), each in [-B/2, B/2)."""
    shift = 64 - count * log_b
    v = _shr(x, shift) + (_shr(x, shift - 1) & 1) if shift else x
    mask = (1 << log_b) - 1
    digits = []
    for _ in range(count):
        d = v & mask
        v = _shr(v, log_b)
        carry = d >> (log_b - 1)
        v = v + carry
        digits.append(d - (carry << log_b))
    return torch.stack(digits[::-1])


class _Fft:
    """Negacyclic FFT of length N in a complex type."""

    def __init__(self, n: int, cdtype: torch.dtype, device):
        j = torch.arange(n, dtype=torch.float64, device=device)
        self.n = n
        self.cdtype = cdtype
        self.rdtype = torch.float64 if cdtype == torch.complex128 else torch.float32
        self.twist = torch.polar(torch.ones_like(j), -math.pi * j / n).to(cdtype)
        self.untwist = torch.polar(torch.ones_like(j), math.pi * j / n).to(cdtype)
        # the evaluation points exp(-i pi (2f + 1) / N) as exponents of
        # exp(-i pi / N): X^a at bin f is exp(-i pi a (2f + 1) / N)
        self.odd = 2 * torch.arange(n, device=device) + 1

    def fwd(self, x: torch.Tensor) -> torch.Tensor:
        """int64 or real [..., N] -> [..., N] complex."""
        return torch.fft.fft(x.to(self.rdtype) * self.twist, dim=-1)

    def inv_round(self, f: torch.Tensor) -> torch.Tensor:
        """[..., N] complex -> int64 [..., N], the real part rounded."""
        x = torch.fft.ifft(f, dim=-1) * self.untwist
        return torch.round(x.real).to(torch.int64)

    def monomial_minus_one(self, a: torch.Tensor) -> torch.Tensor:
        """X^a - 1 at every bin for exponents a int64 [B]: [B, N] complex."""
        e = torch.remainder(a[:, None] * self.odd[None, :], 2 * self.n).to(torch.float64)
        z = torch.polar(torch.ones_like(e), -math.pi * e / self.n)
        return (z - 1).to(self.cdtype)


def _pieces(x: torch.Tensor) -> torch.Tensor:
    """int64 [...] -> its four unsigned 16-bit pieces [..., 4]."""
    return torch.stack([_shr(x, _PIECE_BITS * p) & 0xFFFF for p in range(_PIECES)], dim=-1)


def _recombine(v: torch.Tensor) -> torch.Tensor:
    """int64 [4, ...] pieces -> sum_p v_p * 2^(16 p) mod 2^64."""
    out = v[0]
    for p in range(1, _PIECES):
        out = out + (v[p] << (_PIECE_BITS * p))
    return out


def blind_rotate(acc: torch.Tensor, a: torch.Tensor, bsk: torch.Tensor, group: int,
                 count: int, log_b: int, fft: _Fft) -> torch.Tensor:
    """acc int64 [B, k+1, N], a int64 [ng*g, B] switched mask (padded with
    zeros), bsk int64 [ng, 2^g-1, k+1, l, k+1, N] -> the rotated acc."""
    ns = (1 << group) - 1
    for t in range(bsk.shape[0]):
        # ExtProd(BSK[t, S], acc) for every S at once, in the frequency domain
        dig = decompose(acc, count, log_b)  # [l, B, k+1, N]
        dig_f = fft.fwd(dig)  # [l, B, k+1, N]
        key_f = fft.fwd(_pieces(bsk[t]).movedim(-1, 0))  # [4, S, k+1 (i), l, k+1 (o), N]
        # c_S = prod_{j in S} (X^(a_j) - 1) at every bin, [S, B, N]
        factors = [fft.monomial_minus_one(a[t * group + j]) for j in range(group)]
        c = []
        for m in range(1, ns + 1):
            f = None
            for j in range(group):
                if m & (1 << j):
                    f = factors[j] if f is None else f * factors[j]
            c.append(f)
        total = None
        for s in range(ns):
            # sum_{i, j} digit(i, j) * key piece row (i, j) -> [4, B, k+1 (o), N]
            prod = torch.einsum("jbif,pijof->pbof", dig_f, key_f[:, s])
            term = prod * c[s][None, :, None, :]
            total = term if total is None else total + term
        acc = acc + _recombine(fft.inv_round(total))
    return acc


def programmable_bootstrap(ct: torch.Tensor, lut: torch.Tensor, bsk: torch.Tensor, group: int,
                           count: int, log_b: int, dtype: torch.dtype = torch.float64,
                           chunk: int = 256) -> torch.Tensor:
    """LWE int64 [n0+1, B] -> LWE int64 [k*N+1, B] under the flattened GLWE
    key, `lut` int64 [k+1, N], `bsk` int64 [ng, 2^g-1, k+1, l, k+1, N];
    `dtype` float64 (the plain reference) or float32 (the control). Runs
    `chunk` ciphertexts at a time."""
    kp1, n = lut.shape
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    fft = _Fft(n, cdtype, ct.device)
    log_2n = (2 * n).bit_length() - 1
    ng = bsk.shape[0]
    outs = []
    for c0 in range(0, ct.shape[1], chunk):
        sw = modulus_switch(ct[:, c0:c0 + chunk], log_2n)  # [n0+1, B]
        a = torch.zeros((ng * group, sw.shape[1]), dtype=torch.int64, device=ct.device)
        a[: sw.shape[0] - 1] = sw[:-1]
        acc = monomial_mul(lut, torch.remainder(2 * n - sw[-1], 2 * n))  # [B, k+1, N]
        acc = blind_rotate(acc, a, bsk, group, count, log_b, fft)
        outs.append(sample_extract(acc))
    return torch.cat(outs, dim=1)


def sample_extract(acc: torch.Tensor) -> torch.Tensor:
    """GLWE int64 [B, k+1, N] -> LWE int64 [k*N+1, B] of coefficient 0:
    mask (a_0, -a_{N-1}, ..., -a_1) per mask polynomial, body b_0."""
    mask = acc[:, :-1]  # [B, k, N]
    rev = torch.cat([mask[..., :1], -mask[..., 1:].flip(-1)], dim=-1)
    return torch.cat([rev.reshape(acc.shape[0], -1), acc[:, -1, :1]], dim=1).T.contiguous()
