"""Bootstrap building blocks on int64 torus tensors.

Port of the parts of `spf_tpu/ops/bootstrap_u32.py` that the multi-bit
PBS runs: the torus -> spectrum transform, the key-spectrum conversion,
the frequency-domain MAD, the negacyclic monomial multiply and sample
extraction. Layout as in the reference: coefficient axis second to last,
ciphertext batch last.
"""

from __future__ import annotations

import torch

from ..params import GlweDef
from . import ds, fft, torus


def fwd_limb(a: torch.Tensor):
    """int64 torus values [..., N, B] -> spectrum, 4 f32 planes
    [..., N/2, B] in bit-reversed order."""
    hi, lo = torus.to_ds(a)
    return fft.fwd_ds(hi, lo)


def bsk_to_freq(coeff: torch.Tensor):
    """Any coefficient-domain int64 key tensor [..., N] -> its spectra,
    4 f32 planes [..., N/2], made by the port's FFT (on the device of
    `coeff`). The polynomials are laid onto the batch axis ([N, P]) so
    that one transform converts them all."""
    shp = coeff.shape
    n = shp[-1]
    x = coeff.reshape(-1, n).t().contiguous()  # [N, P]
    f = fwd_limb(x)  # 4 x [K, P]
    return tuple(c.t().contiguous().reshape(*shp[:-1], n // 2) for c in f)


def freq_mad(dfft, ggsw_row):
    """Frequency-domain MAD: digit spectra [l, k+1, K, B] x one GGSW row
    [k+1, l, k+1, K] -> 4 planes [k+1, K, B] (≙ `bootstrap_u32.freq_mad`,
    same order of accumulation)."""
    l, kp1 = dfft[0].shape[:2]
    shape = (kp1, *dfft[0].shape[2:])
    acc = tuple(torch.zeros(shape, dtype=torch.float32, device=dfft[0].device) for _ in range(4))
    for i in range(kp1):
        for j in range(l):
            d = tuple(c[j, i][None] for c in dfft)  # [1, K, B]
            g = tuple(c[i, j][..., None] for c in ggsw_row)  # [k+1, K, 1]
            acc = ds.cadd(acc, ds.cmul(d, g))
    return acc


def monomial_mul(a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """a int64 [..., N, B] times X^t, per batch column t int64 [B] in
    [0, 2N] (negacyclic): out[j] = a[s] if s < N else -a[s - N], with
    s = (j - t) mod 2N."""
    n = a.shape[-2]
    j = torch.arange(n, device=a.device)[:, None]
    s = torch.remainder(j - t[None, :], 2 * n)  # [N, B]
    src = torch.where(s < n, s, s - n).expand(a.shape)
    g = torch.gather(a, -2, src)
    return torch.where(s >= n, -g, g)


def sample_extract(glwe_t: torch.Tensor, h: int, glwe: GlweDef) -> torch.Tensor:
    """GLWE int64 [k+1, N, B] -> LWE int64 [k*N+1, B] extracting
    coefficient h (≙ `bootstrap_u32.sample_extract_u32`)."""
    n = glwe.degree
    a = glwe_t[:-1]  # [k, N, B]
    b = glwe_t[-1]  # [N, B]
    j = torch.arange(n, device=glwe_t.device)
    idx = torch.remainder(h - j, n)
    gathered = a[:, idx]
    a_lwe = torch.where((j > h)[:, None], -gathered, gathered)
    return torch.cat([a_lwe.reshape(glwe.size * n, -1), b[h][None]], dim=0)
