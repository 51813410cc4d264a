"""Multi-bit (grouped) blind rotation: g LWE key bits per step.

Port of `spf_tpu/ops/multibit.py`, following the reference's TPU branch.
For binary secrets the monomial over a group G expands exactly,

    X^{sum_{j in G} a_j s_j} = 1 + sum_{S != {}} c_S * prod_{j in S} s_j,
    c_S = prod_{j in S} (X^{a_j} - 1),

so with a multi-bit bootstrap key BSK[t, S] = GGSW(prod_{j in S} s_j)
one step of the loop is

    acc += IFFT( sum_S c_S * MAD(FFT(decomp(acc)), BSK[t, S]) )

where each (X^{a_j} - 1) is diagonal in the frequency domain
(`phase_rot`). Per step the loop runs four kernels: accumulate and
decompose (`rot_decomp`), the forward FFT (`fft`), MAD + Horner subset
phases with the step's (phase - 1) factors formed from their hoisted
halves (`mad`) and the inverse FFT. The LWE dimension is padded to a
multiple of g with zero mask coefficients, which is exact: a padded bit
contributes phase(0) - 1 = 0.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..params import GlweDef, RadixDecomposition
from . import fft, torus
from .bootstrap import as_tensor, register_spectra, sample_extract, spectra
from .mad import mad_horner
from .phase_rot import phase_factors_all
from .rot_decomp import accumulate_decompose


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


def padded_mask(ct_switched, group: int):
    """The mask rows a [n0, B] of switched ciphertexts [n0+1, B], padded
    with zero rows to a multiple of g (a padded bit contributes
    phase(0) - 1 = 0)."""
    a = ct_switched[:-1]
    pad = n_groups(a.shape[0], group) * group - a.shape[0]
    if pad:
        a = torch.cat([a, a.new_zeros((pad, a.shape[1]))], dim=0)
    return a


def group_phases(a, n: int, group: int):
    """The per-bit (phase - 1) outer-product factors of every step of the
    padded mask a [ng*g, B]: (lo, hi), 4 planes [ng, g, Klo, B] and
    [ng, g, Khi, B], views of `phase_factors_all`'s contiguous planes."""
    ng = a.shape[0] // group
    ph_lo, ph_hi = phase_factors_all(a, n)
    return (tuple(c.reshape(ng, group, *c.shape[1:]) for c in ph_lo),
            tuple(c.reshape(ng, group, *c.shape[1:]) for c in ph_hi))


def rotate_groups(acc, ph_lo, ph_hi, bsk_freq, radix: RadixDecomposition, group: int):
    """The group steps of the multi-bit rotation: acc int64 [k+1, N, B]
    (the LUT rotated by -b), the phase factors of `group_phases`, bsk_freq
    4 planes [n_groups, 2^g-1, k+1, l, k+1, K] -> the rotated accumulator."""
    kp1, n, bb = acc.shape
    zero = torch.zeros((kp1, n, bb), dtype=torch.float32, device=acc.device)
    prod = (zero, zero)
    digits_lo = torch.zeros((radix.count, kp1, n, bb), dtype=torch.float32, device=acc.device)
    for t in range(bsk_freq[0].shape[0]):
        digits_f, acc = accumulate_decompose(acc, prod, radix)
        dfft = fft.fwd_ds(digits_f, digits_lo)
        halves = (tuple(c[t] for c in ph_lo), tuple(c[t] for c in ph_hi))  # [g, Klo/Khi, B]
        row = tuple(c[t] for c in bsk_freq)  # [2^g-1, k+1, l, k+1, K]
        prod = fft.inv_ds(mad_horner(dfft, row, halves, group))
    return torus.add(acc, torus.from_ds(*prod))


def blind_rotate_multibit(lut, ct_switched, bsk_freq, glwe: GlweDef,
                          radix: RadixDecomposition, group: int):
    """lut int64 [k+1, N, 1 or B], ct_switched int64 [n0+1, B] with
    phases < 2N, bsk_freq 4 planes [n_groups, 2^g-1, k+1, l, k+1, K] ->
    the rotated accumulator, int64 [k+1, N, B]."""
    n = glwe.degree
    kp1 = glwe.size + 1
    bb = ct_switched.shape[-1]
    assert bsk_freq[0].shape[1] == (1 << group) - 1, (bsk_freq[0].shape, group)
    a = padded_mask(ct_switched, group)
    assert a.shape[0] == bsk_freq[0].shape[0] * group, (bsk_freq[0].shape, group, a.shape)

    acc = torus.monomial_mul(lut.expand(kp1, n, bb), 2 * n - ct_switched[-1])
    # per-bit (phase - 1) outer-product factors of every step, hoisted
    ph_lo, ph_hi = group_phases(a, n, group)
    return rotate_groups(acc, ph_lo, ph_hi, bsk_freq, radix, group)


def programmable_bootstrap_multibit(ct, lut, bsk_freq, glwe: GlweDef,
                                    radix: RadixDecomposition, group: int):
    """Univariate multi-bit PBS: LWE int64 [n0+1, B] -> LWE int64
    [k*N+1, B] under the flattened GLWE key; `lut` int64 [k+1, N]."""
    ct_sw = torus.modulus_switch(ct, 0, 0, glwe.log_degree + 1)
    rotated = blind_rotate_multibit(lut[..., None], ct_sw, bsk_freq, glwe, radix, group)
    return sample_extract(rotated, 0, glwe)


class MultibitBootstrap(nn.Module):
    """The multi-bit PBS with its key spectra and LUT as buffers.

    `bsk`: the coefficient-domain multi-bit bootstrap key, u64 numpy or
    int64 tensor [n_groups, 2^g-1, k+1, l, k+1, N]; its spectra are made
    by the port's FFT on `device`. `lut`: u64 numpy or int64 tensor
    [k+1, N]. Calling the module on LWE ciphertexts int64 [n0+1, B]
    returns LWE ciphertexts int64 [k*N+1, B]."""

    def __init__(self, bsk, lut, glwe: GlweDef, radix: RadixDecomposition,
                 group: int, device="cuda"):
        super().__init__()
        device = torus.resolve_device(device)
        self.glwe = glwe
        self.radix = radix
        self.group = group
        bsk = as_tensor(bsk)
        kp1, l = glwe.size + 1, radix.count
        want = ((1 << group) - 1, kp1, l, kp1, glwe.degree)
        if tuple(bsk.shape[1:]) != want:
            raise ValueError(f"bsk shape {tuple(bsk.shape)}, want [n_groups, *{want}]")
        register_spectra(self, "bsk", bsk, device)
        self.register_buffer("lut", as_tensor(lut).to(device))

    @property
    def bsk_freq(self):
        return spectra(self, "bsk")

    def forward(self, ct: torch.Tensor) -> torch.Tensor:
        return programmable_bootstrap_multibit(
            ct, self.lut, self.bsk_freq, self.glwe, self.radix, self.group
        )
