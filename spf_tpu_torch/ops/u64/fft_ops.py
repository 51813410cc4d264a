"""Frequency-domain hot ops of the u64 API: external product, CMux, GLEV
CMux, GLWE keyswitch, scheme switch.

Port of `spf_tpu/ops/fft_ops.py` (≙ `sunscreen_tfhe/src/ops/fft_ops.rs`).
Ciphertext arguments carry leading batch dims that broadcast against each
other: a wave of gates is one batched call. The multiply-adds run in the
reference's (i, j) order, one elementwise complex128 product and sum each.
"""

from __future__ import annotations

import torch

from ...params import GlweDef, RadixDecomposition
from .decomp import decompose
from .fft import C128
from .torus import u64


def ggsw_to_fft(ggsw: torch.Tensor, be=C128):
    """A coefficient-domain GGSW [..., k+1, l, k+1, N] in the frequency
    domain (how bootstrap keys and L1 GGSWs are stored)."""
    return be.fwd_torus(u64(ggsw))


def glev_to_fft(glev: torch.Tensor, be=C128):
    return be.fwd_torus(u64(glev))


def glwe_from_fft(glwe_fft, be=C128) -> torch.Tensor:
    return be.inv(glwe_fft)


def external_product_fft(glwe, ggsw_fft, glwe_def: GlweDef, radix: RadixDecomposition,
                         be=C128):
    """GGSW ⊡ GLWE -> GLWE in the frequency domain
    (`fft_ops.rs:23-124`): out = sum_i <Decomp(AB_i), GGSW row i>.

    glwe: int64 [..., k+1, N]; ggsw_fft: complex [..., k+1, l, k+1, N/2];
    returns complex [..., k+1, N/2]."""
    kp1 = glwe_def.size + 1
    digit_fft = be.fwd_signed(decompose(glwe, radix))  # [l, ..., k+1, N/2]
    batch = torch.broadcast_shapes(digit_fft.shape[1:-2], ggsw_fft.shape[:-4])
    acc = be.zeros((*batch, kp1, glwe_def.degree // 2), device=digit_fft.device)
    for i in range(kp1):  # GLWE poly index == GGSW row index
        for j in range(radix.count):  # decomposition level == GLEV row
            acc = be.cmadd(acc, digit_fft[j, ..., i, None, :], ggsw_fft[..., i, j, :, :])
    return acc


def external_product(glwe, ggsw_fft, glwe_def, radix, be=C128) -> torch.Tensor:
    """Coefficient-domain external product (one inverse FFT at the end)."""
    return be.inv(external_product_fft(glwe, ggsw_fft, glwe_def, radix, be))


def cmux(d0, d1, sel_ggsw_fft, glwe_def: GlweDef, radix: RadixDecomposition,
         be=C128) -> torch.Tensor:
    """d0 + sel ⊡ (d1 - d0): d1 where the encrypted bit is 1 (`fft_ops.rs:149-181`)."""
    d0 = u64(d0)
    return d0 + external_product(u64(d1) - d0, sel_ggsw_fft, glwe_def, radix, be)


def glev_cmux(d0, d1, sel_ggsw_fft, glwe_def: GlweDef, ggsw_radix: RadixDecomposition,
              be=C128) -> torch.Tensor:
    """CMux over each GLWE row of GLEVs [..., l_glev, k+1, N]
    (`fft_ops.rs:203-221`); sel carries the batch dims without the row axis."""
    d0, d1 = u64(d0), u64(d1)
    rows = [cmux(d0[..., r, :, :], d1[..., r, :, :], sel_ggsw_fft, glwe_def, ggsw_radix, be)
            for r in range(d0.shape[-3])]
    return torch.stack(rows, dim=-3)


def keyswitch_glwe_to_glwe(ct, ksk_fft, glwe_def: GlweDef, radix: RadixDecomposition,
                           be=C128) -> torch.Tensor:
    """trivial(b) - sum_i <decomp(a_i), GLEV_i> (`fft_ops.rs:457-495`).

    ct: int64 [..., k+1, N] under the original key; ksk_fft: complex
    [k, l, k+1, N/2], row i = GLEV(orig_s_i) under the new key."""
    kp1 = glwe_def.size + 1
    ct = u64(ct)
    digit_fft = be.fwd_signed(decompose(ct[..., :-1, :], radix))  # [l, ..., k, N/2]
    acc = be.zeros((*ct.shape[:-2], kp1, glwe_def.degree // 2), device=ct.device)
    for i in range(glwe_def.size):
        for j in range(radix.count):
            acc = be.cmadd(acc, digit_fft[j, ..., i, None, :], ksk_fft[i, j])
    out = -be.inv(acc)
    out[..., -1, :] += ct[..., -1, :]
    return out


def scheme_switch_fft(glev, ssk_fft, glwe_def: GlweDef, radix_ggsw: RadixDecomposition,
                      radix_ss: RadixDecomposition, be=C128):
    """GLEV(m) -> GGSW(m) in the frequency domain with a scheme switch key
    (WHS+24; `fft_ops.rs:403-442,245-279`). For output row j < k, level i:
    mask position j := fft(b^(i)) (encrypts -b s_j), plus
    sum_r <decomp(a_r^(i)), SSK[j, r]>; row k, level i: fft(x_i).

    glev: int64 [..., l_ggsw, k+1, N]; ssk_fft: complex [k, k, l_ss, k+1,
    N/2], symmetric in its first two axes; returns complex GGSW
    [..., k+1, l_ggsw, k+1, N/2]."""
    k = glwe_def.size
    kp1 = k + 1
    glev = u64(glev)
    b_fft = be.fwd_torus(glev[..., -1, :])  # [..., l_ggsw, N/2]
    digit_fft = be.fwd_signed(decompose(glev[..., :-1, :], radix_ss))  # [l_ss, ..., l_ggsw, k, N/2]
    rows = []
    for j in range(k):
        acc = be.zeros((*glev.shape[:-2], kp1, glwe_def.degree // 2), device=glev.device)
        acc[..., j, :] = b_fft  # `update_encrypted_secret_key_component_fft`, fft_ops.rs:225-242
        for r in range(k):
            for jj in range(radix_ss.count):
                acc = be.cmadd(acc, digit_fft[jj, ..., :, r, None, :], ssk_fft[j, r, jj])
        rows.append(acc)
    rows.append(be.fwd_torus(glev))  # row k: the FFT of each x_i
    return be.stack(rows, axis=-4)
