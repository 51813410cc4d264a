"""Batched programmable and circuit bootstrapping in the coefficient-major
("t") layout.

Port of `spf_tpu/ops/bootstrap_tpu.py`, the JAX package's ds32 path
(`bench.py --backend ds32` and the suite's bivariate PBS). Every
ciphertext tensor puts the polynomial / coefficient axis second to last
and the ciphertext batch last:

- LWE batch:  int64 [n0+1, B]
- GLWE batch: int64 [k+1, N, B]
- BSK:        freq tuple of 4 f32 [n0, k+1, l, k+1, N/2] (broadcast over
              the batch lanes)

Torus values are wrapping int64 (`ops/u64/torus.py`), the transforms
`fft_ds32_t.py`'s, and the order of operations the reference's, so every
function is bit for bit with the reference run op by op. The blind
rotation is a Python loop over the n0 steps (the reference's
`lax.fori_loop`); the per-step monomial rotations are the reference's
bit-selected static rolls. The reference reaches no `pallas_call`, so
this family is plain PyTorch on the card and launches none of the port's
kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import GlweDef, LweDef, RadixDecomposition
from . import fft_ds32_t as ft
from .torus import shr_round
from .u64.cbs import _log_v, multifunctional_cbs_lut
from .u64.ciphertext import lwe_modulus_switch
from .u64.decomp import decompose
from .u64.torus import encode, u64


def to_t_layout(x: torch.Tensor) -> torch.Tensor:
    """[B, ...] -> [..., B]: move the batch axis last."""
    return torch.movedim(x, 0, -1)


def from_t_layout(x: torch.Tensor) -> torch.Tensor:
    return torch.movedim(x, -1, 0)


def bsk_to_t(bsk_coeff):
    """Coefficient-domain BSK int64 (or u64 numpy) [n0, k+1, l, k+1, N] ->
    freq tuple [n0, k+1, l, k+1, N/2] (no batch axis; broadcast over
    lanes), on the key's device."""
    f = ft.fwd_torus_t(u64(bsk_coeff)[..., None])
    return tuple(c[..., 0] for c in f)


def monomial_mul_t(a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """a [..., N, B] times X^t with per-batch t [B] (negacyclic), as
    log2(2N) static negacyclic rolls selected by the bits of t."""
    n = a.shape[-2]
    t = u64(t)
    out = a
    # X^(2^i) for i < log2(N): roll down by 2^i with sign wrap
    for i in range(n.bit_length() - 1):
        s = 1 << i
        rolled = torch.roll(out, s, dims=-2)
        sign_mask = (torch.arange(n, device=a.device) < s)[:, None]
        rolled = torch.where(sign_mask, -rolled, rolled)
        bit = ((t >> i) & 1) > 0  # [B]; bit i of the u64, i < 63
        out = torch.where(bit, rolled, out)
    # X^N = -1
    bit_n = ((t >> (n.bit_length() - 1)) & 1) > 0
    return torch.where(bit_n, -out, out)


def _mac(acc, d, g):
    """acc + d[t] * g[t] for t along the leading axis, the terms added one
    at a time in order, as the reference's loop of `cmadd_t` adds them;
    the products run as one operator each."""
    prods = ft._cmul(d, g)
    for t in range(prods[0].shape[0]):
        acc = ft._cadd(acc, tuple(c[t] for c in prods))
    return acc


def external_product_t(glwe: torch.Tensor, ggsw_fft_row, glwe_def: GlweDef,
                       radix: RadixDecomposition):
    """glwe int64 [k+1, N, B] times a GGSW freq row (components
    [k+1, l, k+1, K], or [k+1, l, k+1, K, B] for one GGSW a lane) ->
    freq tuple [k+1, K, B]."""
    kp1 = glwe_def.size + 1
    k2 = glwe_def.degree // 2
    bb = glwe.shape[-1]
    l = radix.count
    digits = decompose(glwe, radix)  # [l, k+1, N, B]
    dfft = ft.fwd_signed_t(digits)  # tuple [l, k+1, K, B]
    # the terms (i, j), i-major: digit j of row i times GGSW row (i, j)
    d = tuple(c.transpose(0, 1).reshape(kp1 * l, 1, k2, bb) for c in dfft)  # [., 1, K, B]
    if ggsw_fft_row[0].dim() == 5:
        g = tuple(c.reshape(kp1 * l, kp1, k2, bb) for c in ggsw_fft_row)  # [., k+1, K, B]
    else:
        g = tuple(c.reshape(kp1 * l, kp1, k2, 1) for c in ggsw_fft_row)  # [., k+1, K, 1]
    return _mac(ft.zeros_t((kp1, k2, bb), glwe.device), d, g)


def cmux_t(d0, d1, ggsw_fft_row, glwe_def: GlweDef, radix: RadixDecomposition):
    """d0 + GGSW ⊡ (d1 - d0) on GLWE batches int64 [k+1, N, B]."""
    d0 = u64(d0)
    diff = u64(d1) - d0
    prod = ft.inv_t(external_product_t(diff, ggsw_fft_row, glwe_def, radix))
    return d0 + prod


def blind_rotate_t(lut_glwe_t: torch.Tensor, ct_switched_t: torch.Tensor, bsk_fft_t,
                   lwe: LweDef, glwe: GlweDef, radix: RadixDecomposition) -> torch.Tensor:
    """lut [k+1, N, B] (or broadcastable), ct [n0+1, B] with phases < 2N
    -> the rotated accumulator [k+1, N, B]: acc = lut X^(-b), then
    acc = cmux(acc, acc X^(a_i), BSK_i) for each of the n0 steps."""
    a = ct_switched_t[:-1]  # [n0, B]
    b = ct_switched_t[-1]  # [B]
    lut = lut_glwe_t.expand(glwe.size + 1, glwe.degree, ct_switched_t.shape[-1])
    acc = monomial_mul_t(lut, 2 * glwe.degree - b)
    for i in range(lwe.dim):
        rotated = monomial_mul_t(acc, a[i])
        row = tuple(c[i] for c in bsk_fft_t)
        acc = cmux_t(acc, rotated, row, glwe, radix)
    return acc


def sample_extract_t(glwe_t: torch.Tensor, h: int, glwe: GlweDef) -> torch.Tensor:
    """[k+1, N, B] -> LWE [k*N+1, B] extracting coefficient h."""
    n = glwe.degree
    a, b = glwe_t[:-1], glwe_t[-1]  # [k, N, B], [N, B]
    j = np.arange(n)
    idx = torch.from_numpy((h - j) % n).to(glwe_t.device)
    neg = torch.from_numpy(j > h).to(glwe_t.device)[:, None]
    gathered = torch.index_select(a, -2, idx)
    a_lwe = torch.where(neg, -gathered, gathered)
    a_flat = a_lwe.reshape(glwe.size * n, -1)
    return torch.cat([a_flat, b[h][None, :]], dim=0)


def programmable_bootstrap_t(ct_t, lut_glwe, bsk_fft_t, lwe: LweDef, glwe: GlweDef,
                             radix: RadixDecomposition) -> torch.Tensor:
    """Univariate PBS in t layout: ct int64 [n0+1, B] -> LWE int64
    [k*N+1, B] under the flattened GLWE key. `lut_glwe` is the standard
    [k+1, N] LUT (`ops.u64.bootstrap.generate_lut`). The bivariate PBS is
    this call on packed inputs, left * 2^bits + right, under
    `generate_bivariate_lut` (`bench.py:1583-1632`)."""
    ct_t = u64(ct_t)
    ct_sw = lwe_modulus_switch(ct_t, 0, 0, glwe.log_degree + 1)
    lut_t = u64(lut_glwe, ct_t.device)[..., None]
    rotated = blind_rotate_t(lut_t, ct_sw, bsk_fft_t, lwe, glwe, radix)
    return sample_extract_t(rotated, 0, glwe)


# --------------------------------------------------------------------------
# circuit bootstrapping in t layout (the full L0 LWE -> L1 GGSW conversion)
# --------------------------------------------------------------------------


def keys_to_t(auto_keys_coeff, ssk_coeff):
    """Coefficient-domain automorphism keys [log2 N, k, l, k+1, N] and
    scheme-switch key [k, k, l, k+1, N] (int64 or u64 numpy) -> t-layout
    freq tuples."""
    ak = ft.fwd_torus_t(u64(auto_keys_coeff)[..., None])
    ssk = ft.fwd_torus_t(u64(ssk_coeff)[..., None])
    return tuple(c[..., 0] for c in ak), tuple(c[..., 0] for c in ssk)


def monomial_mul_static_t(a: torch.Tensor, t: int) -> torch.Tensor:
    """a [..., N, B] times X^t for a static t (roll + sign mask)."""
    n = a.shape[-2]
    t = t % (2 * n)
    neg = t >= n
    s = t % n
    out = a
    if s:
        out = torch.roll(a, s, dims=-2)
        mask = (torch.arange(n, device=a.device) < s)[:, None]
        out = torch.where(mask, -out, out)
    return -out if neg else out


def pow_k_t(a: torch.Tensor, k_exp: int) -> torch.Tensor:
    """Automorphism X -> X^k on [..., N, B] (a static signed permutation
    along axis -2; ≙ `ops.u64.poly.pow_k`)."""
    n = a.shape[-2]
    i = np.arange(n)
    dest = (i * k_exp) % n
    sign_neg = ((i * k_exp) // n) % 2 == 1
    src = np.zeros(n, dtype=np.int64)
    src[dest] = i
    neg = np.zeros(n, dtype=bool)
    neg[dest] = sign_neg
    out = torch.index_select(a, -2, torch.from_numpy(src).to(a.device))
    neg = torch.from_numpy(neg).to(a.device)[:, None]
    return torch.where(neg, -out, out)


def keyswitch_glwe_t(ct: torch.Tensor, ksk_fft_row, glwe_def: GlweDef,
                     radix: RadixDecomposition) -> torch.Tensor:
    """GLWE keyswitch in t layout: ct [k+1, N, B], ksk freq components
    [k, l, k+1, K] -> [k+1, N, B] (≙ `fft_ops.keyswitch_glwe_to_glwe`)."""
    k = glwe_def.size
    kp1 = k + 1
    k2 = glwe_def.degree // 2
    bb = ct.shape[-1]
    l = radix.count
    a, b = ct[:-1], ct[-1]
    digits = decompose(a, radix)  # [l, k, N, B]
    dfft = ft.fwd_signed_t(digits)
    # the terms (i, j), i-major
    d = tuple(c.transpose(0, 1).reshape(k * l, 1, k2, bb) for c in dfft)
    g = tuple(c.reshape(k * l, kp1, k2, 1) for c in ksk_fft_row)
    a_sum = ft.inv_t(_mac(ft.zeros_t((kp1, k2, bb), ct.device), d, g))
    trivial_b = torch.zeros_like(ct)
    trivial_b[-1] = b
    return trivial_b - a_sum


def trace_t(ct: torch.Tensor, auto_keys_fft_t, glwe_def: GlweDef,
            radix: RadixDecomposition) -> torch.Tensor:
    """Homomorphic trace in t layout (≙ `automorphism.trace`)."""
    n = glwe_def.degree
    out = u64(ct)
    for i in range(1, glwe_def.log_degree + 1):
        k_exp = n // (1 << (i - 1)) + 1
        mapped = pow_k_t(out, k_exp)
        row = tuple(c[i - 1] for c in auto_keys_fft_t)
        out = out + keyswitch_glwe_t(mapped, row, glwe_def, radix)
    return out


def scheme_switch_t(glev: torch.Tensor, ssk_fft_t, glwe_def: GlweDef,
                    radix_ggsw: RadixDecomposition, radix_ss: RadixDecomposition):
    """GLEV [l_ggsw, k+1, N, B] -> GGSW freq tuple [k+1, l_ggsw, k+1, K, B]
    (≙ `fft_ops.scheme_switch_fft`)."""
    k = glwe_def.size
    kp1 = k + 1
    k2 = glwe_def.degree // 2
    bb = glev.shape[-1]
    l_ggsw = radix_ggsw.count
    a = glev[:, :-1]  # [l, k, N, B]
    b = glev[:, -1]  # [l, N, B]
    b_fft = ft.fwd_torus_t(b)  # [l, K, B]
    l_ss = radix_ss.count
    digits = decompose(a, radix_ss)  # [l_ss, l, k, N, B]
    dfft = ft.fwd_signed_t(digits)
    # the terms (r, jj), r-major: digit jj of GLEV column r, [., l, 1, K, B]
    d = tuple(c.permute(2, 0, 1, 3, 4).reshape(k * l_ss, l_ggsw, 1, k2, bb) for c in dfft)
    rows = []
    for j in range(k):
        acc = []
        for c in range(4):
            plane = torch.zeros((l_ggsw, kp1, k2, bb), dtype=torch.float32, device=glev.device)
            plane[:, j] = b_fft[c]
            acc.append(plane)
        g = tuple(c[j].reshape(k * l_ss, 1, kp1, k2, 1) for c in ssk_fft_t)  # [., 1, k+1, K, 1]
        rows.append(_mac(tuple(acc), d, g))
    rows.append(ft.fwd_torus_t(glev))  # row k
    return tuple(torch.stack([rows[r][c] for r in range(kp1)], dim=0) for c in range(4))


def circuit_bootstrap_t(ct_t, bsk_fft_t, auto_keys_fft_t, ssk_fft_t, params):
    """The WHS+24 circuit bootstrap in t layout: L0 LWE batch int64
    [n0+1, B] -> L1 GGSW freq tuple [k+1, l_cbs, k+1, K, B]
    (≙ `cbs.circuit_bootstrap`). As the reference, the blind rotation runs
    at `params.pbs_radix`, so `bsk_fft_t` is the PBS's key."""
    p = params
    glwe = p.l1_params
    cbs_radix = p.cbs_radix
    # 1. rotate by q/4 and multi-function PBS
    ct_rot = u64(ct_t).clone()
    ct_rot[-1] += encode(1, 2)
    lut = multifunctional_cbs_lut(glwe, cbs_radix, ct_rot.device)
    ct_sw = lwe_modulus_switch(ct_rot, 0, _log_v(cbs_radix.count), glwe.log_degree + 1)
    lo_noise = blind_rotate_t(lut[..., None], ct_sw, bsk_fft_t, p.l0_params, glwe, p.pbs_radix)
    # 2. per level: un-rotate offset, X^{-i}, mod-switch (>> log2 N), trace
    rows = []
    rotated = lo_noise
    for i in range(cbs_radix.count):
        pb = cbs_radix.radix_log * (i + 1) + 1
        rotated = rotated.clone()
        rotated[-1, i] += encode(1, pb)
        permuted = monomial_mul_static_t(rotated, 2 * glwe.degree - i)
        shifted = shr_round(permuted, glwe.log_degree)
        rows.append(trace_t(shifted, auto_keys_fft_t, glwe, p.tr_radix))
    glev = torch.stack(rows, dim=0)  # [l, k+1, N, B]
    # 3. scheme switch
    return scheme_switch_t(glev, ssk_fft_t, glwe, cbs_radix, p.ss_radix)
