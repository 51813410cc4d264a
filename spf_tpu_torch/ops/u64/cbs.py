"""Circuit bootstrapping of the u64 API: LWE(bit) -> GGSW(bit) in the
frequency domain.

Port of `spf_tpu/ops/cbs.py`, the WHS+24 variant (≙ `sunscreen_tfhe/src/
ops/bootstrapping/circuit_bootstrapping.rs:342-484`, helpers `:224-298`):
one multi-function PBS puts all l gadget levels into the first l
coefficients of a GLWE; per level a rotation, a switch to q/N and a
homomorphic trace make GLEV row i; a scheme switch makes the GGSW.
"""

from __future__ import annotations

import numpy as np
import torch

from ...params import GlweDef, LweDef, Params, RadixDecomposition
from .automorphism import trace
from .bootstrap import generalized_programmable_bootstrap
from .ciphertext import glwe_mod_switch_and_expand_pow_2, lwe_rotate
from .fft import C128
from .fft_ops import scheme_switch_fft
from .poly import monomial_mul
from .torus import encode, place, u64


def _log_v(count: int) -> int:
    return (count - 1).bit_length()


def multifunctional_cbs_lut(glwe: GlweDef, cbs_radix: RadixDecomposition,
                            device=None) -> torch.Tensor:
    """The multi-function decomposition LUT, a trivial GLWE int64 [k+1, N]
    whose B coefficients cycle through the encodings of -1 in
    T_{B^(i+1)+1} per level, zero-padded to a power of two
    (`circuit_bootstrapping.rs:431-484`), on `device`, else the card."""
    n = glwe.degree
    count = cbs_radix.count
    assert count < 16
    v = 1 << _log_v(count)
    levels = np.zeros(16, dtype=np.uint64)
    for i in range(1, 17):
        pb = cbs_radix.radix_log * i + 1
        if pb < 64:
            levels[i - 1] = np.uint64((1 << pb) - 1) << np.uint64(64 - pb)
    b = np.zeros(n, dtype=np.uint64)
    for i in range(n):
        if i % v < count:
            b[i] = levels[i % v]
    lut = np.zeros((glwe.size + 1, n), dtype=np.uint64)
    lut[-1] = b
    return u64(lut, place(device=device))


def hi_noise_lwe_to_lo_noise_glwe(ct, bsk_fft, lwe: LweDef, glwe: GlweDef,
                                  pbs_radix: RadixDecomposition, cbs_radix: RadixDecomposition,
                                  be=C128) -> torch.Tensor:
    """Rotate the input by q/4 (0 -> q/4, 1 -> 3q/4), then the
    multi-function PBS: GLWE coefficient i < l holds
    encode(±1, radix_log*(i+1)+1) (`circuit_bootstrapping.rs:387-429`)."""
    rotated = lwe_rotate(u64(ct), encode(1, 2))
    lut = multifunctional_cbs_lut(glwe, cbs_radix, rotated.device)
    return generalized_programmable_bootstrap(rotated, lut, bsk_fft, lwe, glwe, pbs_radix,
                                              log_chi=0, log_v=_log_v(cbs_radix.count), be=be)


def mod_switch_trace_and_rotate(lo_noise_glwe, auto_keys_fft, glwe: GlweDef,
                                trace_radix: RadixDecomposition, cbs_radix: RadixDecomposition,
                                be=C128) -> torch.Tensor:
    """Per level i: add encode(1, bits_i) to coefficient i (cumulative, as
    the reference mutates in place), multiply by X^{-i}, shift-round by
    log2 N (a multiply by N^{-1}), then trace: GLEV row i
    (`circuit_bootstrapping.rs:253-298`). Returns int64 [..., l, k+1, N]."""
    rotated = u64(lo_noise_glwe).clone()
    rows = []
    for i in range(cbs_radix.count):
        rotated[..., -1, i] += encode(1, cbs_radix.radix_log * (i + 1) + 1)
        permuted = monomial_mul(rotated, 2 * glwe.degree - i)
        shifted = glwe_mod_switch_and_expand_pow_2(permuted, glwe.log_degree)
        rows.append(trace(shifted, auto_keys_fft, glwe, trace_radix, be))
    return torch.stack(rows, dim=-3)


def circuit_bootstrap(ct, bsk_fft, auto_keys_fft, ssk_fft, params: Params, be=C128):
    """L0 LWE(bit) [..., n0+1] -> L1 GGSW(bit) complex
    [..., k+1, l_cbs, k+1, N/2] (`circuit_bootstrapping.rs:342-385`)."""
    glwe = params.l1_params
    lo_noise_glwe = hi_noise_lwe_to_lo_noise_glwe(ct, bsk_fft, params.l0_params, glwe,
                                                  params.cbs_pbs_radix_eff, params.cbs_radix, be)
    glev = mod_switch_trace_and_rotate(lo_noise_glwe, auto_keys_fft, glwe, params.tr_radix,
                                       params.cbs_radix, be)
    return scheme_switch_fft(glev, ssk_fft, glwe, params.cbs_radix, params.ss_radix, be)
