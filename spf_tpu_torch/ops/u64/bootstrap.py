"""Programmable bootstrapping of the u64 API: LUT construction, blind
rotation, PBS.

Port of `spf_tpu/ops/bootstrap.py` (≙ `sunscreen_tfhe/src/ops/
bootstrapping/programmable_bootstrapping.rs`). The blind rotation is a
Python loop over the n0 key rows (the reference's `lax.fori_loop`): each
step rotates the whole accumulator batch by its per-element a_i and CMuxes
with bootstrap-key row i, one batched call of elementwise PyTorch and
`torch.fft` a step.
"""

from __future__ import annotations

import numpy as np
import torch

from ...params import GlweDef, LweDef, RadixDecomposition
from .. import encryption as _enc
from .ciphertext import lwe_modulus_switch, sample_extract
from .encryption import encrypt_ggsw_scalar
from .fft import C128
from .fft_ops import cmux
from .poly import monomial_mul, monomial_mul_batch
from .torus import place, u64


def generate_bootstrap_key(generator, lwe_sk, glwe_sk, lwe: LweDef, glwe: GlweDef,
                           radix: RadixDecomposition, be=C128):
    """One GGSW(s_i) per LWE key bit under the GLWE key
    (`programmable_bootstrapping.rs:34-58`), in the frequency domain:
    complex [n, k+1, l, k+1, N/2] (`ops.encryption.generate_bsk`'s key)."""
    assert lwe_sk.shape[-1] == lwe.dim
    return be.fwd_torus(_enc.generate_bsk(lwe_sk, glwe_sk, glwe, radix, generator))


def generate_blind_rotation_shift(generator, rotation: int, glwe_sk, glwe: GlweDef,
                                  radix: RadixDecomposition, be=C128):
    """A rotation amount as log2(N) GGSW bit encryptions
    (`ops/bootstrapping/blind_rotation.rs:226-258`): complex
    [log2 N, k+1, l, k+1, N/2]."""
    assert 0 <= rotation < glwe.degree
    bits = torch.tensor([(rotation >> i) & 1 for i in range(glwe.log_degree)],
                        device=generator.device)
    return be.fwd_torus(encrypt_ggsw_scalar(generator, bits, glwe_sk, glwe, radix))


def blind_rotation(ct, shift_fft, glwe: GlweDef, radix: RadixDecomposition,
                   be=C128) -> torch.Tensor:
    """Rotate a GLWE's message by X^{-shift} for an encrypted shift: a
    CMux ladder by X^{-2^i} at level i (`blind_rotation.rs:202-224`)."""
    out = u64(ct)
    for i in range(glwe.log_degree):
        rotated = monomial_mul(out, 2 * glwe.degree - (1 << i))
        out = cmux(out, rotated, shift_fft[i], glwe, radix, be)
    return out


def generate_lut(maps, glwe: GlweDef, plaintext_bits: int, device=None) -> torch.Tensor:
    """A univariate (possibly multi-function) LUT as a trivial GLWE
    [k+1, N] (`programmable_bootstrapping.rs:129-185`) on `device`, else
    the card; see `generate_lut_np`."""
    return u64(generate_lut_np(maps, glwe, plaintext_bits), place(device=device))


def generate_lut_np(maps, glwe: GlweDef, plaintext_bits: int) -> np.ndarray:
    """The LUT on the host, u64 [k+1, N]: p = 2^plaintext_bits entries of
    N/p coefficients, position k of a stride holding function
    k mod ceil_pow2(len(maps)); then the first half stride negated and the
    table rotated left by it, so rounding at stride boundaries works."""
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


def blind_rotate(lut_glwe, ct_switched, bsk_fft, lwe: LweDef, glwe: GlweDef,
                 radix: RadixDecomposition, be=C128) -> torch.Tensor:
    """Rotate the LUT by the (modulus-switched, < 2N) phase of ct_switched
    in n CMux steps (`programmable_bootstrapping.rs:385-409`):
    acc = lut X^{-b}; acc = cmux(acc, acc X^{a_i}, BSK_i) for each i.
    Leading batch dims on lut_glwe / ct_switched."""
    ct_switched = u64(ct_switched)
    a, b = ct_switched[..., :-1], ct_switched[..., -1]
    acc = monomial_mul_batch(u64(lut_glwe, ct_switched.device), (2 * glwe.degree - b)[..., None])
    for i in range(lwe.dim):
        rotated = monomial_mul_batch(acc, a[..., i, None])
        acc = cmux(acc, rotated, bsk_fft[i], glwe, radix, be)
    return acc


def generalized_programmable_bootstrap(ct, lut_glwe, bsk_fft, lwe: LweDef, glwe: GlweDef,
                                       radix: RadixDecomposition, log_chi: int = 0,
                                       log_v: int = 0, be=C128) -> torch.Tensor:
    """Modulus switch to 2N (with log_chi / log_v bit selection), then
    blind rotate the LUT -> GLWE (`programmable_bootstrapping.rs:342-410`)."""
    ct_switched = lwe_modulus_switch(u64(ct), log_chi, log_v, glwe.log_degree + 1)
    return blind_rotate(lut_glwe, ct_switched, bsk_fft, lwe, glwe, radix, be)


def programmable_bootstrap_univariate(ct, lut_glwe, bsk_fft, lwe: LweDef, glwe: GlweDef,
                                      radix: RadixDecomposition, be=C128) -> torch.Tensor:
    """PBS -> LWE under the flattened GLWE key, sample 0 extracted
    (`programmable_bootstrapping.rs:291-340`)."""
    out = generalized_programmable_bootstrap(ct, lut_glwe, bsk_fft, lwe, glwe, radix, 0, 0, be)
    return sample_extract(out, 0, glwe)


def programmable_bootstrap_bivariate(ct_left, ct_right, lut_glwe, bsk_fft, lwe: LweDef,
                                     glwe: GlweDef, radix: RadixDecomposition,
                                     plaintext_bits: int, be=C128) -> torch.Tensor:
    """Pack left * 2^bits + right, then a univariate PBS over 2*bits
    (`programmable_bootstrapping.rs:575-621`)."""
    packed = (u64(ct_left) << plaintext_bits) + u64(ct_right)
    return programmable_bootstrap_univariate(packed, lut_glwe, bsk_fft, lwe, glwe, radix, be)


def generate_bivariate_lut(map2, glwe: GlweDef, plaintext_bits: int,
                           device=None) -> torch.Tensor:
    """The LUT of a bivariate function over packed inputs
    (`programmable_bootstrapping.rs:553-573`): inputs encrypted at
    2*bits + 1 bits, the output decoded at 2*bits."""
    modulus = 1 << plaintext_bits

    def unpacked(x):
        return map2((x // modulus) % modulus, x % modulus) % modulus

    return generate_lut([unpacked], glwe, 2 * plaintext_bits, device)
