"""LWE keyswitching and the keyswitch and automorphism keys (u64 API).

Port of `spf_tpu/ops/keyswitch.py` (≙ `sunscreen_tfhe/src/ops/keyswitch/`).
The keys are `ops.encryption`'s, in the reference's layouts.

The LWE keyswitch is exact mod 2^64, as the reference's u64 product is.
The port's other keyswitch (`ops.keyswitch.keyswitch_lwe`, the u32
family's byte planes recombined through a ds32 pair) keeps ~48 bits of
each sum and differs from it in the low bits, so it is not this function.
Here the key is cut into four 16-bit planes, and each plane's sum
sum_{i,j} digit[j, i] * plane[i, j, m] is one f64 product, exact while
2^(log B - 1) * 2^16 * n_old * l < 2^53 (2^30.6 at DEFAULT_128); the plane
sums are recombined with wrapping shifts.
"""

from __future__ import annotations

import torch

from ...params import GlweDef, LweDef, RadixDecomposition
from .. import encryption as _enc
from .decomp import decompose
from .fft import C128
from .torus import u64


def generate_lwe_keyswitch_key(generator, original_sk, new_sk, old_lwe: LweDef,
                               new_lwe: LweDef, radix: RadixDecomposition) -> torch.Tensor:
    """Row i, level j = LWE_new(s_old_i * q/B^(j+1)) (`lwe_keyswitch_key.rs:16-50`):
    int64 [n_old, l, n_new+1]."""
    assert original_sk.shape[-1] == old_lwe.dim
    return _enc.generate_lwe_keyswitch_key(original_sk, new_sk, new_lwe, radix, generator)


def ksk_planes(ksk) -> torch.Tensor:
    """The keyswitch key [n_old, l, m] as four 16-bit planes, f64
    [4, n_old * l, m], least significant first; made once a key."""
    ksk = u64(ksk)
    flat = ksk.reshape(-1, ksk.shape[-1])
    return torch.stack([((flat >> (16 * p)) & 0xFFFF) for p in range(4)]).to(torch.float64)


def keyswitch_lwe_to_lwe(ct, ksk, old_lwe: LweDef, new_lwe: LweDef,
                         radix: RadixDecomposition, planes=None) -> torch.Tensor:
    """trivial(b) - sum_i <decomp(a_i), LEV_i> (`lwe_keyswitch.rs:23-60`),
    exact, for ct [..., n_old+1]; `planes` are `ksk_planes(ksk)` if the
    caller keeps them."""
    if (1 << (radix.radix_log - 1)) * 0xFFFF * old_lwe.dim * radix.count >= 1 << 53:
        raise ValueError("the f64 plane sums would lose bits at this size")
    ct = u64(ct)
    planes = ksk_planes(ksk) if planes is None else planes
    a, b = ct[..., :-1], ct[..., -1]
    digits = decompose(a, radix)  # [l, ..., n_old]
    d2 = digits.movedim(0, -1).reshape(-1, old_lwe.dim * radix.count).to(torch.float64)
    sums = torch.matmul(d2, planes).to(torch.int64)  # [4, B, m], each exact
    acc = sums[0] + (sums[1] << 16) + (sums[2] << 32) + (sums[3] << 48)
    out = -acc.reshape(*ct.shape[:-1], new_lwe.dim + 1)
    out[..., -1] += b
    return out


def generate_glwe_keyswitch_key(generator, original_sk, new_sk, glwe: GlweDef,
                                radix: RadixDecomposition) -> torch.Tensor:
    """Row i = GLEV(orig_s_i) under the new key (`glwe_keyswitch_key.rs:32-91`):
    int64 [k, l, k+1, N]."""
    return _enc.encrypt_glev(u64(original_sk), new_sk, glwe, radix, generator)


def generate_automorphism_keys(generator, glwe_sk, glwe: GlweDef, radix: RadixDecomposition,
                               be=C128):
    """The log2(N) GLWE keyswitch keys of the trace, from s(X^k) back to s
    for k = N/2^(i-1) + 1 (`ops/automorphisms/mod.rs:18-44`): complex
    [log2 N, k, l, k+1, N/2], or with `be=None` the coefficient-domain
    int64 [log2 N, k, l, k+1, N]."""
    keys = _enc.generate_automorphism_keys(glwe_sk, glwe, radix, generator)
    return keys if be is None else be.fwd_torus(keys)
