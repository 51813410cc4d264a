"""Scheme switch key generation: GLEV(s_i (*) s_j) encryptions.

Port of `spf_tpu/ops/scheme_switch.py` (≙ `sunscreen_tfhe/src/ops/
bootstrapping/scheme_switch.rs:22-64`); the switch itself is
`fft_ops.scheme_switch_fft`. The key is `ops.encryption`'s.
"""

from __future__ import annotations

from ...params import GlweDef, RadixDecomposition
from .. import encryption as _enc
from .fft import C128


def generate_scheme_switch_key(generator, glwe_sk, glwe: GlweDef, radix: RadixDecomposition,
                               be=C128):
    """GLEV(s_i (*) s_j) for every pair, the symmetric [k, k] table (the
    reference stores the i <= j triangle): complex [k, k, l, k+1, N/2],
    or with `be=None` int64 [k, k, l, k+1, N]."""
    key = _enc.generate_scheme_switch_key(glwe_sk, glwe, radix, generator)
    return key if be is None else be.fwd_torus(key)
