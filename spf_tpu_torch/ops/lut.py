"""Lookup-table polynomials for programmable bootstrapping (numpy copy of
`spf_tpu/ops/bootstrap.py::generate_lut_np`)."""

from __future__ import annotations

import numpy as np

from ..params import GlweDef


def generate_lut_np(maps, glwe: GlweDef, plaintext_bits: int) -> np.ndarray:
    """LUT GLWE (trivial, u64 [k+1, N]) for the functions `maps` on
    `plaintext_bits`-bit messages; several maps interleave by
    coefficient (multi-output PBS)."""
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
