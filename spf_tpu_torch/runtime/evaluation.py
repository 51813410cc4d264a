"""Evaluation: the homomorphic op surface that circuits use (u64 API).

Port of `spf_tpu/runtime/evaluation.py` (≙ `parasol_runtime/src/crypto/
evaluation.rs`). Keyless ops use mod-2 arithmetic in the torus top bit:
NOT is x + trivial(1), XOR is GLWE addition (`evaluation.rs:48-56`).
Keyed ops wrap circuit bootstrapping, the scheme switch and the L1 -> L0
keyswitch. GGSW(0) / GGSW(1) are made by circuit-bootstrapping trivial
LWEs (`evaluation.rs:161-196`): valid GGSWs from the compute key alone.
"""

from __future__ import annotations

import torch

from ..ops.u64 import cbs as cbs_ops
from ..ops.u64 import ciphertext as ct_ops
from ..ops.u64 import fft_ops
from ..ops.u64 import keyswitch as ks_ops
from ..ops.u64 import torus
from ..ops.u64.fft import get_backend
from ..ops.u64.poly import monomial_mul
from ..params import DEFAULT_128, Params
from .encryption import Encryption
from .keys import ComputeKey


class Evaluation:
    """Bound to a `ComputeKey`, which it keeps on `device` (the card unless
    the caller asks for the CPU); every method is a function of its
    ciphertext inputs, with leading batch dims.

    `jit_ops` is accepted for the reference's signature and has no effect:
    the reference compiles each op with `jax.jit`; PyTorch runs each op
    eagerly, and nothing here is compiled."""

    def __init__(self, compute_key: ComputeKey, params: Params = DEFAULT_128, be="c128",
                 precompute_constants: bool = True, jit_ops: bool = True, device="cuda"):
        self.device = torus.resolve_device(device)
        self.params = params
        self.ck = compute_key.to(self.device)
        self.be = get_backend(be)
        self.enc = Encryption(params, self.device)
        self.ggsw_zero = None
        self.ggsw_one = None
        if precompute_constants:
            self.ggsw_zero = self.circuit_bootstrap(self.enc.trivial_lwe_l0(0))
            self.ggsw_one = self.circuit_bootstrap(self.enc.trivial_lwe_l0(1))

    # --- keyless ops (`evaluation.rs:26-136`) ---

    def not_(self, glwe: torch.Tensor) -> torch.Tensor:
        """NOT = x + trivial(1)."""
        out = torus.u64(glwe).clone()
        out[..., -1, 0] += torus.encode(1, 1)
        return out

    def xor(self, a, b) -> torch.Tensor:
        """XOR = GLWE addition."""
        return ct_ops.glwe_add(a, b)

    def glwe_add(self, a, b):
        return ct_ops.glwe_add(a, b)

    def cmux(self, sel_ggsw_fft, d0, d1):
        p = self.params
        return fft_ops.cmux(d0, d1, sel_ggsw_fft, p.l1_params, p.cbs_radix, self.be)

    def glev_cmux(self, sel_ggsw_fft, d0, d1):
        p = self.params
        return fft_ops.glev_cmux(d0, d1, sel_ggsw_fft, p.l1_params, p.cbs_radix, self.be)

    def multiply_glwe_ggsw(self, glwe, ggsw_fft):
        p = self.params
        return fft_ops.external_product(glwe, ggsw_fft, p.l1_params, p.cbs_radix, self.be)

    def sample_extract(self, glwe, i: int):
        return ct_ops.sample_extract(glwe, i, self.params.l1_params)

    def mul_xn(self, glwe, n: int):
        """Multiply by the monomial X^n (packing shifts)."""
        return monomial_mul(glwe, n)

    # --- keyed ops ---

    def circuit_bootstrap(self, lwe_l0):
        """L0 LWE(bit) -> L1 GGSW(bit) spectra (`evaluation.rs:211-225`,
        the trace + scheme switch variant)."""
        ck = self.ck
        return cbs_ops.circuit_bootstrap(lwe_l0, ck.bsk, ck.auto_keys, ck.ssk, self.params,
                                         self.be)

    def scheme_switch(self, glev_l1):
        """L1 GLEV -> L1 GGSW spectra (`evaluation.rs:231`)."""
        p = self.params
        return fft_ops.scheme_switch_fft(glev_l1, self.ck.ssk, p.l1_params, p.cbs_radix,
                                         p.ss_radix, self.be)

    def keyswitch_lwe_l1_to_l0(self, lwe_l1) -> torch.Tensor:
        """(`evaluation.rs:246`)"""
        p = self.params
        return ks_ops.keyswitch_lwe_to_lwe(lwe_l1, self.ck.ksk, p.l1_params.as_lwe_def(),
                                           p.l0_params, p.ks_radix, self.ck.ksk_planes)
