"""High-level encryption over the L-typed ciphertexts of the conversion
cycle (u64 API).

Port of `spf_tpu/runtime/encryption.py` (≙ `parasol_runtime/src/crypto/
encryption.rs`). Layouts (int64, leading batch dims allowed): L0 LWE
[n0+1]; L1 LWE [k*N+1]; L1 GLWE [k+1, N], bit messages in coefficients;
L1 GLEV [l_cbs, k+1, N]; L1 GGSW complex128 spectra. Messages are bits
unless noted. Encryptions draw from a `torch.Generator` and are made on
its device; decryptions take int64 tensors or u64 numpy arrays (the
host handles of `utils.host_crypto`) and read them on the key's device.
"""

from __future__ import annotations

import torch

from ..ops.u64 import encryption as enc
from ..ops.u64 import torus
from ..ops.u64.fft import C128
from ..ops.u64.fft_ops import ggsw_to_fft
from ..params import DEFAULT_128, Params
from .keys import PublicKey, SecretKey


class Encryption:
    """Encrypt / decrypt / trivial constructors for every L-type; the
    trivial ones are made on `device` (the card unless the caller asks
    for the CPU)."""

    def __init__(self, params: Params = DEFAULT_128, device="cuda"):
        self.params = params
        self.device = torus.resolve_device(device)

    # --- L0 LWE bits ---

    def encrypt_lwe_l0(self, generator, bit, sk: SecretKey) -> torch.Tensor:
        return enc.encrypt_lwe(generator, torus.encode(bit, 1), sk.lwe_0, self.params.l0_params)

    def decrypt_lwe_l0(self, ct, sk: SecretKey) -> torch.Tensor:
        return torus.decode(enc.decrypt_lwe(ct, sk.lwe_0, self.params.l0_params), 1)

    def trivial_lwe_l0(self, bit) -> torch.Tensor:
        return enc.trivial_lwe(torus.encode(bit, 1), self.params.l0_params, self.device)

    # --- L1 LWE bits (under the flattened GLWE key) ---

    def decrypt_lwe_l1(self, ct, sk: SecretKey) -> torch.Tensor:
        return torus.decode(enc.decrypt_lwe(ct, sk.lwe_1, self.params.l1_params.as_lwe_def()), 1)

    # --- L1 GLWE (a bit a coefficient) ---

    def encrypt_glwe_l1(self, generator, bits_poly, sk: SecretKey) -> torch.Tensor:
        bits = torus.u64(bits_poly, generator.device)
        return enc.encrypt_glwe(generator, torus.encode(bits, 1), sk.glwe_1, self.params.l1_params)

    def decrypt_glwe_l1(self, ct, sk: SecretKey) -> torch.Tensor:
        return torus.decode(enc.decrypt_glwe(ct, sk.glwe_1, self.params.l1_params), 1)

    def trivial_glwe_l1(self, bits_poly) -> torch.Tensor:
        bits = torus.u64(bits_poly, self.device)
        return enc.trivial_glwe(torus.encode(bits, 1), self.params.l1_params, self.device)

    def _unit_poly(self, bit: int) -> torch.Tensor:
        poly = torch.zeros(self.params.l1_params.degree, dtype=torch.int64, device=self.device)
        poly[0] = bit
        return poly

    def trivial_glwe_l1_zero(self) -> torch.Tensor:
        return self.trivial_glwe_l1(self._unit_poly(0))

    def trivial_glwe_l1_one(self) -> torch.Tensor:
        """Encodes 1 in the constant coefficient (used by NOT)."""
        return self.trivial_glwe_l1(self._unit_poly(1))

    # --- L1 GLEV / GGSW ---

    def encrypt_glev_l1(self, generator, bits_poly, sk: SecretKey) -> torch.Tensor:
        return enc.encrypt_glev(generator, torus.u64(bits_poly, generator.device),
                                sk.glwe_1, self.params.l1_params, self.params.cbs_radix)

    def decrypt_glev_l1(self, ct, sk: SecretKey) -> torch.Tensor:
        return enc.decrypt_glev_at(ct, sk.glwe_1, self.params.l1_params, self.params.cbs_radix, 0)

    def trivial_glev_l1(self, bits_poly) -> torch.Tensor:
        return enc.trivial_glev(torus.u64(bits_poly, self.device), self.params.l1_params,
                                self.params.cbs_radix, self.device)

    def encrypt_ggsw_l1(self, generator, bit, sk: SecretKey, be=C128):
        ggsw = enc.encrypt_ggsw_scalar(generator, bit, sk.glwe_1, self.params.l1_params,
                                       self.params.cbs_radix)
        return ggsw_to_fft(ggsw, be)

    # --- integers as GLWE bit ciphertexts, LSB first (how `GenericInt` stores them) ---

    def encrypt_uint_bits(self, generator, value: int, n: int, sk: SecretKey) -> list:
        """An n-bit integer as n GLWE bit ciphertexts, LSB first."""
        polys = torch.zeros((n, self.params.l1_params.degree), dtype=torch.int64,
                            device=generator.device)
        polys[:, 0] = torch.tensor([(value >> i) & 1 for i in range(n)], device=generator.device)
        return list(self.encrypt_glwe_l1(generator, polys, sk).unbind(0))

    def decrypt_uint_bits(self, cts: list, sk: SecretKey) -> int:
        return sum(int(self.decrypt_glwe_l1(ct, sk)[0]) << i for i, ct in enumerate(cts))

    def encrypt_packed_uint(self, generator, value: int, n: int, pk: PublicKey) -> torch.Tensor:
        """An n-bit integer in one GLWE (bit i in coefficient i) under the
        RLWE public key (≙ `PackedGenericInt::encrypt`)."""
        bits = torch.zeros(self.params.l1_params.degree, dtype=torch.int64,
                           device=generator.device)
        bits[:n] = torch.tensor([(value >> i) & 1 for i in range(n)], device=generator.device)
        return self.encrypt_packed_public(generator, bits, pk)

    def decrypt_packed_uint(self, ct, n: int, sk: SecretKey) -> int:
        bits = self.decrypt_glwe_l1(ct, sk)
        return sum(int(bits[i]) << i for i in range(n))

    # --- RLWE public-key packed encryption ---

    def encrypt_packed_public(self, generator, bits_poly, pk: PublicKey) -> torch.Tensor:
        """Up to N bits in one GLWE via the RLWE public key
        (`rlwe_encryption.rs:47-130`)."""
        bits = torus.u64(bits_poly, generator.device)
        return enc.rlwe_encrypt_public(generator, torus.encode(bits, 1), pk.rlwe_1,
                                       self.params.l1_params)
