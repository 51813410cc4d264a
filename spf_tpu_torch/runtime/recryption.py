"""One-time-pad recryption: the output-privacy primitive.

Port of `spf_tpu/runtime/recryption.py` (≙ `parasol_runtime/src/crypto/
recryption.rs:23-110`). The pad holder RLWE-encrypts a random binary
polynomial under the shared public key; the compute party adds it onto a
result GLWE (an XOR of the bits); once that GLWE is decrypted (e.g. by a
threshold committee), only the pad holder can remove the pad. A pad must
never be reused.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.u64 import rng
from ..ops.u64.torus import u64
from .encryption import Encryption
from .keys import PublicKey


@dataclasses.dataclass
class SecretOneTimePad:
    key: torch.Tensor  # binary int64 [N]


@dataclasses.dataclass
class PublicOneTimePad:
    ct: torch.Tensor  # L1 GLWE int64 [2, N]


def generate_one_time_pad(generator: torch.Generator, enc: Encryption, pk: PublicKey):
    """(public, secret) pads, made on the generator's device
    (`recryption.rs:62-84`)."""
    pad = rng.binary(generator, (enc.params.l1_params.degree,))
    ct = enc.encrypt_packed_public(generator, pad, pk)
    return PublicOneTimePad(ct=ct), SecretOneTimePad(key=pad)


def recrypt_one_time_pad(x, otp: PublicOneTimePad) -> torch.Tensor:
    """Add the pad onto a result GLWE, an XOR of its bits (plain wrapping
    ciphertext addition; `recryption.rs:86-100`)."""
    return u64(x, otp.ct.device) + otp.ct


def decrypt_one_time_pad(decrypted_bits, sk: SecretOneTimePad) -> torch.Tensor:
    """Remove the pad from a decrypted bit polynomial (`recryption.rs:102-110`)."""
    return (u64(decrypted_bits, sk.key.device) + sk.key) % 2
