"""Key material of the u64 API: secret, public and compute keys.

Port of `spf_tpu/runtime/keys.py` (≙ `parasol_runtime/src/crypto/keys.rs`):

- `SecretKey`: the L0 LWE key and the L1 GLWE key (`keys.rs:100-126`);
- `PublicKey`: the RLWE public key of packed encryption (`keys.rs:26`);
- `ComputeKey`: what a third party needs to compute (`keys.rs:147-159`):
  bootstrap key, L1 -> L0 LWE keyswitch key, automorphism keys and scheme
  switch key, the three FFT keys as complex128 spectra (`keys.rs:258-306`),
  plus the keyswitch key's 16-bit planes that the exact keyswitch reads.

Keys are made on the card from a seeded `torch.Generator` unless the
caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.u64 import encryption as enc
from ..ops.u64 import keyswitch as ks
from ..ops.u64 import scheme_switch as ss
from ..ops.u64.bootstrap import generate_bootstrap_key
from ..ops.u64.fft import get_backend
from ..ops.u64.torus import resolve_device
from ..params import DEFAULT_128, Params


@dataclasses.dataclass
class SecretKey:
    """lwe_0: int64 [n0], glwe_1: int64 [k, N] (binary)."""

    lwe_0: torch.Tensor
    glwe_1: torch.Tensor

    @property
    def lwe_1(self) -> torch.Tensor:
        """The L1 LWE key: the GLWE key flattened (`keys.rs:126`)."""
        return enc.glwe_sk_to_lwe_sk(self.glwe_1)

    @classmethod
    def generate(cls, generator: torch.Generator, params: Params = DEFAULT_128) -> "SecretKey":
        return cls(lwe_0=enc.generate_lwe_sk(generator, params.l0_params),
                   glwe_1=enc.generate_glwe_sk(generator, params.l1_params))


@dataclasses.dataclass
class PublicKey:
    """RLWE public key int64 [2, N] (`keys.rs:26-64`)."""

    rlwe_1: torch.Tensor

    @classmethod
    def generate(cls, generator: torch.Generator, sk: SecretKey,
                 params: Params = DEFAULT_128) -> "PublicKey":
        return cls(rlwe_1=enc.rlwe_generate_public_key(generator, sk.glwe_1, params.l1_params))


@dataclasses.dataclass
class ComputeKey:
    """Evaluation keys (`keys.rs:147-306`). At DEFAULT_128 the bootstrap
    key's spectra take 167 MB and the keyswitch key's planes 251 MB."""

    bsk: torch.Tensor  # complex128 [n0, k+1, l_pbs, k+1, N/2]
    ksk: torch.Tensor  # int64 [k*N, l_ks, n0+1]
    auto_keys: torch.Tensor  # complex128 [log2 N, k, l_tr, k+1, N/2]
    ssk: torch.Tensor  # complex128 [k, k, l_ss, k+1, N/2]
    ksk_planes: torch.Tensor = None  # f64 [4, k*N*l_ks, n0+1], made from ksk if None

    def __post_init__(self):
        if self.ksk_planes is None:
            self.ksk_planes = ks.ksk_planes(self.ksk)

    @property
    def device(self) -> torch.device:
        return self.bsk.device

    def to(self, device) -> "ComputeKey":
        """The key with every tensor on `device` (no copy where it is already)."""
        return ComputeKey(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})

    @classmethod
    def generate(cls, generator: torch.Generator, sk: SecretKey, params: Params = DEFAULT_128,
                 be="c128") -> "ComputeKey":
        be = get_backend(be)
        glwe = params.l1_params
        bsk = generate_bootstrap_key(generator, sk.lwe_0, sk.glwe_1, params.l0_params, glwe,
                                     params.cbs_pbs_radix_eff, be)
        ksk = ks.generate_lwe_keyswitch_key(generator, sk.lwe_1, sk.lwe_0, glwe.as_lwe_def(),
                                            params.l0_params, params.ks_radix)
        auto_keys = ks.generate_automorphism_keys(generator, sk.glwe_1, glwe, params.tr_radix, be)
        ssk = ss.generate_scheme_switch_key(generator, sk.glwe_1, glwe, params.ss_radix, be)
        return cls(bsk=bsk, ksk=ksk, auto_keys=auto_keys, ssk=ssk)


def generate_keys(generator, params: Params = DEFAULT_128, backend: str = "c128",
                  device="cuda") -> tuple[SecretKey, PublicKey | None, ComputeKey]:
    """(secret, public, compute) keys made on `device` from a seeded
    `torch.Generator` on that device, or from an int seed. Without a card
    this raises unless device="cpu". The public key needs k == 1
    (`rlwe_encryption.rs:55`) and is None otherwise."""
    device = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=device).manual_seed(generator)
    if torch.device(generator.device).type != device.type:
        raise ValueError(f"generator on {generator.device}, keys asked on {device}")
    be = get_backend(backend)
    sk = SecretKey.generate(generator, params)
    pk = PublicKey.generate(generator, sk, params) if params.l1_params.size == 1 else None
    return sk, pk, ComputeKey.generate(generator, sk, params, be)
