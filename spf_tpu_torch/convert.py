"""Carry state across from the JAX package, as numpy arrays.

The JAX package keeps torus arrays either as u64 numpy arrays or, on its
TPU path, as u32 limb pairs (hi, lo). Coefficient-domain keys are
backend-neutral, so the keys the JAX package makes (u64 or limbs) become
port modules whose spectra the port's own FFT makes:

- a multi-bit bootstrap key (`multibit.generate_multibit_bsk`,
  `encryption_u32.generate_multibit_bsk_u32`) -> `MultibitBootstrap`;
- a single-bit bootstrap key [n0, k+1, l, k+1, N] (`bench.py`'s
  `*_bsk_coeff.npy`) -> `Bootstrap`;
- circuit bootstrapping's keys: a bootstrap key of either kind, the
  automorphism keys (`generate_automorphism_keys_u32`), the scheme-switch
  key (`generate_scheme_switch_key_u32`) and the LWE keyswitch key
  (`generate_lwe_keyswitch_key_u32`) -> `ConversionCycle`;
- the u64 API's keys (`spf_tpu.runtime.keys`' `SecretKey`, `PublicKey`,
  `ComputeKey`, or any object with their fields) -> the port's
  (`runtime.keys`): u64 arrays as int64 with the same bits, the c128
  spectra carried as they are; `key_arrays` gives a key back as numpy in
  the JAX package's dtypes, so a key also goes the other way.

Nothing here imports the JAX package: parameters convert by their field
names.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import params as _params
from .ops import torus
from .ops.bootstrap import Bootstrap
from .ops.cbs import ConversionCycle
from .ops.multibit import MultibitBootstrap


def limbs_to_u64(hi, lo) -> np.ndarray:
    """u32 limb pair -> u64 numpy array."""
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)


def u64_to_limbs(x):
    """u64 numpy array -> u32 limb pair (hi, lo)."""
    x = np.asarray(x, dtype=np.uint64)
    return (x >> np.uint64(32)).astype(np.uint32), x.astype(np.uint32)


def _as_u64(x) -> np.ndarray:
    if isinstance(x, tuple):
        return limbs_to_u64(*x)
    return np.asarray(x, dtype=np.uint64)


def to_tensor(x, device="cuda") -> torch.Tensor:
    """u64 numpy array or limb pair -> int64 tensor with the same bits."""
    return torus.from_u64_np(_as_u64(x), torus.resolve_device(device))


def secret_keys(lwe_sk, glwe_sk, device="cuda"):
    """Binary LWE key [n] and GLWE key [k, N] -> int64 tensors."""
    device = torus.resolve_device(device)
    return (
        torch.from_numpy(np.asarray(lwe_sk).astype(np.int64)).to(device),
        torch.from_numpy(np.asarray(glwe_sk).astype(np.int64)).to(device),
    )


def param(obj):
    """A parameter dataclass of the JAX package (LweDef, GlweDef,
    RadixDecomposition or Params) -> the port's, field by field."""
    cls = getattr(_params, type(obj).__name__)
    kwargs = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        kwargs[f.name] = param(v) if dataclasses.is_dataclass(v) else v
    return cls(**kwargs)


def _port_param(obj, cls):
    return obj if isinstance(obj, cls) else param(obj)


def multibit_bootstrap(bsk, lut, glwe, radix, group: int, device="cuda") -> MultibitBootstrap:
    """Coefficient-domain multi-bit BSK, u64 [n_groups, 2^g-1, k+1, l,
    k+1, N] or its limb pair, and a LUT u64 [k+1, N] or limb pair ->
    `MultibitBootstrap` on `device`."""
    return MultibitBootstrap(_as_u64(bsk), _as_u64(lut), _port_param(glwe, _params.GlweDef),
                             _port_param(radix, _params.RadixDecomposition), group, device=device)


def bootstrap(bsk, lut, glwe, radix, fuse_rot: bool = False, phase_rot: bool = False,
              device="cuda") -> Bootstrap:
    """Coefficient-domain single-bit BSK, u64 [n0, k+1, l, k+1, N] or its
    limb pair, and a LUT u64 [k+1, N] or limb pair -> `Bootstrap` on
    `device`, in the blind-rotation form `fuse_rot` / `phase_rot` pick."""
    return Bootstrap(_as_u64(bsk), _as_u64(lut), _port_param(glwe, _params.GlweDef),
                     _port_param(radix, _params.RadixDecomposition), fuse_rot, phase_rot,
                     device=device)


def conversion_cycle(bsk, auto_keys, ssk, ksk, params, phase_rot: bool = False,
                     device="cuda") -> ConversionCycle:
    """Circuit bootstrapping's coefficient-domain keys, each u64 or a limb
    pair (bootstrap key multi-bit [n_groups, 2^g-1, k+1, l, k+1, N] or
    single-bit [n0, k+1, l, k+1, N] at `params.cbs_pbs_radix_eff`;
    automorphism keys [log2 N, k, l_tr, k+1, N]; scheme-switch key
    [k, k, l_ss, k+1, N]; LWE keyswitch key [k*N, l_ks, n0+1]) and the
    JAX package's `Params` -> `ConversionCycle` on `device`."""
    return ConversionCycle(_as_u64(bsk), _as_u64(auto_keys), _as_u64(ssk), _as_u64(ksk),
                           _port_param(params, _params.Params), phase_rot, device=device)


def _field(x, device):
    """A u64 (or binary) array -> int64 tensor, a complex128 spectrum as it is."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return torch.from_numpy(x.astype(np.complex128)).to(device)
    return torus.from_u64_np(x.astype(np.uint64), device)


def secret_key(sk, device="cuda"):
    """A u64 `SecretKey` (lwe_0 [n0], glwe_1 [k, N]) -> the port's."""
    from .runtime.keys import SecretKey

    device = torus.resolve_device(device)
    return SecretKey(lwe_0=_field(sk.lwe_0, device), glwe_1=_field(sk.glwe_1, device))


def public_key(pk, device="cuda"):
    """A u64 `PublicKey` (rlwe_1 [2, N]) -> the port's."""
    from .runtime.keys import PublicKey

    return PublicKey(rlwe_1=_field(pk.rlwe_1, torus.resolve_device(device)))


def compute_key(ck, device="cuda"):
    """A u64 `ComputeKey` of the c128 backend (bsk, auto_keys and ssk
    complex128 spectra, ksk u64) -> the port's, its keyswitch byte planes
    made on `device`."""
    from .runtime.keys import ComputeKey

    device = torus.resolve_device(device)
    return ComputeKey(**{f: _field(getattr(ck, f), device)
                         for f in ("bsk", "ksk", "auto_keys", "ssk")})


def key_arrays(key) -> dict:
    """A port key -> {field: numpy array} in the JAX package's dtypes (u64
    for torus and key bits, complex128 for spectra); derived fields such as
    the keyswitch byte planes are left out."""
    out = {}
    for f in dataclasses.fields(key):
        t = getattr(key, f.name)
        if f.name == "ksk_planes" or t is None:
            continue
        out[f.name] = t.cpu().numpy() if t.is_complex() else torus.to_u64_np(t)
    return out
