"""Carry state across from the JAX package, as numpy arrays.

The JAX package keeps torus arrays either as u64 numpy arrays or, on its
TPU path, as u32 limb pairs (hi, lo). Coefficient-domain keys are
backend-neutral, so a multi-bit bootstrap key made by
`spf_tpu.ops.multibit.generate_multibit_bsk` (u64) or by
`spf_tpu.ops.encryption_u32.generate_multibit_bsk_u32` (limbs) becomes a
`MultibitBootstrap` whose spectra the port's own FFT makes. Nothing here
imports the JAX package: parameters convert by their field names.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import params as _params
from .ops import torus
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


def multibit_bootstrap(bsk, lut, glwe, radix, group: int, device="cuda") -> MultibitBootstrap:
    """Coefficient-domain multi-bit BSK, u64 [n_groups, 2^g-1, k+1, l,
    k+1, N] or its limb pair, and a LUT u64 [k+1, N] or limb pair ->
    `MultibitBootstrap` on `device`."""
    glwe = param(glwe) if not isinstance(glwe, _params.GlweDef) else glwe
    radix = param(radix) if not isinstance(radix, _params.RadixDecomposition) else radix
    return MultibitBootstrap(_as_u64(bsk), _as_u64(lut), glwe, radix, group, device=device)
