"""Negacyclic ("twisted") FFT over Z_q[X]/(X^N + 1), q = 2**64: the c128
backend of the u64 API.

Port of `spf_tpu/ops/fft.py`'s `C128Backend` (≙ the reference's
`TwistedFft`, `sunscreen_tfhe/src/math/fft/negacyclic/mod.rs:29-123`):
fold the N coefficients into N/2 complex values x[j] + i x[j + N/2],
twist by e^{2 pi i j / 2N}, then a size-N/2 complex128 DFT (`torch.fft`:
pocketfft on the CPU, cuFFT on the card); the inverse undoes each step,
rounds, and reduces mod q (`torus.f64_to_torus`). Pointwise products in
this domain are negacyclic convolutions.

The TPU has no complex128, so the JAX package runs this backend on the
CPU only; the port runs it on the card. Different FFT libraries agree to
a few ulps, not bit for bit, so this backend is held against the JAX one
within a tolerance.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .fft_ds32 import DS32, DS32Backend
from .torus import f64_to_torus, to_signed_f64


@functools.lru_cache(maxsize=32)
def _twist(n: int, device: torch.device):
    """e^{2 pi i j/(2n)} for j < n/2 and their inverses (`negacyclic/mod.rs:58-72`)."""
    tw = np.exp(2j * np.pi * np.arange(n // 2) / (2 * n))
    return (torch.from_numpy(tw).to(device), torch.from_numpy(1.0 / tw).to(device))


class C128Backend:
    """complex128 negacyclic FFT backend."""

    name = "c128"

    def fwd_signed(self, x: torch.Tensor) -> torch.Tensor:
        """Signed (or f64) coefficients [..., N] -> complex128 [..., N/2]."""
        n = x.shape[-1]
        k = n // 2
        tw, _ = _twist(n, x.device)
        xf = x.to(torch.float64)
        return torch.fft.fft(torch.complex(xf[..., :k], xf[..., k:]) * tw)

    def fwd_torus(self, x: torch.Tensor) -> torch.Tensor:
        """Torus coefficients [..., N], centered to signed first
        (`entities/polynomial.rs:264-268`)."""
        return self.fwd_signed(to_signed_f64(x))

    def inv(self, f: torch.Tensor) -> torch.Tensor:
        """complex128 [..., N/2] -> int64 torus [..., N]: round to nearest,
        then reduce mod q."""
        _, tw_inv = _twist(f.shape[-1] * 2, f.device)
        z = torch.fft.ifft(f) * tw_inv
        return f64_to_torus(torch.cat([torch.round(z.real), torch.round(z.imag)], dim=-1))

    # --- frequency-domain arithmetic ---

    def zeros(self, shape, device=None) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=torch.complex128, device=device)

    def cmadd(self, acc, a, b):
        """acc + a * b (the reference's `complex_mad`, `math/simd/scalar.rs:12-16`)."""
        return acc + a * b

    def stack(self, fs, axis=0):
        return torch.stack(list(fs), dim=axis)

    def set_component(self, acc, idx: int, value) -> None:
        """Component `idx` of `acc`'s (k+1) axis set to `value`, in place."""
        acc[..., idx, :] = value


C128 = C128Backend()


def get_backend(name: str = "c128"):
    """The FFT backend by name ("c128" or "ds32", `fft_ds32.DS32`), or a
    backend object as it is."""
    if isinstance(name, (C128Backend, DS32Backend)):
        return name
    if name == "c128":
        return C128
    if name == "ds32":
        return DS32
    raise ValueError(f"unknown fft backend {name!r}")
