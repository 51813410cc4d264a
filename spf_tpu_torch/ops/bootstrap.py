"""Bootstrap building blocks and the single-bit PBS on int64 torus tensors.

Port of `spf_tpu/ops/bootstrap_u32.py`: the torus -> spectrum transform,
the key-spectrum conversion, the external product and CMux, the
single-bit blind rotation in its three forms, the PBS, and sample
extraction. Layout as in the reference: coefficient axis second to last,
ciphertext batch last.

The three forms of a blind-rotation step compute the same rotation and,
in plain and fuse_rot, the same bits; they differ in which kernels run:

- plain (`bootstrap_u32.py:317-322`): CMux(acc, acc·X^a): the digits of
  acc·X^a − acc (`rotate_sub_decompose`), forward FFT, MAD with the key
  row (`freq_mad`), inverse FFT, added to acc;
- fuse_rot (`:291-315`): the last step's product folded into acc inside
  the same kernel (`rotate_sub_decompose_acc`), then FFT, MAD, inverse
  FFT;
- phase_rot (`:231-289`): the accumulator itself is decomposed
  (`accumulate_decompose`) and the rotation is the pointwise (phase − 1)
  factor, applied to the MAD output as on the TPU (`mad_horner` at g = 1).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..params import GlweDef, RadixDecomposition
from . import fft, torus
from .mad import freq_mad, freq_mad_plain, mad_horner
from .phase_rot import fence, phase_factors_all
from .rot_decomp import accumulate_decompose, rotate_sub_decompose, rotate_sub_decompose_acc


def fwd_limb(a: torch.Tensor):
    """int64 torus values [..., N, B] -> spectrum, 4 f32 planes
    [..., N/2, B] in bit-reversed order."""
    hi, lo = torus.to_ds(a)
    return fft.fwd_ds(hi, lo)


def fwd_signed(digits: torch.Tensor):
    """Signed digits [..., N, B] (int or f32, |d| < 2^24) -> spectrum."""
    hi = digits.to(torch.float32)
    return fft.fwd_ds(hi, torch.zeros_like(hi))


def inv_limb(f) -> torch.Tensor:
    """Spectrum [..., K, B] -> int64 torus values [..., N, B], rounded."""
    return torus.from_ds(*fft.inv_ds(f))


def bsk_to_freq(coeff: torch.Tensor):
    """Any coefficient-domain int64 key tensor [..., N] -> its spectra,
    4 f32 planes [..., N/2], made by the port's FFT (on the device of
    `coeff`). The polynomials are laid onto the batch axis ([N, P]) so
    that one transform converts them all."""
    shp = coeff.shape
    n = shp[-1]
    x = coeff.reshape(-1, n).t().contiguous()  # [N, P]
    f = fwd_limb(x)  # 4 x [K, P]
    return tuple(c.t().contiguous().reshape(*shp[:-1], n // 2) for c in f)


def external_product(glwe_t: torch.Tensor, ggsw_row, radix: RadixDecomposition):
    """GLWE int64 [k+1, N, B] ⊡ a GGSW row (key row [k+1, l, k+1, K], or
    batched [k+1, l, k+1, K, B]) -> spectrum [k+1, K, B]. A key row goes
    through the `freq_mad` kernel; a batched row (one CMux per batch after
    circuit bootstrapping) is the plain MAD on any device, as it is XLA on
    the TPU."""
    dfft = fwd_signed(torus.decompose(glwe_t, radix))
    mad = freq_mad_plain if ggsw_row[0].dim() == 5 else freq_mad
    return mad(dfft, ggsw_row)


def cmux(d0: torch.Tensor, d1: torch.Tensor, ggsw_row, radix: RadixDecomposition):
    """d0 + GGSW ⊡ (d1 − d0): d1 where the GGSW encrypts 1, else d0."""
    return torus.add(d0, inv_limb(external_product(torus.sub(d1, d0), ggsw_row, radix)))


def blind_rotate(lut, ct_switched, bsk_freq, glwe: GlweDef, radix: RadixDecomposition,
                 fuse_rot: bool = False, phase_rot: bool = False):
    """lut int64 [k+1, N, 1 or B], ct_switched int64 [n0+1, B] with phases
    < 2N, bsk_freq 4 planes [n0, k+1, l, k+1, K] -> the rotated
    accumulator, int64 [k+1, N, B] (≙ `bootstrap_u32.blind_rotate_u32`)."""
    n = glwe.degree
    kp1 = glwe.size + 1
    a = ct_switched[:-1]  # [n0, B]
    b = ct_switched[-1]  # [B]
    bb = ct_switched.shape[-1]
    acc = torus.monomial_mul(lut.expand(kp1, n, bb), 2 * n - b)
    digits_lo = torch.zeros((radix.count, kp1, n, bb), dtype=torch.float32, device=a.device)

    def row(i):
        return tuple(c[i] for c in bsk_freq)

    if not (fuse_rot or phase_rot):
        for i in range(a.shape[0]):
            digits = rotate_sub_decompose(acc, a[i], radix)
            prod = fft.inv_ds(freq_mad(fft.fwd_ds(digits, digits_lo), row(i)))
            acc = torus.add(acc, torus.from_ds(*prod))
        return acc

    zero = torch.zeros((kp1, n, bb), dtype=torch.float32, device=a.device)
    prod = (zero, zero)
    if fuse_rot:
        for i in range(a.shape[0]):
            digits, acc = rotate_sub_decompose_acc(acc, prod, a[i], radix)
            prod = fft.inv_ds(freq_mad(fft.fwd_ds(digits, digits_lo), row(i)))
        return torus.add(acc, torus.from_ds(*prod))

    # phase_rot: the per-step (phase - 1) factors of every step, hoisted
    ph_lo, ph_hi = phase_factors_all(a, n)
    ph_lo = tuple(fence(c) for c in ph_lo)
    ph_hi = tuple(fence(c) for c in ph_hi)
    for i in range(a.shape[0]):
        digits, acc = accumulate_decompose(acc, prod, radix)
        dfft = fft.fwd_ds(digits, digits_lo)
        # cmul(freq_mad(dfft, row), pm1): mad_horner's g = 1 instance, which
        # forms pm1 from the step's halves
        halves = (tuple(c[i:i + 1] for c in ph_lo), tuple(c[i:i + 1] for c in ph_hi))
        key = tuple(c[i:i + 1] for c in bsk_freq)
        prod = fft.inv_ds(mad_horner(dfft, key, halves, 1))
    return torus.add(acc, torus.from_ds(*prod))


def sample_extract(glwe_t: torch.Tensor, h: int, glwe: GlweDef) -> torch.Tensor:
    """GLWE int64 [k+1, N, B] -> LWE int64 [k*N+1, B] extracting
    coefficient h (≙ `bootstrap_u32.sample_extract_u32`)."""
    n = glwe.degree
    a = glwe_t[:-1]  # [k, N, B]
    b = glwe_t[-1]  # [N, B]
    j = torch.arange(n, device=glwe_t.device)
    idx = torch.remainder(h - j, n)
    gathered = a[:, idx]
    a_lwe = torch.where((j > h)[:, None], -gathered, gathered)
    return torch.cat([a_lwe.reshape(glwe.size * n, -1), b[h][None]], dim=0)


def programmable_bootstrap(ct, lut, bsk_freq, glwe: GlweDef, radix: RadixDecomposition,
                           fuse_rot: bool = False, phase_rot: bool = False):
    """Univariate single-bit PBS: LWE int64 [n0+1, B] -> LWE int64
    [k*N+1, B] under the flattened GLWE key; `lut` int64 [k+1, N]
    (≙ `bootstrap_u32.programmable_bootstrap_u32`)."""
    ct_sw = torus.modulus_switch(ct, 0, 0, glwe.log_degree + 1)
    rotated = blind_rotate(lut[..., None], ct_sw, bsk_freq, glwe, radix, fuse_rot, phase_rot)
    return sample_extract(rotated, 0, glwe)


def as_tensor(x) -> torch.Tensor:
    """u64 numpy array or int64 tensor -> int64 tensor (same bits)."""
    return torus.from_u64_np(x) if isinstance(x, np.ndarray) else x


def register_spectra(module: nn.Module, prefix: str, coeff: torch.Tensor, device) -> None:
    """Register the spectra of a coefficient-domain key (int64 [..., N])
    as the buffers {prefix}_rh, _rl, _ih, _il of `module`, made by the
    port's FFT on `device`."""
    for part, c in zip(("rh", "rl", "ih", "il"), bsk_to_freq(coeff.to(device))):
        module.register_buffer(f"{prefix}_{part}", c)


def spectra(module: nn.Module, prefix: str):
    return tuple(getattr(module, f"{prefix}_{part}") for part in ("rh", "rl", "ih", "il"))


class Bootstrap(nn.Module):
    """The single-bit PBS with its key spectra and LUT as buffers.

    `bsk`: the coefficient-domain bootstrap key, u64 numpy or int64 tensor
    [n0, k+1, l, k+1, N]; its spectra are made by the port's FFT on
    `device`. `lut`: u64 numpy or int64 tensor [k+1, N]. `fuse_rot` /
    `phase_rot` pick the form of the blind rotation (the same result; plain
    and fuse_rot the same bits). Calling the module on LWE ciphertexts int64
    [n0+1, B] returns LWE ciphertexts int64 [k*N+1, B]."""

    def __init__(self, bsk, lut, glwe: GlweDef, radix: RadixDecomposition,
                 fuse_rot: bool = False, phase_rot: bool = False, device="cuda"):
        super().__init__()
        device = torus.resolve_device(device)
        self.glwe = glwe
        self.radix = radix
        self.fuse_rot = fuse_rot
        self.phase_rot = phase_rot
        kp1 = glwe.size + 1
        bsk = as_tensor(bsk)
        if bsk.dim() != 5 or tuple(bsk.shape[1:]) != (kp1, radix.count, kp1, glwe.degree):
            raise ValueError(f"bsk shape {tuple(bsk.shape)}, want [n0, k+1, l, k+1, N]")
        register_spectra(self, "bsk", bsk, device)
        self.register_buffer("lut", as_tensor(lut).to(device))

    @property
    def bsk_freq(self):
        return spectra(self, "bsk")

    def forward(self, ct: torch.Tensor) -> torch.Tensor:
        return programmable_bootstrap(ct, self.lut, self.bsk_freq, self.glwe, self.radix,
                                      self.fuse_rot, self.phase_rot)
