"""Frequency-domain monomial rotation for the blind-rotation loop.

Port of the parts of `spf_tpu/ops/phase_rot.py` that the multi-bit path
runs. Multiplying a polynomial by X^t is diagonal in the twisted
negacyclic frequency domain: bin m (natural order) is multiplied by
phase[m] = psi^(t*(1-4m) mod 2N), psi = e^(i*pi/N). The rotation of a
blind-rotation step therefore becomes a pointwise multiply by
(phase - 1), and the phases of all steps are built up front as outer-
product factors (`phase_factors_all`) that each step combines once
(`combine_phase_minus_one`).

The port's FFT emits plain bit-reversed order, so the bit images here are
always the bit reversal (the reference's `use_pallas=True` order), and
the doubling seeds are exact lookups into one 2N-entry ds table (the
reference's CPU formulation; gathers are cheap on a GPU).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..kernels.build import check_cuda, dispatch, stream_of
from . import ds


@functools.lru_cache(maxsize=8)
def _psi_table_np(two_n: int):
    """ds components of psi^s = e^(2*pi*i*s/two_n), s in [0, two_n)."""
    s = np.arange(two_n)
    w = np.exp(2j * np.pi * s / two_n)
    return (*ds.from_f64_array(w.real), *ds.from_f64_array(w.imag))


@functools.lru_cache(maxsize=8)
def _psi_table(two_n: int, device: torch.device):
    return tuple(torch.from_numpy(c).to(device) for c in _psi_table_np(two_n))


def backend_bit_images(n: int):
    """Frequency-order bit images of the port's FFT: position r holds
    natural bin f(r) = sum_j bit_j(r) * images[j]; plain bit reversal."""
    j_count = int(np.log2(n // 2))
    return tuple(1 << (j_count - 1 - j) for j in range(j_count))


def phase_factors_all(a: torch.Tensor, n: int):
    """Hoisted outer-product factors of the rotation phases of every
    step: a int64 [steps, B] (exponents < 2N) -> (lo, hi), 4-tuples of
    f32 [steps, Klo, B] / [steps, Khi, B] with, for every step,

        phase[r] = hi[r // Klo] * lo[r % Klo]        (before the -1)

    in bit-reversed frequency order."""
    two_n = 2 * n
    j_count = int(np.log2(n // 2))
    j_half = j_count // 2
    images = backend_bit_images(n)
    mask = two_n - 1
    tabs = _psi_table(two_n, a.device)

    def look(idx):
        return tuple(c[idx] for c in tabs)

    seed = look(a & mask)
    qjs = [look((0 - a * ((4 * images[j]) % (2 * two_n))) & mask) for j in range(j_count)]

    def doubling(j_lo, j_hi, seed):
        seq = tuple(c[None] for c in seed)  # [1, steps, B]
        for j in range(j_lo, j_hi):
            shifted = ds.cmul(seq, tuple(c[None] for c in qjs[j]))
            seq = tuple(torch.cat([x, y], dim=0) for x, y in zip(seq, shifted))
        return tuple(torch.movedim(c, 0, 1) for c in seq)  # [steps, m, B]

    zeros = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    one = (torch.ones_like(zeros), zeros, zeros, zeros)
    lo = doubling(0, j_half, seed)  # C * Q^(low bits)
    hi = doubling(j_half, j_count, one)  # Q^(high bits)
    return lo, hi


def combine_phase_minus_one(lo_t, hi_t):
    """One step's (phase - 1) from its factors: lo_t [Klo, B], hi_t
    [Khi, B] -> 4-tuple [K, B] (r = rh * Klo + rl)."""
    klo = lo_t[0].shape[0]
    khi = hi_t[0].shape[0]
    full = ds.cmul(
        tuple(c[:, None, :] for c in hi_t), tuple(c[None, :, :] for c in lo_t)
    )  # [Khi, Klo, B]
    seq = tuple(c.reshape(khi * klo, -1) for c in full)
    rh, rl = ds.add(seq[0], seq[1], -1.0, 0.0)
    return (rh, rl, seq[2], seq[3])


def fence_plain(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def _fence_cuda(x):
    x = x.contiguous()
    check_cuda("fence", x)
    if x.numel() >= 1 << 31:
        raise ValueError("fence: too many elements for one launch")
    out = torch.empty_like(x)
    kernels.FENCE(x.data_ptr(), out.data_ptr(), x.numel(), stream_of(x))
    return out


def fence(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of the hoisted phase factors (≙ `phase_rot.fence`,
    which on the TPU stops XLA from recomputing them inside the loop;
    eager PyTorch recomputes nothing, so here it only materializes the
    copy). The CUDA kernel on CUDA tensors, `clone` on CPU tensors."""
    return dispatch("fence", x, _fence_cuda, fence_plain, x)
