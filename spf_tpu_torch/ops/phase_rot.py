"""Frequency-domain monomial rotation for the blind-rotation loop.

Port of the parts of `spf_tpu/ops/phase_rot.py` that the multi-bit path
runs. Multiplying a polynomial by X^t is diagonal in the twisted
negacyclic frequency domain: bin m (natural order) is multiplied by
phase[m] = psi^(t*(1-4m) mod 2N), psi = e^(i*pi/N). The rotation of a
blind-rotation step therefore becomes a pointwise multiply by
(phase - 1), and the phases of all steps are built up front as outer-
product factors (`phase_factors_all`) that each step combines once
(`combine_phase_minus_one`; the MAD kernel forms the same values from the
same halves in registers, `mad.mad_horner`).

The port's FFT emits plain bit-reversed order, so the bit images here are
always the bit reversal (the reference's `use_pallas=True` order), and
the doubling seeds are exact lookups into one 2N-entry ds table (the
reference's CPU formulation; gathers are cheap on a GPU).

The in-loop generator `phase_minus_one` builds one step's (phase − 1)
over the K bins by the serial geometric doubling C·Q^m (≙
`phase_minus_one_pallas`; the CUDA kernel is `csrc/phase.cu`). No path of
the port runs it: the blind rotations use the hoisted factors. It is
timed against them by `spf_tpu_torch.scripts.step_microbench`.
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


@functools.lru_cache(maxsize=8)
def scrambled_perm(k: int):
    """Permutation sigma with scrambled_fwd(x)[r] == natural_fwd(x)[sigma[r]]
    for a K-point transform that emits its bins in scrambled order, as the
    port's FFT does: plain bit reversal, sigma[r] = sum_j bit_j(r) *
    backend_bit_images(2K)[j]. (spf_tpu derives the same permutation
    numerically, by simulating its DIF stages.)"""
    r = np.arange(k)
    perm = np.zeros(k, dtype=np.int32)
    for j, img in enumerate(backend_bit_images(2 * k)):
        perm += ((r >> j) & 1).astype(np.int32) * img
    return perm


def seed_factors(t: torch.Tensor, n: int):
    """C = psi^t [B] and the doubling factors q_j = psi^(-4t*2^j) [J, B]
    (exact table lookups), J = log2(n/2); t int64 [B], any value (only
    t mod 2N is read)."""
    two_n = 2 * n
    mask = two_n - 1
    tabs = _psi_table(two_n, t.device)
    j_count = int(np.log2(n // 2))
    c0 = tuple(c[t & mask] for c in tabs)
    qidx = torch.stack([(0 - (t << (2 + j))) & mask for j in range(j_count)], dim=0)
    return c0, tuple(c[qidx] for c in tabs)


def phase_minus_one_plain(t: torch.Tensor, n: int, perm=None, bit_images=None):
    """(phase(t) - 1) as 4 f32 planes [K, B] (re hi, re lo, im hi, im lo).

    t: int64 [B] rotation exponents (any value: only t mod 2N is read).
    seq[m] = C * Q^m by geometric doubling: level j writes seq[M + m] =
    cmul(seq[m], q_j), q_j = Q^(2^j) (or Q^bit_images[j], which builds the
    sequence directly in a bit-permuted order). `perm` (numpy [K])
    gathers the bins: out[r] = seq[perm[r]]. Then -1 on the real part."""
    two_n = 2 * n
    k = n // 2
    mask = two_n - 1
    tabs = _psi_table(two_n, t.device)

    def look(idx):
        return tuple(c[idx] for c in tabs)

    seq = tuple(c[None, :] for c in look(t & mask))  # [1, B]
    m_len = 1
    j = 0
    while m_len < k:
        img = (1 << j) if bit_images is None else bit_images[j]
        qj = look((0 - t * ((4 * img) % (2 * two_n))) & mask)
        shifted = ds.cmul(seq, tuple(c[None, :] for c in qj))
        seq = tuple(torch.cat([a, b], dim=0) for a, b in zip(seq, shifted))
        m_len *= 2
        j += 1
    if perm is not None:
        idx = torch.as_tensor(np.asarray(perm), dtype=torch.int64, device=t.device)
        seq = tuple(c[idx] for c in seq)
    rh, rl = ds.add(seq[0], seq[1], -1.0, 0.0)
    return (rh, rl, seq[2], seq[3])


def phase_minus_one_outer(t: torch.Tensor, n: int, bit_images=None):
    """(phase(t) - 1) as 4 f32 planes [K, B], built as an outer product:
    each half of the K index bits gets its own geometric table by
    doubling, and one broadcast complex multiply combines them
    [K_hi, K_lo, B] -> [K, B]. `bit_images` as in `phase_minus_one_plain`."""
    two_n = 2 * n
    k = n // 2
    j_count = int(np.log2(k))
    mask = two_n - 1
    tabs = _psi_table(two_n, t.device)

    def look(idx):
        return tuple(c[idx] for c in tabs)

    def img(j):
        return (1 << j) if bit_images is None else bit_images[j]

    def doubling(j_lo, j_hi, seed):
        seq = tuple(c[None, :] for c in seed)  # [1, B]
        for j in range(j_lo, j_hi):
            qj = look((0 - t * ((4 * img(j)) % (2 * two_n))) & mask)
            shifted = ds.cmul(seq, tuple(c[None, :] for c in qj))
            seq = tuple(torch.cat([a, b], dim=0) for a, b in zip(seq, shifted))
        return seq

    j_half = j_count // 2
    zeros = torch.zeros(t.shape, dtype=torch.float32, device=t.device)
    one = (torch.ones_like(zeros), zeros, zeros, zeros)
    lo = doubling(0, j_half, look(t & mask))  # C * Q^(low bits)  [Klo, B]
    hi = doubling(j_half, j_count, one)  # Q^(high bits)          [Khi, B]
    full = ds.cmul(tuple(c[:, None, :] for c in hi), tuple(c[None, :, :] for c in lo))
    seq = tuple(c.reshape(k, -1) for c in full)
    rh, rl = ds.add(seq[0], seq[1], -1.0, 0.0)
    return (rh, rl, seq[2], seq[3])


@functools.lru_cache(maxsize=8)
def _inverse_perm(perm_bytes: bytes, device: torch.device) -> torch.Tensor:
    perm = np.frombuffer(perm_bytes, dtype=np.int64)
    if not np.array_equal(np.sort(perm), np.arange(perm.size)):
        raise ValueError("phase_minus_one: perm is not a permutation of the K bins")
    return torch.from_numpy(np.argsort(perm).astype(np.int32)).to(device)


def _phase_minus_one_cuda(t, n, perm):
    k = n // 2
    if k < 2 or k > 1 << 15 or k & (k - 1):
        raise ValueError(f"phase_minus_one: K = {k} must be a power of two in [2, 2^15]")
    t = t.contiguous()
    check_cuda("phase_minus_one", t, dtype=torch.int64)
    if t.dim() != 1:
        raise ValueError(f"phase_minus_one: t shape {tuple(t.shape)}, want [B]")
    b = t.shape[0]
    inv = 0
    if perm is not None:
        perm = np.asarray(perm, dtype=np.int64)
        if perm.shape != (k,):
            raise ValueError(f"phase_minus_one: perm shape {perm.shape}, want ({k},)")
        inv = _inverse_perm(perm.tobytes(), t.device).data_ptr()
    tabs = _psi_table(2 * n, t.device)
    out = [torch.empty((k, b), dtype=torch.float32, device=t.device) for _ in range(4)]
    kernels.PHASE_MINUS_ONE(
        t.data_ptr(), *(c.data_ptr() for c in tabs), inv, *(o.data_ptr() for o in out),
        k, b, stream_of(t),
    )
    return tuple(out)


def phase_minus_one(t: torch.Tensor, n: int, perm=None):
    """(phase(t) - 1) over the K = N/2 bins of each column, 4 f32 planes
    [K, B], bins gathered by `perm` if given (≙ `phase_minus_one_pallas`):
    the CUDA kernel on CUDA tensors, `phase_minus_one_plain` on CPU
    tensors. The kernel stores bin m at row perm⁻¹[m], which equals the
    gather: a permutation moves values and changes no bits."""
    return dispatch("phase_minus_one", t, _phase_minus_one_cuda, phase_minus_one_plain,
                    t, n, perm)


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
