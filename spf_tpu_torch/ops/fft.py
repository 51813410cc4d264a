"""ds32 negacyclic FFT in bit-reversed frequency order.

Port of `spf_tpu/ops/fft_pallas.py`. The forward transform folds the N
reals of a polynomial into K = N/2 complex values (x[:K] + i x[K:]),
twists them, and runs log2(K) radix-2 DIF stages, so its output lies in
plain bit-reversed order; the inverse runs DIT stages from that order,
untwists, scales by 1/K and unfolds. Pointwise frequency-domain work and
the stored key spectra all live in this order: key spectra and data
spectra must both come from this transform.

Layout as in the reference: coefficient axis second to last, batch last;
a spectrum is a 4-tuple of f32 planes (re_hi, re_lo, im_hi, im_lo).

`fwd_ds`/`inv_ds` launch the CUDA kernels (`csrc/fft.cu`) on CUDA
tensors and run the plain versions `fwd_ds_plain`/`inv_ds_plain` (the
port of the reference's twins `fwd_ds_ref`/`inv_ds_ref`) on CPU tensors.
The kernels read the same constants as the plain versions, compacted into
one table a direction (`kernel_tables_np`), and return their planes as
views of one output tensor.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import kernels
from ..kernels.build import check_cuda, dispatch, stream_of
from . import ds


@functools.lru_cache(maxsize=16)
def _stage_tables(k: int, inverse: bool):
    """Per-stage constants as one f32 array [C, K, 1]: per stage 5
    channels (is_a mask, twiddle ds components), then 4 twist/untwist ds
    channels. Returns (consts, halves)."""
    sign = 1.0 if inverse else -1.0
    ms = [1 << s for s in range(int(np.log2(k)), 0, -1)]
    if inverse:
        ms = ms[::-1]
    r = np.arange(k)
    chans = []
    halves = []
    for m in ms:
        half = m // 2
        halves.append(half)
        pos = r % m
        is_a = pos < half
        n_idx = np.where(is_a, pos, pos - half)
        w = np.exp(sign * 2j * np.pi * n_idx / m)
        chans.append(is_a.astype(np.float32))
        chans.extend(ds.from_f64_array(w.real))
        chans.extend(ds.from_f64_array(w.imag))
    kk = np.arange(k)
    tw = np.exp(2j * np.pi * kk / (4 * k))  # twist for N = 2k
    if inverse:
        tw = (1.0 / tw) / k
    chans.extend(ds.from_f64_array(tw.real))
    chans.extend(ds.from_f64_array(tw.imag))
    consts = np.stack(chans, axis=0)[:, :, None].astype(np.float32)
    return consts, tuple(halves)


@functools.lru_cache(maxsize=32)
def _consts(k: int, inverse: bool, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_stage_tables(k, inverse)[0]).to(device)


def _fft_stages(vals, consts, halves, inverse):
    """vals: 4 tensors [..., K, B]; every stage as roll + select over
    the whole coefficient axis (the reference's formulation)."""
    for s, half in enumerate(halves):
        base = 5 * s
        is_a = consts[base] > 0
        w = tuple(consts[base + 1 + c] for c in range(4))
        up = [torch.roll(c, -half, dims=-2) for c in vals]  # x[r + half]
        down = [torch.roll(c, half, dims=-2) for c in vals]  # x[r - half]
        if not inverse:
            # DIF: a: x + up ; b: (down - x) * w
            sum_a = ds.cadd(vals, up)
            prod = ds.cmul(ds.csub(down, vals), w)
            vals = [torch.where(is_a, a, p) for a, p in zip(sum_a, prod)]
        else:
            # DIT: t = x * w ; a: x + t[r + half] ; b: x[r - half] - t
            prod = ds.cmul(vals, w)
            t_up = [torch.roll(c, -half, dims=-2) for c in prod]
            a_vals = ds.cadd(vals, t_up)
            b_vals = ds.csub(down, prod)
            vals = [torch.where(is_a, a, b) for a, b in zip(a_vals, b_vals)]
    return vals


def fwd_ds_plain(hi: torch.Tensor, lo: torch.Tensor):
    """ds pair [..., N, B] -> 4 f32 planes [..., N/2, B], bit-reversed."""
    k = hi.shape[-2] // 2
    consts = _consts(k, False, hi.device)
    halves = _stage_tables(k, False)[1]
    tb = 5 * len(halves)
    vals = ds.cmul(
        (hi[..., :k, :], lo[..., :k, :], hi[..., k:, :], lo[..., k:, :]),
        tuple(consts[tb + c] for c in range(4)),
    )
    return tuple(_fft_stages(list(vals), consts, halves, False))


def inv_ds_plain(f):
    """4 f32 planes [..., K, B] in bit-reversed order -> ds pair
    [..., 2K, B] (the caller rounds to the torus)."""
    k = f[0].shape[-2]
    consts = _consts(k, True, f[0].device)
    halves = _stage_tables(k, True)[1]
    tb = 5 * len(halves)
    vals = _fft_stages(list(f), consts, halves, True)
    vals = ds.cmul(vals, tuple(consts[tb + c] for c in range(4)))
    return (
        torch.cat([vals[0], vals[2]], dim=-2),
        torch.cat([vals[1], vals[3]], dim=-2),
    )


def _check_k(k: int) -> None:
    if k < 2 or k > 2048 or k & (k - 1):
        raise ValueError(f"FFT length K = {k} must be a power of two in [2, 2048]")


@functools.lru_cache(maxsize=16)
def kernel_tables_np(k: int, inverse: bool) -> np.ndarray:
    """The kernels' constants, f32 [2K, 4] as (re hi, re lo, im hi, im lo):
    row h + n (1 <= h <= K/2, n < h) is the twiddle of the stage with half
    h at index n, row K + r the twist (or untwist) of row r; row 0 is
    unused. Every word is `_stage_tables`' own: the twiddle at any b-row of
    the stage whose position in its block is h + n, the twist at row r."""
    consts, halves = _stage_tables(k, inverse)
    consts = consts[:, :, 0]
    tab = np.zeros((2 * k, 4), dtype=np.float32)
    for s, h in enumerate(halves):
        tab[h:2 * h] = consts[5 * s + 1:5 * s + 5, h:2 * h].T
    tb = 5 * len(halves)
    tab[k:] = consts[tb:tb + 4].T
    return tab


@functools.lru_cache(maxsize=32)
def _kernel_tables(k: int, inverse: bool, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(kernel_tables_np(k, inverse)).to(device)


def _fwd_ds_cuda(hi, lo):
    *lead, n, b = hi.shape
    k = n // 2
    _check_k(k)
    if n != 2 * k or lo.shape != hi.shape:
        raise ValueError(f"fwd_ds: hi {tuple(hi.shape)} and lo {tuple(lo.shape)} must be one "
                         "shape [..., N, B] with N even")
    hi = hi.contiguous()
    lo = lo.contiguous()
    check_cuda("fwd_ds", hi, lo)
    out = torch.empty((4, *lead, k, b), dtype=torch.float32, device=hi.device)
    kernels.FWD_DS(
        hi.data_ptr(), lo.data_ptr(), _kernel_tables(k, False, hi.device).data_ptr(),
        out.data_ptr(), math.prod(lead), k, b, stream_of(hi),
    )
    return out.unbind(0)


def _inv_ds_cuda(f):
    *lead, k, b = f[0].shape
    _check_k(k)
    if any(c.shape != f[0].shape for c in f[1:]):
        raise ValueError(f"inv_ds: the 4 planes must be one shape, got {[tuple(c.shape) for c in f]}")
    f = [c.contiguous() for c in f]
    check_cuda("inv_ds", *f)
    out = torch.empty((2, *lead, 2 * k, b), dtype=torch.float32, device=f[0].device)
    kernels.INV_DS(
        *(c.data_ptr() for c in f), _kernel_tables(k, True, f[0].device).data_ptr(),
        out.data_ptr(), math.prod(lead), k, b, stream_of(f[0]),
    )
    return out.unbind(0)


def fwd_ds(hi: torch.Tensor, lo: torch.Tensor):
    """Forward ds32 FFT: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    return dispatch("fwd_ds", hi, _fwd_ds_cuda, fwd_ds_plain, hi, lo)


def inv_ds(f):
    """Inverse ds32 FFT: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    return dispatch("inv_ds", f[0], _inv_ds_cuda, inv_ds_plain, f)
