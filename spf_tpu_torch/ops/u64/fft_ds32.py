"""Negacyclic FFT backend in double-single f32 arithmetic: the ds32
backend of the u64 API.

Port of `spf_tpu/ops/fft_ds32.py`. The same transform conventions as the
c128 backend (`fft.py`), but every complex value is a pair of ds numbers
(4 f32 tensors: re_hi, re_lo, im_hi, im_lo), carrying ~48 mantissa bits:
enough for the external product's error budget at q = 2**64.

The FFT is an iterative radix-2 DIT over the last axis with a bit-reversal
permutation and per-stage ds twiddles, in PyTorch elementwise operators
with the reference's order of operations (`ops/ds.py`), so the backend is
bit for bit with the JAX package's run op by op. It is another algorithm
than the kernels' FFT (`csrc/fft.cu`: bit-reversed output, radix-8
passes), so it has its own bits; the reference is plain jnp with no
`pallas_call`, so there is no kernel here either.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import ds
from .torus import u64


class DsFreq:
    """A frequency-domain value: 4 f32 tensors of one shape. Indexing
    applies to all four, so the ciphertext code that indexes c128 spectra
    runs unchanged."""

    __slots__ = ("rh", "rl", "ih", "il")

    def __init__(self, rh, rl, ih, il):
        self.rh, self.rl, self.ih, self.il = rh, rl, ih, il

    @property
    def shape(self):
        return self.rh.shape

    @property
    def device(self) -> torch.device:
        return self.rh.device

    def __getitem__(self, idx):
        return DsFreq(self.rh[idx], self.rl[idx], self.ih[idx], self.il[idx])

    def astuple(self):
        return self.rh, self.rl, self.ih, self.il

    def to(self, device) -> "DsFreq":
        return DsFreq(*(c.to(device) for c in self.astuple()))


def _cadd(a: DsFreq, b: DsFreq) -> DsFreq:
    return DsFreq(*ds.cadd(a.astuple(), b.astuple()))


def _csub(a: DsFreq, b: DsFreq) -> DsFreq:
    return DsFreq(*ds.csub(a.astuple(), b.astuple()))


def _cmul(a: DsFreq, b: DsFreq) -> DsFreq:
    return DsFreq(*ds.cmul(a.astuple(), b.astuple()))


@functools.lru_cache(maxsize=16)
def _fft_tables_np(k: int, inverse: bool):
    """Bit-reversal permutation and per-stage ds twiddles of a size-k
    radix-2 DIT FFT (forward: e^{-2 pi i j/m}; inverse: conjugate), the
    reference's numpy constants."""
    stages = int(np.log2(k))
    assert 1 << stages == k
    br = np.zeros(k, dtype=np.int64)
    for i in range(k):
        br[i] = int(format(i, f"0{stages}b")[::-1], 2) if stages else 0
    twiddles = []
    for s in range(1, stages + 1):
        m = 1 << s
        j = np.arange(m // 2)
        sign = 1.0 if inverse else -1.0
        w = np.exp(sign * 2j * np.pi * j / m)
        twiddles.append((*ds.from_f64_array(w.real), *ds.from_f64_array(w.imag)))
    return br, twiddles


@functools.lru_cache(maxsize=32)
def _fft_tables(k: int, inverse: bool, device: torch.device):
    br, twiddles = _fft_tables_np(k, inverse)
    return (torch.from_numpy(br).to(device),
            [DsFreq(*(torch.from_numpy(c).to(device) for c in tw)) for tw in twiddles])


def _fft_core(z: DsFreq, inverse: bool) -> DsFreq:
    """Radix-2 DIT over the last axis (size k), stage by stage."""
    k = z.shape[-1]
    br, twiddles = _fft_tables(k, inverse, z.device)
    comps = [c[..., br] for c in z.astuple()]
    for s, tw in enumerate(twiddles, start=1):
        m = 1 << s
        half = m // 2
        reshaped = [c.reshape(*c.shape[:-1], k // m, m) for c in comps]
        a = DsFreq(*[c[..., :half] for c in reshaped])
        b = DsFreq(*[c[..., half:] for c in reshaped])
        t = _cmul(tw, b)
        top = _cadd(a, t)
        bot = _csub(a, t)
        comps = [torch.cat([x, y], dim=-1).reshape(*x.shape[:-2], k)
                 for x, y in zip(top.astuple(), bot.astuple())]
    return DsFreq(*comps)


@functools.lru_cache(maxsize=32)
def _twist_tables(n: int, device: torch.device):
    """Twist e^{2 pi i j/(2n)} and untwist (1/tw)/(n/2) as ds constants."""
    kk = n // 2
    j = np.arange(kk)
    tw = np.exp(2j * np.pi * j / (2 * n))
    untw = (1.0 / tw) / kk

    def planes(x):
        return DsFreq(*(torch.from_numpy(c).to(device)
                        for c in (*ds.from_f64_array(x.real), *ds.from_f64_array(x.imag))))

    return planes(tw), planes(untw)


class DS32Backend:
    """Double-single f32 negacyclic FFT backend, with the c128 backend's
    interface (`fft.C128Backend`); spectra are `DsFreq`."""

    name = "ds32"

    def _fwd(self, hi, lo, n: int) -> DsFreq:
        kk = n // 2
        twist, _ = _twist_tables(n, hi.device)
        z = DsFreq(hi[..., :kk], lo[..., :kk], hi[..., kk:], lo[..., kk:])
        return _fft_core(_cmul(z, twist), inverse=False)

    def fwd_torus(self, x: torch.Tensor) -> DsFreq:
        """Torus coefficients [..., N] (their int64 reading is the centered
        value) -> spectra [..., N/2]."""
        hi, lo = ds.from_i64(u64(x))
        return self._fwd(hi, lo, x.shape[-1])

    def fwd_signed(self, x: torch.Tensor) -> DsFreq:
        """Signed integer coefficients [..., N] -> spectra [..., N/2]."""
        hi, lo = ds.from_i64(x.to(torch.int64))
        return self._fwd(hi, lo, x.shape[-1])

    def inv(self, f: DsFreq) -> torch.Tensor:
        """Spectra [..., N/2] -> int64 torus [..., N]: rounded, reduced mod q."""
        kk = f.shape[-1]
        _, untwist = _twist_tables(kk * 2, f.device)
        z = _cmul(_fft_core(f, inverse=True), untwist)
        re = ds.to_u64_mod_q(z.rh, z.rl)
        im = ds.to_u64_mod_q(z.ih, z.il)
        return torch.cat([re, im], dim=-1)

    # --- frequency-domain arithmetic ---

    def zeros(self, shape, device=None) -> DsFreq:
        return DsFreq(*(torch.zeros(tuple(shape), dtype=torch.float32, device=device)
                        for _ in range(4)))

    def add(self, a, b):
        return _cadd(a, b)

    def sub(self, a, b):
        return _csub(a, b)

    def mul(self, a, b):
        return _cmul(a, b)

    def cmadd(self, acc, a, b):
        """acc + a * b, the product first (the reference's order)."""
        return _cadd(acc, _cmul(a, b))

    def stack(self, fs, axis=0):
        """Spectra stacked as one `DsFreq`; plain tensors (LWE / GLWE
        ciphertexts, which stay int64 on this backend) as `torch.stack`."""
        fs = list(fs)
        if isinstance(fs[0], torch.Tensor):
            return torch.stack(fs, dim=axis)
        return DsFreq(*(torch.stack([f.astuple()[c] for f in fs], dim=axis) for c in range(4)))

    def set_component(self, acc: DsFreq, idx: int, value: DsFreq) -> None:
        """Component `idx` of `acc`'s (k+1) axis set to `value`, in place."""
        for a, v in zip(acc.astuple(), value.astuple()):
            a[..., idx, :] = v


DS32 = DS32Backend()
