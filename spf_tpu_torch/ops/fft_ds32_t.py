"""ds32 negacyclic FFT in coefficient-major ("t") layout.

Port of `spf_tpu/ops/fft_ds32_t.py`. Tensors are [..., N, B] / [..., K, B]:
the polynomial or frequency index on axis -2 and the ciphertext batch
last. A complex ds value is a 4-tuple of f32 tensors (re_hi, re_lo,
im_hi, im_lo) in the arithmetic of `ops/ds.py`, and every function keeps
the reference's order of operations and operand order, so the port is
bit for bit with the reference run op by op.

The transform is the reference's: DIF stages of radix 8, 4 or 2 while
blocks are longer than _LIST_CUTOFF rows (the radix plan depends on K:
8 while K/8 >= 16, then 4, then 2), radix-2 stages with scalar twiddles
below, then the mixed-radix digit reversal. The reference unstacks the
last 16 rows of each block into separate arrays (tile-contiguous on a
TPU) and butterflies them one pair at a time; here each stage, big or
small, runs on a [..., K/m, radix, m/radix, B] view of the whole tensor,
all butterflies of a stage in one elementwise operator each. Every
element sees the same operations on the same operands in the same order,
so the bits are the reference's, with a few dozen times fewer operators
a transform. It is another algorithm than the kernels' FFT
(`csrc/fft.cu`) and `ops/u64/fft_ds32.py`'s radix-2 one, with its own
bits; the reference reaches no `pallas_call`, so this is plain PyTorch.

Same transform conventions as the c128 FFT (twist e^{2 pi i j/2N},
forward DFT with negative exponent, inverse normalized with untwist/K).
Tables are numpy, built once, and move to a device once per (K, device).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import ds

_LIST_CUTOFF = 16


_cadd, _csub, _cmul = ds.cadd, ds.csub, ds.cmul


def _cmul_wsplit(a, b6):
    """Complex ds multiply where b ships with Veltkamp-presplit hi
    components: b6 = (brh, brl, bih, bil, brhh, brhl, bihh, bihl) with
    brh == brhh + brhl exactly (12-bit mantissas), likewise bih
    (`ds.mul_wsplit`, halves from `ds.presplit_f32`)."""
    brh, brl, bih, bil, brhh, brhl, bihh, bihl = b6
    pr = ds.mul_wsplit(a[0], a[1], brh, brl, brhh, brhl)
    qr = ds.mul_wsplit(a[2], a[3], bih, bil, bihh, bihl)
    rh, rl = ds.sub(pr[0], pr[1], qr[0], qr[1])
    pi = ds.mul_wsplit(a[0], a[1], bih, bil, bihh, bihl)
    qi = ds.mul_wsplit(a[2], a[3], brh, brl, brhh, brhl)
    ih, il = ds.add(pi[0], pi[1], qi[0], qi[1])
    return (rh, rl, ih, il)


@functools.lru_cache(maxsize=16)
def _tables(k: int, inverse: bool):
    """Per-stage twiddles and the output digit-reversal permutation, the
    reference's numpy tables: `big`, a list of (radix, twiddle planes)
    for the stages on blocks longer than _LIST_CUTOFF (radix 8 while
    m/8 >= cutoff, then 4, then 2; radix r has r - 1 twiddle tuples of
    4 f32 arrays [m/r]); `small`, one list of f32 scalar 4-tuples [m/2]
    per radix-2 stage below; `br`, i32 [K], the position of each
    frequency."""
    sign = 1.0 if inverse else -1.0
    big, small = [], []
    radices = []
    m = k
    while m > _LIST_CUTOFF:
        if m // 8 >= _LIST_CUTOFF:
            n = np.arange(m // 8)
            ws = []
            w1 = np.exp(sign * 2j * np.pi * n / m)
            w = w1.copy()
            for _ in range(7):
                ws.append((*ds.from_f64_array(w.real), *ds.from_f64_array(w.imag)))
                w = w * w1
            big.append((8, tuple(ws)))
            radices.append(8)
            m //= 8
        elif m // 4 >= _LIST_CUTOFF:
            n = np.arange(m // 4)
            w1 = np.exp(sign * 2j * np.pi * n / m)
            w2 = w1 * w1
            w3 = w2 * w1
            big.append((4, tuple((*ds.from_f64_array(w.real), *ds.from_f64_array(w.imag))
                                 for w in (w1, w2, w3))))
            radices.append(4)
            m //= 4
        else:
            n = np.arange(m // 2)
            w = np.exp(sign * 2j * np.pi * n / m)
            big.append((2, ((*ds.from_f64_array(w.real), *ds.from_f64_array(w.imag)),)))
            radices.append(2)
            m //= 2
    while m >= 2:
        n = np.arange(m // 2)
        w = np.exp(sign * 2j * np.pi * n / m)
        small.append([
            (
                np.float32(w.real[i]),
                np.float32(w.real[i] - np.float64(np.float32(w.real[i]))),
                np.float32(w.imag[i]),
                np.float32(w.imag[i] - np.float64(np.float32(w.imag[i]))),
            )
            for i in range(m // 2)
        ])
        radices.append(2)
        m //= 2

    # mixed-radix digit reversal: the recursive residue-class split the
    # DIF stages perform
    def perm(length, rads):
        if not rads:
            return list(range(length))
        r = rads[0]
        sub = perm(length // r, rads[1:])
        out = []
        for j in range(r):
            out.extend(j + r * s for s in sub)
        return out

    freq_at_pos = perm(k, radices)
    br = np.zeros(k, dtype=np.int32)
    br[np.asarray(freq_at_pos)] = np.arange(k)
    return big, small, br


@functools.lru_cache(maxsize=32)
def _device_tables(k: int, inverse: bool, device: torch.device):
    """`_tables(k, inverse)` on `device`: each big stage's twiddles as 4
    f32 tensors [radix - 1, m/radix, 1] (one row per output part), each
    small stage's as 4 f32 tensors [m/2 - 1, 1] (position p >= 1; p = 0
    multiplies by nothing), the permutation as an int64 index."""
    big, small, br = _tables(k, inverse)

    def planes(rows):
        if not rows:  # the m = 2 stage: position 0 only, no twiddle
            return None
        return tuple(torch.from_numpy(np.stack([np.asarray(r[c], np.float32) for r in rows]))
                     .to(device)[..., None] for c in range(4))

    big_t = [(radix, planes(tws)) for radix, tws in big]
    small_t = [planes(tws[1:]) for tws in small]
    return big_t, small_t, torch.from_numpy(br.astype(np.int64)).to(device)


_ISQ2 = ds.from_f64_array(np.float64(2.0 ** -0.5))


@functools.lru_cache(maxsize=8)
def _isq2(device: torch.device):
    """1/sqrt(2) as a ds pair of 0-dim f32 tensors on `device` (the
    reference's f32 scalars: TwoProd sees f32 operands)."""
    return tuple(torch.tensor(c, dtype=torch.float32, device=device) for c in _ISQ2)


def _part(z, i):
    """Part i (a python int or slice) of a comps tuple whose axis -3
    holds a stage's parts."""
    return tuple(c[..., i, :, :] for c in z)


def _join(parts, dim=-3):
    """Comps tuples stacked along a new parts axis."""
    return tuple(torch.stack([p[c] for p in parts], dim=dim) for c in range(4))


def _cat(parts, dim=-3):
    return tuple(torch.cat([p[c] for p in parts], dim=dim) for c in range(4))


def _scale_isq2(z):
    """Multiply a comps tuple by the real ds constant 1/sqrt(2)."""
    c_hi, c_lo = _isq2(z[0].device)
    rh, rl = ds.mul(z[0], z[1], c_hi, c_lo)
    ih, il = ds.mul(z[2], z[3], c_hi, c_lo)
    return (rh, rl, ih, il)


def _mul_i(z, s):
    """s*i*z for s = +-1 on a comps tuple."""
    if s > 0:
        return (-z[2], -z[3], z[0], z[1])
    return (z[2], z[3], -z[0], -z[1])


def _mul_w8(z, s):
    """omega^1 * z, omega = e^(s*2*pi*i/8) = (1 + s*i)/sqrt(2)."""
    if s > 0:
        re = _2sub(z[0], z[1], z[2], z[3])
        im = _2add(z[2], z[3], z[0], z[1])
    else:
        re = _2add(z[0], z[1], z[2], z[3])
        im = _2sub(z[2], z[3], z[0], z[1])
    return _scale_isq2((*re, *im))


def _mul_w8_3(z, s):
    """omega^3 * z = (s*i - 1)/sqrt(2) * z."""
    if s > 0:
        # (i - 1)/sqrt(2): re = -(zr + zi), im = zr - zi
        re = _2add(z[0], z[1], z[2], z[3])
        im = _2sub(z[0], z[1], z[2], z[3])
        re = (-re[0], -re[1])
    else:
        re = _2sub(z[0], z[1], z[2], z[3])
        im = _2add(z[2], z[3], z[0], z[1])
        re = (-re[0], -re[1])
        im = (-im[0], -im[1])
    return _scale_isq2((*re, *im))


_2add, _2sub = ds.add, ds.sub


def _dft4(z, s):
    """4-point DFT, omega4 = s*i, of the parts z0..z3 on axis -3 of z:
    (u0, u1, u2, u3) on the same axis. The reference's pairs (z0 + z2,
    z1 + z3), (z0 - z2, z1 - z3), then (t0 +- t2, t1 +- t3) run as one
    operator each."""
    sums = _cadd(_part(z, slice(0, 2)), _part(z, slice(2, 4)))  # t0, t2
    difs = _csub(_part(z, slice(0, 2)), _part(z, slice(2, 4)))  # t1, z1 - z3
    t3 = _mul_i(_part(difs, 1), s)
    lo = _join([_part(sums, 0), _part(difs, 0)])  # t0, t1
    hi = _join([_part(sums, 1), t3])  # t2, t3
    return _cat([_cadd(lo, hi), _csub(lo, hi)])


def _dft8(z, s):
    """8-point DFT with omega = e^(s*2*pi*i/8) of the parts x0..x7 on
    axis -3 of z: y[r] = sum_t x[t] w^(rt) on the same axis. Even outputs
    via DFT4 of (x_t + x_{t+4}); odd via DFT4 of omega^t * (x_t - x_{t+4});
    both DFT4s run as one."""
    a = _cadd(_part(z, slice(0, 4)), _part(z, slice(4, 8)))
    b = _csub(_part(z, slice(0, 4)), _part(z, slice(4, 8)))
    b = _join([_part(b, 0), _mul_w8(_part(b, 1), s), _mul_i(_part(b, 2), s),
               _mul_w8_3(_part(b, 3), s)])
    u = _dft4(_join([a, b], dim=-4), s)  # [..., 2 (even, odd), 4, q, B]
    # interleave: e0, o0, e1, o1, ...
    return tuple(c.transpose(-4, -3).reshape(*c.shape[:-4], 8, *c.shape[-2:]) for c in u)


def _twiddle(y, tws):
    """Part 0 as it is, parts r >= 1 times twiddle row r - 1 (tws: 4
    tensors [radix - 1, q, 1])."""
    rest = _cmul(_part(y, slice(1, None)), tws)
    return _cat([_part(y, slice(0, 1)), rest])


def _radix8_dif(x, tws, inverse):
    """One radix-8 DIF butterfly group on the eighths of each block, axis
    -3 of x: y_r = w_r * DFT8(x)[r] on the same axis."""
    return _twiddle(_dft8(x, 1 if inverse else -1), tws)


def _radix8_dit(y, tws):
    """Inverse of `_radix8_dif(..., inverse=False)` up to the x8 factor
    (absorbed in the untwist /K): u_r = conj(w_r) * y_r, then DFT8 with
    s = +1. `tws` are the inverse-sign twiddle tables."""
    return _dft8(_twiddle(y, tws), 1)


def _radix4_dif(x, tws, inverse):
    """One radix-4 DIF butterfly group on the quarters of each block,
    axis -3 of x: y0 = t0 + t2, y1 = (t1 + t3) w1, y2 = (t0 - t2) w2,
    y3 = (t1 - t3) w3, t3 = -+i (b - d)."""
    sums = _cadd(_part(x, slice(0, 2)), _part(x, slice(2, 4)))  # t0, t2
    difs = _csub(_part(x, slice(0, 2)), _part(x, slice(2, 4)))  # t1, b - d
    t3 = _mul_i(_part(difs, 1), 1 if inverse else -1)
    lo = _join([_part(sums, 0), _part(difs, 0)])  # t0, t1
    hi = _join([_part(sums, 1), t3])  # t2, t3
    return _twiddle(_cat([_cadd(lo, hi), _csub(lo, hi)]), tws)


def _radix4_dit(y, tws):
    """Inverse of `_radix4_dif(..., inverse=False)` up to the x4 factor
    (absorbed in the untwist /K)."""
    u = _twiddle(y, tws)  # y0, u1, u2, u3
    lo, hi = _part(u, slice(0, 2)), _part(u, slice(2, 4))
    t02, t13 = _cadd(lo, hi), _csub(lo, hi)  # (t0, t1), (t2, t3)
    it3 = _mul_i(_part(t13, 1), 1)  # i * t3 == (b - d)
    a = _join([_part(t02, 0), _part(t13, 0)])  # t0, t2
    b = _join([_part(t02, 1), it3])  # t1, i t3
    return _cat([_cadd(a, b), _csub(a, b)])


def _radix2_dif(x, tws):
    a, b = _part(x, slice(0, 1)), _part(x, slice(1, 2))
    return _cat([_cadd(a, b), _cmul(_csub(a, b), tws)])


def _radix2_dit(y, tws):
    u, v = _part(y, slice(0, 1)), _part(y, slice(1, 2))
    vp = _cmul(v, tws)
    return _cat([_cadd(u, vp), _csub(u, vp)])


def _stage(comps, m: int, radix: int, fn):
    """fn on the [..., K/m, radix, m/radix, B] view of [..., K, B]."""
    shape = comps[0].shape
    k, lead = shape[-2], shape[:-2]
    x = tuple(c.reshape(*lead, k // m, radix, m // radix, shape[-1]) for c in comps)
    return tuple(c.reshape(shape) for c in fn(x))


def _small_stage(comps, m: int, tws, dit: bool):
    """One radix-2 stage of block m below the cutoff: position p of a
    block and p + m/2 butterflied, the difference (DIF) or the odd input
    (DIT) times twiddle p for p >= 1 (tws: 4 tensors [m/2 - 1, 1])."""

    def twiddled(v):
        if m == 2:
            return v
        rest = _cmul(tuple(c[..., 1:, :] for c in v), tws)
        return tuple(torch.cat([c[..., :1, :], r], dim=-2) for c, r in zip(v, rest))

    def fn(x):
        a, b = _part(x, 0), _part(x, 1)
        if dit:
            vp = twiddled(b)
            top, bot = _cadd(a, vp), _csub(a, vp)
        else:
            top, bot = _cadd(a, b), twiddled(_csub(a, b))
        return _join([top, bot])

    return _stage(comps, m, 2, fn)


def _fft_core_t(comps, inverse: bool, take_out: bool = True):
    """comps: 4 f32 tensors [..., K, B] (K on axis -2) -> the DFT
    (inverse sign if `inverse`), unnormalized. `take_out=False` skips the
    final digit-reversal gather and returns the DIF output (scrambled)
    order."""
    k = comps[0].shape[-2]
    big, small, br = _device_tables(k, inverse, comps[0].device)
    m = k
    for radix, tws in big:
        if radix == 8:
            comps = _stage(comps, m, 8, lambda x, t=tws: _radix8_dif(x, t, inverse))
        elif radix == 4:
            comps = _stage(comps, m, 4, lambda x, t=tws: _radix4_dif(x, t, inverse))
        else:
            comps = _stage(comps, m, 2, lambda x, t=tws: _radix2_dif(x, t))
        m //= radix
    for tws in small:
        comps = _small_stage(comps, m, tws, dit=False)
        m //= 2
    if not take_out:
        return comps
    return tuple(torch.index_select(c, -2, br) for c in comps)


def _fft_core_t_list(comps):
    """The reference's concat-free forward DIF core, identical to
    `_fft_core_t(..., inverse=False, take_out=False)` bit for bit. It
    keeps blocks as separate arrays to spare a TPU the concatenates'
    round trips to HBM; eager PyTorch materializes every operator either
    way, so it runs the same stages."""
    return _fft_core_t(comps, inverse=False, take_out=False)


def _ifft_core_t_list(comps):
    """The reference's concat-free mirror of `_ifft_core_t_dit` (the same
    values bit for bit); here the same stages, as `_fft_core_t_list`."""
    return _ifft_core_t_dit(comps)


def _ifft_core_t_dit(comps):
    """Algebraic inverse of `_fft_core_t(..., inverse=False,
    take_out=False)`: consumes the DIF output (digit-scrambled) order and
    returns natural coefficient order with no permutation gather. Each
    forward stage [a; b] -> [a+b, (a-b)*w] inverts (up to a factor 2 per
    radix-2 stage, absorbed by the caller's untwist /K) to v' = v*conj(w),
    a = u+v', b = u-v': a DIT pipeline with the inverse-sign twiddle
    tables, the stages mirrored small to big."""
    k = comps[0].shape[-2]
    big, small, _ = _device_tables(k, True, comps[0].device)
    cut = min(_LIST_CUTOFF, k)
    m = 2
    for tws in reversed(small):
        comps = _small_stage(comps, m, tws, dit=True)
        m *= 2
    assert m // 2 == cut
    ms = []
    mm = k
    for radix, _tws in big:
        ms.append(mm)
        mm //= radix
    for (radix, tws), m in zip(reversed(big), reversed(ms)):
        if radix == 8:
            comps = _stage(comps, m, 8, lambda y, t=tws: _radix8_dit(y, t))
        elif radix == 4:
            comps = _stage(comps, m, 4, lambda y, t=tws: _radix4_dit(y, t))
        else:
            comps = _stage(comps, m, 2, lambda y, t=tws: _radix2_dit(y, t))
    return comps


@functools.lru_cache(maxsize=16)
def dif_freq_order(k: int):
    """freq_at_pos: position r of the take-free DIF output holds natural
    frequency bin `dif_freq_order(k)[r]` (numpy i64)."""
    _, _, br = _tables(k, False)
    freq_at_pos = np.zeros(k, dtype=np.int64)
    freq_at_pos[br] = np.arange(k)  # br[freq] = pos  ->  invert
    return freq_at_pos


@functools.lru_cache(maxsize=16)
def dif_bit_images(k: int):
    """The DIF digit reversal is a permutation of index bits, so
    f(r) = sum over set bits j of f(2^j). Returns the images (f(2^0),
    f(2^1), ...) for building frequency-ordered geometric sequences in
    scrambled order; asserts bit-linearity as a self-check."""
    f = dif_freq_order(k)
    imgs = tuple(int(f[1 << j]) for j in range(k.bit_length() - 1))
    r = np.arange(k)
    recon = np.zeros(k, dtype=np.int64)
    for j, img in enumerate(imgs):
        recon += ((r >> j) & 1) * img
    assert np.array_equal(recon, f), "DIF digit reversal is not bit-linear"
    return imgs


@functools.lru_cache(maxsize=16)
def _twist_tables_np(n: int):
    kk = n // 2
    j = np.arange(kk)
    tw = np.exp(2j * np.pi * j / (2 * n))
    untw = (1.0 / tw) / kk
    return ((*ds.from_f64_array(tw.real), *ds.from_f64_array(tw.imag)),
            (*ds.from_f64_array(untw.real), *ds.from_f64_array(untw.imag)))


@functools.lru_cache(maxsize=32)
def _twist_tables_t(n: int, device: torch.device):
    """Twist and untwist as 4 f32 tensors [N/2, 1] each on `device`."""
    return tuple(tuple(torch.from_numpy(t).to(device)[:, None] for t in planes)
                 for planes in _twist_tables_np(n))


def fwd_torus_t(x: torch.Tensor):
    """Torus int64 [..., N, B] -> freq tuple of 4 f32 [..., N/2, B]."""
    n = x.shape[-2]
    kk = n // 2
    hi, lo = ds.from_i64(x.to(torch.int64))
    twist, _ = _twist_tables_t(n, x.device)
    z = (hi[..., :kk, :], lo[..., :kk, :], hi[..., kk:, :], lo[..., kk:, :])
    z = _cmul(z, twist)
    return _fft_core_t(z, inverse=False)


def fwd_signed_t(x: torch.Tensor):
    """Signed integer coefficients [..., N, B] -> freq tuple [..., N/2, B]."""
    return fwd_torus_t(x.to(torch.int64))


def inv_t(f) -> torch.Tensor:
    """freq tuple [..., K, B] -> torus int64 [..., N, B], rounded mod q."""
    _, untwist = _twist_tables_t(f[0].shape[-2] * 2, f[0].device)
    z = _fft_core_t(f, inverse=True)
    z = _cmul(z, untwist)
    re = ds.to_u64_mod_q(z[0], z[1])
    im = ds.to_u64_mod_q(z[2], z[3])
    return torch.cat([re, im], dim=-2)


def cmadd_t(acc, a, b):
    """acc + a*b on freq tuples (broadcastable components)."""
    return _cadd(acc, _cmul(a, b))


def zeros_t(shape, device=None):
    z = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
    return (z, z, z, z)
