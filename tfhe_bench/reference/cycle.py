"""A plain conversion cycle in PyTorch: circuit bootstrapping of L0 LWE
bits, a CMux under each GGSW, sample extraction and the L1 -> L0 LWE
keyswitch.

Written from the scheme (the circuit bootstrap by trace and scheme switch
of WHS+24, as sunscreen_tfhe's `ops/bootstrapping/circuit_bootstrapping.rs`
computes it), not from the program, and importing nothing of it. It takes
the benchmark's coefficient-domain keys (`frozen/keygen.py`), the
configuration's `params` and LWE ciphertexts int64 [n0+1, B], and returns
LWE ciphertexts int64 [n0+1, B] under the same L0 key:

    ct -> b + q/4 -> switch to 2N/v, times v (v = 2^ceil(log2 l_cbs))
       -> multi-bit blind rotation of the multi-function LUT: coefficient c
          holds -q/2^(log B_cbs (i+1) + 1) for level i = c mod v < l_cbs
       -> per level i: + q/2^(log B_cbs (i+1) + 1) at coefficient i, X^-i,
          a rounding shift by log2 N, the trace (log2 N rounds of
          X -> X^k, k = N/2^(r-1) + 1, a GLWE keyswitch from s(X^k) to s,
          and an add): GLEV level i of the bit
       -> scheme switch: GGSW row j < k = (b in mask j) + sum_r
          decomp(a_r) (*) GLEV(s_j s_r), row k the GLEV itself
       -> CMux of (0, q/2 in every coefficient of b): GGSW (*) (d1 - d0) + d0
       -> sample extraction of coefficient 0 (an L1 LWE under the flat key)
       -> LWE keyswitch: (0, b) - sum_ij digit_ij * KSK[i, j]

Every polynomial product (the rotation's, the trace's keyswitches, the
scheme switch's, the CMux's) runs through `reference/pbs.py`'s negacyclic
FFT in the complex type of `dtype`, the key-side polynomial cut into four
16-bit pieces, each product rounded back to integers and the pieces
recombined mod 2^64. In float64 the rounded products are exact at
DEFAULT_128 but for rare ties; in float32 they are not, which makes it the
control. The LWE keyswitch is an integer product, exact in either dtype
(16-bit key pieces in float64 matrix products, every partial sum below
2^53).

Beside the cycle: `glwe_phases` decrypts GLWE ciphertexts exactly,
`ggsw_error_shares` holds GGSWs to what each row and level encrypts (the
cell's check of a sample of the program's), and `gap_log2` compares two
sets of phases (the tests' comparison of the program's stages with
these).

Departures from upstream, each with the same decryption:

- the rotation is the multi-bit one of `reference/pbs.py` at the key's
  group size (this repository's g = 2 key; upstream rotates one bit a
  CMux);
- each level adds only its own offset (upstream carries the earlier
  levels' offsets along at their own coefficients, which the trace
  cancels exactly: it keeps N times coefficient 0 of the body);
- the GGSW is formed in the coefficient domain (rounded to integers) and
  the CMux takes its spectra, where the program keeps it as spectra.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tfhe_bench.frozen import keygen
from tfhe_bench.reference import pbs

_PIECE_BITS = 16


def _radix(params: dict, name: str) -> tuple:
    count, log_b = params[name]
    return int(count), int(log_b)


def _key_spectra(key: torch.Tensor, fft) -> torch.Tensor:
    """int64 key polynomials [..., N] -> the spectra of their four 16-bit
    pieces, [4, ..., N]."""
    return fft.fwd(pbs._pieces(key).movedim(-1, 0))


def _product(digits: torch.Tensor, key_f: torch.Tensor, fft, per_lane: bool = False):
    """sum_{i, j} digits[j, b, i] (*) key[i, j] mod 2^64: digits int64
    [l, B, k', N], key_f the pieces' spectra [4, k', l, k+1, N] (or
    [4, B, k', l, k+1, N] with `per_lane`: one key a lane) -> int64
    [B, k+1, N]."""
    dig_f = fft.fwd(digits)
    spec = "jbif,pbijof->pbof" if per_lane else "jbif,pijof->pbof"
    return pbs._recombine(fft.inv_round(torch.einsum(spec, dig_f, key_f)))


def _negacyclic_shift(x: torch.Tensor, e: int) -> torch.Tensor:
    """X^e * x for int64 x [..., N] and one exponent e (any integer)."""
    n = x.shape[-1]
    e %= 2 * n
    doubled = torch.cat([x, -x], dim=-1)  # X^N = -1
    return torch.roll(doubled, e, dims=-1)[..., :n]


def automorphism(x: torch.Tensor, k_exp: int) -> torch.Tensor:
    """x(X^k) for odd k, int64 [..., N]: coefficient c goes to c*k mod 2N,
    negated where it lands past N."""
    n = x.shape[-1]
    c = torch.arange(n, device=x.device)
    dest = (c * k_exp) % (2 * n)
    out = torch.empty_like(x)
    out[..., dest % n] = torch.where(dest >= n, -x, x)
    return out


def cbs_lut(n: int, kp1: int, count: int, log_b: int, device) -> torch.Tensor:
    """The multi-function LUT, trivial GLWE int64 [k+1, N]: coefficient c
    holds -q/2^(log_b (i+1) + 1) for level i = c mod v where i < count."""
    v = 1 << (count - 1).bit_length()
    lut = torch.zeros((kp1, n), dtype=torch.int64, device=device)
    for i in range(count):
        lut[-1, i::v] = -(1 << (64 - log_b * (i + 1) - 1))
    return lut


def trace(ct: torch.Tensor, ak_f: torch.Tensor, count: int, log_b: int, fft) -> torch.Tensor:
    """The homomorphic trace of GLWE int64 [B, k+1, N]: round r (1-based)
    maps X -> X^k, k = N/2^(r-1) + 1, keyswitches from s(X^k) back to s
    with `ak_f` [4, log2 N, k, l, k+1, N] and adds the result."""
    n = ct.shape[-1]
    for r in range(1, n.bit_length()):
        mapped = automorphism(ct, n // (1 << (r - 1)) + 1)
        ks = -_product(pbs.decompose(mapped[:, :-1], count, log_b), ak_f[:, r - 1], fft)
        ks[:, -1] += mapped[:, -1]
        ct = ct + ks
    return ct


def glev(ct: torch.Tensor, bsk: torch.Tensor, ak: torch.Tensor, params: dict, fft) -> torch.Tensor:
    """The circuit bootstrap up to the scheme switch: LWE int64 [n0+1, B]
    -> GLEV int64 [l_cbs, B, k+1, N] of each bit (level i encrypts
    bit * q/B_cbs^(i+1) under s)."""
    group = int(params["group_cbs"])
    c_count, c_log = _radix(params, "cbs_radix")
    p_count, p_log = _radix(params, "cbs_pbs_radix")
    t_count, t_log = _radix(params, "tr_radix")
    kp1, n = ak.shape[-2:]
    log_2n = (2 * n).bit_length() - 1
    log_v = (c_count - 1).bit_length()
    ak_f = _key_spectra(ak, fft)
    rotated = ct.clone()
    rotated[-1] += 1 << 62  # b + q/4: bit 0 -> q/4, bit 1 -> 3q/4
    sw = pbs.modulus_switch(rotated, log_2n - log_v) << log_v  # [n0+1, B], multiples of v
    ng = bsk.shape[0]
    a = torch.zeros((ng * group, sw.shape[1]), dtype=torch.int64, device=ct.device)
    a[: sw.shape[0] - 1] = sw[:-1]
    lut = cbs_lut(n, kp1, c_count, c_log, ct.device)
    acc = pbs.monomial_mul(lut, torch.remainder(2 * n - sw[-1], 2 * n))  # [B, k+1, N]
    acc = pbs.blind_rotate(acc, a, bsk, group, p_count, p_log, fft)
    levels = []
    for i in range(c_count):
        lvl = acc.clone()
        lvl[:, -1, i] += 1 << (64 - c_log * (i + 1) - 1)
        shifted = _negacyclic_shift(lvl, -i)
        shifted = pbs._shr(shifted, n.bit_length() - 1) + (pbs._shr(shifted, n.bit_length() - 2) & 1)
        levels.append(trace(shifted, ak_f, t_count, t_log, fft))
    return torch.stack(levels)


def scheme_switch(glev_ct: torch.Tensor, ssk_f: torch.Tensor, count: int, log_b: int, fft):
    """GLEV int64 [l_cbs, B, k+1, N] -> GGSW int64 [B, k+1, l_cbs, k+1, N]:
    row j < k encrypts -s_j * m level by level, row k the GLEV itself;
    `ssk_f` [4, k, k, l_ss, k+1, N] (GLEV(s_i s_j))."""
    l_c, bb, kp1, n = glev_ct.shape
    k = kp1 - 1
    flat = glev_ct.reshape(l_c * bb, kp1, n)
    digits = pbs.decompose(flat[:, :-1], count, log_b)  # [l_ss, l_c*B, k, N]
    rows = []
    for j in range(k):
        row = _product(digits, ssk_f[:, j], fft)  # [l_c*B, k+1, N]
        row[:, j] += flat[:, -1]
        rows.append(row)
    rows.append(flat)
    ggsw = torch.stack(rows).reshape(kp1, l_c, bb, kp1, n)
    return ggsw.permute(2, 0, 1, 3, 4)


def cmux_extract(ggsw: torch.Tensor, count: int, log_b: int, fft) -> torch.Tensor:
    """CMux of d0 = 0 and d1 = (0, q/2 in every coefficient of b) under the
    GGSW of each lane (int64 [B, k+1, l, k+1, N]), then sample extraction
    of coefficient 0: L1 LWE int64 [k*N+1, B]."""
    bb, kp1, _, _, n = ggsw.shape
    d1 = torch.zeros((bb, kp1, n), dtype=torch.int64, device=ggsw.device)
    d1[:, -1] = -(1 << 63)
    digits = pbs.decompose(d1, count, log_b)  # [l, B, k+1, N]; d0 = 0, so d1 - d0 = d1
    return pbs.sample_extract(_product(digits, _key_spectra(ggsw, fft), fft, per_lane=True))


def lwe_keyswitch(l1: torch.Tensor, ksk: torch.Tensor, count: int, log_b: int) -> torch.Tensor:
    """L1 LWE int64 [n1+1, B] -> L0 LWE int64 [n0+1, B]: (0, b) minus
    sum_{i, j} digit_j(a_i) * KSK[i, j], exact mod 2^64."""
    n1, _, m = ksk.shape
    if (1 << (log_b - 1)) * 0xFFFF * n1 * count >= 1 << 53:
        raise ValueError("keyswitch partial sums would pass 2^53")
    digits = pbs.decompose(l1[:-1], count, log_b)  # [l, n1, B]
    d = digits.permute(2, 1, 0).reshape(-1, n1 * count).to(torch.float64)  # [B, n1*l]
    key = ksk.reshape(n1 * count, m)
    out = torch.zeros((d.shape[0], m), dtype=torch.int64, device=l1.device)
    for p in range(4):
        piece = (pbs._shr(key, _PIECE_BITS * p) & 0xFFFF).to(torch.float64)
        out = out + (torch.matmul(d, piece).to(torch.int64) << (_PIECE_BITS * p))
    out = -out.T
    out[-1] += l1[-1]
    return out


def cycle_stages(ct: torch.Tensor, bsk: torch.Tensor, ak: torch.Tensor, ssk: torch.Tensor,
                 ksk: torch.Tensor, params: dict, dtype: torch.dtype = torch.float64):
    """One block of `conversion_cycle`, with what it passes through: (the
    GLEV int64 [l_cbs, B, k+1, N], the GGSW int64 [B, k+1, l_cbs, k+1, N],
    the L1 LWE after the CMux and sample extraction int64 [k*N+1, B], the
    L0 LWE int64 [n0+1, B])."""
    n = ak.shape[-1]
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    fft = pbs._Fft(n, cdtype, ct.device)
    levels = glev(ct, bsk, ak, params, fft)
    ggsw = scheme_switch(levels, _key_spectra(ssk, fft), *_radix(params, "ss_radix"), fft)
    l1 = cmux_extract(ggsw, *_radix(params, "cbs_radix"), fft)
    return levels, ggsw, l1, lwe_keyswitch(l1, ksk, *_radix(params, "ks_radix"))


def conversion_cycle(ct: torch.Tensor, bsk: torch.Tensor, ak: torch.Tensor, ssk: torch.Tensor,
                     ksk: torch.Tensor, params: dict, dtype: torch.dtype = torch.float64,
                     chunk: int = 64) -> torch.Tensor:
    """L0 LWE int64 [n0+1, B] -> L0 LWE int64 [n0+1, B], a fresh encryption
    of each input bit. Keys as `frozen/keygen.py` makes them: `bsk` the
    multi-bit key [n_groups, 2^g-1, k+1, l_pbs, k+1, N] at `cbs_pbs_radix`,
    `ak` [log2 N, k, l_tr, k+1, N], `ssk` [k, k, l_ss, k+1, N], `ksk`
    [k*N, l_ks, n0+1]; `params` the configuration's (`cbs_radix`,
    `cbs_pbs_radix`, `tr_radix`, `ss_radix`, `ks_radix` as [count, log B],
    `group_cbs`). `dtype` float64 (the plain reference) or float32 (the
    control). Runs `chunk` ciphertexts at a time."""
    return torch.cat([cycle_stages(ct[:, c0:c0 + chunk], bsk, ak, ssk, ksk, params, dtype)[-1]
                      for c0 in range(0, ct.shape[1], chunk)], dim=1)


def glwe_phases(ct: torch.Tensor, sk: torch.Tensor) -> torch.Tensor:
    """Phase polynomials b - sum_i a_i (*) s_i of GLWE ciphertexts int64
    [..., k+1, N] under the binary key int64 [k, N], exact mod 2^64:
    int64 [..., N]."""
    dot = sum(keygen.negacyclic_mul_binary(ct[..., i, :].contiguous(), sk[i])
              for i in range(sk.shape[0]))
    return ct[..., -1, :] - dot


def ggsw_error_shares(ggsw: torch.Tensor, bits: torch.Tensor, sk: torch.Tensor,
                      log_b: int) -> torch.Tensor:
    """The worst error of each lane's GGSW, int64 [S, k+1, l, k+1, N] of
    the bits int64 [S], as a share of its level's half step (1 or more
    decodes wrong): row j < k, level i encrypts -s_j * m * q/B^(i+1), row
    k m * q/B^(i+1) at coefficient 0. float64 [S]."""
    _, kp1, levels, _, n = ggsw.shape
    k = kp1 - 1
    phases = glwe_phases(ggsw, sk)  # [S, k+1, l, N]
    msg = torch.zeros((kp1, n), dtype=torch.int64, device=ggsw.device)
    msg[:k] = -sk
    msg[k, 0] = 1
    shifts = torch.tensor([64 - log_b * (i + 1) for i in range(levels)], device=ggsw.device)
    want = (bits.view(-1, 1, 1, 1) * msg[None, :, None, :]) << shifts.view(1, 1, -1, 1)
    err = (phases - want).to(torch.float64).abs()
    half_step = torch.exp2((shifts - 1).to(torch.float64)).view(1, 1, -1, 1)
    return (err / half_step).amax(dim=(1, 2, 3))


def gap_log2(a, b) -> float:
    """log2 of the largest wrapped difference of two phase arrays mod 2^64
    (int64 tensors, or u64 / int64 NumPy arrays); 0 where they agree."""
    a, b = (x.cpu() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x).view(np.int64))
            for x in (a, b))
    d = (a - b).to(torch.float64).abs().max().item()
    return math.log2(max(d, 1.0))
