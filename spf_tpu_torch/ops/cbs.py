"""Circuit bootstrapping and the conversion cycle on int64 torus tensors.

Port of `spf_tpu/ops/cbs_u32.py` (WHS+24; reference
`sunscreen_tfhe/src/ops/bootstrapping/circuit_bootstrapping.rs:342-484`):
an L0 LWE bit becomes an L1 GGSW in the frequency domain, through

1. a multi-function PBS of the bit rotated by q/4, whose LUT holds one
   function per decomposition level (`multifunctional_cbs_lut_np`);
2. per level: the level's offset removed at its coefficient, X^-i,
   a rounding shift by log2 N and the homomorphic trace (log2 N rounds of
   automorphism + GLWE keyswitch), which leaves a GLEV;
3. the scheme switch GLEV -> GGSW.

The reference scans the levels and the trace rounds (`jax.lax.scan`) to
keep its compiled graph small; eager PyTorch loops in Python over the
same stacked tables. `ConversionCycle` is the cycle that
`bench.py --cbs` times (`bench.py:476-487`): CBS, a CMux of (0, q/2)
under the GGSW, sample extraction and the L1 -> L0 LWE keyswitch.

Kernels on this path: the blind rotation's (multi-bit at the key's
group size: `accumulate_decompose`, `mad_horner`, the FFTs, `phase_factors`),
the forward and inverse FFTs of every keyswitch, the scheme switch and
the CMux, the CMux's MAD under the batched row of the CBS output
(`freq_mad_batched`), and, for every GLWE keyswitch of the trace and the
scheme switch's rows, the MAD (`freq_mad_ks`) and the coefficient-domain
halves around it (`ks_decompose`: the automorphism and the digits;
`ks_round_add`: the rounding, the negation and the adds; XLA glue on the
TPU).

Each stage runs inside a span of `utils.profiling` (`cbs.rotate`,
`cbs.levels`, `cbs.trace`, `cbs.scheme_switch`, `cycle.cmux`,
`cycle.keyswitch`), and `metrics` counts `cbs.calls` and `cbs.lanes` a
circuit bootstrap, `cbs.glwe_keyswitches` a GLWE keyswitch, and on a card
the launches of the keyswitch kernels, a circuit bootstrap:
`cbs.ks_mad_launches` log2(N) * l_cbs + k (the trace's, the scheme switch's
rows), `cbs.ks_decompose_launches` log2(N) * l_cbs + 1 and
`cbs.ks_round_launches` log2(N) * l_cbs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..params import GlweDef, Params, RadixDecomposition
from ..utils.profiling import metrics, span
from . import fft, mad, rot_decomp, torus
from .bootstrap import (
    as_tensor,
    blind_rotate,
    cmux,
    fwd_limb,
    fwd_signed,
    register_spectra,
    sample_extract,
    spectra,
)
from .keyswitch import keyswitch_lwe, ksk_to_byte_planes
from .multibit import blind_rotate_multibit


def _log_v(count: int) -> int:
    return (count - 1).bit_length()


def multifunctional_cbs_lut_np(glwe: GlweDef, cbs_radix: RadixDecomposition) -> np.ndarray:
    """The multi-function decomposition LUT, u64 [k+1, N]: coefficient i
    holds function i mod 2^log_v, the level whose output is
    -1 at precision radix_log*(level+1)+1 bits (≙
    `cbs_u32.multifunctional_cbs_lut_np`)."""
    n = glwe.degree
    count = cbs_radix.count
    if count >= 16:
        raise ValueError(f"cbs_radix.count {count} >= 16")
    v = 1 << _log_v(count)
    levels = np.zeros(16, dtype=np.uint64)
    for i in range(1, 17):
        pb = cbs_radix.radix_log * i + 1
        if pb < 64:
            levels[i - 1] = np.uint64((1 << pb) - 1) << np.uint64(64 - pb)
    b = np.zeros(n, dtype=np.uint64)
    for i in range(n):
        if i % v < count:
            b[i] = levels[i % v]
    lut = np.zeros((glwe.size + 1, n), dtype=np.uint64)
    lut[-1] = b
    return lut


# Device tables are cached without bound: a CUDA graph that the wave
# machine captured (`runtime/wave_machine.py`) reads them by address on
# every replay, so an evicted table would be freed under it.
@functools.lru_cache(maxsize=None)
def _cbs_lut(glwe: GlweDef, cbs_radix: RadixDecomposition, device: torch.device) -> torch.Tensor:
    """`multifunctional_cbs_lut_np` on `device`, int64 [k+1, N], copied
    once (a copy from the host inside a captured graph is not allowed)."""
    return torus.from_u64_np(multifunctional_cbs_lut_np(glwe, cbs_radix)).to(device)


def _count_launch(counter: str, t: torch.Tensor) -> None:
    """Count a launch of a kernel as `counter`, on a card only (CPU tensors
    run the plain versions)."""
    if t.is_cuda:
        metrics.inc(counter)


def _ks_mad(dfft, key_row, init=None, init_plane: int = 0):
    """`mad.freq_mad_ks`, each launch of its kernel counted as
    `cbs.ks_mad_launches`."""
    out = mad.freq_mad_ks(dfft, key_row, init, init_plane)
    _count_launch("cbs.ks_mad_launches", dfft[0])
    return out


def _ks_decompose(masks, radix: RadixDecomposition, table=None):
    """`rot_decomp.ks_decompose`, each launch counted as
    `cbs.ks_decompose_launches`."""
    out = rot_decomp.ks_decompose(masks, radix, table)
    _count_launch("cbs.ks_decompose_launches", masks)
    return out


def keyswitch_glwe(ct: torch.Tensor, ksk_row, glwe: GlweDef, radix: RadixDecomposition,
                   table=None, accumulate: bool = False):
    """GLWE keyswitch: ct int64 [k+1, N, B], key spectra 4 planes
    [k, l, k+1, K] -> int64 [k+1, N, B] (≙ `cbs_u32.keyswitch_glwe_u32`).
    With `table`, a trace round's (src, neg) of `_trace_tables`, the
    keyswitch of ct's image under the round's X -> X^k, read in place; with
    `accumulate`, ct plus the keyswitch (the trace round's sum)."""
    metrics.inc("cbs.glwe_keyswitches")
    dfft = fwd_signed(_ks_decompose(ct[:-1], radix, table))  # [l, k, K, B]
    prod = fft.inv_ds(_ks_mad(dfft, ksk_row))
    out = rot_decomp.ks_round_add(prod, ct, table, accumulate)
    _count_launch("cbs.ks_round_launches", ct)
    return out


@functools.lru_cache(maxsize=None)  # never evicted: see `_cbs_lut`
def _trace_tables(n: int, device: torch.device):
    """Per-round X -> X^k tables of the trace, on `device`: for round r
    (1-based), k = N/2^(r-1) + 1; src[r-1, d] is the coefficient that lands
    at d and neg[r-1, d] its negacyclic sign (≙ `cbs_u32._trace_tables`).
    Copied once: a copy from the host waits for every operation queued
    before it, so one a round made the host wait for the device."""
    rounds = n.bit_length() - 1
    src = np.zeros((rounds, n), dtype=np.int64)
    neg = np.zeros((rounds, n), dtype=bool)
    i = np.arange(n)
    for r in range(1, rounds + 1):
        k_exp = n // (1 << (r - 1)) + 1
        dest = (i * k_exp) % n
        src[r - 1, dest] = i
        neg[r - 1, dest] = ((i * k_exp) // n) % 2 == 1
    return torch.from_numpy(src).to(device), torch.from_numpy(neg).to(device)


@span("cbs.trace")
def trace(ct: torch.Tensor, auto_keys_freq, glwe: GlweDef, radix: RadixDecomposition):
    """Homomorphic trace: log2(N) rounds of (X -> X^k, GLWE keyswitch,
    add); auto_keys_freq 4 planes [log2 N, k, l, k+1, K]
    (≙ `cbs_u32.trace_u32`)."""
    src, neg = _trace_tables(glwe.degree, ct.device)
    for r in range(src.shape[0]):
        ct = keyswitch_glwe(ct, tuple(c[r] for c in auto_keys_freq), glwe, radix,
                            (src[r], neg[r]), accumulate=True)
    return ct


@span("cbs.scheme_switch")
def scheme_switch(glev: torch.Tensor, ssk_freq, glwe: GlweDef,
                  radix_ggsw: RadixDecomposition, radix_ss: RadixDecomposition):
    """GLEV int64 [l_ggsw, k+1, N, B] -> GGSW spectra, 4 planes
    [k+1, l_ggsw, k+1, K, B]; ssk_freq 4 planes [k, k, l_ss, k+1, K]
    (≙ `cbs_u32.scheme_switch_u32`)."""
    kp1 = glwe.size + 1
    b_fft = fwd_limb(glev[:, -1])  # [l, K, B]
    dfft = fwd_signed(_ks_decompose(glev[:, :-1], radix_ss))  # [l_ss, l, k, K, B]
    # row j: GLEV(b) in column j, plus the product with the key row [k, l_ss, k+1, K]
    rows = [_ks_mad(dfft, tuple(c[j] for c in ssk_freq), b_fft, j) for j in range(glwe.size)]
    rows.append(fwd_limb(glev))  # row k: GLEV(m) itself
    return tuple(torch.stack([rows[r][c] for r in range(kp1)]) for c in range(4))


@span("cbs.rotate")
def cbs_blind_rotate(ct: torch.Tensor, bsk_freq, params: Params, phase_rot: bool = False):
    """Step 1 of circuit bootstrapping: the input bit rotated by q/4
    (0 -> q/4, 1 -> 3q/4), then the multi-function PBS's blind rotation:
    L0 LWE int64 [n0+1, B] -> accumulator int64 [k+1, N, B]. A 6-dim
    `bsk_freq` is a multi-bit key [n_groups, 2^g-1, k+1, l, k+1, K] and
    selects the multi-bit rotation (g from its subset axis; `phase_rot`
    does not apply); a 5-dim one is a single-bit key, rotated in the form
    `phase_rot` picks (plain otherwise)."""
    glwe = params.l1_params
    cbs_radix = params.cbs_radix
    ct_rot = ct.clone()
    ct_rot[-1] = torus.add_small(ct[-1], torus.encode_const(1, 2))
    lut = _cbs_lut(glwe, cbs_radix, ct.device)
    ct_sw = torus.modulus_switch(ct_rot, 0, _log_v(cbs_radix.count), glwe.log_degree + 1)
    if bsk_freq[0].dim() == 6:
        ns = bsk_freq[0].shape[1]
        group = (ns + 1).bit_length() - 1
        if (1 << group) - 1 != ns:
            raise ValueError(f"multi-bit key subset axis {ns} is not 2^g - 1")
        return blind_rotate_multibit(lut[..., None], ct_sw, bsk_freq, glwe,
                                     params.cbs_pbs_radix_eff, group)
    return blind_rotate(lut[..., None], ct_sw, bsk_freq, glwe, params.cbs_pbs_radix_eff,
                        phase_rot=phase_rot)


@span("cbs.levels")
def cbs_levels(acc: torch.Tensor, auto_keys_freq, params: Params) -> torch.Tensor:
    """Step 2: per level i, remove the level's offset at coefficient i
    (the offsets accumulate level by level), X^-i, shr-round by log2 N,
    trace: accumulator int64 [k+1, N, B] -> GLEV int64 [l_cbs, k+1, N, B]."""
    glwe = params.l1_params
    cbs_radix = params.cbs_radix
    n = glwe.degree
    rows = []
    for i in range(cbs_radix.count):
        acc = acc.clone()
        acc[-1, i] = torus.add_small(acc[-1, i], torus.encode_const(1, cbs_radix.radix_log * (i + 1) + 1))
        t = torch.full((acc.shape[-1],), 2 * n - i, dtype=torch.int64, device=acc.device)
        shifted = torus.shr_round(torus.monomial_mul(acc, t), glwe.log_degree)
        rows.append(trace(shifted, auto_keys_freq, glwe, params.tr_radix))
    return torch.stack(rows)


def circuit_bootstrap(ct: torch.Tensor, bsk_freq, auto_keys_freq, ssk_freq, params: Params,
                      phase_rot: bool = False):
    """L0 LWE int64 [n0+1, B] -> L1 GGSW spectra, 4 planes
    [k+1, l_cbs, k+1, K, B] (≙ `cbs_u32.circuit_bootstrap_u32`): the
    blind rotation (`cbs_blind_rotate`), the levels (`cbs_levels`), and
    the scheme switch GLEV -> GGSW."""
    metrics.inc("cbs.calls")
    metrics.inc("cbs.lanes", ct.shape[-1])
    acc = cbs_blind_rotate(ct, bsk_freq, params, phase_rot)
    glev = cbs_levels(acc, auto_keys_freq, params)
    return scheme_switch(glev, ssk_freq, params.l1_params, params.cbs_radix, params.ss_radix)


class ConversionCycle(nn.Module):
    """L0 LWE -> (CBS) -> GGSW -> (CMux of 0 and q/2) -> GLWE -> (sample
    extract) -> L1 LWE -> (keyswitch) -> L0 LWE, the cycle of
    `bench.py --cbs` (`bench.py:476-487`): a fresh L0 encryption of the
    same bit.

    Keys in the coefficient domain, u64 numpy or int64 tensors: `bsk` the
    blind rotation's key at `params.cbs_pbs_radix_eff` (multi-bit
    [n_groups, 2^g-1, k+1, l, k+1, N] or single-bit [n0, k+1, l, k+1, N]),
    `auto_keys` [log2 N, k, l_tr, k+1, N], `ssk` [k, k, l_ss, k+1, N] and
    `ksk` [k*N, l_ks, n0+1]. Spectra are made by the port's FFT and the
    keyswitch key cut into byte planes on `device`. Calling the module on
    LWE ciphertexts int64 [n0+1, B] returns LWE ciphertexts int64
    [n0+1, B] under the same L0 key."""

    def __init__(self, bsk, auto_keys, ssk, ksk, params: Params, phase_rot: bool = False,
                 device="cuda"):
        super().__init__()
        device = torus.resolve_device(device)
        self.params = params
        self.phase_rot = phase_rot
        glwe = params.l1_params
        kp1, n = glwe.size + 1, glwe.degree
        want = {
            "bsk": (kp1, params.cbs_pbs_radix_eff.count, kp1, n),
            "ak": (glwe.log_degree, glwe.size, params.tr_radix.count, kp1, n),
            "ssk": (glwe.size, glwe.size, params.ss_radix.count, kp1, n),
        }
        for prefix, key in (("bsk", bsk), ("ak", auto_keys), ("ssk", ssk)):
            key = as_tensor(key)
            tail = tuple(key.shape[-len(want[prefix]):])
            if tail != want[prefix] or (prefix == "bsk" and key.dim() not in (5, 6)):
                raise ValueError(f"{prefix} shape {tuple(key.shape)}, want [..., *{want[prefix]}]")
            register_spectra(self, prefix, key, device)
        ksk = as_tensor(ksk)
        want_ksk = (glwe.size * n, params.ks_radix.count, params.l0_params.dim + 1)
        if tuple(ksk.shape) != want_ksk:
            raise ValueError(f"ksk shape {tuple(ksk.shape)}, want {want_ksk}")
        self.register_buffer("ksk_planes", ksk_to_byte_planes(ksk.to(device)))

    @span("cycle.cmux")
    def select(self, ggsw) -> torch.Tensor:
        """CMux of (0, q/2 in every coefficient of b) under the GGSWs
        (column b under GGSW b, read in place by `freq_mad_batched`),
        then sample extraction: L1 LWE int64 [k*N+1, B]."""
        p = self.params
        glwe = p.l1_params
        shape = (glwe.size + 1, glwe.degree, ggsw[0].shape[-1])
        m0 = torch.zeros(shape, dtype=torch.int64, device=ggsw[0].device)
        m1 = m0.clone()
        m1[-1] = torus.encode_const(1, 1)
        return sample_extract(cmux(m0, m1, ggsw, p.cbs_radix), 0, glwe)

    @span("cycle.keyswitch")
    def keyswitch(self, l1: torch.Tensor) -> torch.Tensor:
        p = self.params
        return keyswitch_lwe(l1, self.ksk_planes, p.l1_params.as_lwe_def(), p.l0_params,
                             p.ks_radix)

    def bootstrap(self, ct: torch.Tensor):
        """LWE int64 [n0+1, B] -> the GGSW spectra of `circuit_bootstrap`."""
        return circuit_bootstrap(ct, spectra(self, "bsk"), spectra(self, "ak"),
                                 spectra(self, "ssk"), self.params, self.phase_rot)

    def forward(self, ct: torch.Tensor) -> torch.Tensor:
        return self.keyswitch(self.select(self.bootstrap(ct)))
