"""Empirical noise measurement for FHE ops (u64 API).

Port of `spf_tpu/utils/noise.py` (≙ reference `parasol_runtime/examples/
op_noise`: measures the noise distribution of encryption, keyswitching,
CMux (vs. tree depth), circuit bootstrapping, and scheme switching; used
to validate parameter sets and the noise-vs-depth model
`params.rs:103-106`).

Noise is measured at decrypt level: encrypt a known message, apply the
op, decrypt *without decoding*, subtract the expected torus point, and
report the signed error statistics (log2 of the std dev, in torus units
of q = 2**64).

Randomness: a `torch.Generator` takes the place of the reference's JAX
key, and `fold_in(generator, data)` of `jax.random.fold_in(key, data)`:
each trial draws from a fresh generator on the caller's generator's
device, seeded by a hash of the caller's seed (`initial_seed()`) and the
trial's number (splitmix64's finalizer of seed + (trial + 1) *
0x9E3779B97F4A7C15, `fold_in`). Like a JAX key, the caller's generator
is read and never advanced, so a measurement is reproducible from the
seed alone.

Samples are made and the ops run on the device of the caller's
generator and evaluation (the card unless the caller asks for the CPU);
trials that the reference loops over run as one batched call where the
op takes batch dims. The errors are wrapping int64 differences; the
statistics (`RunningStats`, `NoiseStats`, `fit_noise_vs_depth`,
`log2_failure_probability_binary`) are host math in f64.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from ..ops.u64 import encryption as enc
from ..ops.u64 import fft_ops
from ..ops.u64 import scheme_switch as ss
from ..ops.u64 import torus
from ..ops.u64.fft import get_backend
from ..ops.u64.poly import negacyclic_mul_exact
from ..params import Params, RadixDecomposition
from .security import probability_away_from_mean_gaussian

_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijection of u64 that spreads every input
    bit over the output."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _M64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _M64
    return x ^ (x >> 31)


_GOLDEN = 0x9E3779B97F4A7C15  # splitmix64's increment: odd, so (data + 1) * _GOLDEN != 0


def fold_in(generator: torch.Generator, data: int) -> torch.Generator:
    """A new generator on `generator`'s device for `data` (≙
    `jax.random.fold_in`): seeded by mix64(seed + (data + 1) * GOLDEN mod
    2**64), seed the caller's `initial_seed()`. The step is never 0 (GOLDEN
    is odd), so a fold is not its caller's stream even where mix64 has its
    fixed point (mix64(0) = 0: seed 0, data 0). The caller's generator is
    not advanced; nested calls fold in turn (the result's seed is its own)."""
    seed = _mix64((generator.initial_seed() + (data + 1) * _GOLDEN) & _M64)
    return torch.Generator(device=generator.device).manual_seed(seed)


class RunningStats:
    """Streaming mean/variance accumulator, Welford's algorithm
    (≙ `sunscreen_math/src/stats.rs` Stats: add_sample/mean/variance/
    std; numerically stable for the tiny relative variances noise
    measurement produces)."""

    def __init__(self):
        self.count = 0
        self._mean = 0.0
        self._m2 = 0.0

    def add_sample(self, x: float):
        self.count += 1
        delta = x - self._mean
        self._mean += delta / self.count
        self._m2 += delta * (x - self._mean)

    def mean(self) -> float:
        return self._mean

    def variance(self) -> float:
        return self._m2 / self.count if self.count else 0.0

    def std(self) -> float:
        return math.sqrt(self.variance())


@dataclasses.dataclass
class NoiseStats:
    op: str
    samples: int
    log2_std: float
    log2_max: float

    def as_dict(self):
        return dataclasses.asdict(self)


def _host_f64(errors) -> np.ndarray:
    if isinstance(errors, torch.Tensor):
        errors = errors.detach().cpu().numpy()
    return np.asarray(errors).astype(np.float64)


def _stats(op: str, errors) -> NoiseStats:
    e = _host_f64(errors)
    std = float(e.std()) or 1.0
    mx = float(np.abs(e).max()) or 1.0
    return NoiseStats(op, e.size, math.log2(std), math.log2(mx))


def _signed_err(noisy, expected_torus) -> torch.Tensor:
    """The wrapping difference noisy - expected as int64: the signed
    (centered) error, on `noisy`'s device."""
    a = torus.u64(noisy)
    return a - torus.u64(expected_torus, a.device)


def u64_mul_shift(msg, shift: int) -> torch.Tensor:
    """msg * 2^shift mod 2^64 (a wrapping left shift; 0 from shift 64 on)."""
    m = torus.u64(msg)
    return m << shift if shift < 64 else torch.zeros_like(m)


def _unit_poly(n: int, device) -> torch.Tensor:
    """The polynomial 1 = X^0 with N coefficients, int64."""
    msg = torch.zeros((n,), dtype=torch.int64, device=device)
    msg[0] = 1
    return msg


def measure_encryption_noise(generator, sk, params: Params, trials=32) -> NoiseStats:
    glwe = params.l1_params
    msg = torch.zeros((glwe.degree,), dtype=torch.int64, device=generator.device)
    cts = torch.stack([enc.encrypt_glwe(fold_in(generator, t), msg, sk.glwe_1, glwe)
                       for t in range(trials)])
    return _stats("glwe_encryption", _signed_err(enc.decrypt_glwe(cts, sk.glwe_1, glwe), 0))


def measure_cmux_noise(generator, sk, ev, params: Params, depth=8, trials=4) -> list:
    """Chain CMuxes (select=1 each level) and report noise per depth
    (the op_noise `cmux_tree` experiment); the trials run as one batch."""
    glwe = params.l1_params
    dev = ev.device
    zero = enc.trivial_glwe(torch.zeros((glwe.degree,), dtype=torch.int64, device=dev), glwe)
    one = torus.encode(torch.ones((glwe.degree,), dtype=torch.int64, device=dev), 1)
    sel = ev.be.stack([ev.enc.encrypt_ggsw_l1(fold_in(generator, 1000 + t), 1, sk, ev.be)
                       for t in range(trials)], axis=0)
    acc = torch.stack([enc.encrypt_glwe(fold_in(generator, t), one, sk.glwe_1, glwe)
                       for t in range(trials)])
    stats = []
    for d in range(depth):
        acc = fft_ops.cmux(zero, acc, sel, glwe, params.cbs_radix, ev.be)
        errs = _signed_err(enc.decrypt_glwe(acc, sk.glwe_1, glwe), one)
        stats.append(_stats(f"cmux_depth_{d + 1}", errs))
    return stats


def measure_cbs_noise(generator, sk, ev, params: Params, trials=4) -> NoiseStats:
    """Noise of a CMux whose selector came from circuit bootstrapping (the
    trials' CBS as one batched call)."""
    glwe = params.l1_params
    dev = ev.device
    one = torus.encode(torch.ones((glwe.degree,), dtype=torch.int64, device=dev), 1)
    zero = torch.zeros((glwe.degree,), dtype=torch.int64, device=dev)
    lwe_ct = torch.stack([enc.encrypt_lwe(fold_in(generator, t), torus.encode(1, 1), sk.lwe_0,
                                          params.l0_params) for t in range(trials)])
    ggsw = ev.circuit_bootstrap(lwe_ct.to(dev))
    out = fft_ops.cmux(enc.trivial_glwe(zero, glwe), enc.trivial_glwe(one, glwe), ggsw, glwe,
                       params.cbs_radix, ev.be)
    return _stats("cbs_then_cmux", _signed_err(enc.decrypt_glwe(out, sk.glwe_1, glwe), one))


def measure_keyswitch_noise(generator, sk, ev, params: Params, trials=16) -> NoiseStats:
    ct1 = torch.stack([enc.encrypt_lwe(fold_in(generator, t), torus.encode(0, 1), sk.lwe_1,
                                       params.l1_params.as_lwe_def()) for t in range(trials)])
    ct0 = ev.keyswitch_lwe_l1_to_l0(ct1.to(ev.device))
    return _stats("keyswitch_l1_l0",
                  _signed_err(enc.decrypt_lwe(ct0, sk.lwe_0, params.l0_params), 0))


# --------------------------------------------------------------------------
# Failure-probability model (≙ op_noise/math.rs + params.rs:103-106)
# --------------------------------------------------------------------------


def log2_failure_probability_binary(normalized_std: float) -> float:
    """Base-2 log of the probability that a binary-encoded message
    decodes wrongly given a normalized-torus-distance noise std
    (decode boundary at 1/4 turn; ≙ op_noise/math.rs:34
    `probability_away_from_mean_gaussian_log_binary`)."""
    return probability_away_from_mean_gaussian(0.25, normalized_std) / math.log10(2)


def fit_noise_vs_depth(depths, log2_probs):
    """Least-squares fit of the reference's depth model
    f(x) = -1/(a(x+b)) + c (≙ op_noise/cmux_tree.rs:73
    function_to_fit) to (depth, log2 failure probability) points.
    Returns (a, b, c). Linear in (a, ab) once c is fixed, so c is found
    by 1-D scan + refinement, no scipy dependency."""
    x = np.asarray(depths, dtype=np.float64)
    y = np.asarray(log2_probs, dtype=np.float64)

    def solve_given_c(c):
        # 1/(c - f) = a*x + a*b
        denom = c - y
        if np.any(denom <= 0):
            return None, np.inf
        z = 1.0 / denom
        A = np.stack([x, np.ones_like(x)], axis=1)
        coef, *_ = np.linalg.lstsq(A, z, rcond=None)
        a, ab = coef
        if a <= 0:
            return None, np.inf
        resid = -1.0 / (a * x + ab) + c - y
        return (a, ab / a, c), float((resid**2).sum())

    best, best_err = None, np.inf
    hi = float(y.max())
    for c in np.linspace(hi + 1e-3, hi + 50.0, 400):
        fit, err = solve_given_c(c)
        if err < best_err:
            best, best_err = fit, err
    return best


# --------------------------------------------------------------------------
# CMux-tree depth experiment (≙ op_noise/cmux_tree.rs: "random select
# lines, cascaded data lines")
# --------------------------------------------------------------------------


@dataclasses.dataclass
class CMuxTreeLevel:
    depth: int
    log2_std: float  # of the normalized torus distance
    log2_failure_probability: float
    samples: int

    def as_dict(self):
        return dataclasses.asdict(self)


def measure_cmux_tree_noise(generator, glwe_sk, glwe, cbs_radix, be, depth=16,
                            trials=2) -> list:
    """Cascade CMuxes with fresh random select lines and measure the
    per-level noise (≙ cmux_tree.rs `RandomSelectLinesCascadedDataLines`:
    at every level two fresh GGSWs, a random bit and its complement,
    select between the two data lines carried from the previous level).

    Noise is taken as the normalized torus distance of every decrypted
    coefficient from its expected binary encoding (the reference routes
    through a keyswitch to L0 first; measuring the GLWE directly isolates
    the CMux accumulation itself). Only GLWE material is needed, no
    bootstrap keys. The select bits come from numpy's generator seeded
    1234, as the reference's; everything else from `generator`'s device.
    Returns one `CMuxTreeLevel` per depth; feed `log2_failure_probability`
    to `fit_noise_vs_depth` to reproduce the `params.noise_exponent_at_depth`
    model."""
    be = get_backend(be)
    rng = np.random.default_rng(1234)
    dev = generator.device
    per_level_err: list[list] = [[] for _ in range(depth)]

    def encoded(v):
        return torus.encode(torch.full((glwe.degree,), v, dtype=torch.int64, device=dev), 1)

    for t in range(trials):
        kt = fold_in(generator, t)
        vals = [0, 1]  # plaintext bits carried by the two data lines
        lines = [enc.encrypt_glwe(fold_in(kt, 10_000 + i), encoded(v), glwe_sk, glwe)
                 for i, v in enumerate(vals)]
        for d in range(depth):
            b = int(rng.integers(0, 2))
            sels = [be.fwd_torus(enc.encrypt_ggsw_scalar(fold_in(kt, 2 * d + 100 + i), bit,
                                                         glwe_sk, glwe, cbs_radix))
                    for i, bit in enumerate((b, 1 - b))]
            new_lines, new_vals = [], []
            for s, bit in zip(sels, (b, 1 - b)):
                new_lines.append(fft_ops.cmux(lines[0], lines[1], s, glwe, cbs_radix, be))
                new_vals.append(vals[bit])
            lines, vals = new_lines, new_vals
            for line, v in zip(lines, vals):
                per_level_err[d].append(
                    _signed_err(enc.decrypt_glwe(line, glwe_sk, glwe), encoded(v)))
    out = []
    for d in range(depth):
        e = _host_f64(torch.cat(per_level_err[d])) / 2.0**64
        std = float(e.std()) or 2.0**-64
        out.append(CMuxTreeLevel(depth=d + 1, log2_std=math.log2(std),
                                 log2_failure_probability=log2_failure_probability_binary(std),
                                 samples=e.size))
    return out


# --------------------------------------------------------------------------
# Scheme-switch parameter search (≙ op_noise/scheme_switch.rs)
# --------------------------------------------------------------------------


def measure_noise_ggsw(ggsw, glwe_sk, glwe, cbs_radix) -> np.ndarray:
    """Normalized torus distance of the most noise-sensitive GGSW row:
    the last (finest-gadget) GLWE of the GLEV encrypting -s_0 (*) m, whose
    plaintext needs the full radix_log*count bits (≙ op_noise/noise.rs:69
    measure_noise_ggsw). The GGSW is assumed to encrypt m = 1·X^0. The
    error is exact wrapping int64 arithmetic (the port's exact negacyclic
    product); the result is host f64."""
    ggsw = torus.u64(ggsw)
    shift = 64 - cbs_radix.radix_log * cbs_radix.count
    msg = _unit_poly(glwe.degree, ggsw.device)
    expected = u64_mul_shift(-negacyclic_mul_exact(msg, glwe_sk[0].to(ggsw.device)), shift)
    noisy = enc.decrypt_glwe(ggsw[0, cbs_radix.count - 1], glwe_sk, glwe)
    return _host_f64(_signed_err(noisy, expected)) / 2.0**64


def search_scheme_switch(generator, glwe_sk, glwe, cbs_radix, radix_logs, counts, trials=2,
                         max_decomp=64, be=None) -> list:
    """Grid-search scheme-switch radix parameters, measuring output GGSW
    noise per candidate (≙ op_noise/scheme_switch.rs:48-105
    search_scheme_switch). Returns one dict per (radix_log, count) with
    the input GLEV and output GGSW noise stds (log2, normalized torus)
    and wall time (the device synchronised); candidates whose total
    decomposition exceeds `max_decomp` bits are skipped like the
    reference's min/max_decomp window."""
    be = get_backend(be or "c128")
    dev = generator.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    results = []
    msg = _unit_poly(glwe.degree, dev)
    for count in counts:
        for radix_log in radix_logs:
            if radix_log * count > max_decomp:
                continue
            ss_radix = RadixDecomposition(count=count, radix_log=radix_log)
            kc = fold_in(generator, 1000 * count + radix_log)
            ssk_fft = ss.generate_scheme_switch_key(kc, glwe_sk, glwe, ss_radix, be)
            in_errs, out_errs = [], []
            sync()
            t0 = time.perf_counter()
            for t in range(trials):
                glev = enc.encrypt_glev(fold_in(kc, 7 + t), msg, glwe_sk, glwe, cbs_radix)
                shift = 64 - cbs_radix.radix_log * cbs_radix.count
                expected_in = u64_mul_shift(msg, shift)
                in_errs.append(_host_f64(_signed_err(
                    enc.decrypt_glwe(glev[cbs_radix.count - 1], glwe_sk, glwe), expected_in))
                    / 2.0**64)
                ggsw_fft = fft_ops.scheme_switch_fft(glev, ssk_fft, glwe, cbs_radix, ss_radix, be)
                ggsw = be.inv(ggsw_fft)
                out_errs.append(measure_noise_ggsw(ggsw, glwe_sk, glwe, cbs_radix))
            sync()
            elapsed = time.perf_counter() - t0
            in_std = float(np.concatenate(in_errs).std()) or 2.0**-64
            out_std = float(np.concatenate(out_errs).std()) or 2.0**-64
            results.append({
                "ss_radix_log": radix_log,
                "ss_radix_count": count,
                "log2_in_std": math.log2(in_std),
                "log2_out_std": math.log2(out_std),
                "time_s": elapsed,
            })
    return results
