#!/usr/bin/env python3
"""Drive the PyTorch port (spf_tpu_torch) through its main path on one
CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

1. card: name and power limit (nvidia-smi), PyTorch and CUDA versions,
   SM count and maximum SM clock (the chains' and the roll's bounds are
   the card's peak rates for their instructions at that clock,
   `spf_tpu_torch.scripts.steps_per_clock`);
2. build: every CUDA kernel from csrc/, one nvcc each, all in parallel;
   each source's registers and spills, and the opcodes of each chain
   probe kernel, the MAD and the R = 8 FFT kernels (cuobjdump -sass);
3. each kernel against its plain PyTorch version on the card, at the
   DEFAULT_128 shapes of the paths below (bit for bit; the rotation
   kernels also at B = 64 and at every N of ROT_NS with every B of ROT_BS,
   P of ROT_PS, t at its edges (0, 1, N - 1, N, 2N - 1, 2N, negative,
   > 2^40) and random; the MADs with random phase factor halves,
   Klo = Khi = 32, and each per-plane instance, g = 0-3, at k + 1 = 3, 4
   and 6, N = 256, B = 129 and 8; `fence` also on odd lengths at each offset
   within 16 bytes and below one vector; `fwd_ds` and `inv_ds` also at
   every K of FFT_KS with ragged B and P up to 8, and timed at each P the
   paths give them, beside torch.fft.fft of complex128 [P, K, B] as a
   yardstick of the card), with both timed (device time:
   the kernel queued behind a spin kernel, rotating through copies of its
   inputs that exceed the L2 cache; a plain version of thousands of
   launches summed by torch.profiler). Also the kernels of the probes:
   `phase_minus_one` at K = 1024 (B = 256 and 8, bit-reversed and natural
   order, t at its edges and beyond 2N), every `chain` body, both
   `fma_probe` entry points (against zeros and against the exact f64
   error) and `roll`, at the probe scripts' shapes;
4. small runs on the card (kernels) and on the CPU (plain versions),
   bit-identical outputs: a multi-bit PBS (N = 256, n0 = 32, g = 3,
   B = 8), the single-bit PBS in its three forms (N = 256, n0 = 16) and
   the conversion cycle with a multi-bit (g = 2) and a single-bit key
   (N = 256, n0 = 8); then, as one path with the launch counts read
   around it, the multi-bit PBS (g = 3 and 2) and the single-bit PBS in
   its three forms at k + 1 = 3, 4 and 6 (N = 256, n0 = 16, B = 8), every
   MAD on its per-plane instances;
5. path 1, the multi-bit PBS at DEFAULT_128, g = 3, batch 256: keygen on
   the card, the key conversion through the FFT kernel, one
   `MultibitBootstrap` call with every kernel's launch count read around
   it, decryption on the host (256/256 correct, noise margin >= 8 bits),
   then the median PBS/s of 5 calls (information only) and one profiled
   call: its device time, by kernel, its share of the wall time, and the
   device time and launches of PyTorch's kernels in it (the glue: fewer
   than 10 launches a group step, or the phase combine still runs);
6. path 2, the single-bit PBS (`Bootstrap`) at DEFAULT_128, batch 256, in
   each of its forms (plain, fuse_rot, phase_rot), read as phase 5
   (3 timed calls each);
7. path 3, the conversion cycle (`ConversionCycle`: CBS with the
   multi-bit rotation at g = 2, radix 4x8, CMux, sample extract, LWE
   keyswitch) at DEFAULT_128, batch 256: keygen on the card, one cycle
   with the launch counts read around it, decryption (256/256 correct,
   noise margin >= 2 bits; the TPU's run of the same arithmetic recorded
   3.1), 3 timed cycles and one profiled, then each stage of the cycle
   run alone (wall and device time);
8. the probes, as one path with the launch counts read around it: the
   entry points `spf_tpu_torch.scripts.step_microbench`, `gap_probe2` and
   `vpu_probe` through their main() (their lines are printed as they
   come): exactly ITERS launches of `phase_minus_one` in each pm1
   component, the gap probe's three variants bit-identical, `fma_probe`
   0 everywhere and its fused entry point the exact error everywhere, no
   chain nor the roll above the card's peak rate for its instructions (a
   rate above it means the compiler folded the work).

Then one {"kernels": [...]} line (per kernel: route, source, the TPU
kernel it replaces, launches on the paths (summed, and by path), error
against the plain version, kernel / plain / library / bound times; the
probes' `opaque_materialize` is the fence kernel's row) and,
last, one {"ok": true, "device": {...}} line. A bound is the larger of the
bytes over the HBM rate and the instructions of the cheapest form with the
same bits over the card's issue rate for them (f32: 128 a clock per SM at
the maximum SM clock). Any failure raises and the script exits non-zero; without a CUDA device it exits 1 and prints no
result.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from spf_tpu_torch.scripts import (card, chain_peak_per_s, device_ms, emit, profiled_device_ms,
                                   profiled_kernels)

SEED = 20260416
BITS = 3  # message bits of the LUT, as bench.py
GROUP = 3
GROUP_CBS = 2  # bench.py's DEFAULT_MB_GROUP_CBS
BATCH = 256
MIN_MARGIN_BITS = 8.0
MIN_CYCLE_MARGIN_BITS = 2.0
TPU_CYCLE_MARGIN_BITS = 3.1  # BENCH_SUITE.json cbs_cycle: a correctness reference only
FORMS = {"plain": (False, False), "fuse_rot": (True, False), "phase_rot": (False, True)}

# NVIDIA H100 SXM data sheet: HBM3 rate and L2 size; roofline bounds are
# stated against the rate
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20

# f32 instructions of the ds32 primitives (ops/ds.py) in the cheapest form
# that gives the same bits: TwoProd as p = a*b, e = fma(a, b, -p), one
# instruction each, a negation folded into its add (0). add 11, sub 11,
# mul 9; complex: cadd 22, csub 22, cmul 58; the phase combine (cmul, then
# -1 on the real part) 69. Operation bounds divide instructions by the
# card's f32 issue rate, 128 a clock per SM (`chain_peak_per_s(1, {"fma": 1},
# hw)`): each FADD / FMUL / FFMA yields one result per lane and clock.
CADD, CSUB, CMUL, DS_ADD = 22, 22, 58, 11
COMBINE = CMUL + DS_ADD
# the port's kernels (csrc/*.cu) by name; every other kernel in a profile
# is PyTorch's: the glue around them
PORT_KERNELS = ("accumulate_decompose_kernel", "rotate_sub_decompose_kernel", "fwd_ds_kernel",
                "inv_ds_kernel", "mad_horner_kernel", "mad_plane_kernel", "copy_kernel",
                "phase_kernel", "chain_kernel",
                "fma_probe_kernel", "fma_probe_fma_kernel", "roll_kernel")


def clone_args(args):
    if isinstance(args, torch.Tensor):
        return args.clone()
    if isinstance(args, (tuple, list)):
        return type(args)(clone_args(a) for a in args)
    return args


def cold_copies(args, nbytes: int) -> list:
    """`args` and enough copies of it that a call comes back to the same
    copy only after more than twice the L2 cache of other traffic."""
    n = -(-2 * L2_BYTES // nbytes) + 1
    return [args] + [clone_args(args) for _ in range(n - 1)]


def bound_ms(nbytes: float, ops: float, ops_per_s: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.dtype == torch.int64:  # torus: the wrapped difference
        return float((a - b).abs().max().item())
    return float((a.double() - b.double()).abs().max().item())


def compare(name, got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    exact = all(same_bits(g, w) for g, w in zip(got, want))
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    return exact, err


def mad_fns(group: int):
    """(the wrapper, its plain version) of mad.cu's g-instance: freq_mad at
    g = 0, else mad_horner with the step's phase factor halves."""
    from spf_tpu_torch.ops import mad

    if group == 0:
        return mad.freq_mad, mad.freq_mad_plain

    def kernel(d, r, h):
        return mad.mad_horner(d, r, h, group)

    def plain(d, r, h):
        return mad.mad_horner_combine_plain(d, r, h, group)

    return kernel, plain


def mad_bytes(group: int, kp1: int, l: int, k: int, b: int, k_halves: int) -> int:
    """Bytes a MAD call moves: the digit spectra, the key rows, the phase
    factor halves (Klo + Khi bins a bit) and the output, 4 f32 planes each."""
    ns = max(1, (1 << group) - 1)
    return 4 * 4 * (l * kp1 * k * b + ns * kp1 * l * kp1 * k + group * k_halves * b + kp1 * k * b)


def mad_ops(group: int, kp1: int, l: int, k: int, b: int) -> int:
    """f32 instructions of a MAD call in the cheapest form with the same bits:
    the subset MADs, the Horner sum and the g (phase - 1) combines."""
    ns = max(1, (1 << group) - 1)
    horner = kp1 * (ns * CMUL + (ns - 1) * CADD) + group * COMBINE if group else 0
    return k * b * (ns * kp1 * l * kp1 * (CMUL + CADD) + horner)


def phase_kernels(gen, hw):
    """Each kernel against its plain version at the main paths' shapes."""
    from spf_tpu_torch.ops import encryption, fft, phase_rot, rot_decomp
    from spf_tpu_torch.ops.multibit import n_groups
    from spf_tpu_torch.params import DEFAULT_128

    dev = "cuda"
    glwe, radix = DEFAULT_128.l1_params, DEFAULT_128.pbs_radix
    n, k, b = glwe.degree, glwe.degree // 2, BATCH
    kp1, l = glwe.size + 1, radix.count
    l_cbs = DEFAULT_128.cbs_pbs_radix.count
    logk = k.bit_length() - 1

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def ds_planes(*shape, exp=40):
        hi = randn(*shape, scale=2.0**exp)
        return hi, hi * randn(*shape, scale=2.0**-25)

    def spectrum(*shape, exp):
        return (*ds_planes(*shape, exp=exp), *ds_planes(*shape, exp=exp))

    # accumulate_decompose: acc [k+1, N, B], inverse-FFT output over many
    # magnitudes (the reduction mod 2^64 and the i32 clamps included)
    acc = encryption.uniform_torus((kp1, n, b), gen)
    exps = torch.randint(0, 86, (kp1, n, b), generator=gen, device=dev).float()
    ph = randn(kp1, n, b) * torch.exp2(exps)
    pl = randn(kp1, n, b) * torch.exp2((exps - 26).clamp(min=0))
    ph.view(-1)[:4] = torch.tensor([2.0**31, -(2.0**31), 2.0**63, 2.0**84], device=dev)
    e = kp1 * n * b
    t = rotation_t(gen, n, b)

    # fwd_ds: the signed digits [l, k+1, N, B] and a zero lo plane
    digits = torch.randint(-(1 << 15), 1 << 15, (l, kp1, n, b), generator=gen, device=dev).float()
    zeros = torch.zeros_like(digits)
    # inv_ds: a product spectrum [k+1, K, B]
    prod_f = spectrum(kp1, k, b, exp=70)
    # the MADs: digit spectra [l, k+1, K, B] (l = 4 for the CBS rotation),
    # key rows, the per-bit phase factors
    dfft = fft.fwd_ds(digits, zeros)
    digits_cbs = torch.randint(-(1 << 7), 1 << 7, (l_cbs, kp1, n, b), generator=gen, device=dev).float()
    dfft_cbs = fft.fwd_ds(digits_cbs, torch.zeros_like(digits_cbs))
    # fence: one of the hoisted factor planes [n_groups, g, Klo, B]; also an
    # odd length at each offset within 16 bytes, and a length below one vector
    factors = randn(n_groups(DEFAULT_128.l0_params.dim, GROUP), GROUP, 1 << (logk // 2), b)
    flat = factors.view(-1)
    fence_extra = [(flat[1:],), (flat[2:-1],), (flat[3:],), (flat[:-1],), (flat[5:7],)]
    # the MADs' phase factor halves: Klo = Khi = 32, as the paths make them
    klo = 1 << (logk // 2)
    khi = k // klo

    def mad_case(name, group, d):
        """mad_horner's g-instance (g = 0: freq_mad) on digit spectra d,
        with random phase factor halves for g >= 1."""
        ll = d[0].shape[0]
        ns = max(1, (1 << group) - 1)
        row_shape = (kp1, ll, kp1, k) if group == 0 else (ns, kp1, ll, kp1, k)
        row = spectrum(*row_shape, exp=60)
        kernel, plain = mad_fns(group)
        args = (d, row) if group == 0 else (
            d, row, (spectrum(group, klo, b, exp=0), spectrum(group, khi, b, exp=0)))
        return dict(
            name=name, source="spf_tpu_torch/csrc/mad.cu", replaces="spf_tpu/ops/mad_pallas.py:94",
            note=f"mad.cu's g = {group} instance" + (
                "; in place of the XLA glue freq_mad (spf_tpu/ops/bootstrap_u32.py:161)"
                if group == 0 else
                "; also forms the g per-bit (phase - 1) factors from the step's halves "
                "(Klo = Khi = 32), the combine XLA fuses on the TPU (spf_tpu/ops/multibit.py:213-245)"),
            kernel=kernel, plain=plain, args=args,
            nbytes=mad_bytes(group, kp1, ll, k, b, klo + khi), ops=mad_ops(group, kp1, ll, k, b),
        )

    def mad_any_kp1_case(group, kp1_):
        """mad.cu's per-plane g-instance at k + 1 = kp1_ (the test sets' 3 and
        4, GLWE_5_256_128's 6) at N = 256 (K = 128), B = 129; also B = 8."""
        k_, l_, klo_, khi_ = 128, 2, 16, 8
        ns = max(1, (1 << group) - 1)

        def inputs(b_):
            d = spectrum(l_, kp1_, k_, b_, exp=20)
            row = spectrum(*((kp1_, l_, kp1_, k_) if group == 0 else (ns, kp1_, l_, kp1_, k_)),
                           exp=60)
            return (d, row) if group == 0 else (
                d, row, (spectrum(group, klo_, b_, exp=0), spectrum(group, khi_, b_, exp=0)))

        kernel, plain = mad_fns(group)
        return dict(
            name=f"mad_any_kp1_g{group} k+1={kp1_}", row=f"mad_any_kp1_g{group}",
            source="spf_tpu_torch/csrc/mad.cu", replaces="spf_tpu/ops/mad_pallas.py:94",
            note=f"mad.cu's per-plane g = {group} instance (k + 1 a runtime loop bound, one output "
                 "plane a block); parts: k + 1 = 3, 4, 6 at [l = 2, k + 1, K = 128, B = 129], "
                 "also held bit for bit at B = 8",
            kernel=kernel, plain=plain, args=inputs(129), extra_args=[inputs(8)],
            plain_copies=1,  # thousands of small launches: one copy times them
            nbytes=mad_bytes(group, kp1_, l_, k_, 129, klo_ + khi_),
            ops=mad_ops(group, kp1_, l_, k_, 129),
        )

    def rotation_case(fused, cols, **extra):
        """A rotation kernel on the first `cols` columns (the paths' B = 256,
        and 64, a small wave's batch): one part of the kernel's row."""
        kernel_name = "rotate_sub_decompose_acc" if fused else "rotate_sub_decompose"
        acc_, t_ = acc[..., :cols].contiguous(), t[:cols].contiguous()
        if fused:
            prod_ = (ph[..., :cols].contiguous(), pl[..., :cols].contiguous())
            kernel = lambda a, p, tt: rot_decomp.rotate_sub_decompose_acc(a, p, tt, radix)
            plain = lambda a, p, tt: rot_decomp.rotate_sub_decompose_acc_plain(a, p, tt, radix)
            args = (acc_, prod_, t_)
        else:
            kernel = lambda a, tt: rot_decomp.rotate_sub_decompose(a, tt, radix)
            plain = lambda a, tt: rot_decomp.rotate_sub_decompose_plain(a, tt, radix)
            args = (acc_, t_)
        return dict(
            name=f"{kernel_name} B={cols}", row=kernel_name,
            source="spf_tpu_torch/csrc/rot_decomp.cu",
            replaces="spf_tpu/ops/rot_decomp_pallas.py:98" if fused
            else "spf_tpu/ops/rot_decomp_pallas.py:182",
            kernel=kernel, plain=plain, args=args,
            # acc (+ ph, pl) read once, the digits (+ acc') written once
            nbytes=acc_.numel() * (8 + (16 if fused else 0) + 4 * l) + 8 * cols,
            ops=acc_.numel() * 18 if fused else 0,  # from_ds once an element; the rest integer
            note=f"parts: [{kp1}, {n}, B] at B = {b} and 64; extra shapes held bit for bit: "
                 f"N {ROT_NS} x B {ROT_BS}, P {ROT_PS}, t at its edges and random",
            **extra)

    rotation_cases = [case for fused in (False, True) for case in (
        rotation_case(fused, b, extra_args=rotation_extra(gen, fused)),
        rotation_case(fused, 64))]

    cases = [
        dict(
            name="accumulate_decompose",
            source="spf_tpu_torch/csrc/rot_decomp.cu",
            replaces="spf_tpu/ops/rot_decomp_pallas.py:147",
            kernel=lambda a, p: rot_decomp.accumulate_decompose(a, p, radix),
            plain=lambda a, p: rot_decomp.accumulate_decompose_plain(a, p, radix),
            args=(acc, (ph, pl)),
            nbytes=e * (8 + 4 + 4 + 8 + 4 * l),
            ops=e * 18,  # the f32 work of from_ds; the rest is integer
        ),
        *rotation_cases,
        *fft_cases(gen, (digits, zeros), prod_f, digits_cbs),
        mad_case("mad_horner", GROUP, dfft),
        mad_case("mad_horner_g2", GROUP_CBS, dfft_cbs),
        mad_case("mad_horner_g1", 1, dfft),
        mad_case("freq_mad", 0, dfft),
        *(mad_any_kp1_case(g, kp) for g in (3, 2, 1, 0) for kp in (3, 4, 6)),
        dict(
            name="fence",
            source="spf_tpu_torch/csrc/fence.cu",
            replaces="spf_tpu/ops/phase_rot.py:242",
            kernel=phase_rot.fence,
            plain=phase_rot.fence_plain,
            plain_is_one_launch=True,  # clone: timed as the kernel is
            library=lambda x: x.clone(),
            args=(factors,),
            extra_args=fence_extra,
            nbytes=2 * 4 * factors.numel(),
            ops=0,
        ),
    ]
    cases += phase_and_probe_cases(gen, hw)
    f32_per_s = chain_peak_per_s(1, {"fma": 1}, hw)  # one f32 instruction a lane and clock
    for c in cases:
        c.setdefault("ops_per_s", f32_per_s)
    return merge_rows(cases, [measure(c) for c in cases])


ROT_NS = (64, 1024, 2048)
ROT_BS = (1, 3, 8, 64, 129, 256)
ROT_PS = (1, 2, 3)


def rotation_t(gen, n: int, b: int) -> torch.Tensor:
    """A monomial exponent a column: random of either sign and beyond 2^40,
    the edges 0, 1, N - 1, N, 2N - 1, 2N, negative ones and ones > 2^40 in
    the first columns."""
    t = torch.randint(-(1 << 41), 1 << 41, (b,), generator=gen, device="cuda")
    edges = [0, 1, n - 1, n, 2 * n - 1, 2 * n, -1, -n, -(2 * n) - 3, (1 << 40) + 7,
             -(1 << 40) - 5, 3 * n + 5]
    t[:min(b, len(edges))] = torch.tensor(edges[:b], device="cuda")
    return t


def rotation_extra(gen, fused: bool):
    """The rotation kernels' extra shapes: every N of ROT_NS with every B of
    ROT_BS, P cycling through ROT_PS; the products over many magnitudes."""
    from spf_tpu_torch.ops import encryption

    for i, (n, b) in enumerate((n, b) for n in ROT_NS for b in ROT_BS):
        p = ROT_PS[i % len(ROT_PS)]
        acc = encryption.uniform_torus((p, n, b), gen)
        t = rotation_t(gen, n, b)
        if not fused:
            yield acc, t
            continue
        exps = torch.randint(0, 86, (p, n, b), generator=gen, device="cuda").float()
        ph = torch.randn((p, n, b), generator=gen, device="cuda") * torch.exp2(exps)
        pl = torch.randn((p, n, b), generator=gen, device="cuda") * torch.exp2((exps - 26).clamp(min=0))
        yield acc, (ph, pl), t


FFT_KS = (2, 4, 32, 1024, 2048)
FFT_BS = (1, 3, 8, 129, 256, 1024)
FFT_PS = (1, 2, 4, 8)
YARDSTICK = "c128 cuFFT, same size, not the same bits"


def fft_ops(p: int, k: int, b: int) -> int:
    """f32 instructions of one ds32 FFT call: the twist (or untwist), then
    log2(K) stages of K/2 butterflies (a complex add, subtract, multiply)."""
    return p * b * (CMUL * k + (CADD + CSUB + CMUL) * (k // 2) * (k.bit_length() - 1))


def fft_cases(gen, fwd_args, prod_f, digits_cbs) -> list:
    """fwd_ds and inv_ds, each one row whose `parts` are the shapes the
    paths time it at: fwd_ds at P = l(k+1) = 4 (the PBS) and 8 (the CBS
    rotation, l = 4), inv_ds at P = k+1 = 2 and 4; each beside a yardstick,
    torch.fft.fft over the same [P, K, B] in complex128 (cuFFT: the same
    size, not the same bits). The first part is also held bit for bit at
    every K of FFT_KS, each with every B of FFT_BS and a P of FFT_PS: the
    forward on signed digits with a zero lo plane and on torus values with
    a real lo plane (the key conversion's), the inverse on spectra of
    magnitude 2^70."""
    from spf_tpu_torch.ops import encryption, fft, torus

    dev = "cuda"

    def spectrum(*shape, exp=70):
        out = []
        for _ in range(2):
            hi = torch.randn(shape, generator=gen, device=dev) * 2.0**exp
            out += [hi, hi * torch.randn(shape, generator=gen, device=dev) * 2.0**-25]
        return tuple(out)

    def shapes():
        for k in FFT_KS:
            for i, b in enumerate(FFT_BS):
                yield k, b, FFT_PS[(i + FFT_KS.index(k)) % len(FFT_PS)]

    def fwd_extra():
        for k, b, p in shapes():
            digits = torch.randint(-(1 << 15), 1 << 15, (p, 2 * k, b), generator=gen,
                                   device=dev).float()
            yield digits, torch.zeros_like(digits)
            yield torus.to_ds(encryption.uniform_torus((p, 2 * k, b), gen))

    def inv_extra():
        for k, b, p in shapes():
            yield (spectrum(p, k, b),)

    def yardstick(p, k, b):
        z = torch.randn((p, k, b), generator=gen, device=dev, dtype=torch.complex128)
        return dict(yardstick=lambda x: torch.fft.fft(x, dim=-2), yardstick_args=(z,))

    def case(inverse, args, p, k, b, **extra):
        n = 2 * k
        return dict(
            name=f"{'inv' if inverse else 'fwd'}_ds P={p}", row="inv_ds" if inverse else "fwd_ds",
            source="spf_tpu_torch/csrc/fft.cu",
            replaces="spf_tpu/ops/fft_pallas.py:294" if inverse else "spf_tpu/ops/fft_pallas.py:258",
            kernel=fft.inv_ds if inverse else fft.fwd_ds,
            plain=fft.inv_ds_plain if inverse else fft.fwd_ds_plain,
            args=args, nbytes=p * b * (2 * n * 4 + 4 * k * 4), ops=fft_ops(p, k, b),
            note=f"parts: the paths' P; extra shapes held bit for bit: K {FFT_KS}, B {FFT_BS}, "
                 f"P {FFT_PS}; yardstick_ms: {YARDSTICK}",
            **yardstick(p, k, b), **extra)

    digits, zeros = fwd_args
    kp1, k, b = prod_f[0].shape
    p_fwd = digits.shape[0] * digits.shape[1]
    return [
        case(False, fwd_args, p_fwd, k, b, extra_args=fwd_extra()),
        case(False, (digits_cbs, torch.zeros_like(digits_cbs)),
             digits_cbs.shape[0] * digits_cbs.shape[1], k, b),
        case(True, (prod_f,), kp1, k, b, extra_args=inv_extra()),
        case(True, (spectrum(2 * kp1, k, b),), 2 * kp1, k, b),
    ]


def phase_and_probe_cases(gen, hw) -> list:
    """The in-loop phase generator at K = 1024 (B = 256 and 8, bit-reversed
    and natural order, t at its edges and beyond 2N) and the probe kernels
    at the probe script's shapes (every chain body, both fma_probe entry
    points, roll). The chains and the roll are bounded by the card's peak
    rate for the instructions of their step (`card()`'s `hw`)."""
    from spf_tpu_torch.ops import phase_rot
    from spf_tpu_torch.params import DEFAULT_128
    from spf_tpu_torch.scripts import vpu_probe

    dev = "cuda"
    n = DEFAULT_128.l1_params.degree
    k = n // 2
    perm = phase_rot.scrambled_perm(k)

    def exponents(b):
        t = torch.randint(0, 2 * n, (b,), generator=gen, device=dev)
        edges = [0, 1, n - 1, n, 2 * n - 1, 2 * n, 3 * n + 5, (1 << 32) - 1][:b]
        t[:len(edges)] = torch.tensor(edges, device=dev)
        return t

    t_b, t_8 = exponents(BATCH), exponents(8)
    cases = [dict(
        name="phase_minus_one", source="spf_tpu_torch/csrc/phase.cu",
        replaces="spf_tpu/ops/phase_rot.py:147",
        note="timed at K = 1024, B = 256 with perm = scrambled_perm(K), as step_microbench "
             "calls it; also held bit for bit in natural order and at B = 8",
        kernel=phase_rot.phase_minus_one, plain=phase_rot.phase_minus_one_plain,
        args=(t_b, n, perm), extra_args=[(t_b, n, None), (t_8, n, perm), (t_8, n, None)],
        nbytes=4 * 4 * k * BATCH + 8 * BATCH + 4 * 4 * 2 * n + 4 * k,
        ops=BATCH * ((k - 1) * CMUL + k * DS_ADD),  # the doubling, then -1 on the real part
    )]
    x = vpu_probe.inputs(dev)
    elems = vpu_probe.R * vpu_probe.C
    for body, (_, ops, mix) in vpu_probe.BODIES.items():
        f32 = body in vpu_probe.F32_BODIES
        cases.append(dict(
            name=body, row="chain", source="spf_tpu_torch/csrc/probe.cu",
            replaces="scripts/vpu_probe.py:44",
            note="timed: the f32 mul chain; `parts`: every body, [1024, 512], 400 steps",
            kernel=lambda v, body=body: vpu_probe.chain(v, body),
            plain=lambda v, body=body: vpu_probe.chain_plain(v, body),
            args=(x["f32"] if f32 else x["i32"],), plain_copies=1,
            nbytes=2 * 4 * elems, ops=elems * vpu_probe.ITERS * ops,
            ops_per_s=chain_peak_per_s(ops, mix, hw),
        ))
    fma = dict(source="spf_tpu_torch/csrc/probe.cu", replaces="scripts/vpu_probe.py:94",
               row="fma_probe", args=(x["a"], x["b"]), nbytes=3 * 4 * elems, ops=3 * elems,
               note="timed: a*b - p as written (0 everywhere); `parts`: also the "
                    "__fmaf_rn(a, b, -p) entry point, held against the exact f64 error")
    cases.append(dict(fma, name="fma_probe", kernel=vpu_probe.fma_probe,
                      plain=vpu_probe.fma_probe_plain))
    cases.append(dict(fma, name="fma_probe_fma", kernel=vpu_probe.fma_probe_fma,
                      plain=vpu_probe.fma_probe_fma_plain))
    cases.append(dict(
        name="roll", source="spf_tpu_torch/csrc/probe.cu", replaces="scripts/vpu_probe.py:178",
        note="[1024, 512], 400 steps of roll(v, 8, axis=0) + 1.0; bounded by its adds",
        kernel=vpu_probe.roll, plain=vpu_probe.roll_plain, args=(x["roll"],), plain_copies=1,
        nbytes=2 * 4 * elems, ops=elems * vpu_probe.ITERS,
        ops_per_s=chain_peak_per_s(1, vpu_probe.ROLL_MIX, hw),
    ))
    return cases


def merge_rows(cases, results) -> list:
    """One row per kernel: the cases that share a `row` (the chain bodies,
    the two fma_probe entry points) become one row with the numbers of its
    first case and every case under `parts`."""
    rows, merged = [], {}
    for c, r in zip(cases, results):
        name = c.get("row")
        if name is None:
            rows.append(r)
            continue
        if name not in merged:
            merged[name] = dict(r, name=name, parts={})
            rows.append(merged[name])
        m = merged[name]
        m["parts"][r["name"]] = {key: r[key] for key in (
            "bitexact", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "share",
            "host_us_per_call", "yardstick_ms") if key in r}
        m["bitexact"] = m["bitexact"] and r["bitexact"]
        m["max_abs_err"] = max(m["max_abs_err"], r["max_abs_err"])
    return rows


def measure(c) -> dict:
    """Run one case's kernel and plain version on the same inputs (bit for
    bit, also on `c["extra_args"]`), time both, and give the row of the
    kernels line."""
    t0 = time.perf_counter()
    args = c["args"]
    got = c["kernel"](*args)
    want = c["plain"](*args)
    torch.cuda.synchronize()
    exact, err = compare(c["name"], got, want)
    for extra in c.get("extra_args", ()):
        e_exact, e_err = compare(c["name"], c["kernel"](*extra), c["plain"](*extra))
        exact, err = exact and e_exact, max(err, e_err)
    del got, want
    copies = cold_copies(args, c["nbytes"])
    kernel_ms, host_us = device_ms(c["kernel"], copies, 50)
    if c.get("plain_is_one_launch"):
        plain_ms = device_ms(c["plain"], copies, 50)[0]
    else:  # thousands of launches: summed by the profiler
        plain_copies = copies[:c.get("plain_copies", len(copies))]
        c["plain"](*args)  # warm-up
        plain_ms = profiled_device_ms(lambda: [c["plain"](*a) for a in plain_copies])[0] \
            / len(plain_copies)
    library_ms = device_ms(c["library"], copies, 50)[0] if "library" in c else None
    del copies
    extra = {}
    if "yardstick" in c:
        z = c["yardstick_args"]
        extra = dict(yardstick=YARDSTICK, yardstick_ms=device_ms(
            c["yardstick"], cold_copies(z, z[0].numel() * z[0].element_size()), 50)[0])
    bms, by = bound_ms(c["nbytes"], c["ops"], c["ops_per_s"])
    return dict(
        name=c["name"], route="cuda", source=c["source"], replaces=c["replaces"],
        bitexact=exact, max_abs_err=err, ms=kernel_ms, kernel_ms=kernel_ms,
        plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms, bound_by=by,
        share=bms / kernel_ms, bytes=c["nbytes"], ops=c["ops"], host_us_per_call=host_us,
        note=c.get("note"), seconds=time.perf_counter() - t0, **extra,
    )


def decode(out: torch.Tensor, sk: np.ndarray, expected: np.ndarray, bits: int = BITS):
    """Decrypt LWE outputs int64 [n+1, B] under the key sk [n] on the
    host: (n_correct, noise margin in bits), as bench.py does for PBS
    outputs (bench.py:859-866) and, with bits = 1, for conversion cycles
    (bench.py:505-521)."""
    from spf_tpu_torch.ops import encryption, torus

    phase = encryption.lwe_phase_np(torus.to_u64_np(out).T, sk)
    rb = (phase >> np.uint64(64 - bits - 1)) & np.uint64(1)
    dec = ((phase >> np.uint64(64 - bits)) + rb) & np.uint64((1 << bits) - 1)
    err = (phase - (expected.astype(np.uint64) << np.uint64(64 - bits))).astype(np.int64)
    margin = 64 - bits - 1 - float(np.log2(max(float(np.abs(err).max()), 1.0)))
    return int((dec == expected).sum()), margin


def lut_fn(x):
    return (x + 1) % 8


def phase_small_pbs():
    """A small PBS on the card and on the CPU: bit-identical spectra and
    outputs (the glue between the kernels)."""
    from spf_tpu_torch.ops import encryption, torus
    from spf_tpu_torch.ops.lut import generate_lut_np
    from spf_tpu_torch.ops.multibit import MultibitBootstrap
    from spf_tpu_torch.params import GlweDef, LweDef, RadixDecomposition

    lwe = LweDef(dim=32, std=1e-16)
    glwe = GlweDef(size=1, degree=256, std=1e-16)
    radix = RadixDecomposition(count=2, radix_log=16)
    b = 8
    rng = np.random.default_rng(SEED)
    lwe_sk = rng.integers(0, 2, lwe.dim).astype(np.int64)
    glwe_sk = torch.from_numpy(rng.integers(0, 2, (glwe.size, glwe.degree)).astype(np.int64))
    bsk = encryption.generate_multibit_bsk(lwe_sk, glwe_sk, glwe, radix, GROUP,
                                           torch.Generator().manual_seed(SEED))
    lut = generate_lut_np([lut_fn], glwe, BITS)
    msgs = np.arange(b, dtype=np.uint64) % 8
    ct = encryption.encrypt_lwe_np(rng, msgs << np.uint64(64 - BITS - 1), lwe_sk, lwe)
    ct = torus.from_u64_np(ct.T.copy())

    cpu = MultibitBootstrap(bsk, lut, glwe, radix, GROUP, device="cpu")
    gpu = MultibitBootstrap(bsk, lut, glwe, radix, GROUP, device="cuda")
    spectra_exact = all(same_bits(g.cpu(), c) for g, c in zip(gpu.bsk_freq, cpu.bsk_freq))
    out_cpu = cpu(ct)
    out_gpu = gpu(ct.cuda())
    torch.cuda.synchronize()
    out_exact = torch.equal(out_gpu.cpu(), out_cpu)
    n_correct, margin = decode(out_gpu, glwe_sk.numpy().reshape(-1).astype(np.uint64), lut_fn(msgs))
    res = dict(phase="small_pbs", n=glwe.degree, n0=lwe.dim, group=GROUP, batch=b,
               spectra_bitexact=spectra_exact, output_bitexact=out_exact,
               correct=f"{n_correct}/{b}", noise_margin_bits=margin)
    emit(res)
    if not (spectra_exact and out_exact and n_correct == b):
        raise AssertionError(f"small PBS: card and CPU disagree or decrypt fails: {res}")


def small_cycle_params():
    """A conversion cycle small enough for the CPU: DEFAULT_128's radices
    at N = 256, n0 = 8, noise-free key streams."""
    from spf_tpu_torch.params import DEFAULT_128, GlweDef, LweDef

    return dataclasses.replace(DEFAULT_128, l0_params=LweDef(dim=8, std=1e-16),
                               l1_params=GlweDef(size=1, degree=256, std=1e-16))


def cycle_keys(params, lwe_sk: np.ndarray, gen, group=GROUP_CBS):
    """Every key of the conversion cycle, made from `gen` on its device:
    (glwe_sk, bsk (multi-bit at `group`, single-bit for group 1), automorphism
    keys, scheme-switch key, LWE keyswitch key)."""
    from spf_tpu_torch.ops import encryption

    glwe = params.l1_params
    glwe_sk = encryption.generate_glwe_sk(glwe, gen)
    if group == 1:
        bsk = encryption.generate_bsk(lwe_sk, glwe_sk, glwe, params.cbs_pbs_radix_eff, gen)
    else:
        bsk = encryption.generate_multibit_bsk(lwe_sk, glwe_sk, glwe, params.cbs_pbs_radix_eff,
                                               group, gen)
    ak = encryption.generate_automorphism_keys(glwe_sk, glwe, params.tr_radix, gen)
    ssk = encryption.generate_scheme_switch_key(glwe_sk, glwe, params.ss_radix, gen)
    ksk = encryption.generate_lwe_keyswitch_key(
        glwe_sk.reshape(-1), torch.from_numpy(lwe_sk).to(glwe_sk.device), params.l0_params,
        params.ks_radix, gen)
    return glwe_sk, bsk, ak, ssk, ksk


def encrypt_bits(rng, bits_in: np.ndarray, lwe_sk: np.ndarray, lwe) -> torch.Tensor:
    """L0 encryptions of bits (as bench.py --cbs: bit << 63), int64 [n0+1, B]."""
    from spf_tpu_torch.ops import encryption, torus

    cts = encryption.encrypt_lwe_np(rng, bits_in.astype(np.uint64) << np.uint64(63), lwe_sk, lwe)
    return torus.from_u64_np(cts.T.copy())


def phase_small_single_bit_and_cycle():
    """The single-bit PBS in its three forms and the conversion cycle
    (multi-bit and single-bit keys), small, on the card and on the CPU:
    bit-identical outputs."""
    from spf_tpu_torch.ops import encryption, torus
    from spf_tpu_torch.ops.bootstrap import Bootstrap
    from spf_tpu_torch.ops.cbs import ConversionCycle
    from spf_tpu_torch.ops.lut import generate_lut_np
    from spf_tpu_torch.params import GlweDef, LweDef, RadixDecomposition

    res = dict(phase="small_single_bit_and_cycle")
    ok = True
    lwe = LweDef(dim=16, std=1e-16)
    glwe = GlweDef(size=1, degree=256, std=1e-16)
    radix = RadixDecomposition(count=2, radix_log=16)
    b = 8
    rng = np.random.default_rng(SEED + 1)
    lwe_sk = rng.integers(0, 2, lwe.dim).astype(np.int64)
    gen = torch.Generator().manual_seed(SEED + 1)
    glwe_sk = encryption.generate_glwe_sk(glwe, gen)
    bsk = encryption.generate_bsk(lwe_sk, glwe_sk, glwe, radix, gen)
    lut = generate_lut_np([lut_fn], glwe, BITS)
    msgs = np.arange(b, dtype=np.uint64) % 8
    ct = torus.from_u64_np(encryption.encrypt_lwe_np(
        rng, msgs << np.uint64(64 - BITS - 1), lwe_sk, lwe).T.copy())
    sk_flat = glwe_sk.numpy().reshape(-1).astype(np.uint64)
    for form, (fuse_rot, phase_rot) in FORMS.items():
        out_cpu = Bootstrap(bsk, lut, glwe, radix, fuse_rot, phase_rot, device="cpu")(ct)
        out_gpu = Bootstrap(bsk, lut, glwe, radix, fuse_rot, phase_rot, device="cuda")(ct.cuda())
        torch.cuda.synchronize()
        exact = torch.equal(out_gpu.cpu(), out_cpu)
        n_correct, margin = decode(out_gpu, sk_flat, lut_fn(msgs))
        res[f"pbs_{form}"] = dict(output_bitexact=exact, correct=f"{n_correct}/{b}",
                                  noise_margin_bits=margin)
        ok = ok and exact and n_correct == b

    params = small_cycle_params()
    bits_in = (np.arange(b) % 2).astype(np.uint64)
    ct = encrypt_bits(rng, bits_in, lwe_sk[:params.l0_params.dim], params.l0_params)
    for group in (GROUP_CBS, 1):
        keys = cycle_keys(params, lwe_sk[:params.l0_params.dim], torch.Generator().manual_seed(group),
                          group)
        out_cpu = ConversionCycle(*keys[1:], params, phase_rot=group == 1, device="cpu")(ct)
        out_gpu = ConversionCycle(*keys[1:], params, phase_rot=group == 1, device="cuda")(ct.cuda())
        torch.cuda.synchronize()
        exact = torch.equal(out_gpu.cpu(), out_cpu)
        n_correct, margin = decode(out_gpu, lwe_sk[:params.l0_params.dim].astype(np.uint64),
                                   bits_in, bits=1)
        res[f"cycle_g{group}"] = dict(output_bitexact=exact, correct=f"{n_correct}/{b}",
                                      noise_margin_bits=margin)
        ok = ok and exact and n_correct == b
    emit(res)
    if not ok:
        raise AssertionError(f"small single-bit PBS / cycle: card and CPU disagree or decrypt fails: {res}")


WIDE_KS = (2, 3, 5)  # GLWE sizes k whose k + 1 the MAD's per-plane instances serve


def phase_wide_glwe():
    """The entry points at k + 1 = 3, 4 and 6 (N = 256, n0 = 16, B = 8, radix
    2x16): the multi-bit PBS at g = 3 and 2 and the single-bit PBS in its
    three forms, as one path with the launch counts read around it (every
    MAD launch on the per-plane instances), each output bit-identical to
    the CPU's and decrypting right."""
    from spf_tpu_torch.ops import encryption, torus
    from spf_tpu_torch.ops.bootstrap import Bootstrap
    from spf_tpu_torch.ops.lut import generate_lut_np
    from spf_tpu_torch.ops.multibit import MultibitBootstrap, n_groups
    from spf_tpu_torch.params import GlweDef, LweDef, RadixDecomposition

    lwe = LweDef(dim=16, std=1e-16)
    radix = RadixDecomposition(count=2, radix_log=16)
    b = 8
    rng = np.random.default_rng(SEED + 4)
    lwe_sk = rng.integers(0, 2, lwe.dim).astype(np.int64)
    msgs = np.arange(b, dtype=np.uint64) % 8
    ct = torus.from_u64_np(encryption.encrypt_lwe_np(
        rng, msgs << np.uint64(64 - BITS - 1), lwe_sk, lwe).T.copy())
    runs = []  # (name, module on the CPU, module on the card, glwe_sk)
    for kk in WIDE_KS:
        glwe = GlweDef(size=kk, degree=256, std=1e-16)
        gen = torch.Generator().manual_seed(SEED + kk)
        glwe_sk = encryption.generate_glwe_sk(glwe, gen)
        lut = generate_lut_np([lut_fn], glwe, BITS)
        for group in (GROUP, GROUP_CBS):
            bsk = encryption.generate_multibit_bsk(lwe_sk, glwe_sk, glwe, radix, group, gen)
            runs.append((f"k+1={kk + 1} multi-bit g={group}", *(
                MultibitBootstrap(bsk, lut, glwe, radix, group, device=d) for d in ("cpu", "cuda")),
                glwe_sk))
        bsk = encryption.generate_bsk(lwe_sk, glwe_sk, glwe, radix, gen)
        for form, (fuse_rot, phase_rot) in FORMS.items():
            runs.append((f"k+1={kk + 1} single-bit {form}", *(
                Bootstrap(bsk, lut, glwe, radix, fuse_rot, phase_rot, device=d)
                for d in ("cpu", "cuda")), glwe_sk))
    steps, ks = lwe.dim, len(WIDE_KS)
    g3, g2 = n_groups(lwe.dim, GROUP), n_groups(lwe.dim, GROUP_CBS)
    want = expect_launches(
        accumulate_decompose=ks * (g3 + g2 + steps), rotate_sub_decompose=ks * steps,
        rotate_sub_decompose_acc=ks * steps, fwd_ds=ks * (g3 + g2 + 3 * steps),
        inv_ds=ks * (g3 + g2 + 3 * steps), fence=ks * 3 * 8, mad_any_kp1_g3=ks * g3,
        mad_any_kp1_g2=ks * g2, mad_any_kp1_g1=ks * steps, mad_any_kp1_g0=ks * 2 * steps)
    ct_gpu = ct.cuda()
    outs, _, launches, _ = drive(lambda: [gpu(ct_gpu) for _, _, gpu, _ in runs], want,
                                 "k + 1 = 3, 4, 6")
    res, ok = dict(phase="wide_glwe", n=256, n0=lwe.dim, batch=b), True
    for (name, cpu, _, glwe_sk), out in zip(runs, outs):
        exact = torch.equal(out.cpu(), cpu(ct))
        n_correct, margin = decode(out, glwe_sk.numpy().reshape(-1).astype(np.uint64), lut_fn(msgs))
        res[name] = dict(output_bitexact=exact, correct=f"{n_correct}/{b}",
                         noise_margin_bits=margin)
        ok = ok and exact and n_correct == b
    res["launches"] = {k: v for k, v in launches.items() if v}
    emit(res)
    if not ok:
        raise AssertionError(f"k + 1 = 3, 4, 6: card and CPU disagree or decrypt fails: {res}")
    return {"k + 1 = 3, 4, 6": launches}


def expect_launches(**counts) -> dict:
    from spf_tpu_torch import kernels

    want = {name: 0 for name in kernels.ALL}
    want.update(counts)
    return want


def drive(fn, want: dict, name: str):
    """Run fn() once with every launch count set to 0 just before and read
    just after; raise unless the counts are `want`. Returns (output,
    seconds, launches, peak device GiB)."""
    from spf_tpu_torch import kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launches()
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, want {want}")
    return out, seconds, launches, torch.cuda.max_memory_allocated() / 2**30


def wall_and_device(fn, calls: int):
    """Wall seconds of `calls` synchronised calls, and one profiled call's
    device ms, top 8 kernels by device ms, the device ms and launches of
    every kernel that is not the port's (the glue), and the device us a
    launch of each of the port's kernels in it."""
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    kernels = profiled_kernels(fn)
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    glue = [v for name, v in kernels.items() if name.split("<")[0] not in PORT_KERNELS]
    port = {name: 1e3 * ms / n for name, (ms, n) in ranked if name.split("<")[0] in PORT_KERNELS}
    return (times, sum(ms for ms, _ in kernels.values()), {n: ms for n, (ms, _) in ranked[:8]},
            dict(ms=sum(ms for ms, _ in glue), launches=sum(n for _, n in glue)), port)


def phase_main_path():
    """Path 1: DEFAULT_128, g = 3, batch 256, through the user's entry points."""
    from spf_tpu_torch.ops import encryption, torus
    from spf_tpu_torch.ops.lut import generate_lut_np
    from spf_tpu_torch.ops.multibit import MultibitBootstrap, n_groups
    from spf_tpu_torch.params import DEFAULT_128

    lwe, glwe, radix = DEFAULT_128.l0_params, DEFAULT_128.l1_params, DEFAULT_128.pbs_radix
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(20240817)
    lwe_sk = rng.integers(0, 2, lwe.dim).astype(np.int64)

    t0 = time.perf_counter()
    glwe_sk = encryption.generate_glwe_sk(glwe, gen)
    bsk = encryption.generate_multibit_bsk(lwe_sk, glwe_sk, glwe, radix, GROUP, gen)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pbs = MultibitBootstrap(bsk, generate_lut_np([lut_fn], glwe, BITS), glwe, radix, GROUP)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    del bsk

    msgs = np.arange(BATCH, dtype=np.uint64) % 8
    expected = lut_fn(msgs)
    cts = encryption.encrypt_lwe_np(rng, msgs << np.uint64(64 - BITS - 1), lwe_sk, lwe)
    ct = torus.from_u64_np(cts.T.copy(), "cuda")  # [n0+1, B]

    ng = n_groups(lwe.dim, GROUP)
    want = expect_launches(accumulate_decompose=ng, fwd_ds=ng, inv_ds=ng, mad_horner=ng, fence=8)
    out, first_s, launches, peak_gib = drive(lambda: pbs(ct), want, "path 1 (multi-bit PBS)")

    sk_flat = glwe_sk.cpu().numpy().reshape(-1).astype(np.uint64)
    n_correct, margin = decode(out, sk_flat, expected)
    times, device_call_ms, by_kernel, glue, port_us = wall_and_device(lambda: pbs(ct), 5)
    med = statistics.median(times)
    res = dict(
        phase="main_path", path="multi-bit PBS", params="DEFAULT_128", group=GROUP, batch=BATCH,
        out_shape=list(out.shape), keygen_s=keygen_s, key_conversion_s=convert_s,
        first_call_s=first_s, correct=f"{n_correct}/{BATCH}", noise_margin_bits=margin,
        launches={k: v for k, v in launches.items() if v}, pbs_call_s=times,
        pbs_per_s_median=BATCH / med, device_ms_per_call=device_call_ms,
        device_busy_share=device_call_ms / 1e3 / med, device_ms_by_kernel=by_kernel,
        glue=glue, port_kernel_us_per_launch=port_us, peak_device_mem_gib=peak_gib,
    )
    emit(res)
    if tuple(out.shape) != (glwe.size * glwe.degree + 1, BATCH):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    # the phase combine ran ~60 PyTorch operators a bit, g bits a group step;
    # the MAD kernel forms the factors now, so no glue may run in the loop
    if glue["launches"] >= 10 * ng:
        raise AssertionError(f"main path: {glue['launches']} launches of PyTorch kernels in one "
                             f"call ({ng} group steps): glue still runs in the loop")
    if n_correct != BATCH or margin < MIN_MARGIN_BITS:
        raise AssertionError(f"main path: {n_correct}/{BATCH} correct, margin {margin:.2f} bits")
    return {"multi-bit PBS": launches}


def phase_single_bit():
    """Path 2: the single-bit PBS at DEFAULT_128, batch 256, in each form."""
    from spf_tpu_torch.ops import encryption, torus
    from spf_tpu_torch.ops.bootstrap import Bootstrap
    from spf_tpu_torch.ops.lut import generate_lut_np
    from spf_tpu_torch.params import DEFAULT_128

    lwe, glwe, radix = DEFAULT_128.l0_params, DEFAULT_128.l1_params, DEFAULT_128.pbs_radix
    n0 = lwe.dim
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rng = np.random.default_rng(20240817)
    lwe_sk = rng.integers(0, 2, n0).astype(np.int64)
    t0 = time.perf_counter()
    glwe_sk = encryption.generate_glwe_sk(glwe, gen)
    bsk = encryption.generate_bsk(lwe_sk, glwe_sk, glwe, radix, gen)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    lut = generate_lut_np([lut_fn], glwe, BITS)
    msgs = np.arange(BATCH, dtype=np.uint64) % 8
    expected = lut_fn(msgs)
    cts = encryption.encrypt_lwe_np(rng, msgs << np.uint64(64 - BITS - 1), lwe_sk, lwe)
    ct = torus.from_u64_np(cts.T.copy(), "cuda")
    sk_flat = glwe_sk.cpu().numpy().reshape(-1).astype(np.uint64)
    wants = {
        "plain": expect_launches(rotate_sub_decompose=n0, fwd_ds=n0, inv_ds=n0, freq_mad=n0),
        "fuse_rot": expect_launches(rotate_sub_decompose_acc=n0, fwd_ds=n0, inv_ds=n0, freq_mad=n0),
        "phase_rot": expect_launches(accumulate_decompose=n0, fwd_ds=n0, inv_ds=n0,
                                     mad_horner_g1=n0, fence=8),
    }
    res = dict(phase="single_bit_pbs", path="single-bit PBS", params="DEFAULT_128", batch=BATCH,
               keygen_s=keygen_s)
    by_path, failures = {}, []
    for form, (fuse_rot, phase_rot) in FORMS.items():
        t0 = time.perf_counter()
        pbs = Bootstrap(bsk, lut, glwe, radix, fuse_rot, phase_rot)
        torch.cuda.synchronize()
        convert_s = time.perf_counter() - t0
        out, first_s, launches, peak_gib = drive(lambda: pbs(ct), wants[form], f"path 2 ({form})")
        n_correct, margin = decode(out, sk_flat, expected)
        times, device_call_ms, by_kernel, glue, port_us = wall_and_device(lambda: pbs(ct), 3)
        med = statistics.median(times)
        res[form] = dict(
            out_shape=list(out.shape), key_conversion_s=convert_s, first_call_s=first_s,
            correct=f"{n_correct}/{BATCH}", noise_margin_bits=margin,
            launches={k: v for k, v in launches.items() if v}, pbs_call_s=times,
            pbs_per_s_median=BATCH / med, device_ms_per_call=device_call_ms,
            device_busy_share=device_call_ms / 1e3 / med, device_ms_by_kernel=by_kernel,
            glue=glue, port_kernel_us_per_launch=port_us, peak_device_mem_gib=peak_gib,
        )
        by_path[f"single-bit PBS, {form}"] = launches
        if tuple(out.shape) != (glwe.size * glwe.degree + 1, BATCH) or n_correct != BATCH \
                or margin < MIN_MARGIN_BITS:
            failures.append(f"{form}: shape {tuple(out.shape)}, {n_correct}/{BATCH}, "
                            f"margin {margin:.2f} bits")
        del pbs
    emit(res)
    if failures:
        raise AssertionError(f"single-bit PBS: {failures}")
    return by_path


def phase_cycle():
    """Path 3: the conversion cycle at DEFAULT_128, batch 256, g = 2."""
    from spf_tpu_torch.ops.cbs import ConversionCycle
    from spf_tpu_torch.ops.multibit import n_groups
    from spf_tpu_torch.params import DEFAULT_128

    p = DEFAULT_128
    lwe = p.l0_params
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rng = np.random.default_rng(20240817)
    lwe_sk = rng.integers(0, 2, lwe.dim).astype(np.int64)
    t0 = time.perf_counter()
    keys = cycle_keys(p, lwe_sk, gen)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cycle = ConversionCycle(*keys[1:], p)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    del keys

    bits_in = (np.arange(BATCH) % 2).astype(np.uint64)
    ct = encrypt_bits(rng, bits_in, lwe_sk, lwe).cuda()
    ng = n_groups(lwe.dim, GROUP_CBS)
    rounds = p.l1_params.log_degree * p.cbs_radix.count  # trace keyswitches
    want = expect_launches(
        accumulate_decompose=ng, mad_horner_g2=ng, fence=8,
        fwd_ds=ng + rounds + 3 + 1,  # rotation, trace, scheme switch (b, digits, GLEV), CMux
        inv_ds=ng + rounds + 1,  # rotation, trace, CMux
    )
    out, first_s, launches, peak_gib = drive(lambda: cycle(ct), want, "path 3 (conversion cycle)")
    n_correct, margin = decode(out, lwe_sk.astype(np.uint64), bits_in, bits=1)
    times, device_call_ms, by_kernel, glue, port_us = wall_and_device(lambda: cycle(ct), 3)
    med = statistics.median(times)
    breakdown = cycle_breakdown(cycle, ct)
    res = dict(
        phase="conversion_cycle", path="conversion cycle", params="DEFAULT_128",
        group=GROUP_CBS, cbs_pbs_radix="4x8", batch=BATCH, out_shape=list(out.shape),
        keygen_s=keygen_s, key_conversion_s=convert_s, first_call_s=first_s,
        correct=f"{n_correct}/{BATCH}", noise_margin_bits=margin,
        tpu_noise_margin_bits=TPU_CYCLE_MARGIN_BITS,
        launches={k: v for k, v in launches.items() if v}, cycle_call_s=times,
        cycles_per_s_median=BATCH / med, device_ms_per_call=device_call_ms,
        device_busy_share=device_call_ms / 1e3 / med, device_ms_by_kernel=by_kernel,
        glue=glue, port_kernel_us_per_launch=port_us, peak_device_mem_gib=peak_gib,
        stages=breakdown,
    )
    emit(res)
    if tuple(out.shape) != (lwe.dim + 1, BATCH):
        raise AssertionError(f"cycle output shape {tuple(out.shape)}")
    if n_correct != BATCH or margin < MIN_CYCLE_MARGIN_BITS:
        raise AssertionError(f"cycle: {n_correct}/{BATCH} correct, margin {margin:.2f} bits")
    return {"conversion cycle": launches}


def cycle_breakdown(cycle, ct) -> dict:
    """Each stage of one conversion cycle run alone, on the previous
    stage's output: wall seconds of 2 synchronised calls, one profiled
    call's device ms and its top kernels."""
    from spf_tpu_torch.ops import cbs
    from spf_tpu_torch.ops.bootstrap import spectra

    p = cycle.params
    acc = cbs.cbs_blind_rotate(ct, spectra(cycle, "bsk"), p)
    glev = cbs.cbs_levels(acc, spectra(cycle, "ak"), p)
    ggsw = cbs.scheme_switch(glev, spectra(cycle, "ssk"), p.l1_params, p.cbs_radix, p.ss_radix)
    l1 = cycle.select(ggsw)
    stages = {
        "cbs_blind_rotate": lambda: cbs.cbs_blind_rotate(ct, spectra(cycle, "bsk"), p),
        "cbs_levels_trace": lambda: cbs.cbs_levels(acc, spectra(cycle, "ak"), p),
        "scheme_switch": lambda: cbs.scheme_switch(glev, spectra(cycle, "ssk"), p.l1_params,
                                                   p.cbs_radix, p.ss_radix),
        "cmux_sample_extract": lambda: cycle.select(ggsw),
        "lwe_keyswitch": lambda: cycle.keyswitch(l1),
    }
    out = {}
    for name, fn in stages.items():
        times, device_call_ms, by_kernel, _, _ = wall_and_device(fn, 2)
        out[name] = dict(wall_s=times, device_ms=device_call_ms,
                         top_kernels=dict(list(by_kernel.items())[:3]))
    return out


def phase_probes():
    """The probe entry points (step_microbench, gap_probe2, vpu_probe)
    through their main(), as one path: every launch count set to 0 just
    before and read just after. Checks: exactly ITERS launches of
    phase_minus_one in each of the pm1 components, the three gap_probe2
    variants bit-identical (gap_probe2 raises otherwise), fma_probe 0
    everywhere and its fused entry point the exact error everywhere.
    Returns ({"probes": launches}, the launches of opaque_materialize)."""
    from spf_tpu_torch import kernels
    from spf_tpu_torch.scripts import gap_probe2, step_microbench, vpu_probe

    torch.cuda.synchronize()
    kernels.reset_launches()
    step = step_microbench.main([])
    gap = gap_probe2.main([])
    vpu = vpu_probe.main([])
    torch.cuda.synchronize()
    launches = kernels.launches()

    pm1 = {ln["component"]: ln["launches"].get("phase_minus_one", 0) for ln in step
           if ln.get("component") in ("pm1 doubling", "phase step (full)")}
    fenced = next(ln for ln in gap if ln.get("variant") == "in-call phases + opaque_materialize")
    fma = {ln["probe"]: ln for ln in vpu if ln.get("probe", "").startswith("fma contraction")}
    as_written, fused = fma["fma contraction (as written)"], fma["fma contraction (__fmaf_rn)"]
    folded = [ln["probe"] for ln in vpu if "mix" in ln and ln["share_of_peak"] > 1.0]
    res = dict(phase="probes", launches={k: v for k, v in launches.items() if v},
               pm1_launches=pm1, opaque_materialize_launches=fenced["launches"].get("fence", 0),
               fma_as_written_nonzero=as_written["nonzero"],
               fma_fused_bit_exact=f"{fused['bit_exact_vs_f64_error']}/{fused['size']}",
               chains_above_peak=folded)
    emit(res)
    bad = []
    if set(pm1.values()) != {step_microbench.ITERS} or len(pm1) != 2:
        bad.append(f"phase_minus_one launches {pm1}, want {step_microbench.ITERS} each")
    if as_written["nonzero"] or fused["bit_exact_vs_f64_error"] != fused["size"]:
        bad.append(f"fma probe: {as_written}, {fused}")
    if not res["opaque_materialize_launches"]:
        bad.append("opaque_materialize launched no fence")
    if folded:
        bad.append(f"above the card's peak rate for their instructions (folded): {folded}")
    if bad:
        raise AssertionError(f"probes: {bad}")
    return {"probes": launches}, res["opaque_materialize_launches"]


def sass_histogram(path: str, kernel: str) -> dict:
    """Opcode counts of each instance of `kernel` in a built library
    (cuobjdump -sass): for the chains, the evidence that no chain was
    folded into a closed form; for the MAD, its instructions by kind."""
    from spf_tpu_torch.kernels import build as kbuild

    exe = shutil.which("cuobjdump") or os.path.join(os.path.dirname(kbuild.nvcc_path()),
                                                     "cuobjdump")
    if not os.path.exists(exe):
        return {"cuobjdump": "not found"}
    out = subprocess.run([exe, "-sass", path], capture_output=True, text=True, timeout=300)
    funcs, cur = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            funcs[cur] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", line)
        if cur is not None and m:
            funcs[cur][m.group(1)] = funcs[cur].get(m.group(1), 0) + 1
    return {name: ops for name, ops in funcs.items() if kernel in name}


def timed(name: str, fn):
    t0 = time.perf_counter()
    out = fn()
    emit(dict(phase_seconds=name, seconds=time.perf_counter() - t0))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from spf_tpu_torch.kernels import build as kbuild

    kind = torch.cuda.get_device_name(0)
    hw = card(torch.device("cuda", 0))
    print(hw["nvidia_smi"], flush=True)
    emit(dict(phase="card", kind=kind, torch=torch.__version__, cuda=torch.version.cuda,
              python=sys.version.split()[0], **hw))

    t0 = time.perf_counter()
    per_source = kbuild.build()
    ptxas = {}
    for name in kbuild.SOURCES:
        with open(f"{kbuild.BUILD_DIR}/{name}.log", errors="replace") as fh:
            ptxas[name] = [ln.strip() for ln in fh if "registers" in ln or "spill" in ln]
    emit(dict(phase="build", seconds=time.perf_counter() - t0, per_source_s=per_source,
              ptxas=ptxas,
              chain_sass_opcodes=sass_histogram(kbuild.library_path("probe"), "chain_kernel"),
              mad_sass_opcodes=sass_histogram(kbuild.library_path("mad"), "mad_horner_kernel"),
              fft_sass_opcodes=sass_histogram(kbuild.library_path("fft"), "ds_kernelILi8E")))

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = timed("kernels_vs_plain", lambda: phase_kernels(gen, hw))
    emit(dict(phase="kernels_vs_plain", bitexact={r["name"]: r["bitexact"] for r in results}))
    bad = [r["name"] for r in results if not r["bitexact"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")

    timed("small_pbs", phase_small_pbs)
    timed("small_single_bit_and_cycle", phase_small_single_bit_and_cycle)
    by_path = timed("wide_glwe", phase_wide_glwe)
    by_path.update(timed("main_path", phase_main_path))
    by_path.update(timed("single_bit_pbs", phase_single_bit))
    by_path.update(timed("conversion_cycle", phase_cycle))
    probes, opaque_launches = timed("probes", phase_probes)
    by_path.update(probes)
    for r in results:
        names = ("fma_probe", "fma_probe_fma") if r["name"] == "fma_probe" else (r["name"],)
        r["launches_by_path"] = {path: sum(counts[k] for k in names)
                                 for path, counts in by_path.items()
                                 if any(counts[k] for k in names)}
        r["launches"] = sum(r["launches_by_path"].values())
    # gap_probe2's opaque_materialize is the fence kernel at the fence row's shapes
    fence_row = next(r for r in results if r["name"] == "fence")
    results.append(dict(
        fence_row, name="opaque_materialize", replaces="scripts/gap_probe2.py:170",
        note="routed to the fence kernel (the same identity copy), timed at the same shapes "
             "[213, 3, 32, 256]; launches: gap_probe2's in-call phases + opaque_materialize "
             "variant", launches_by_path={"probes": opaque_launches}, launches=opaque_launches))
    unused = [r["name"] for r in results if not r["launches"]]
    if unused:
        raise AssertionError(f"kernels launched on no path: {unused}")
    emit(dict(kernels=results))
    emit(dict(ok=True, device=dict(platform="gpu", kind=kind, count=torch.cuda.device_count())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
