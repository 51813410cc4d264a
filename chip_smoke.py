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
   probe kernel, the roll kernel, both fma_probe kernels, the MAD and the
   R = 8 FFT kernels (cuobjdump -sass; fails unless the roll's loop shows
   at least ROLL_CHAINS x ROLL_UNROLL FADDs, `fma_probe_kernel` no FFMA and
   `fma_probe_fma_kernel` one for each of a thread's FMA_ELEMS elements,
   `csrc/probe.cu`);
3. each kernel against its plain PyTorch version on the card, at the
   DEFAULT_128 shapes of the paths below (bit for bit; the rotation
   kernels also at B = 64 and at every N of ROT_NS with every B of ROT_BS,
   P of ROT_PS, t at its edges (0, 1, N - 1, N, 2N - 1, 2N, negative,
   > 2^40) and random; the MADs with random phase factor halves,
   Klo = Khi = 32, and each per-plane instance, g = 0-3, at k + 1 = 3, 4
   and 6, N = 256, B = 129 and 256 (also held at B = 1 and 8, l = 4, K = 32);
   `fence` also on odd lengths at each offset
   within 16 bytes and below one vector; the batched-row MAD
   (`freq_mad_batched`) at l = 4, K = 1024, B = 256, 32, 64 and 129 over a
   slot buffer of 256 GGSWs, slots repeating and out of order, and on a
   batched row, also at the edge shapes of `spf_tpu_torch.scripts.mad_edges`
   (B = 1, 31, 33, 62, 255; K = 32, 64, 128, 40; every column on one slot;
   slots of -1 and nslots giving NaN; k + 1 = 3, 4, 6 at l = 2 and 4; both
   layouts); the keyswitch MAD (`freq_mad_ks`) at the benchmark cycle's
   trace and scheme-switch shapes (B = 2048, l = 6 and 15, L = 1 and 4,
   the latter with its initial plane), also at the edge shapes of
   `mad_edges.check_ks`; the keyswitch's coefficient-domain halves at the
   same shapes (`ks_decompose`: the trace's mask with each round's table and
   the scheme switch's strided masks; `ks_round_add` with each round's
   table, with no table and without the sum), also at N = 64 with B = 1, 3
   and 129, and the two options for the forward FFT's zero lo plane (a
   fresh fill a call or one kept a shape), timed at both shapes; the
   kernels of the CBS and the CMux (`accumulate_decompose` at the CBS
   radix, `mad_horner` g = 2, `fwd_ds` P = 8, `inv_ds` P = 2 and 4) and
   `fence` also at B = 32 and 64, the widths of the wave machine's
   small waves; `phase_factors` at the paths' [steps, B]: the multi-bit
   PBS's [639, 2048] (timed), the CBS rotation's [638, 256], the
   single-bit PBS's [637, 256], ragged B = 1 and 129, and at every K of
   `probe_edges.PHASE_KS` x B = 1, 33 (a at its edges and beyond 2N);
   `fwd_ds` and `inv_ds` also at
   every K of FFT_KS with ragged B and P up to 8, and timed at each P the
   paths give them, beside torch.fft.fft of complex128 [P, K, B] as a
   yardstick of the card), with both timed (device time:
   the kernel queued behind a spin kernel, rotating through copies of its
   inputs that exceed the L2 cache; a plain version of thousands of
   launches summed by torch.profiler). Also the kernels of the probes:
   `phase_minus_one` at K = 1024 (B = 256 and 8, bit-reversed and natural
   order, t at its edges and beyond 2N), every `chain` body, both
   `fma_probe` entry points (against zeros and against the exact f64
   error) and `roll`, at the probe scripts' shapes; `phase_minus_one` and
   `roll` also at the edge shapes of `spf_tpu_torch.scripts.probe_edges`
   (K = 2-2048 x B = 1, 8, 33, 256 in both orders; ragged rows and
   columns, shift 0, rows - 1 and negative, iters 0, 1, 7, 9, 15 and 17,
   iters x shift beyond 2^31, 4099 rows), and both `fma_probe` entry
   points at its sizes 1-4097, [1024, 512] and 3 past it, with a, b and e
   at every offset within 16 bytes, on ±0, ±inf, NaN, subnormals and
   products that overflow or underflow (NaN equal to NaN);
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
   with the launch counts read around it (and the program's counters of
   the keyswitch kernels' launches, `cbs.ks_*_launches`, equal to them), decryption (256/256 correct,
   noise margin >= 2 bits; the TPU's run of the same arithmetic recorded
   3.1), 3 timed cycles and one profiled, then each stage of the cycle
   run alone (wall and device time);
8. a small wave machine run (N = 256, n0 = 8: a u2 add and a NOT through
   fluent graphs) on the card and on the CPU, through the WaveMachine and
   the per-wave U32CircuitExecutor: four bit-identical outputs;
9. path 6, bench.py --intop's add8, mul8 and mul16 at DEFAULT_128 through
   the WaveMachine (keys on the card, 128 L0 input bits encrypted on the
   host, one FheCircuit holding every instance): each workload's first
   call with the launch counts read around it and held against the counts
   its schedule implies, every instance decrypting right with a worst
   noise margin of at least 2 bits (printed beside the TPU's record), its
   wave statistics beside the TPU's, add8 also through the per-wave
   executor (the same values), then the median latency of 3 calls (1 for
   mul16) and one profiled call (device ms by kernel and glue, busy share);
10. path 7, the encrypted Parasol CPU (`spf_tpu_torch.cpu.FheComputer`
   over `U32HostEvaluation`, every flush run by the WaveMachine) at
   DEFAULT_128 on path 6's keys plus GGSW(0) / GGSW(1) made on the card:
   bench.py --program mul32 (its graph built and scheduled apart, seconds
   each; a first call with the launch counts read around it and held
   against its schedule's; a * b mod 2^32 from 4 encrypted return bytes,
   every bit's margin >= 2 bits; gas 500003, one flush; wave statistics
   equal to the JAX scheduler's; the median latency of 3 calls beside the
   host encryption's seconds, one profiled call), then the encrypted u8
   programs of tests/test_cpu.py (add, CmpGt + Cmux, x plaintext 3) and a
   Dbg program that flushes twice, each with its launch counts read around
   it and decrypting right;
11. path 8, the u64 API (`spf_tpu_torch.runtime`: `generate_keys`,
   `Evaluation`, `CircuitExecutor`; the c128 backend, torch.fft and
   elementwise PyTorch, which launch none of the port's kernels) at
   DEFAULT_128: the README quick start, keygen on the card from a seeded
   generator, `Evaluation` (its two constant CBSs), the u8 add 42 + 54
   built with `runtime.fluent` through `CircuitExecutor(ev).run` decrypting
   to 96 (its launch counts read around it: every port kernel 0), then path
   7's u8 add program through `FheComputer(ev)` with no executor (the u64
   `CircuitExecutor`), its return decrypting to 96 via `decrypt_return`;
   keygen and set-up seconds (the set-up also again, warm), the median
   latency of 3 synchronised runs,
   one profiled run (device ms, busy share), the worst output-bit margin;
12. path 9, on path 8's keys at DEFAULT_128 (`spf_tpu_torch.ops.u64.pfks`,
   `runtime.recryption`; c128, every port kernel's launch count 0 around
   each call): the CBS-PFKS keys and a bootstrap key at `pbs_radix` made
   on the card (seconds), circuit bootstrapping v1 via PFKS of 8
   encrypted bits (4 of each value) in one call, a CMux of two L1 GLWEs
   through each GGSW decrypted on the host (every coefficient selected
   right, worst margin >= 2 bits), one more call's latency; the private
   (identity map) and public functional keyswitch from an L1 LWE of
   dimension k·N to the L1 GLWE, decrypting right (margin >= 2 bits); the
   one-time pad round trip, exact (`phase_pfks`);
13. path 10, noise measurement (`spf_tpu_torch.utils.noise`; c128 and
   host code, every port kernel's launch count 0 around each call):
   `spf_tpu_torch.scripts.op_noise`'s four measurements at its own
   PARAMS (keys on the card), each log2 std and max; at DEFAULT_128 on
   path 8's keys the GLWE encryption, the LWE keyswitch, a chain of 8
   CMuxes selecting 1 and a CMux behind a CBS, each log2 std beside the
   parameters' sigma and `noise_exponent_at_depth`, each >= 2 bits below
   the message's decision boundary; a serialization round trip
   (`utils.serialization`) of path 8's keyswitch key, secret keys and a
   ciphertext of each kind, byte-identical, with their sizes
   (`phase_noise`);
14. path 13, the multi-device layer (`spf_tpu_torch.parallel`) on the
   card's mesh (one card on a one-card machine): `sharded_pbs_multibit`
   on path 1's key and inputs with path 1's launch counts,
   `sharded_cbs_u32` on path 3's with one CBS's, `sharded_pbs` on path 8's
   compute key (no port kernel) and `sharded_pbs_multibit_multihost` on a
   one-process (1, count) multi-host mesh with path 1's, each bit for bit
   the unsharded call's; the sharded and unsharded device ms, `replicate`'s
   seconds a device, and `scaling_model` for 1, 4 and 8 devices, printed as
   a model (`phase_mesh`);
15. the probes, as one path with the launch counts read around it: the
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
PORT_KERNELS = ("accumulate_decompose_kernel", "rotate_sub_decompose_kernel",
                "ks_decompose_kernel", "ks_round_add_kernel", "fwd_ds_kernel",
                "inv_ds_kernel", "mad_horner_kernel", "mad_plane_kernel", "mad_planes_kernel",
                "mad_batched_kernel", "ks_mad_kernel",
                "copy_kernel",
                "phase_kernel", "phase_factors_kernel", "chain_kernel",
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

    def mad_case(name, group, d, extra_bs=()):
        """mad_horner's g-instance (g = 0: freq_mad) on digit spectra d,
        with random phase factor halves for g >= 1; also held bit for bit on
        the first columns of d at each width of `extra_bs`."""
        ll = d[0].shape[0]
        ns = max(1, (1 << group) - 1)
        row_shape = (kp1, ll, kp1, k) if group == 0 else (ns, kp1, ll, kp1, k)
        row = spectrum(*row_shape, exp=60)
        kernel, plain = mad_fns(group)

        def args_at(cols):
            dd = tuple(x[..., :cols].contiguous() for x in d)
            return (dd, row) if group == 0 else (
                dd, row, (spectrum(group, klo, cols, exp=0), spectrum(group, khi, cols, exp=0)))

        args = args_at(b)
        return dict(
            name=name, source="spf_tpu_torch/csrc/mad.cu", replaces="spf_tpu/ops/mad_pallas.py:94",
            note=f"mad.cu's g = {group} instance" + (
                "; in place of the XLA glue freq_mad (spf_tpu/ops/bootstrap_u32.py:161)"
                if group == 0 else
                "; also forms the g per-bit (phase - 1) factors from the step's halves "
                "(Klo = Khi = 32), the combine XLA fuses on the TPU (spf_tpu/ops/multibit.py:213-245)"),
            kernel=kernel, plain=plain, args=args, extra_args=[args_at(c) for c in extra_bs],
            nbytes=mad_bytes(group, kp1, ll, k, b, klo + khi), ops=mad_ops(group, kp1, ll, k, b),
        )

    def mad_any_kp1_case(group, kp1_, b_=129):
        """mad.cu's per-plane g-instance at k + 1 = kp1_ (the test sets' 3 and
        4, GLWE_5_256_128's 6) at N = 256 (K = 128), B = b_ (129: also B = 8;
        256: GLWE_5_256_128's width at the paths' batch); at k + 1 = 3, B =
        129 also every edge shape of `scripts.mad_edges` of its g."""
        from spf_tpu_torch.scripts import mad_edges

        k_, l_, klo_, khi_ = 128, 2, 16, 8
        ns = max(1, (1 << group) - 1)

        def inputs(b_):
            d = spectrum(l_, kp1_, k_, b_, exp=20)
            row = spectrum(*((kp1_, l_, kp1_, k_) if group == 0 else (ns, kp1_, l_, kp1_, k_)),
                           exp=60)
            return (d, row) if group == 0 else (
                d, row, (spectrum(group, klo_, b_, exp=0), spectrum(group, khi_, b_, exp=0)))

        kernel, plain = mad_fns(group)
        edges = dict(edge_check=lambda: mad_edges.check_plane(gen, group)) \
            if (kp1_, b_) == (3, 129) else {}
        return dict(
            name=f"mad_any_kp1_g{group} k+1={kp1_}" + ("" if b_ == 129 else f" B={b_}"),
            row=f"mad_any_kp1_g{group}",
            source="spf_tpu_torch/csrc/mad.cu", replaces="spf_tpu/ops/mad_pallas.py:94",
            note=f"mad.cu's g = {group} instance for k + 1 != 2 (mad_planes_kernel: a block one "
                 "bin x 32-128 columns x every output plane; mad_plane_kernel, one plane a block, "
                 "where it was measured faster); parts: k + 1 = 3, 4, 6 at [l = 2, k + 1, "
                 "K = 128] with B = 129 (also held bit for bit at B = 8) and B = 256; "
                 "edge_shapes: scripts.mad_edges at this g",
            kernel=kernel, plain=plain, args=inputs(b_),
            extra_args=[inputs(8)] if b_ == 129 else [], **edges,
            plain_copies=1,  # thousands of small launches: one copy times them
            nbytes=mad_bytes(group, kp1_, l_, k_, b_, klo_ + khi_),
            ops=mad_ops(group, kp1_, l_, k_, b_),
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
            kernel=lambda a, p, r=radix: rot_decomp.accumulate_decompose(a, p, r),
            plain=lambda a, p, r=radix: rot_decomp.accumulate_decompose_plain(a, p, r),
            args=(acc, (ph, pl)),
            # the CBS rotation's radix at the widths of small waves
            extra_args=[(acc[..., :c].contiguous(), (ph[..., :c].contiguous(),
                                                     pl[..., :c].contiguous()),
                         DEFAULT_128.cbs_pbs_radix) for c in SMALL_WAVES],
            nbytes=e * (8 + 4 + 4 + 8 + 4 * l),
            ops=e * 18,  # the f32 work of from_ds; the rest is integer
        ),
        *rotation_cases,
        *fft_cases(gen, (digits, zeros), prod_f, digits_cbs),
        mad_case("mad_horner", GROUP, dfft),
        mad_case("mad_horner_g2", GROUP_CBS, dfft_cbs, extra_bs=SMALL_WAVES),
        mad_case("mad_horner_g1", 1, dfft),
        mad_case("freq_mad", 0, dfft),
        *(mad_any_kp1_case(g, kp, bb) for g in (3, 2, 1, 0) for bb in (129, 256)
          for kp in (3, 4, 6)),
        *batched_mad_cases(gen, dfft_cbs),
        *ks_mad_cases(gen),
        *ks_halves_cases(gen),
        dict(
            name="fence",
            source="spf_tpu_torch/csrc/fence.cu",
            replaces="spf_tpu/ops/phase_rot.py:242",
            kernel=phase_rot.fence,
            plain=phase_rot.fence_plain,
            plain_is_one_launch=True,  # clone: timed as the kernel is
            library=lambda x: x.clone(),
            args=(factors,),
            extra_args=fence_extra + [(factors[..., :c].contiguous(),) for c in SMALL_WAVES],
            nbytes=2 * 4 * factors.numel(),
            ops=0,
        ),
        phase_factors_case(gen),
    ]
    cases += phase_and_probe_cases(gen, hw)
    f32_per_s = chain_peak_per_s(1, {"fma": 1}, hw)  # one f32 instruction a lane and clock
    for c in cases:
        c.setdefault("ops_per_s", f32_per_s)
    return merge_rows(cases, [measure(c) for c in cases])


# the [steps, B] of phase_factors' callers: the multi-bit PBS (g = 3) at the
# benchmark's batch (timed), the CBS rotation (g = 2) and the single-bit
# PBS at the paths' batch, and ragged widths
FACTOR_SHAPES = ((639, 2048), (638, BATCH), (637, BATCH), (639, 1), (639, 129))


def phase_factors_case(gen) -> dict:
    """The hoisted phase factors (`phase_factors`, N = 2048) at every
    [steps, B] of FACTOR_SHAPES, the exponents random in [0, 2N) after the
    edges of `probe_edges.exponents` in each shape's first step; also at
    the edge shapes of `probe_edges.check_phase_factors`."""
    from spf_tpu_torch.ops import phase_rot
    from spf_tpu_torch.params import DEFAULT_128
    from spf_tpu_torch.scripts import probe_edges

    n = DEFAULT_128.l1_params.degree
    klo, khi = phase_rot.factor_halves(n)

    def exponents(steps, b):
        a = torch.randint(0, 2 * n, (steps, b), generator=gen, device="cuda")
        a[0] = probe_edges.exponents(n, b, gen)
        return a

    def flat(fn):
        return lambda a, nn: sum(fn(a, nn), ())

    (steps, b), *extra = FACTOR_SHAPES
    return dict(
        name="phase_factors", source="spf_tpu_torch/csrc/phase.cu",
        replaces="none: XLA glue on the TPU (spf_tpu/ops/phase_rot.py:364)",
        note=f"phase_factors_kernel, timed at [steps, B] = [{steps}, {b}] (Klo = {klo}, Khi = "
             f"{khi}); also held bit for bit at {[list(x) for x in extra]}; edge_shapes: "
             "scripts.probe_edges.check_phase_factors (K 2-2048 x B 1, 33, 3 steps)",
        kernel=flat(phase_rot.phase_factors_all), plain=flat(phase_rot.phase_factors_all_plain),
        args=(exponents(steps, b), n), extra_args=[(exponents(*x), n) for x in extra],
        edge_check=lambda: probe_edges.check_phase_factors(gen),
        plain_copies=1,  # ~900 launches: one copy times them
        reps=10,  # 1.34 GB of output a call, each kept to the end of the timing
        # the two outputs written once, a and the table read once
        nbytes=16 * (klo + khi) * steps * b + 8 * steps * b + 16 * 2 * n,
        ops=steps * b * (klo + khi - 2) * CMUL,  # the doubling of both halves
    )


# the widths below 256 of the wave machine's CMux (64) and CBS (32) waves
# (`runtime/wave_machine.py::_WIDTHS`): the kernels of both held there too
SMALL_WAVES = (32, 64)
BATCHED_BS = (256, 32, 64, 129)  # the batched-row MAD's widths, over a slot buffer of 256
BATCHED_SLOTS = 256


def batched_mad_cases(gen, dfft_cbs) -> list:
    """The batched-row MAD (`freq_mad_batched`) at [l = 4, k+1 = 2, K = 1024]
    and B of BATCHED_BS over a slot-major buffer of BATCHED_SLOTS GGSWs, the
    slot indices random (repeating, out of order); the first part also on
    a batched row [k+1, l, k+1, K, B] as circuit bootstrapping makes them
    (no slot indices) and at every edge shape of `scripts.mad_edges`
    (k + 1 = 3, 4, 6 among them). One row with a part a width; the bound
    counts the distinct slots the indices name."""
    from spf_tpu_torch.ops import mad
    from spf_tpu_torch.scripts import mad_edges

    dev = "cuda"
    l, kp1, k, _ = dfft_cbs[0].shape

    def spectrum(*shape, exp=60):
        out = []
        for _ in range(2):
            hi = torch.randn(shape, generator=gen, device=dev) * 2.0**exp
            out += [hi, hi * torch.randn(shape, generator=gen, device=dev) * 2.0**-25]
        return tuple(out)

    rows = spectrum(BATCHED_SLOTS, kp1, l, kp1, k)
    row_bytes = 16 * kp1 * l * kp1 * k
    cases = []
    for cols in BATCHED_BS:
        d = tuple(x[..., :cols].contiguous() for x in dfft_cbs)
        slots = torch.randint(0, BATCHED_SLOTS, (cols,), generator=gen, device=dev,
                              dtype=torch.int32)
        distinct = int(torch.unique(slots).numel())
        first = cols == BATCHED_BS[0]
        extra = [(d, spectrum(kp1, l, kp1, k, cols), None, -1)] if first else []
        edges = dict(edge_check=lambda: mad_edges.check_batched(gen)) if first else {}
        cases.append(dict(
            name=f"freq_mad_batched B={cols}", row="freq_mad_batched",
            source="spf_tpu_torch/csrc/mad.cu", replaces="spf_tpu/ops/mad_pallas.py:94",
            note="mad.cu's batched-row g = 0 MAD (`mad_batched_kernel`): each column reads its "
                 "own GGSW row in place, in place of the XLA glue freq_mad under a batched row "
                 "(spf_tpu/ops/bootstrap_u32.py:161-178); parts: B = 256, 32, 64, 129 over a "
                 f"slot buffer of {BATCHED_SLOTS} (slots repeating, out of order; the bound "
                 "counts the distinct slots), B = 256 also on a batched row; edge_shapes: "
                 "scripts.mad_edges (B = 1-255, one slot, slots outside as NaN, K = 32-128 and "
                 "40, k + 1 = 3, 4, 6, both layouts)",
            kernel=mad.freq_mad_batched, plain=mad.freq_mad_batched_plain,
            args=(d, rows, slots, 0), extra_args=extra, **edges,
            nbytes=distinct * row_bytes + 16 * (l * kp1 + kp1) * k * cols + 4 * cols,
            ops=k * cols * kp1 * l * kp1 * (CMUL + CADD), distinct_slots=distinct,
        ))
    return cases


# the keyswitch MAD's shapes in the benchmark's conversion cycle (DEFAULT_128,
# B = 2048): the trace's GLWE keyswitch (l = tr_radix.count, L = 1) and the
# scheme switch's row (l = ss_radix.count, L = cbs_radix.count, the initial
# plane GLEV(b)'s spectra)
KS_BATCH = 2048


def ks_mad_cases(gen) -> list:
    """The keyswitch MAD (`freq_mad_ks`) at the conversion cycle's two
    shapes, B = KS_BATCH, one row with a part each; also at every edge
    shape of `scripts.mad_edges.check_ks`."""
    from spf_tpu_torch.ops import mad
    from spf_tpu_torch.params import DEFAULT_128
    from spf_tpu_torch.scripts import mad_edges

    glwe = DEFAULT_128.l1_params
    kp1, k_in, k = glwe.size + 1, glwe.size, glwe.degree // 2
    shapes = (("trace", DEFAULT_128.tr_radix.count, None),
              ("scheme switch", DEFAULT_128.ss_radix.count, DEFAULT_128.cbs_radix.count))
    cases = []
    for label, l, nz in shapes:
        lead = () if nz is None else (nz,)
        dfft = mad_edges.spectrum(gen, (l, *lead, k_in, k, KS_BATCH), 20)
        row = mad_edges.spectrum(gen, (k_in, l, kp1, k), 60)
        init = None if nz is None else mad_edges.spectrum(gen, (*lead, k, KS_BATCH), 60)
        z = nz or 1
        first = not cases
        cases.append(dict(
            name=f"freq_mad_ks {label}", row="freq_mad_ks", source="spf_tpu_torch/csrc/mad.cu",
            replaces="none: XLA glue on the TPU, cbs_u32.keyswitch_glwe_u32's and "
                     "scheme_switch_u32's products (spf_tpu/ops/cbs_u32.py)",
            note="mad.cu's keyswitch MAD (`ks_mad_kernel`): digit spectra [l, L, k_in, K, B] "
                 "times one key row [k_in, l, k+1, K] that every column shares; parts: the "
                 f"trace's GLWE keyswitch [l = {shapes[0][1]}, k_in = {k_in}, K = {k}, B = "
                 f"{KS_BATCH}] and the scheme switch's row [l = {shapes[1][1]}, L = "
                 f"{shapes[1][2]}], column 0 from GLEV(b); edge_shapes: scripts.mad_edges."
                 "check_ks (B = 1-255, K = 32 and 40, k + 1 = 2, 3, 4, 6, l = 1-15, L = 1-3, "
                 "every initial plane)",
            kernel=mad.freq_mad_ks, plain=mad.freq_mad_ks_plain, args=(dfft, row, init, 0),
            **(dict(edge_check=lambda: mad_edges.check_ks(gen)) if first else {}),
            plain_copies=1, reps=10,
            # the spectra, the key row and the initial plane read once, the output written once
            nbytes=16 * (l * z * k_in * k * KS_BATCH + k_in * l * kp1 * k
                         + (0 if init is None else z * k * KS_BATCH) + z * kp1 * k * KS_BATCH),
            ops=z * k * KS_BATCH * k_in * l * kp1 * (CMUL + CADD),
        ))
    return cases


def ks_halves_cases(gen) -> list:
    """The coefficient-domain halves of the CBS keyswitch at the benchmark
    cycle's shapes, B = KS_BATCH: `ks_decompose` on the trace's mask
    [1, N, B] at tr_radix with round 0's table and on the scheme switch's
    strided masks glev[:, :-1] of a GLEV [l_cbs, 2, N, B] at ss_radix;
    `ks_round_add` at [2, N, B] with round 0's table. Torus values random
    with 0, 2^63, -1 and each digit's carry edge first; the ds pairs over
    the inverse FFT's range with the i32 clamps. Also held bit for bit at
    every other round's table, with no table and without the sum, and at
    N = 64 with B = 1, 3 and 129 (one column a thread)."""
    from spf_tpu_torch.ops import cbs, encryption, rot_decomp, torus
    from spf_tpu_torch.params import DEFAULT_128

    dev = torch.device("cuda")
    glwe = DEFAULT_128.l1_params
    kp1, n, b = glwe.size + 1, glwe.degree, KS_BATCH
    signed = lambda x: torus.encode_const(x, 64)  # x mod 2^64, as an int64
    tr, ss, l_cbs = DEFAULT_128.tr_radix, DEFAULT_128.ss_radix, DEFAULT_128.cbs_radix.count
    rounds = glwe.log_degree

    def torus_at(shape):
        x = encryption.uniform_torus(shape, gen)
        edges = [0, -(1 << 63), -1]
        for radix in (tr, ss):
            shift = 64 - radix.radix_log * radix.count
            edges += [1 << (shift - 1), (1 << (shift - 1)) - 1]
            for j in range(radix.count):
                at = shift + radix.radix_log * j
                edges += [signed((1 << (radix.radix_log - 1)) << at),
                          signed(((1 << (radix.radix_log - 1)) - 1) << at)]
        edges += [signed(-e) for e in edges]
        m = min(len(edges), x.numel())
        x.view(-1)[:m] = torch.tensor(edges[:m], dtype=torch.int64, device=dev)
        return x

    def prod_at(shape):
        exps = torch.randint(0, 86, shape, generator=gen, device=dev).float()
        ph = torch.randn(shape, generator=gen, device=dev) * torch.exp2(exps)
        pl = torch.randn(shape, generator=gen, device=dev) * torch.exp2((exps - 26).clamp(min=0))
        ph.view(-1)[:5] = torch.tensor([2.0**31, -(2.0**31), 2.0**63, 2.0**84, 0.5], device=dev)
        return ph, pl

    def table(nn, rnd):
        src, neg = cbs._trace_tables(nn, dev)
        return src[rnd], neg[rnd]

    small = [(64, bb) for bb in (1, 3, 129)]
    ct = torus_at((kp1, n, b))
    glev = torus_at((l_cbs, kp1, n, b))
    prod = prod_at((kp1, n, b))
    e = n * b
    note = ("rot_decomp.cu's {}: parts: {}; also held bit for bit at every trace round's table "
            "of N = 2048, and at N = 64 with B = 1, 3, 129")
    return [
        dict(
            name="ks_decompose trace", row="ks_decompose",
            source="spf_tpu_torch/csrc/rot_decomp.cu",
            replaces="none: XLA glue on the TPU, cbs_u32.trace_u32's automorphism and "
                     "keyswitch_glwe_u32's decomposition (spf_tpu/ops/cbs_u32.py)",
            note=note.format("ks_decompose_kernel (automorphism, sign and gadget digits in one "
                             "pass)", f"the trace's mask [1, {n}, {b}] at tr_radix "
                             f"{tr.count}x{tr.radix_log} with round 0's table; the scheme "
                             f"switch's strided masks [{l_cbs}, 1, {n}, {b}] at ss_radix "
                             f"{ss.count}x{ss.radix_log}"),
            kernel=lambda c, t: rot_decomp.ks_decompose(c[:-1], tr, t),
            plain=lambda c, t: rot_decomp.ks_decompose_plain(c[:-1], tr, t),
            args=(ct, table(n, 0)),
            extra_args=[(ct, table(n, r)) for r in range(1, rounds)] + [(ct, None)]
            + [(torus_at((kp1, nn, bb)), table(nn, r)) for nn, bb in small for r in (0, 3)],
            reps=20,
            # the mask read once (its table), the digits written once
            nbytes=e * (8 + 4 * tr.count) + 9 * n, ops=0,
        ),
        dict(
            name="ks_decompose scheme switch", row="ks_decompose",
            source="spf_tpu_torch/csrc/rot_decomp.cu",
            replaces="none: XLA glue on the TPU, scheme_switch_u32's decomposition",
            kernel=lambda g: rot_decomp.ks_decompose(g[:, :-1], ss),
            plain=lambda g: rot_decomp.ks_decompose_plain(g[:, :-1], ss),
            args=(glev,),
            extra_args=[(torus_at((l_cbs, kp1, nn, bb)),) for nn, bb in small],
            reps=10, plain_copies=1,
            nbytes=l_cbs * e * (8 + 4 * ss.count), ops=0,
        ),
        dict(
            name="ks_round_add", source="spf_tpu_torch/csrc/rot_decomp.cu",
            replaces="none: XLA glue on the TPU, keyswitch_glwe_u32's from_ds, negation and "
                     "add of b and trace_u32's add",
            note=note.format("ks_round_add_kernel (rounding, negation, the mapped b and the "
                             "round's sum in one pass)", f"[{kp1}, {n}, {b}] with round 0's "
                             "table and the sum; also with no table and no sum"),
            kernel=lambda q, c, t, acc: rot_decomp.ks_round_add(q, c, t, acc),
            plain=lambda q, c, t, acc: rot_decomp.ks_round_add_plain(q, c, t, acc),
            args=(prod, ct, table(n, 0), True),
            extra_args=[(prod, ct, table(n, r), True) for r in range(1, rounds)]
            + [(prod, ct, None, False), (prod, ct, table(n, 5), False)]
            + [(prod_at((kp1, nn, bb)), torus_at((kp1, nn, bb)), table(nn, r), r == 0)
               for nn, bb in small for r in (0, 3)],
            reps=20,
            # the ds pair and ct read once (b is ct's row k, permuted), the output
            # written once
            nbytes=kp1 * e * (4 + 4 + 8 + 8) + 9 * n, ops=kp1 * e * 18,
        ),
    ]


def lo_plane_options() -> dict:
    """The forward FFT of a keyswitch's digits takes a zero lo plane: a
    fresh zero tensor each call (what the CBS does) or one kept a shape.
    Device ms of the fill alone and of the transform with each, at the
    trace's digits [6, 1, N, B] and the scheme switch's [15, 4, 1, N, B]."""
    from spf_tpu_torch.ops import fft
    from spf_tpu_torch.params import DEFAULT_128

    glwe = DEFAULT_128.l1_params
    n, b = glwe.degree, KS_BATCH
    out = {}
    for label, shape in (("trace", (DEFAULT_128.tr_radix.count, 1, n, b)),
                         ("scheme switch", (DEFAULT_128.ss_radix.count, DEFAULT_128.cbs_radix.count,
                                            1, n, b))):
        digits = torch.randint(-64, 64, shape, device="cuda").float()
        nbytes = digits.numel() * 4
        copies = cold_copies((digits,), 2 * nbytes)
        reps = 10 if label == "trace" else 4
        zero = torch.zeros_like(digits)
        out[label] = dict(
            shape=list(shape), kept_zero_bytes=nbytes,
            fill_ms=device_ms(torch.zeros_like, copies, reps)[0],
            fwd_fresh_zero_ms=device_ms(lambda d: fft.fwd_ds(d, torch.zeros_like(d)), copies,
                                        reps)[0],
            fwd_kept_zero_ms=device_ms(lambda d: fft.fwd_ds(d, zero), copies, reps)[0],
        )
        del digits, copies, zero
    return out


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
    small_fwd = [(digits_cbs[..., :c].contiguous(), torch.zeros_like(digits_cbs[..., :c]))
                 for c in SMALL_WAVES]  # the CMux and CBS waves' widths, P = 8

    def small_inv(p):
        return [(spectrum(p, k, c),) for c in SMALL_WAVES]

    return [
        case(False, fwd_args, p_fwd, k, b, extra_args=fwd_extra()),
        case(False, (digits_cbs, torch.zeros_like(digits_cbs)),
             digits_cbs.shape[0] * digits_cbs.shape[1], k, b, extra_args=small_fwd),
        case(True, (prod_f,), kp1, k, b, extra_args=[*inv_extra(), *small_inv(kp1)]),
        case(True, (spectrum(2 * kp1, k, b),), 2 * kp1, k, b, extra_args=small_inv(2 * kp1)),
    ]


def phase_and_probe_cases(gen, hw) -> list:
    """The in-loop phase generator at K = 1024 (B = 256 and 8, bit-reversed
    and natural order, t at its edges and beyond 2N) and the probe kernels
    at the probe script's shapes (every chain body, both fma_probe entry
    points, roll). The chains and the roll are bounded by the card's peak
    rate for the instructions of their step (`card()`'s `hw`)."""
    from spf_tpu_torch.ops import phase_rot
    from spf_tpu_torch.params import DEFAULT_128
    from spf_tpu_torch.scripts import probe_edges, vpu_probe

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
             "calls it; also held bit for bit in natural order and at B = 8; edge_shapes: "
             "scripts.probe_edges.check_phase (K 2-2048 x B 1, 8, 33, 256, both orders, t at "
             "its edges and beyond 2N)",
        kernel=phase_rot.phase_minus_one, plain=phase_rot.phase_minus_one_plain,
        args=(t_b, n, perm), extra_args=[(t_b, n, None), (t_8, n, perm), (t_8, n, None)],
        edge_check=lambda: probe_edges.check_phase(gen),
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
                    "__fmaf_rn(a, b, -p) entry point, held against the exact f64 error; "
                    "edge_shapes: scripts.probe_edges.check_fma (n 1-4097, [1024, 512] and 3 "
                    "past it, a, b and e at every offset within 16 bytes, ±0, ±inf, NaN, "
                    "subnormals, products that overflow and underflow; both entry points)")
    cases.append(dict(fma, name="fma_probe", kernel=vpu_probe.fma_probe,
                      plain=vpu_probe.fma_probe_plain,
                      edge_check=lambda: probe_edges.check_fma(gen)))
    cases.append(dict(fma, name="fma_probe_fma", kernel=vpu_probe.fma_probe_fma,
                      plain=vpu_probe.fma_probe_fma_plain))
    cases.append(dict(
        name="roll", source="spf_tpu_torch/csrc/probe.cu", replaces="scripts/vpu_probe.py:178",
        note="[1024, 512], 400 steps of roll(v, 8, axis=0) + 1.0; bounded by its adds; "
             "edge_shapes: scripts.probe_edges.ROLL_CASES (ragged rows and columns, shift 0, "
             "rows - 1 and negative, iters 0, 1, 7, 9, 15, 17, iters x shift beyond 2^31, "
             "4099 rows)",
        kernel=vpu_probe.roll, plain=vpu_probe.roll_plain, args=(x["roll"],), plain_copies=1,
        edge_check=lambda: probe_edges.check_roll(gen),
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
            "host_us_per_call", "yardstick_ms", "distinct_slots", "edge_shapes") if key in r}
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
    edges = c["edge_check"]() if "edge_check" in c else None  # bit for bit at its edge shapes
    exact = exact and not (edges and edges["not_bitexact"])
    del got, want
    copies = cold_copies(args, c["nbytes"])
    reps = c.get("reps", 50)  # every output is kept to the end: fewer for a large one
    kernel_ms, host_us = device_ms(c["kernel"], copies, reps)
    if c.get("plain_is_one_launch"):
        plain_ms = device_ms(c["plain"], copies, reps)[0]
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
        **{k: c[k] for k in ("distinct_slots",) if k in c},
        **({"edge_shapes": edges} if edges else {}),
    )


def lwe_decoded(out: torch.Tensor, sk: np.ndarray, bits: int):
    """LWE outputs int64 [n+1, B] decrypted under sk [n] on the host: their
    phases and the messages decoded to `bits` bits (bench.py:849-858)."""
    from spf_tpu_torch.ops import encryption, torus

    phase = encryption.lwe_phase_np(torus.to_u64_np(out).T, sk)
    rb = (phase >> np.uint64(64 - bits - 1)) & np.uint64(1)
    return phase, ((phase >> np.uint64(64 - bits)) + rb) & np.uint64((1 << bits) - 1)


def decode(out: torch.Tensor, sk: np.ndarray, expected: np.ndarray, bits: int = BITS):
    """Decrypt LWE outputs int64 [n+1, B] under the key sk [n] on the
    host: (n_correct, noise margin in bits), as bench.py does for PBS
    outputs (bench.py:859-866) and, with bits = 1, for conversion cycles
    (bench.py:505-521)."""
    phase, dec = lwe_decoded(out, sk, bits)
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
        inv_ds=ks * (g3 + g2 + 3 * steps), phase_factors=ks * 3, mad_any_kp1_g3=ks * g3,
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
    """Path 1: DEFAULT_128, g = 3, batch 256, through the user's entry points.
    Returns its launches and (the module, its input, output and launches)
    for path 13."""
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
    want = expect_launches(accumulate_decompose=ng, fwd_ds=ng, inv_ds=ng, mad_horner=ng,
                           phase_factors=1)
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
    return {"multi-bit PBS": launches}, (pbs, ct, out, launches)


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
                                     mad_horner_g1=n0, phase_factors=1),
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


# the counters `ops/cbs.py` keeps of the keyswitch kernels' launches on a
# card, and the kernels they count
KS_COUNTERS = {"cbs.ks_mad_launches": "freq_mad_ks", "cbs.ks_decompose_launches": "ks_decompose",
               "cbs.ks_round_launches": "ks_round_add"}


def phase_cycle():
    """Path 3: the conversion cycle at DEFAULT_128, batch 256, g = 2.
    Returns its launches and (the module, its input) for path 13."""
    from spf_tpu_torch.ops.cbs import ConversionCycle
    from spf_tpu_torch.params import DEFAULT_128
    from spf_tpu_torch.utils.profiling import metrics

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
    cbs = cbs_launches(p)
    # a CBS, then the CMux: its forward and inverse FFT and its MAD under the
    # CBS output's batched row
    want = expect_launches(**dict(cbs, fwd_ds=cbs["fwd_ds"] + 1, inv_ds=cbs["inv_ds"] + 1,
                                  freq_mad_batched=1))
    before = metrics.snapshot()
    out, first_s, launches, peak_gib = drive(lambda: cycle(ct), want, "path 3 (conversion cycle)")
    # the program's own launch counters of the CBS keyswitch's kernels
    counters = {k: metrics.snapshot().get(k, 0) - before.get(k, 0) for k in KS_COUNTERS}
    want_counters = {k: cbs[name] for k, name in KS_COUNTERS.items()}
    if counters != want_counters:
        raise AssertionError(f"path 3: counters {counters}, want {want_counters}")
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
        launches={k: v for k, v in launches.items() if v}, cbs_counters=counters,
        cycle_call_s=times,
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
    return {"conversion cycle": launches}, (cycle, ct)


# bench.py --intop's workloads (bench.py:536-720): (op, width); instances
# max(1, 64 // width), so 2 * width * instances = 128 input bits
INTOPS = (("add", 8), ("mul", 8), ("mul", 16))
MIN_INTOP_MARGIN_BITS = 2.0
TIMED_CALLS = {"add8": 3, "mul8": 3, "mul16": 1}
# the TPU's record of the same runs (BENCH_SUITE.json add8, mul8, mul16): a
# correctness reference, and its wave statistics, never a target
TPU_INTOP = {
    "add8": dict(correct="8/8", noise_margin_bits_worst=5.7, mean_cmux_batch=65.0,
                 mean_cbs_batch=128.0),
    "mul8": dict(correct="8/8", noise_margin_bits_worst=3.5, mean_cmux_batch=155.6,
                 mean_cbs_batch=128.0),
    "mul16": dict(correct="4/4", noise_margin_bits_worst=3.5, mean_cmux_batch=123.0,
                  mean_cbs_batch=128.0),
}


def intop_graph(op: str, width: int):
    """One FheCircuit holding every instance of bench.py's intop workload
    (bench.py:608-641): 2 * width * n_inst L0 LWE inputs "b{r}", each
    through CBS, then the adder or multiplier of each instance over its
    bits (refreshed every 64 CMuxes), one OUTPUT_GLWE1 "o{j}_{wi}" an output
    bit. Returns (graph, [(instance, bit, key)], n_inst, the mux circuit's
    function on (a, b))."""
    from spf_tpu_torch.circuits import integer as ic
    from spf_tpu_torch.runtime.fhe_circuit import CtType, FheCircuit, FheEdge, FheOp

    n_inst = max(1, 64 // width)
    if op == "add":
        circuit, fn = ic.ripple_carry_adder(width, emit_carry=True), lambda a, b: a + b
    else:
        circuit, fn = ic.unsigned_multiplier(width, width), lambda a, b: a * b
    g = FheCircuit()
    sel_all = []
    for r in range(2 * width * n_inst):
        nd = g.add_node(FheOp.INPUT_LWE0, f"b{r}")
        sel_all.append(g.insert_ciphertext_conversion(nd, CtType.LWE0, CtType.GGSW1))
    out_keys = []
    for j in range(n_inst):
        outs = g.insert_mux_circuit(circuit, [sel_all[i * n_inst + j] for i in range(2 * width)])
        for wi, o in enumerate(outs):
            on = g.add_node(FheOp.OUTPUT_GLWE1, f"o{j}_{wi}")
            g.add_edge(o, on, FheEdge.UNARY)
            out_keys.append((j, wi, f"o{j}_{wi}"))
    return g, out_keys, n_inst, fn


def intop_inputs(rng, lwe_sk: np.ndarray, lwe, width: int, n_inst: int):
    """bench.py:566-581: operand values from seed 11, their bits
    input-major (bit idx of every instance, a's bits then b's) encrypted
    under L0 as bit << 63. Returns (a, b, {"b{r}": u64 [n0+1]})."""
    from spf_tpu_torch.ops import encryption

    rng2 = np.random.default_rng(11)
    a_vals = rng2.integers(0, 1 << width, n_inst, dtype=np.uint64)
    b_vals = rng2.integers(0, 1 << width, n_inst, dtype=np.uint64)
    bits = [(int(a_vals[j] if idx < width else b_vals[j]) >> (idx % width)) & 1
            for idx in range(2 * width) for j in range(n_inst)]
    rows = encryption.encrypt_lwe_np(rng, np.array(bits, dtype=np.uint64) << np.uint64(63),
                                     lwe_sk, lwe)
    return a_vals, b_vals, {f"b{r}": rows[r] for r in range(rows.shape[0])}


def bit_and_margin(ct: np.ndarray, glwe_sk: np.ndarray, glwe, want: int):
    """bench.py:667-690: a GLWE bit's phase at coefficient 0, the bit it
    decodes to and its noise margin (bits to the 2^62 decision boundary,
    against the expected bit `want`)."""
    from spf_tpu_torch.utils import host_crypto as hc

    phase = int(hc.decrypt_glwe_np(ct, glwe_sk, glwe)[0])
    err = (phase - (want << 63)) % (1 << 64)
    err = min(err, (1 << 64) - err)
    return ((phase >> 63) + ((phase >> 62) & 1)) & 1, 62 - float(np.log2(max(err, 1)))


def intop_decode(res: dict, out_keys, glwe_sk: np.ndarray, glwe, expected):
    """Each output bit of every instance and its noise margin. Returns
    (values, n_correct, margins)."""
    sums = [0] * len(expected)
    margins = []
    for j, wi, okey in out_keys:
        bit, margin = bit_and_margin(res[okey], glwe_sk, glwe, (expected[j] >> wi) & 1)
        sums[j] |= bit << wi
        margins.append(margin)
    return sums, sum(int(s == e) for s, e in zip(sums, expected)), margins


def cbs_launches(p) -> dict:
    """Kernel launches of one circuit bootstrap (multi-bit rotation at
    GROUP_CBS, the trace, the scheme switch), whatever its width."""
    from spf_tpu_torch.ops.multibit import n_groups

    ng = n_groups(p.l0_params.dim, GROUP_CBS)
    rounds = p.l1_params.log_degree * p.cbs_radix.count  # the trace's GLWE keyswitches
    return dict(accumulate_decompose=ng, mad_horner_g2=ng, phase_factors=1,
                fwd_ds=ng + rounds + 3,  # rotation, trace, scheme switch (b, digits, GLEV)
                inv_ds=ng + rounds,  # rotation, trace
                freq_mad_ks=rounds + p.l1_params.size,  # the trace, the scheme switch's rows
                ks_decompose=rounds + 1,  # the trace, the scheme switch
                ks_round_add=rounds)  # the trace


def schedule_launches(p, *scheds) -> dict:
    """The launches wave machine runs of `scheds` make: a CBS for every
    cbs, convert and refresh wave; a forward FFT, a batched-row MAD and an
    inverse FFT for every CMux and external product (8 stacked CMux waves
    for a cmux_scan; the refresh's external product of ONE)."""
    counts = dict.fromkeys(("fwd_ds", "inv_ds", "freq_mad_batched"), 0)
    for w in (w for sched in scheds for w in sched.waves):
        prods = {"cmux": 1, "extprod": 1, "refresh": 1}.get(w.group, 0)
        if w.group == "cmux_scan":
            prods = len(w.idx["out"])
        if w.group in ("cbs", "convert", "refresh"):
            for name, n in cbs_launches(p).items():
                counts[name] = counts.get(name, 0) + n
        for name in ("fwd_ds", "inv_ds", "freq_mad_batched"):
            counts[name] += prods
    return expect_launches(**counts)


def phase_small_wave_machine():
    """The wave machine and the per-wave executor on the card and on the
    CPU at a small size (DEFAULT_128's radices, N = 256, n0 = 8): a u2 add
    and a NOT through fluent graphs, bit-identical outputs on both devices
    and both executors, decrypting right."""
    from spf_tpu_torch.ops import encryption
    from spf_tpu_torch.runtime.executor_u32 import U32CircuitExecutor, U32ComputeKey
    from spf_tpu_torch.runtime.fhe_circuit import FheEdge, FheOp
    from spf_tpu_torch.runtime.fluent import FheCircuitCtx, UInt
    from spf_tpu_torch.runtime.wave_machine import WaveMachine
    from spf_tpu_torch.utils import host_crypto as hc

    p = small_cycle_params()
    glwe = p.l1_params
    rng = np.random.default_rng(SEED + 5)
    lwe_sk = rng.integers(0, 2, p.l0_params.dim).astype(np.int64)
    glwe_sk, *keys = cycle_keys(p, lwe_sk, torch.Generator().manual_seed(SEED + 5))
    g01 = encryption.encrypt_ggsw_scalar(torch.tensor([0, 1]), glwe_sk, glwe, p.cbs_radix,
                                         torch.Generator().manual_seed(SEED + 6))
    sk = glwe_sk.numpy().astype(np.uint64)
    ctx = FheCircuitCtx()
    a, b = UInt.input(ctx, 2), UInt.input(ctx, 2)
    out_keys = (a + b).output()
    nt = ctx.circuit.add_node(FheOp.NOT)
    ctx.circuit.add_edge(a.bits[0], nt, FheEdge.UNARY)
    o = ctx.circuit.add_node(FheOp.OUTPUT_GLWE1, "not_a0")
    ctx.circuit.add_edge(nt, o, FheEdge.UNARY)
    a_val, b_val = 3, 2
    cts = hc.encrypt_uint_bits_np(rng, a_val, 2, sk, glwe) + hc.encrypt_uint_bits_np(rng, b_val, 2, sk, glwe)
    inputs = dict(zip(a.input_keys() + b.input_keys(), cts))
    outs = {}
    for dev in ("cpu", "cuda"):
        key = U32ComputeKey.from_coeff(*keys, g01[0], g01[1], device=dev)
        outs[f"wave_machine {dev}"] = WaveMachine(key, p).run(ctx.circuit, inputs)
        outs[f"per-wave {dev}"] = U32CircuitExecutor(key, p).run(ctx.circuit, inputs)
    ref = outs["wave_machine cpu"]
    exact = {name: all(np.array_equal(o[k], ref[k]) for k in ref) for name, o in outs.items()}
    got = hc.decrypt_uint_bits_np([ref[k] for k in out_keys], sk, glwe)
    not_a0 = hc.decrypt_glwe_bit_np(ref["not_a0"], sk, glwe)
    res = emit(dict(phase="small_wave_machine", n=glwe.degree, n0=p.l0_params.dim,
                    bitexact_vs_wave_machine_cpu=exact, sum=got, want=(a_val + b_val) % 4,
                    not_a0=not_a0))
    if not all(exact.values()) or got != (a_val + b_val) % 4 or not_a0 != 1 - (a_val & 1):
        raise AssertionError(f"small wave machine: {res}")


@dataclasses.dataclass
class WaveKeys:
    """The keys of paths 6 and 7, made once on the card: the cycle's
    (multi-bit bsk at g = 2, radix 4x8; ak, ssk, ksk) at DEFAULT_128."""

    key: object  # U32ComputeKey
    glwe_sk: torch.Tensor
    lwe_sk: np.ndarray
    rng: np.random.Generator
    gen: torch.Generator
    keygen_s: float
    convert_s: float


def wave_keys() -> WaveKeys:
    from spf_tpu_torch.params import DEFAULT_128
    from spf_tpu_torch.runtime.executor_u32 import U32ComputeKey

    p = DEFAULT_128
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rng = np.random.default_rng(20240817)
    lwe_sk = rng.integers(0, 2, p.l0_params.dim).astype(np.int64)
    t0 = time.perf_counter()
    glwe_sk, bsk, ak, ssk, ksk = cycle_keys(p, lwe_sk, gen)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    key = U32ComputeKey.from_coeff(bsk, ak, ssk, ksk)
    torch.cuda.synchronize()
    return WaveKeys(key, glwe_sk, lwe_sk, rng, gen, keygen_s, time.perf_counter() - t0)


def phase_intop(keys: WaveKeys):
    """Path 6: bench.py --intop's add8, mul8 and mul16 at DEFAULT_128 through
    the port's WaveMachine (bench.py:536-720): the cycle's keys on the card
    (refresh every 64 CMuxes), 128 L0 bits encrypted on the host, one
    FheCircuit holding every instance; a first call with the launch counts
    read around it and held against the schedule's, decryption (every
    instance right, worst margin >= 2 bits, beside the TPU's), wave
    statistics beside the TPU's, add8 also through the per-wave
    U32CircuitExecutor (the same decryption), then a second call (it
    captures the schedule's CUDA graphs), the median latency of
    TIMED_CALLS calls (replays) and one profiled call."""
    from spf_tpu_torch.runtime.executor_u32 import U32CircuitExecutor
    from spf_tpu_torch.runtime.wave_machine import WaveMachine
    from spf_tpu_torch.params import DEFAULT_128

    p = DEFAULT_128
    lwe, glwe = p.l0_params, p.l1_params
    key, lwe_sk, rng = keys.key, keys.lwe_sk, keys.rng
    keygen_s, convert_s = keys.keygen_s, keys.convert_s
    sk = keys.glwe_sk.cpu().numpy().astype(np.uint64)
    wm = WaveMachine(key, p)
    by_path, failures = {}, []
    for op, width in INTOPS:
        name = f"{op}{width}"
        t0 = time.perf_counter()
        g, out_keys, n_inst, fn = intop_graph(op, width)
        sched = wm.schedule(g)
        build_s = time.perf_counter() - t0
        a_vals, b_vals, inputs = intop_inputs(rng, lwe_sk, lwe, width, n_inst)
        expected = [fn(int(x), int(y)) for x, y in zip(a_vals, b_vals)]
        wm.wave_log.clear()
        res, first_s, launches, peak_gib = drive(lambda: wm.run(g, inputs),
                                                 schedule_launches(p, sched), f"path 6 ({name})")
        stats = wm.wave_stats()
        values, n_ok, margins = intop_decode(res, out_keys, sk, glwe, expected)
        row = dict(
            phase="intop", path="wave machine", workload=name, params="DEFAULT_128",
            group=GROUP_CBS, cbs_pbs_radix="4x8", batch=n_inst, input_bits=len(inputs),
            schedule_s=build_s, slot_counts=sched.slot_counts, keygen_s=keygen_s,
            key_conversion_s=convert_s, first_call_s=first_s, correct=f"{n_ok}/{n_inst}",
            noise_margin_bits_worst=min(margins),
            noise_margin_bits_median=float(np.median(margins)), tpu=TPU_INTOP[name],
            wave_stats=stats, mean_cmux_batch=stats.get("cmux", {}).get("mean_batch"),
            mean_cbs_batch=stats.get("cbs", {}).get("mean_batch"),
            launches={k: v for k, v in launches.items() if v}, peak_device_mem_gib=peak_gib)
        if name == "add8":
            per_wave = U32CircuitExecutor(key, p).run(g, inputs)
            pw_values, pw_ok, _ = intop_decode(per_wave, out_keys, sk, glwe, expected)
            row["per_wave_executor"] = dict(correct=f"{pw_ok}/{n_inst}",
                                            same_values=pw_values == values)
            if pw_values != values:
                failures.append(f"add8: the per-wave executor decrypts {pw_values}, the wave "
                                f"machine {values}")
        wm.run(g, inputs)
        times, device_call_ms, by_kernel, glue, port_us = wall_and_device(
            lambda: wm.run(g, inputs), TIMED_CALLS[name])
        med = statistics.median(times)
        row.update(
            latency_s=med, call_s=times, device_ms_per_call=device_call_ms,
            device_busy_share=device_call_ms / 1e3 / med, device_ms_by_kernel=by_kernel,
            glue=glue, port_kernel_us_per_launch=port_us,
            bench_line=dict(metric=f"encrypted_u{width}_{op}s_per_sec_per_chip",
                            value=n_inst / med, unit=f"u{width} {op}s/s", batch=n_inst,
                            latency_s=med, backend="spf_tpu_torch", platform="gpu",
                            correct=f"{n_ok}/{n_inst}", executor="wave_machine",
                            mean_cmux_batch=row["mean_cmux_batch"],
                            mean_cbs_batch=row["mean_cbs_batch"],
                            noise_margin_bits_worst=min(margins),
                            noise_margin_bits_median=float(np.median(margins))))
        emit(row)
        by_path[f"intop {name}"] = launches
        if n_ok != n_inst or min(margins) < MIN_INTOP_MARGIN_BITS:
            failures.append(f"{name}: {n_ok}/{n_inst} correct, worst margin {min(margins):.2f} bits")
    if failures:
        raise AssertionError(f"path 6 (intop): {failures}")
    return by_path


# bench.py --program mul32 (bench.py:1245-1280): five instructions (load,
# load, Mul, store, ret) on two encrypted u32 arguments, host-encrypted
# from bench's seed
MUL32 = (51977, 40961)
MUL32_SEED = 20260818
MUL32_TIMED_CALLS = 3
MIN_PROGRAM_MARGIN_BITS = 2.0
# the JAX scheduler's statistics of the JAX FheComputer's mul32 graph
# (tests/test_torch_cpu.py holds them, and the port's, equal)
MUL32_WAVE_STATS = {
    "convert": {"waves": 5, "gates": 128, "mean_batch": 25.6, "max_batch": 64},
    "cmux": {"waves": 721, "gates": 44860, "mean_batch": 62.2, "max_batch": 222},
    "refresh": {"waves": 19, "gates": 1145, "mean_batch": 60.3, "max_batch": 222},
}
# the TPU's record of the same program (BENCH_SUITE.json mul32; its wave
# statistics summed over 3 runs of an older scheduler): a correctness
# reference, never a target
TPU_MUL32 = dict(correct=True, got=2129029897, latency_s=8.928, mean_cmux_batch=48.7)


def cpu_programs():
    """The encrypted programs of tests/test_cpu.py that path 7 runs after
    mul32, and one whose Dbg handler flushes mid-program: (name, program
    builder over Asm, argument values (u8, encrypted), the value it returns,
    the value the Dbg handler sees or None, flushes)."""
    from spf_tpu_torch.cpu.isa import RP, SP

    def load2(a):
        return a.load(1, SP, 8, offset=0).load(2, SP, 8, offset=1)

    return [
        ("add_u8", lambda a: load2(a).add(3, 1, 2).store(RP, 3, 8).ret(), (42, 54), 96, None, 1),
        ("max_cmpgt_cmux", lambda a: load2(a).cmp_gt(3, 1, 2).cmux(4, 3, 1, 2).store(RP, 4, 8)
         .ret(), (57, 201), 201, None, 1),
        ("mul_by_plain_3", lambda a: a.load(1, SP, 8, offset=0).loadi(2, 3, 8).mul(3, 1, 2)
         .store(RP, 3, 8).ret(), (21,), 63, None, 1),
        ("dbg_two_flushes", lambda a: load2(a).add(3, 1, 2).dbg(3, 7).xor(4, 3, 1)
         .store(RP, 4, 8).ret(), (42, 54), 96 ^ 42, 96, 2),
    ]


class GraphRecorder:
    """A circuit executor that keeps each flush's circuit and answers with
    zero GLWE arrays: the graphs a program builds (their structure does not
    depend on the values), with the time to build them, and no crypto."""

    def __init__(self, glwe):
        self.shape = (glwe.size + 1, glwe.degree)
        self.circuits = []

    def run(self, circuit, inputs):
        self.circuits.append(circuit)
        return {n.param: np.zeros(self.shape, np.uint64) for n in circuit.nodes
                if n.op.name == "OUTPUT_GLWE1"}


def phase_cpu(keys: WaveKeys):
    """Path 7: the encrypted Parasol CPU (`spf_tpu_torch.cpu.FheComputer`)
    on the port's WaveMachine at DEFAULT_128, through the entry points a
    user calls: `FheComputer(U32HostEvaluation(p), executor=WaveMachine(key,
    p))`, with path 6's keys plus GGSW encryptions of 0 and 1 at cbs_radix
    made on the card. bench.py --program mul32 first: its graph built once
    with a recording executor (seconds) and scheduled (seconds, launches
    expected), a first call with the launch counts read around it, all 4
    return bytes encrypted and decrypting to a * b mod 2^32 with every bit's
    margin >= 2 bits, gas 500003, one flush, the wave statistics equal to
    the JAX scheduler's; then the median latency of MUL32_TIMED_CALLS calls
    (the graph built anew, the schedule cached, the host encryption apart)
    and one profiled call. Then the programs of `cpu_programs()`, each with
    its launch counts read around it, decrypting right with margins >= 2."""
    from spf_tpu_torch.cpu import ArgsBuilder, FheComputer, Memory
    from spf_tpu_torch.cpu.isa import RP, SP, Asm
    from spf_tpu_torch.cpu.memory import EncByte
    from spf_tpu_torch.ops import encryption
    from spf_tpu_torch.ops.bootstrap import bsk_to_freq
    from spf_tpu_torch.params import DEFAULT_128
    from spf_tpu_torch.runtime.executor_u32 import U32HostEvaluation
    from spf_tpu_torch.runtime.wave_machine import WaveMachine, build_schedule
    from spf_tpu_torch.utils import host_crypto as hc

    p = DEFAULT_128
    glwe = p.l1_params
    t0 = time.perf_counter()
    g01 = encryption.encrypt_ggsw_scalar(torch.tensor([0, 1], device="cuda"), keys.glwe_sk, glwe,
                                         p.cbs_radix, keys.gen)
    key = dataclasses.replace(keys.key, ggsw_zero_freq=bsk_to_freq(g01[0]),
                              ggsw_one_freq=bsk_to_freq(g01[1]))
    torch.cuda.synchronize()
    ggsw_s = time.perf_counter() - t0
    del g01
    sk = keys.glwe_sk.cpu().numpy().astype(np.uint64)
    wm = WaveMachine(key, p)

    def run(build, cts, ret_bytes, executor, dbg=None):
        mem = Memory()
        entry = mem.allocate_program(build(Asm()).instrs)
        proc = FheComputer(U32HostEvaluation(p), executor=executor)
        if dbg is not None:
            proc.debug_handlers[7] = dbg
        call = ArgsBuilder()
        for c in cts:
            call = call.arg_encrypted(c)
        rp = proc.run_program(entry, mem, call.return_value(8 * ret_bytes).build())
        return mem, rp, proc

    def read(mem, rp, n, value):
        """The return value and each bit's margin against `value`'s bit."""
        got, margins = 0, []
        for i in range(n):
            byte = mem.load_byte(rp + i)
            if not isinstance(byte, EncByte):
                raise AssertionError(f"path 7: return byte {i} is not encrypted: {byte!r}")
            for j, ct in enumerate(byte.bits):
                bit, margin = bit_and_margin(ct, sk, glwe, (value >> (8 * i + j)) & 1)
                got |= bit << (8 * i + j)
                margins.append(margin)
        return got, margins

    def graphs(build, cts, ret_bytes, dbg=None):
        """The circuits of the program's flushes and the seconds to build them."""
        rec = GraphRecorder(glwe)
        t0 = time.perf_counter()
        run(build, cts, ret_bytes, rec, dbg)
        return rec.circuits, time.perf_counter() - t0

    def expected_launches(build, cts, ret_bytes, dbg=None):
        circuits, graph_s = graphs(build, cts, ret_bytes, dbg)
        t0 = time.perf_counter()
        scheds = [build_schedule(c) for c in circuits]
        return schedule_launches(p, *scheds), graph_s, time.perf_counter() - t0

    # bench.py --program mul32
    rng = np.random.default_rng(MUL32_SEED)
    a_v, b_v = MUL32
    want = (a_v * b_v) & 0xFFFFFFFF
    t0 = time.perf_counter()
    cts = [hc.encrypt_uint_bits_np(rng, v, 32, sk, glwe) for v in MUL32]
    encrypt_s = time.perf_counter() - t0

    def mul32_program(a):
        return (a.load(1, SP, 32, offset=0).load(2, SP, 32, offset=4).mul(3, 1, 2)
                .store(RP, 3, 32).ret())

    launches_want, graph_s, schedule_s = expected_launches(mul32_program, cts, 4)
    wm.wave_log.clear()
    (mem, rp, proc), first_s, launches, peak_gib = drive(
        lambda: run(mul32_program, cts, 4, wm), launches_want, "path 7 (cpu mul32)")
    stats = wm.wave_stats()
    got, margins = read(mem, rp, 4, want)
    times, device_call_ms, by_kernel, glue, port_us = wall_and_device(
        lambda: run(mul32_program, cts, 4, wm), MUL32_TIMED_CALLS)
    med = statistics.median(times)
    _, graph_again_s = graphs(mul32_program, cts, 4)
    row = dict(
        phase="cpu", path="encrypted CPU", program="mul32", params="DEFAULT_128",
        group=GROUP_CBS, cbs_pbs_radix="4x8", a=a_v, b=b_v, got=got, want=want,
        correct=got == want, noise_margin_bits_worst=min(margins),
        noise_margin_bits_median=float(np.median(margins)), gas_used=proc.gas_used,
        flush_count=proc.flush_count, ggsw_consts_s=ggsw_s, first_call_s=first_s,
        wave_stats=stats, wave_stats_jax=MUL32_WAVE_STATS,
        launches={k: v for k, v in launches.items() if v}, peak_device_mem_gib=peak_gib,
        latency_s=med, call_s=times, device_ms_per_call=device_call_ms,
        device_busy_share=device_call_ms / 1e3 / med, device_ms_by_kernel=by_kernel, glue=glue,
        port_kernel_us_per_launch=port_us, tpu=TPU_MUL32)
    emit(row)
    # bench's run_once times the host encryption and the graph build too;
    # the first graph build also makes the circuits that no path built before
    emit(dict(phase="cpu", program="mul32", host_encrypt_s=encrypt_s, graph_build_s=graph_s,
              graph_build_again_s=graph_again_s, schedule_s=schedule_s, latency_s=med,
              latency_with_host_encrypt_s=med + encrypt_s))
    failures = []
    if got != want or min(margins) < MIN_PROGRAM_MARGIN_BITS:
        failures.append(f"mul32: got {got}, want {want}, worst margin {min(margins):.2f} bits")
    if (proc.gas_used, proc.flush_count) != (500_003, 1):
        failures.append(f"mul32: gas {proc.gas_used}, flushes {proc.flush_count}")
    if stats != MUL32_WAVE_STATS:
        failures.append(f"mul32: wave statistics {stats}, the JAX scheduler's {MUL32_WAVE_STATS}")
    by_path = {"cpu mul32": launches}

    for name, build, values, value, dbg_want, flushes in cpu_programs():
        cts = [hc.encrypt_uint_bits_np(rng, v, 8, sk, glwe) for v in values]
        dbg_seen = []

        def dbg(v):
            dbg_seen.append(hc.decrypt_uint_bits_np(list(v.bits), sk, glwe))

        dbg_fn = dbg if dbg_want is not None else None
        want_l, _, _ = expected_launches(build, cts, 1, dbg_fn)
        dbg_seen.clear()
        (mem, rp, proc), first_s, launches, _ = drive(lambda: run(build, cts, 1, wm, dbg_fn),
                                                     want_l, f"path 7 (cpu {name})")
        got, margins = read(mem, rp, 1, value)
        emit(dict(phase="cpu", program=name, params="DEFAULT_128", args=list(values), got=got,
                  want=value, dbg_seen=dbg_seen, flush_count=proc.flush_count,
                  gas_used=proc.gas_used, noise_margin_bits_worst=min(margins),
                  noise_margin_bits_median=float(np.median(margins)), first_call_s=first_s,
                  launches={k: v for k, v in launches.items() if v}))
        by_path[f"cpu {name}"] = launches
        if got != value or min(margins) < MIN_PROGRAM_MARGIN_BITS or proc.flush_count != flushes \
                or dbg_seen != ([dbg_want] if dbg_want is not None else []):
            failures.append(f"{name}: got {got}, want {value}, worst margin {min(margins):.2f}, "
                            f"flushes {proc.flush_count}, Dbg saw {dbg_seen}")
    if failures:
        raise AssertionError(f"path 7 (encrypted CPU): {failures}")
    return by_path


U64_SEED = 20261017
U64_TIMED_CALLS = 3
MIN_U64_MARGIN_BITS = 2.0


def phase_u64_api(hw):
    """Path 8: the README quick start through the port's u64 API at
    DEFAULT_128 on the card, then the encrypted CPU on its default
    executor. `generate_keys` from a seeded generator on the card,
    `Evaluation(ck, DEFAULT_128)` (its GGSW(0) / GGSW(1) by CBS), the u8
    add 42 + 54 of `runtime.fluent` through `CircuitExecutor(ev).run`
    with the launch counts read around it (the c128 path launches none of
    the port's kernels: all 0), decrypting to 96 with every output bit's
    margin >= 2 bits; the median latency of U64_TIMED_CALLS synchronised
    runs and one profiled run. Then path 7's add program (`cpu.isa`) through
    `FheComputer(ev)` with no executor, its return decrypting to 96 via
    `decrypt_return`. Raises on any failure."""
    from spf_tpu_torch.cpu import ArgsBuilder, FheComputer, Memory
    from spf_tpu_torch.cpu.args import decrypt_return
    from spf_tpu_torch.cpu.isa import RP, SP, Asm
    from spf_tpu_torch.cpu.memory import EncByte
    from spf_tpu_torch.ops import torus
    from spf_tpu_torch.params import DEFAULT_128
    from spf_tpu_torch.runtime import Evaluation, generate_keys
    from spf_tpu_torch.runtime.executor import CircuitExecutor
    from spf_tpu_torch.runtime.fluent import FheCircuitCtx, UInt

    p = DEFAULT_128
    glwe = p.l1_params
    a_v, b_v, want = 42, 54, 96
    gen = torch.Generator(device="cuda").manual_seed(U64_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sk, pk, ck = generate_keys(gen, p)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev = Evaluation(ck, p)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    glwe_sk = torus.to_u64_np(sk.glwe_1)

    ctx = FheCircuitCtx()
    a, b = UInt.input(ctx, 8), UInt.input(ctx, 8)
    out_keys = (a + b).output()
    x = ev.enc.encrypt_uint_bits(gen, a_v, 8, sk)
    y = ev.enc.encrypt_uint_bits(gen, b_v, 8, sk)
    inputs = dict(zip(a.input_keys() + b.input_keys(), x + y))
    ex = CircuitExecutor(ev, debug=True)
    outs, first_s, launches, peak_gib = drive(lambda: ex.run(ctx.circuit, inputs),
                                              expect_launches(), "path 8 (quick start)")
    got = ev.enc.decrypt_uint_bits([outs[k] for k in out_keys], sk)
    margins = [bit_and_margin(torus.to_u64_np(outs[k]), glwe_sk, glwe, (want >> i) & 1)[1]
               for i, k in enumerate(out_keys)]
    waves = {}
    for op, _, gates in ex.debug_log:
        if op in ("cbs", "cmux", "keyswitch", "sample_extract"):
            waves.setdefault(op, []).append(gates)
    times, device_call_ms, by_kernel, glue, _ = wall_and_device(
        lambda: ex.run(ctx.circuit, inputs), U64_TIMED_CALLS)
    med = statistics.median(times)
    t0 = time.perf_counter()  # the set-up again, past every first use
    Evaluation(ck, p)
    torch.cuda.synchronize()
    setup_again_s = time.perf_counter() - t0
    emit(dict(phase="u64_api", path="u64 API (README quick start)", params="DEFAULT_128",
              backend=ev.be.name, card=hw["nvidia_smi"], a=a_v, b=b_v, got=got, want=want,
              correct=got == want, noise_margin_bits_worst=min(margins),
              noise_margin_bits_median=float(np.median(margins)), keygen_s=keygen_s,
              evaluation_setup_s=setup_s, evaluation_setup_again_s=setup_again_s,
              first_call_s=first_s, latency_s=med, call_s=times,
              device_ms_per_call=device_call_ms, device_busy_share=device_call_ms / 1e3 / med,
              device_launches_per_call=glue["launches"], device_ms_by_kernel=by_kernel,
              waves={op: dict(waves=len(g), gates=sum(g)) for op, g in waves.items()},
              port_kernel_launches={k: v for k, v in launches.items() if v},
              peak_device_mem_gib=peak_gib))

    mem = Memory()
    entry = mem.allocate_program(Asm().load(1, SP, 8, offset=0).load(2, SP, 8, offset=1)
                                 .add(3, 1, 2).store(RP, 3, 8).ret().instrs)
    call = ArgsBuilder().arg_encrypted(x).arg_encrypted(y).return_value(8).build()
    proc = FheComputer(ev)
    rp, cpu_s, cpu_launches, _ = drive(lambda: proc.run_program(entry, mem, call),
                                       expect_launches(), "path 8 (cpu default executor)")
    cpu_got = decrypt_return(mem, rp, 1, ev.enc, sk)
    byte = mem.load_byte(rp)
    cpu_margins = [bit_and_margin(torus.to_u64_np(ct), glwe_sk, glwe, (want >> j) & 1)[1]
                   for j, ct in enumerate(byte.bits)] if isinstance(byte, EncByte) else [-1.0]
    emit(dict(phase="u64_api", path="encrypted CPU, default executor", program="add_u8",
              params="DEFAULT_128", card=hw["nvidia_smi"], executor=type(proc.ex).__name__,
              got=cpu_got, want=want, correct=cpu_got == want, flush_count=proc.flush_count,
              noise_margin_bits_worst=min(cpu_margins), call_s=cpu_s))
    failures = []
    if got != want or min(margins) < MIN_U64_MARGIN_BITS:
        failures.append(f"quick start: got {got}, want {want}, worst margin {min(margins):.2f}")
    if not isinstance(proc.ex, CircuitExecutor) or cpu_got != want \
            or min(cpu_margins) < MIN_U64_MARGIN_BITS:
        failures.append(f"cpu default executor {type(proc.ex).__name__}: got {cpu_got}, "
                        f"want {want}, worst margin {min(cpu_margins):.2f}")
    if failures:
        raise AssertionError(f"path 8 (u64 API): {failures}")
    return {"u64 quick start": launches, "u64 cpu": cpu_launches}, (sk, pk, ev)


PFKS_SEED = 20261018
PFKS_BITS = (0, 1, 1, 0, 1, 0, 0, 1)  # 8 encrypted bits, 4 of each value
PFKS_MSGS = (0, 1, 2, 3)  # the private keyswitch's 2-bit messages; the public one takes 3
MIN_PFKS_MARGIN_BITS = 2.0


def host_margins(ct, glwe_sk: np.ndarray, glwe, want: np.ndarray, plain_bits: int):
    """A GLWE int64 [k+1, N] decrypted on the host: (decoded plaintext
    bits [N], worst margin: bits between the largest phase error and the
    decision boundary 2^(63 - plain_bits), against the expected `want`)."""
    from spf_tpu_torch.ops import torus
    from spf_tpu_torch.utils import host_crypto as hc

    phase = hc.decrypt_glwe_np(torus.to_u64_np(ct), glwe_sk, glwe)
    shift = np.uint64(64 - plain_bits)
    got = ((phase + (np.uint64(1) << (shift - np.uint64(1)))) >> shift).astype(np.int64)
    err = (phase - (want.astype(np.uint64) << shift)).astype(np.int64)
    worst = max(int(np.abs(err.astype(np.float64)).max()), 1)
    return got % (1 << plain_bits), 63 - plain_bits - float(np.log2(worst))


def phase_pfks(hw, sk, pk, ev):
    """Path 9: circuit bootstrapping v1 through the private functional
    keyswitch (`ops.u64.pfks`), the public functional keyswitch and the
    one-time pad (`runtime.recryption`) at DEFAULT_128 on path 8's keys
    (the c128 backend: torch.fft and elementwise PyTorch, so every port
    kernel's launch count stays 0, read around each call). The CBS-PFKS
    keys (k + 1 = 2 keys of [1, 2049, 2, 2, 2048] int64) and a bootstrap
    key at `pbs_radix` made on the card (seconds printed); CBS v1 of
    PFKS_BITS in one batched call with `pbs_radix`, `cbs_radix` and
    `pfks_radix`; a CMux of two L1 GLWEs of complementary random bits
    through each GGSW, decrypted on the host: every coefficient the GLWE
    its bit selects, worst margin >= 2 bits; the latency of one more
    synchronised CBS-PFKS call. Then the private keyswitch (the CBS key's
    identity-map row k) of four L1 LWEs (dimension k·N) of 2-bit messages in
    one call and the public keyswitch (its key made on the card, identity
    map) of one, each decrypting right with a margin >= 2 bits, and the
    one-time pad round trip (pad, packed public encryption, recrypt,
    decrypt, pad removed) exact. Raises on any failure."""
    from spf_tpu_torch.ops.u64 import encryption as enc
    from spf_tpu_torch.ops.u64 import fft_ops, pfks
    from spf_tpu_torch.ops.u64 import torus as t64
    from spf_tpu_torch.params import DEFAULT_128
    from spf_tpu_torch.runtime import (decrypt_one_time_pad, generate_one_time_pad,
                                       recrypt_one_time_pad)

    p = DEFAULT_128
    glwe, lwe0 = p.l1_params, p.l0_params
    from_lwe = glwe.as_lwe_def()
    n = glwe.degree
    gen = torch.Generator(device="cuda").manual_seed(PFKS_SEED)
    glwe_sk = sk.glwe_1.cpu().numpy().astype(np.uint64)
    failures = []

    def keygen(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    cbs_keys, cbs_keygen_s = keygen(lambda: pfks.generate_cbs_pfks_keys(
        gen, sk.lwe_1, sk.glwe_1, from_lwe, glwe, p.pfks_radix))
    bsk, bsk_keygen_s = keygen(lambda: pfks.generate_bootstrap_key(
        gen, sk.lwe_0, sk.glwe_1, lwe0, glwe, p.pbs_radix))
    bits = torch.tensor(PFKS_BITS, device="cuda")
    ct = ev.enc.encrypt_lwe_l0(gen, bits, sk)

    def cbs():
        return pfks.circuit_bootstrap_via_pfks(ct, bsk, cbs_keys, lwe0, glwe, glwe, p.pbs_radix,
                                               p.cbs_radix, p.pfks_radix)

    ggsw, first_s, launches, peak_gib = drive(cbs, expect_launches(), "path 9 (CBS via PFKS)")
    m0 = torch.randint(0, 2, (n,), generator=gen, device="cuda")
    d0, d1 = (ev.enc.encrypt_glwe_l1(gen, m, sk) for m in (m0, 1 - m0))
    sel, _, cmux_launches, _ = drive(
        lambda: fft_ops.cmux(d0, d1, fft_ops.ggsw_to_fft(ggsw), glwe, p.cbs_radix),
        expect_launches(), "path 9 (CMux)")
    selected, margins = 0, []
    for b, bit in enumerate(PFKS_BITS):
        want = (m0 if bit == 0 else 1 - m0).cpu().numpy()
        got, margin = host_margins(sel[b], glwe_sk, glwe, want, 1)
        selected += bool((got == want).all())
        margins.append(margin)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cbs()
    torch.cuda.synchronize()
    latency_s = time.perf_counter() - t0
    if selected != len(PFKS_BITS) or min(margins) < MIN_PFKS_MARGIN_BITS:
        failures.append(f"CBS via PFKS: {selected}/{len(PFKS_BITS)} selected right, worst "
                        f"margin {min(margins):.2f}")
    emit(dict(phase="pfks", path="CBS v1 via PFKS", params="DEFAULT_128",
              card=hw["nvidia_smi"], bits=len(PFKS_BITS),
              cbs_pfks_key_shape=list(cbs_keys.shape), cbs_pfks_keygen_s=cbs_keygen_s,
              pbs_bsk_keygen_s=bsk_keygen_s, first_call_s=first_s, latency_s=latency_s,
              selected=f"{selected}/{len(PFKS_BITS)}", noise_margin_bits_worst=min(margins),
              noise_margin_bits_median=float(np.median(margins)),
              port_kernel_launches={k: v for k, v in launches.items() if v},
              peak_device_mem_gib=peak_gib))

    msgs = torch.tensor(PFKS_MSGS, device="cuda")
    lwes = enc.encrypt_lwe(gen, t64.encode(msgs, 2), sk.lwe_1, from_lwe)  # [4, k*N+1]
    out, priv_s, priv_launches, _ = drive(
        lambda: pfks.private_functional_keyswitch(lwes[:, None, :], cbs_keys[glwe.size],
                                                  from_lwe, glwe, p.pfks_radix),
        expect_launches(), "path 9 (private keyswitch)")
    priv = [host_margins(out[i], glwe_sk, glwe, np.eye(1, n, dtype=np.int64)[0] * m, 2)
            for i, m in enumerate(PFKS_MSGS)]
    priv_ok = all(int(g[0]) == m and not g[1:].any() for (g, _), m in zip(priv, PFKS_MSGS))
    pufksk, pub_keygen_s = keygen(lambda: pfks.generate_public_functional_keyswitch_key(
        gen, sk.lwe_1, sk.glwe_1, from_lwe, glwe, p.pfks_radix))
    out, pub_s, pub_launches, _ = drive(
        lambda: pfks.public_functional_keyswitch(lwes[3][None, :], pufksk,
                                                 lambda s: pfks.constant_map(s, n), from_lwe,
                                                 glwe, p.pfks_radix),
        expect_launches(), "path 9 (public keyswitch)")
    del pufksk
    pub_got, pub_margin = host_margins(out, glwe_sk, glwe, np.eye(1, n, dtype=np.int64)[0] * 3, 2)
    pub_ok = int(pub_got[0]) == 3 and not pub_got[1:].any()
    priv_margin = min(m for _, m in priv)
    if not priv_ok or priv_margin < MIN_PFKS_MARGIN_BITS:
        failures.append(f"private keyswitch: right {priv_ok}, worst margin {priv_margin:.2f}")
    if not pub_ok or pub_margin < MIN_PFKS_MARGIN_BITS:
        failures.append(f"public keyswitch: right {pub_ok}, margin {pub_margin:.2f}")

    packed = torch.randint(0, 2, (n,), generator=gen, device="cuda")

    def otp():
        public, secret = generate_one_time_pad(gen, ev.enc, pk)
        recrypted = recrypt_one_time_pad(ev.enc.encrypt_packed_public(gen, packed, pk), public)
        padded = ev.enc.decrypt_glwe_l1(recrypted, sk)
        return padded, secret, decrypt_one_time_pad(padded, secret)

    (padded, secret, recovered), otp_s, otp_launches, _ = drive(
        otp, expect_launches(), "path 9 (one-time pad)")
    otp_ok = torch.equal(recovered, packed) and torch.equal(padded, packed ^ secret.key)
    if not otp_ok:
        failures.append("one-time pad: the round trip did not give the bits back")
    emit(dict(phase="pfks", path="functional keyswitches and one-time pad", card=hw["nvidia_smi"],
              private_keyswitch=dict(messages=list(PFKS_MSGS), right=priv_ok,
                                     noise_margin_bits_worst=priv_margin, call_s=priv_s),
              public_keyswitch=dict(message=3, right=pub_ok, noise_margin_bits=pub_margin,
                                    keygen_s=pub_keygen_s, call_s=pub_s),
              one_time_pad=dict(bits=n, exact=otp_ok, call_s=otp_s)))
    if failures:
        raise AssertionError(f"path 9 (PFKS, CBS v1, one-time pad): {failures}")
    return {"pfks cbs": launches, "pfks cmux": cmux_launches, "pfks private": priv_launches,
            "pfks public": pub_launches, "one-time pad": otp_launches}


NOISE_SEED = 20261019
NOISE_TRIALS = 2  # DEFAULT_128 trials a measurement (op_noise's own: 4)
NOISE_DEPTH = 8
MIN_NOISE_MARGIN_BITS = 2.0


def noise_margin_bits(log2_max: float) -> float:
    """Bits between the worst error and a 1-bit message's decision
    boundary q/4 = 2^62 (the message bit is 2^63)."""
    return 62.0 - log2_max


def phase_noise(hw, sk, pk, ev):
    """Path 10: empirical noise (`spf_tpu_torch.utils.noise`) on the card,
    every port kernel's launch count held at 0 around each call (c128 and
    host code only). op_noise's four measurements at its own PARAMS
    (`spf_tpu_torch.scripts.op_noise.measure`, keys made on the card), each
    log2 std and max; then at DEFAULT_128 on path 8's keys the GLWE
    encryption, the L1 -> L0 LWE keyswitch, a chain of NOISE_DEPTH CMuxes
    selecting 1 and a CMux behind a CBS, each log2 std beside the
    parameters' sigma and the model's failure exponent
    (`params.noise_exponent_at_depth`), each at least
    MIN_NOISE_MARGIN_BITS below the message's decision boundary; then a
    serialization round trip (`utils.serialization`) of path 8's
    keyswitch key, secret keys and one ciphertext of each kind,
    byte-identical, with their sizes. Raises on any failure."""
    import math

    from spf_tpu_torch.ops.u64 import encryption as enc
    from spf_tpu_torch.ops.u64 import torus as t64
    from spf_tpu_torch.params import DEFAULT_128, noise_exponent_at_depth
    from spf_tpu_torch.scripts import op_noise
    from spf_tpu_torch.utils import noise, serialization

    p, dev = ev.params, ev.device  # DEFAULT_128 on the card
    label = "DEFAULT_128" if p == DEFAULT_128 else repr(p)
    glwe = p.l1_params
    failures = []
    rows, op_s, op_launches, _ = drive(
        lambda: op_noise.measure(op_noise.PARAMS, depth=NOISE_DEPTH, trials=4, device=dev),
        expect_launches(), "path 10 (op_noise)")
    emit(dict(phase="noise", path="op_noise", params="op_noise.PARAMS", card=hw["nvidia_smi"],
              seconds=op_s, rows={r["op"]: dict(samples=r["samples"], log2_std=r["log2_std"],
                                                log2_max=r["log2_max"]) for r in rows}))
    if any(noise_margin_bits(r["log2_max"]) < MIN_NOISE_MARGIN_BITS for r in rows):
        failures.append(f"op_noise: {rows}")

    gen = torch.Generator(device=dev).manual_seed(NOISE_SEED)
    sigma = {"glwe_encryption": glwe.std, "keyswitch_l1_l0": p.l0_params.std}
    measured, launches = {}, {}
    for name, fn in (
            ("encryption", lambda: [noise.measure_encryption_noise(gen, sk, p)]),
            ("keyswitch", lambda: [noise.measure_keyswitch_noise(gen, sk, ev, p, 16)]),
            ("cmux", lambda: noise.measure_cmux_noise(gen, sk, ev, p, NOISE_DEPTH, NOISE_TRIALS)),
            ("cbs_then_cmux", lambda: [noise.measure_cbs_noise(gen, sk, ev, p, NOISE_TRIALS)])):
        stats, seconds, launches[name], _ = drive(fn, expect_launches(), f"path 10 ({name})")
        for st in stats:
            depth = int(st.op.rsplit("_", 1)[1]) if st.op.startswith("cmux_depth_") else None
            std = 2.0 ** (st.log2_std - 64)
            measured[st.op] = dict(
                samples=st.samples, log2_std=st.log2_std, log2_max=st.log2_max,
                margin_bits=noise_margin_bits(st.log2_max), seconds=seconds,
                log2_sigma=math.log2(sigma[st.op] * 2.0**64) if st.op in sigma else None,
                log2_failure_probability=noise.log2_failure_probability_binary(std),
                model_exponent_at_depth=noise_exponent_at_depth(depth) if depth else None)
    emit(dict(phase="noise", path="DEFAULT_128 noise", params=label,
              card=hw["nvidia_smi"], trials=NOISE_TRIALS, rows=measured))
    low = {op: r["margin_bits"] for op, r in measured.items()
           if r["margin_bits"] < MIN_NOISE_MARGIN_BITS}
    if low:
        failures.append(f"noise margins below {MIN_NOISE_MARGIN_BITS}: {low}")

    def round_trip():
        ones = torch.ones(glwe.degree, dtype=torch.int64, device=dev)
        arrays = {"ksk": ev.ck.ksk, "lwe0_sk": sk.lwe_0, "glwe1_sk": sk.glwe_1,
                  "lwe0": ev.enc.encrypt_lwe_l0(gen, 1, sk),
                  "lwe1": enc.encrypt_lwe(gen, t64.encode(1, 1), sk.lwe_1, glwe.as_lwe_def()),
                  "glwe1": ev.enc.encrypt_glwe_l1(gen, ones, sk),
                  "glev1": ev.enc.encrypt_glev_l1(gen, ones, sk),
                  "ggsw1": enc.encrypt_ggsw_scalar(gen, 1, sk.glwe_1, glwe, p.cbs_radix)}
        out = {}
        for kind, t in arrays.items():
            t0 = time.perf_counter()
            blob = serialization.serialize(kind, t, p)
            back = serialization.deserialize(blob, kind, p, device=dev)
            out[kind] = dict(shape=list(t.shape), array_bytes=t.numel() * 8,
                             payload_bytes=len(blob), equal=bool(torch.equal(back, t.long())),
                             seconds=time.perf_counter() - t0)
        return out

    sizes, ser_s, launches["serialization"], _ = drive(round_trip, expect_launches(),
                                                       "path 10 (serialization)")
    emit(dict(phase="noise", path="serialization round trip", params=label,
              card=hw["nvidia_smi"], seconds=ser_s, kinds=sizes))
    if not all(v["equal"] for v in sizes.values()):
        failures.append(f"serialization: {sizes}")
    if failures:
        raise AssertionError(f"path 10 (noise): {failures}")
    return {"noise op_noise": op_launches, **{f"noise {k}": v for k, v in launches.items()}}


MESH_SEED = 20261022


def phase_mesh(hw, path1, path3, u64_keys):
    """Path 13: the multi-device layer (`spf_tpu_torch.parallel`) on the
    card's mesh (every CUDA device: one on a one-card machine), each
    sharded call with the launch counts read around it and bit for bit
    equal to the unsharded call on the same inputs: `sharded_pbs_multibit`
    on path 1's key and 256 ciphertexts (path 1's launches),
    `sharded_cbs_u32` on path 3's keys and ciphertexts (one CBS's
    launches), `sharded_pbs` on path 8's compute key (64 lanes, c128, no
    port kernel) and `sharded_pbs_multibit_multihost` on a one-process
    (1, count) multi-host mesh (`init_distributed` a no-op); the seconds
    `replicate` takes a device for path 1's key from the host, the device
    ms of the sharded and unsharded PBS and CBS, and `scaling_model` for
    1, 4 and 8 devices (a model, not a measurement)."""
    from spf_tpu_torch import parallel
    from spf_tpu_torch.ops import cbs
    from spf_tpu_torch.ops.bootstrap import spectra
    from spf_tpu_torch.ops.u64 import bootstrap as u64_bs
    from spf_tpu_torch.ops.u64 import encryption as enc64
    from spf_tpu_torch.params import DEFAULT_128

    p = DEFAULT_128
    lwe, glwe, radix = p.l0_params, p.l1_params, p.pbs_radix
    (pbs, ct1, out1, want1), (cycle, ct3) = path1, path3
    sk, _, ev = u64_keys
    mesh = parallel.make_mesh()
    launches, equal, device_ms_by = {}, {}, {}

    host_key = tuple(c.cpu() for c in pbs.bsk_freq)
    key_bytes = sum(c.numel() * c.element_size() for c in host_key)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bsk_rep = parallel.replicate(host_key, mesh)
    torch.cuda.synchronize()
    replicate_s = (time.perf_counter() - t0) / mesh.size

    step = parallel.sharded_pbs_multibit(lwe, glwe, radix, GROUP, bsk_rep, pbs.lut, mesh)
    out, pbs_s, launches["mesh multi-bit PBS"], _ = drive(
        lambda: step(ct1), want1, "path 13 (sharded_pbs_multibit)")
    equal["sharded_pbs_multibit"] = torch.equal(out, out1)
    device_ms_by["multi-bit PBS"] = dict(sharded=profiled_device_ms(lambda: step(ct1))[0],
                                         unsharded=profiled_device_ms(lambda: pbs(ct1))[0])

    keys3 = [spectra(cycle, k) for k in ("bsk", "ak", "ssk")]
    ggsw = cbs.circuit_bootstrap(ct3, *keys3, p)
    step3 = parallel.sharded_cbs_u32(p, *keys3, mesh)
    got3, cbs_s, launches["mesh CBS"], _ = drive(
        lambda: step3(ct3), expect_launches(**cbs_launches(p)), "path 13 (sharded_cbs_u32)")
    equal["sharded_cbs_u32"] = all(same_bits(g, w) for g, w in zip(got3, ggsw, strict=True))
    device_ms_by["CBS"] = dict(
        sharded=profiled_device_ms(lambda: step3(ct3))[0],
        unsharded=profiled_device_ms(lambda: cbs.circuit_bootstrap(ct3, *keys3, p))[0])

    gen = torch.Generator(device="cuda").manual_seed(MESH_SEED)
    msgs = torch.arange(64, device="cuda") % 4
    cts8 = enc64.encrypt_lwe(gen, msgs << 61, sk.lwe_0, lwe)
    lut8 = u64_bs.generate_lut([lambda x: (x + 1) % 4], glwe, 2, device="cuda")
    ref8 = u64_bs.programmable_bootstrap_univariate(cts8, lut8, ev.ck.bsk, lwe, glwe, radix)
    step8 = parallel.sharded_pbs(p, ev.ck.bsk, mesh, lut8)
    got8, u64_s, launches["mesh u64 PBS"], _ = drive(lambda: step8(cts8), expect_launches(),
                                                      "path 13 (sharded_pbs)")
    equal["sharded_pbs"] = torch.equal(got8, ref8)

    rank_world = parallel.init_distributed()
    mh = parallel.make_multihost_mesh()
    step_mh = parallel.sharded_pbs_multibit_multihost(lwe, glwe, radix, GROUP, pbs.bsk_freq,
                                                      pbs.lut, mh)
    out_mh, mh_s, launches["mesh multihost PBS"], _ = drive(
        lambda: step_mh(ct1), want1, "path 13 (sharded_pbs_multibit_multihost)")
    equal["sharded_pbs_multibit_multihost"] = torch.equal(out_mh, out1)

    per_lane = pbs_s / ct1.shape[-1]
    model = {str(n): parallel.scaling_model(ct1.shape[-1], hosts, n // hosts,
                                            per_lane_cost=per_lane,
                                            key_broadcast_bytes=key_bytes)
             for n, hosts in ((1, 1), (4, 1), (8, 2))}
    emit(dict(phase="mesh", path="multi-device layer (spf_tpu_torch.parallel)",
              params="DEFAULT_128", card=hw["nvidia_smi"], mesh_devices=mesh.size,
              multihost_mesh=list(mh.devices.shape), init_distributed=list(rank_world),
              bit_for_bit=equal, call_s=dict(sharded_pbs_multibit=pbs_s, sharded_cbs_u32=cbs_s,
                                             sharded_pbs=u64_s, multihost=mh_s),
              device_ms=device_ms_by, replicate_s_per_device=replicate_s,
              replicated_key_bytes=key_bytes,
              scaling_model=dict(kind="analytic model, not a measurement",
                                 per_lane_cost_s=per_lane, by_devices=model)))
    if not all(equal.values()):
        raise AssertionError(f"path 13 (mesh): sharded and unsharded differ: {equal}")
    return launches


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


def check_roll_sass(hist: dict) -> None:
    """The roll kernel's unrolled loop issues every add of every chain as
    its own FADD: at least ROLL_CHAINS x ROLL_UNROLL of them (`csrc/probe.cu`);
    fewer means the compiler merged adds."""
    from spf_tpu_torch.kernels import build as kbuild

    with open(os.path.join(kbuild.CSRC, "probe.cu")) as fh:
        src = fh.read()
    want = 1
    for name in ("ROLL_CHAINS", "ROLL_UNROLL"):
        want *= int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    if "cuobjdump" in hist:
        raise AssertionError(f"roll_kernel: no SASS to count ({hist})")
    fadds = [ops.get("FADD", 0) for ops in hist.values()]
    if len(fadds) != 1 or fadds[0] < want:
        raise AssertionError(f"roll_kernel: FADDs {fadds} in the SASS, want one kernel with "
                             f">= {want}")


def check_fma_sass(hist: dict) -> None:
    """`fma_probe_kernel` (as written) has no FFMA; `fma_probe_fma_kernel`
    one for each of the FMA_ELEMS elements a thread handles
    (`csrc/probe.cu`): a contracted product, or a result computed twice, would
    show there."""
    from spf_tpu_torch.kernels import build as kbuild

    with open(os.path.join(kbuild.CSRC, "probe.cu")) as fh:
        src = fh.read()
    elems = 4 * int(re.search(r"constexpr int FMA_VEC = (\d+);", src).group(1))
    if "cuobjdump" in hist:
        raise AssertionError(f"fma_probe: no SASS to count ({hist})")
    ffma = {("fused" if "fma_probe_fma_kernel" in name else "as written"): ops.get("FFMA", 0)
            for name, ops in hist.items()}
    if ffma != {"as written": 0, "fused": elems}:
        raise AssertionError(f"fma_probe: FFMAs {ffma} in the SASS, want as written 0, "
                             f"fused {elems}")


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
    roll_sass = sass_histogram(kbuild.library_path("probe"), "roll_kernel")
    fma_sass = sass_histogram(kbuild.library_path("probe"), "fma_probe")
    emit(dict(phase="build", seconds=time.perf_counter() - t0, per_source_s=per_source,
              ptxas=ptxas,
              chain_sass_opcodes=sass_histogram(kbuild.library_path("probe"), "chain_kernel"),
              roll_sass_opcodes=roll_sass, fma_sass_opcodes=fma_sass,
              mad_sass_opcodes=sass_histogram(kbuild.library_path("mad"), "mad_horner_kernel"),
              fft_sass_opcodes=sass_histogram(kbuild.library_path("fft"), "ds_kernelILi8E")))
    check_roll_sass(roll_sass)
    check_fma_sass(fma_sass)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = timed("kernels_vs_plain", lambda: phase_kernels(gen, hw))
    emit(dict(phase="kernels_vs_plain", bitexact={r["name"]: r["bitexact"] for r in results}))
    bad = [r["name"] for r in results if not r["bitexact"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    emit(dict(phase="ks_lo_plane", **timed("ks_lo_plane", lo_plane_options)))

    timed("small_pbs", phase_small_pbs)
    timed("small_single_bit_and_cycle", phase_small_single_bit_and_cycle)
    by_path = timed("wide_glwe", phase_wide_glwe)
    path1_launches, path1 = timed("main_path", phase_main_path)
    by_path.update(path1_launches)
    by_path.update(timed("single_bit_pbs", phase_single_bit))
    path3_launches, path3 = timed("conversion_cycle", phase_cycle)
    by_path.update(path3_launches)
    timed("small_wave_machine", phase_small_wave_machine)
    keys = timed("wave_keys", wave_keys)
    by_path.update(timed("intop", lambda: phase_intop(keys)))
    by_path.update(timed("cpu", lambda: phase_cpu(keys)))
    del keys
    u64_launches, u64_keys = timed("u64_api", lambda: phase_u64_api(hw))
    by_path.update(u64_launches)
    by_path.update(timed("pfks", lambda: phase_pfks(hw, *u64_keys)))
    by_path.update(timed("noise", lambda: phase_noise(hw, *u64_keys)))
    by_path.update(timed("mesh", lambda: phase_mesh(hw, path1, path3, u64_keys)))
    del u64_keys, path1, path3
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
