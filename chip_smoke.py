#!/usr/bin/env python3
"""Drive the PyTorch port (spf_tpu_torch) through its main path on one
CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

1. card: name and power limit (nvidia-smi), PyTorch and CUDA versions;
2. build: every CUDA kernel from csrc/, one nvcc each, all in parallel;
3. each kernel against its plain PyTorch version on the card, at the
   DEFAULT_128 shapes of the paths below (bit for bit; the rotation
   kernels also at the edge values of t), with both timed (device time:
   the kernel queued behind a spin kernel, rotating through copies of its
   inputs that exceed the L2 cache; a plain version of thousands of
   launches summed by torch.profiler);
4. small runs on the card (kernels) and on the CPU (plain versions),
   bit-identical outputs: a multi-bit PBS (N = 256, n0 = 32, g = 3,
   B = 8), the single-bit PBS in its three forms (N = 256, n0 = 16) and
   the conversion cycle with a multi-bit (g = 2) and a single-bit key
   (N = 256, n0 = 8);
5. path 1, the multi-bit PBS at DEFAULT_128, g = 3, batch 256: keygen on
   the card, the key conversion through the FFT kernel, one
   `MultibitBootstrap` call with every kernel's launch count read around
   it, decryption on the host (256/256 correct, noise margin >= 8 bits),
   then the median PBS/s of 5 calls (information only) and one profiled
   call: its device time, by kernel, and its share of the wall time;
6. path 2, the single-bit PBS (`Bootstrap`) at DEFAULT_128, batch 256, in
   each of its forms (plain, fuse_rot, phase_rot), read as phase 5
   (3 timed calls each);
7. path 3, the conversion cycle (`ConversionCycle`: CBS with the
   multi-bit rotation at g = 2, radix 4x8, CMux, sample extract, LWE
   keyswitch) at DEFAULT_128, batch 256: keygen on the card, one cycle
   with the launch counts read around it, decryption (256/256 correct,
   noise margin >= 2 bits; the TPU's run of the same arithmetic recorded
   3.1), 3 timed cycles and one profiled, then each stage of the cycle
   run alone (wall and device time).

Then one {"kernels": [...]} line (per kernel: route, source, the TPU
kernel it replaces, launches on the paths (summed, and by path), error
against the plain version, kernel / plain / library / bound times) and,
last, one {"ok": true, "device": {...}} line. Any failure raises and the
script exits non-zero; without a CUDA device it exits 1 and prints no
result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20260416
BITS = 3  # message bits of the LUT, as bench.py
GROUP = 3
GROUP_CBS = 2  # bench.py's DEFAULT_MB_GROUP_CBS
BATCH = 256
MIN_MARGIN_BITS = 8.0
MIN_CYCLE_MARGIN_BITS = 2.0
TPU_CYCLE_MARGIN_BITS = 3.1  # BENCH_SUITE.json cbs_cycle: a correctness reference only
FORMS = {"plain": (False, False), "fuse_rot": (True, False), "phase_rot": (False, True)}

# NVIDIA H100 SXM data sheet: HBM3 rate, f32 rate outside the tensor
# cores and L2 size; roofline bounds are stated against the rates
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
L2_BYTES = 50 * 2**20

# f32 operations of the ds32 primitives (ops/ds.py) in the cheapest form
# that gives the same bits: TwoProd as p = a*b, e = fma(a, b, -p) (an fma
# counts 2, a negation 0). add 11, sub 11, mul 10; complex: cadd 22,
# csub 22, cmul 62. The kernels' Veltkamp TwoProd does more work than this.
CADD, CSUB, CMUL = 22, 22, 62


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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


def device_ms(fn, copies: list, reps: int):
    """Device time of one call of fn, in ms, and the host time it took to
    issue it, in us. The calls are queued behind a spin kernel, so they
    run back to back and the events time the device, not the host's
    launch rate; the host meanwhile only issues them. They rotate through
    `copies` of the arguments, and every output is kept to the end, so
    each call reads and writes device memory, not the L2 cache, as the
    main path's steps do. Only for a few hundred launches: beyond about a
    thousand queued launches the host blocks."""

    def run():
        return [fn(*copies[i % len(copies)]) for i in range(reps)]

    run()  # warm-up: the allocator caches the outputs' blocks
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(500_000_000)
    start.record()
    t0 = time.perf_counter()
    outs = run()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    end.record()
    torch.cuda.synchronize()
    del outs
    return start.elapsed_time(end) / reps, host_us


def profiled_device_ms(fn, top: int = 8):
    """Device time of one call of fn (the sum of its kernels' device
    times, by torch.profiler) in ms, and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = name.split("(")[0][:80]
            by_name[name] = by_name.get(name, 0.0) + e.device_time / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return sum(by_name.values()), {k: v for k, v in ranked}


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
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


def phase_kernels(gen):
    """Each kernel against its plain version at the main paths' shapes."""
    from spf_tpu_torch.ops import encryption, fft, mad, phase_rot, rot_decomp, torus
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
    # the rotation kernels: per-column t, the edge values in the first columns
    t = torch.randint(0, 2 * n, (b,), generator=gen, device=dev)
    t[:6] = torch.tensor([0, 1, n - 1, n, 2 * n - 1, 2 * n], device=dev)

    # fwd_ds: the signed digits [l, k+1, N, B] and a zero lo plane
    digits = torch.randint(-(1 << 15), 1 << 15, (l, kp1, n, b), generator=gen, device=dev).float()
    zeros = torch.zeros_like(digits)
    p_fwd = l * kp1
    # inv_ds: a product spectrum [k+1, K, B]
    prod_f = spectrum(kp1, k, b, exp=70)
    # the MADs: digit spectra [l, k+1, K, B] (l = 4 for the CBS rotation),
    # key rows, the per-bit phase factors
    dfft = fft.fwd_ds(digits, zeros)
    digits_cbs = torch.randint(-(1 << 7), 1 << 7, (l_cbs, kp1, n, b), generator=gen, device=dev).float()
    dfft_cbs = fft.fwd_ds(digits_cbs, torch.zeros_like(digits_cbs))
    # fence: one of the hoisted factor planes [n_groups, g, Klo, B]
    factors = randn(n_groups(DEFAULT_128.l0_params.dim, GROUP), GROUP, 1 << (logk // 2), b)

    fft_ops = p_fwd * b * (CMUL * k + (CADD + CSUB + CMUL) * (k // 2) * logk)
    inv_ops = kp1 * b * (CMUL * k + (CADD + CSUB + CMUL) * (k // 2) * logk)

    def mad_case(name, group, d):
        """mad_horner's g-instance (g = 0: freq_mad) on digit spectra d."""
        ll = d[0].shape[0]
        ns = max(1, (1 << group) - 1)
        row_shape = (kp1, ll, kp1, k) if group == 0 else (ns, kp1, ll, kp1, k)
        row = spectrum(*row_shape, exp=60)
        horner = kp1 * (ns * CMUL + (ns - 1) * CADD) if group else 0
        if group == 0:
            kernel, plain, args = mad.freq_mad, mad.freq_mad_plain, (d, row)
        else:
            def kernel(d_, r_, u_):
                return mad.mad_horner(d_, r_, u_, group)

            def plain(d_, r_, u_):
                return mad.mad_horner_plain(d_, r_, u_, group)

            args = (d, row, spectrum(group, k, b, exp=0))
        return dict(
            name=name, source="spf_tpu_torch/csrc/mad.cu", replaces="spf_tpu/ops/mad_pallas.py:94",
            note=f"mad.cu's g = {group} instance" + (
                "; in place of the XLA glue freq_mad (spf_tpu/ops/bootstrap_u32.py:161)"
                if group == 0 else ""),
            kernel=kernel, plain=plain, args=args,
            nbytes=4 * 4 * (ll * kp1 * k * b + ns * kp1 * ll * kp1 * k + group * k * b + kp1 * k * b),
            ops=k * b * (ns * kp1 * ll * kp1 * (CMUL + CADD) + horner),
        )

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
        dict(
            name="rotate_sub_decompose",
            source="spf_tpu_torch/csrc/rot_decomp.cu",
            replaces="spf_tpu/ops/rot_decomp_pallas.py:182",
            kernel=lambda a, tt: rot_decomp.rotate_sub_decompose(a, tt, radix),
            plain=lambda a, tt: rot_decomp.rotate_sub_decompose_plain(a, tt, radix),
            args=(acc, t),
            nbytes=e * (8 + 4 * l) + 8 * b,
            ops=0,  # integer work only
        ),
        dict(
            name="rotate_sub_decompose_acc",
            source="spf_tpu_torch/csrc/rot_decomp.cu",
            replaces="spf_tpu/ops/rot_decomp_pallas.py:98",
            kernel=lambda a, p, tt: rot_decomp.rotate_sub_decompose_acc(a, p, tt, radix),
            plain=lambda a, p, tt: rot_decomp.rotate_sub_decompose_acc_plain(a, p, tt, radix),
            args=(acc, (ph, pl), t),
            nbytes=e * (8 + 4 + 4 + 8 + 4 * l) + 8 * b,
            ops=e * 18,  # from_ds once per element; the rest is integer
        ),
        dict(
            name="fwd_ds",
            source="spf_tpu_torch/csrc/fft.cu",
            replaces="spf_tpu/ops/fft_pallas.py:258",
            kernel=fft.fwd_ds,
            plain=fft.fwd_ds_plain,
            args=(digits, zeros),
            nbytes=p_fwd * b * (2 * n * 4 + 4 * k * 4),
            ops=fft_ops,
        ),
        dict(
            name="inv_ds",
            source="spf_tpu_torch/csrc/fft.cu",
            replaces="spf_tpu/ops/fft_pallas.py:294",
            kernel=fft.inv_ds,
            plain=fft.inv_ds_plain,
            args=(prod_f,),
            nbytes=kp1 * b * (4 * k * 4 + 2 * n * 4),
            ops=inv_ops,
        ),
        mad_case("mad_horner", GROUP, dfft),
        mad_case("mad_horner_g2", GROUP_CBS, dfft_cbs),
        mad_case("mad_horner_g1", 1, dfft),
        mad_case("freq_mad", 0, dfft),
        dict(
            name="fence",
            source="spf_tpu_torch/csrc/fence.cu",
            replaces="spf_tpu/ops/phase_rot.py:242",
            kernel=phase_rot.fence,
            plain=phase_rot.fence_plain,
            plain_is_one_launch=True,  # clone: timed as the kernel is
            library=lambda x: x.clone(),
            args=(factors,),
            nbytes=2 * 4 * factors.numel(),
            ops=0,
        ),
    ]
    # a second fwd_ds input: torus values with a real lo plane, as the key
    # conversion feeds it
    tor = encryption.uniform_torus((n, 1024), gen)
    t_hi, t_lo = torus.to_ds(tor)
    key_exact, key_err = compare("fwd_ds", fft.fwd_ds(t_hi, t_lo), fft.fwd_ds_plain(t_hi, t_lo))

    results = []
    for c in cases:
        args = c["args"]
        got = c["kernel"](*args)
        want = c["plain"](*args)
        torch.cuda.synchronize()
        exact, err = compare(c["name"], got, want)
        if c["name"] == "fwd_ds":
            exact, err = exact and key_exact, max(err, key_err)
        copies = cold_copies(args, c["nbytes"])
        kernel_ms, host_us = device_ms(c["kernel"], copies, 50)
        if c.get("plain_is_one_launch"):
            plain_ms = device_ms(c["plain"], copies, 50)[0]
        else:  # thousands of launches: summed by the profiler
            c["plain"](*args)  # warm-up
            plain_ms = profiled_device_ms(lambda: [c["plain"](*a) for a in copies])[0] / len(copies)
        library_ms = device_ms(c["library"], copies, 50)[0] if "library" in c else None
        del copies
        bms, by = bound_ms(c["nbytes"], c["ops"])
        results.append(dict(
            name=c["name"], route="cuda", source=c["source"], replaces=c["replaces"],
            bitexact=exact, max_abs_err=err, ms=kernel_ms, kernel_ms=kernel_ms,
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms, bound_by=by,
            bytes=c["nbytes"], ops=c["ops"], host_us_per_call=host_us, note=c.get("note"),
        ))
    return results


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
    device ms and top kernels."""
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    device_call_ms, by_kernel = profiled_device_ms(fn)
    return times, device_call_ms, by_kernel


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
    times, device_call_ms, by_kernel = wall_and_device(lambda: pbs(ct), 5)
    med = statistics.median(times)
    res = dict(
        phase="main_path", path="multi-bit PBS", params="DEFAULT_128", group=GROUP, batch=BATCH,
        out_shape=list(out.shape), keygen_s=keygen_s, key_conversion_s=convert_s,
        first_call_s=first_s, correct=f"{n_correct}/{BATCH}", noise_margin_bits=margin,
        launches={k: v for k, v in launches.items() if v}, pbs_call_s=times,
        pbs_per_s_median=BATCH / med, device_ms_per_call=device_call_ms,
        device_busy_share=device_call_ms / 1e3 / med, device_ms_by_kernel=by_kernel,
        peak_device_mem_gib=peak_gib,
    )
    emit(res)
    if tuple(out.shape) != (glwe.size * glwe.degree + 1, BATCH):
        raise AssertionError(f"output shape {tuple(out.shape)}")
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
        times, device_call_ms, by_kernel = wall_and_device(lambda: pbs(ct), 3)
        med = statistics.median(times)
        res[form] = dict(
            out_shape=list(out.shape), key_conversion_s=convert_s, first_call_s=first_s,
            correct=f"{n_correct}/{BATCH}", noise_margin_bits=margin,
            launches={k: v for k, v in launches.items() if v}, pbs_call_s=times,
            pbs_per_s_median=BATCH / med, device_ms_per_call=device_call_ms,
            device_busy_share=device_call_ms / 1e3 / med, device_ms_by_kernel=by_kernel,
            peak_device_mem_gib=peak_gib,
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
    times, device_call_ms, by_kernel = wall_and_device(lambda: cycle(ct), 3)
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
        peak_device_mem_gib=peak_gib, stages=breakdown,
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
        times, device_call_ms, by_kernel = wall_and_device(fn, 2)
        out[name] = dict(wall_s=times, device_ms=device_call_ms,
                         top_kernels=dict(list(by_kernel.items())[:3]))
    return out


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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = card_line()
    print(smi, flush=True)
    emit(dict(phase="card", nvidia_smi=smi, kind=kind, torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0]))

    t0 = time.perf_counter()
    per_source = kbuild.build()
    ptxas = {}
    for name in kbuild.SOURCES:
        with open(f"{kbuild.BUILD_DIR}/{name}.log", errors="replace") as fh:
            ptxas[name] = [ln.strip() for ln in fh if "registers" in ln or "spill" in ln]
    emit(dict(phase="build", seconds=time.perf_counter() - t0, per_source_s=per_source,
              ptxas=ptxas))

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = timed("kernels_vs_plain", lambda: phase_kernels(gen))
    emit(dict(phase="kernels_vs_plain", bitexact={r["name"]: r["bitexact"] for r in results}))
    bad = [r["name"] for r in results if not r["bitexact"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")

    timed("small_pbs", phase_small_pbs)
    timed("small_single_bit_and_cycle", phase_small_single_bit_and_cycle)
    by_path = {}
    by_path.update(timed("main_path", phase_main_path))
    by_path.update(timed("single_bit_pbs", phase_single_bit))
    by_path.update(timed("conversion_cycle", phase_cycle))
    for r in results:
        r["launches_by_path"] = {path: counts[r["name"]] for path, counts in by_path.items()
                                 if counts[r["name"]]}
        r["launches"] = sum(r["launches_by_path"].values())
    unused = [r["name"] for r in results if not r["launches"]]
    if unused:
        raise AssertionError(f"kernels launched on no path: {unused}")
    emit(dict(kernels=results))
    emit(dict(ok=True, device=dict(platform="gpu", kind=kind, count=torch.cuda.device_count())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
