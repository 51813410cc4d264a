"""A/B runs of designs of a kernel source on one CUDA card.

    python -m spf_tpu_torch.scripts.kernel_ab [--source fft|rot_decomp|mad|phase|probe]
        DIR [DIR ...] [--check DIR] [--mul32] [--alone]

Each DIR holds a copy of the package, `DIR/spf_tpu_torch/`, whose
`csrc/<source>.cu` is one design (or one diagnostic edit of a design). The
script builds every copy's library of that source at once, one nvcc each,
then runs each copy in a process of its own, in turns (DIR_1 .. DIR_n,
then DIR_n .. DIR_1), and prints one JSON line a run, each kernel held bit
for bit against its plain version and timed by `device_ms` (device ms a
call, with inputs rotating past the L2; host us a call):

- `fft` (the default): `fwd_ds` at [P, 2048, 256] for P = 4 and 8 and
  `inv_ds` at [P, 1024, 256] for P = 2 and 4 (DEFAULT_128 at batch 256:
  the paths' shapes). `--check DIR` also holds that copy bit for bit at K
  in {2, 4, 8, 16, 32, 64, 1024, 2048} with B in {1, 3, 8, 129, 256, 1024}
  and P in {1, 2, 4, 8}, on signed digits with a zero lo plane, torus
  values and spectra of magnitude 2^70. Each run also drives path 1 (the
  multi-bit PBS at DEFAULT_128, batch 256) once under the profiler and
  gives the FFTs' device ms a launch there, where each follows other
  kernels.
- `rot_decomp`: `rotate_sub_decompose` and `rotate_sub_decompose_acc` at
  [2, 2048, B] for B = 256 and 64 (radix 2x16), and `accumulate_decompose`
  at B = 256. `--check DIR` also holds the two rotation kernels bit for
  bit at N in {2, 64, 1024, 2048}, B in {1, 3, 8, 64, 129, 256} and P in
  {1, 2, 3}, with t at its edges and beyond 2N. It also times the CBS
  keyswitch's halves at the benchmark cycle's shapes (N = B = 2048):
  `ks_decompose` at the trace's [1, N, B] (tr_radix 6x7, round 0's table)
  and on a GLEV's strided masks [4, 1, N, B] (ss_radix 15x3, no table), and
  `ks_round_add` at [2, N, B] (round 0), each against its byte bound; `--check
  DIR` holds them bit for bit at the same N x B x P (P the GLEV's levels)
  and every trace round of N. Each run also drives path 2
  (the single-bit PBS at DEFAULT_128, batch 256) once in its plain and its
  fuse_rot form under the profiler: the rotation kernel's device ms a
  launch there and the path's device ms a call.
- `mad`: `mad_batched_kernel` (`freq_mad_batched`) at [l = 4, k+1 = 2,
  K = 1024] with B = 32, 64, 129 and 256 over a slot buffer of 256 GGSWs
  (random slots), and `mad_plane_kernel` at k+1 in {3, 4, 6} x g in 0..3 x
  B in {8, 129, 256} at [l = 2, K = 128]. `--check DIR` also holds that
  copy bit for bit at the edge shapes of `scripts.mad_edges`. Each run
  also drives path 5 (the entry points at k+1 = 3, 4, 6) and path 6's
  mul8 (the wave machine at DEFAULT_128, wide CMux waves; keys made on the
  card) once under the profiler: each kernel instance's device us a launch
  there, the outputs decrypted; with `--mul32` also path 7's mul32 (the
  encrypted CPU, narrow waves), ~1 minute more a run; with `--alone`
  only the kernels alone (~20 s a run). The paths are driven
  by the repository's `chip_smoke.py`, imported beside each copy's package.
- `phase`: `phase_minus_one` at K = 1024 with B = 256 and 8, each with
  `perm = scrambled_perm(K)` (as `step_microbench` calls it) and in
  natural order. `--check DIR` also holds that copy bit for bit at the
  edge shapes of `scripts.probe_edges` (`check_phase`). Each run also
  profiles `step_microbench`'s "pm1 doubling" and "phase step (full)"
  components (ITERS calls each, at batch 256): the kernel's device us a
  launch there and the component's device us a call; `--alone` skips them.
- `probe`: `roll` at [1024, 512], 400 steps of shift 8 (`vpu_probe`'s
  shape), beside the f32 mul chain and both `fma_probe` entry points of
  the same source at [1024, 512] (also as written with a and b one element
  past a 16-byte boundary: its scalar path), each cold copy sized by its
  own bytes, and two floor copies with `fma_probe`'s traffic and no
  arithmetic (`FLOOR_CU`, built once into the repository's `_build/`): on
  the grid of one element a thread and on one of 2 16-byte vectors a
  thread. `--check DIR` also holds that copy's roll bit for bit at
  `probe_edges.ROLL_CASES` and both fma entry points at
  `probe_edges.check_fma`'s sizes and offsets. Each run also times the
  roll and both fma entry points as `vpu_probe` times them (one input, 5
  calls, `vpu_probe.timed`); `--alone` skips that.

The build's lines give each kernel's registers and spills (ptxas), the
last line the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# run in a copy's directory: imports that copy's spf_tpu_torch
RUN_FFT = r'''
import json, sys, torch
sys.path.insert(0, ".")
from spf_tpu_torch.ops import encryption, fft, torus
from spf_tpu_torch.scripts import device_ms

gen = torch.Generator(device="cuda").manual_seed(7)

def spectrum(p, k, b):
    out = []
    for _ in range(2):
        hi = torch.randn((p, k, b), generator=gen, device="cuda") * 2.0**70
        out += [hi, hi * torch.randn((p, k, b), generator=gen, device="cuda") * 2.0**-25]
    return tuple(out)

def digits(p, k, b):
    d = torch.randint(-(1 << 15), 1 << 15, (p, 2 * k, b), generator=gen, device="cuda").float()
    return d, torch.zeros_like(d)

def same(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))

def copies(args):
    nbytes = sum(t.numel() * 4 for a in args for t in (a if isinstance(a, tuple) else (a,)))
    n = -(-2 * 50 * 2**20 // nbytes) + 1
    clone = lambda a: tuple(t.clone() for t in a) if isinstance(a, tuple) else a.clone()
    return [args] + [tuple(clone(a) for a in args) for _ in range(n - 1)]

res = {}
for name, kernel, plain, p, args in (
        ("fwd_ds P=4", fft.fwd_ds, fft.fwd_ds_plain, 4, digits(4, 1024, 256)),
        ("fwd_ds P=8", fft.fwd_ds, fft.fwd_ds_plain, 8, digits(8, 1024, 256)),
        ("inv_ds P=2", fft.inv_ds, fft.inv_ds_plain, 2, (spectrum(2, 1024, 256),)),
        ("inv_ds P=4", fft.inv_ds, fft.inv_ds_plain, 4, (spectrum(4, 1024, 256),))):
    ok = same(kernel(*args), plain(*args))
    ms, host_us = device_ms(kernel, copies(args), 50)
    res[name] = dict(bitexact=ok, ms=ms, host_us=host_us)
if sys.argv[1] == "check":
    bad, n = [], 0
    for k in (2, 4, 8, 16, 32, 64, 1024, 2048):
        for b, p in ((1, 1), (3, 2), (8, 4), (129, 8), (256, 1), (1024, 2)):
            for args in (digits(p, k, b), torus.to_ds(encryption.uniform_torus((p, 2 * k, b), gen))):
                n += 1
                if not same(fft.fwd_ds(*args), fft.fwd_ds_plain(*args)):
                    bad.append(["fwd_ds", k, b, p])
            s = spectrum(p, k, b)
            n += 1
            if not same(fft.inv_ds(s), fft.inv_ds_plain(s)):
                bad.append(["inv_ds", k, b, p])
    res["shapes"] = dict(checked=n, not_bitexact=bad)

# in path 1 (the multi-bit PBS at DEFAULT_128, g = 3, batch 256), where each
# FFT launch follows other kernels: its device ms a launch, by the profiler
import numpy as np
from spf_tpu_torch.ops.lut import generate_lut_np
from spf_tpu_torch.ops.multibit import MultibitBootstrap
from spf_tpu_torch.params import DEFAULT_128
from spf_tpu_torch.scripts import profiled_kernels

lwe, glwe, radix = DEFAULT_128.l0_params, DEFAULT_128.l1_params, DEFAULT_128.pbs_radix
rng = np.random.default_rng(1)
lwe_sk = rng.integers(0, 2, lwe.dim).astype(np.int64)
bsk = encryption.generate_multibit_bsk(lwe_sk, encryption.generate_glwe_sk(glwe, gen), glwe,
                                       radix, 3, gen)
pbs = MultibitBootstrap(bsk, generate_lut_np([lambda m: (m + 1) % 8], glwe, 3), glwe, radix, 3)
del bsk
cts = encryption.encrypt_lwe_np(rng, (np.arange(256, dtype=np.uint64) % 8) << np.uint64(60),
                                lwe_sk, lwe)
ct = torus.from_u64_np(cts.T.copy(), "cuda")
pbs(ct)
torch.cuda.synchronize()
by_name = profiled_kernels(lambda: pbs(ct))
path = {"device_ms": sum(ms for ms, _ in by_name.values())}
for name, (ms, n) in by_name.items():
    for kernel in ("fwd_ds", "inv_ds"):
        if name.startswith(kernel + "_kernel"):
            path[kernel + " ms"] = ms / n
res["path 1"] = path
print("RESULT " + json.dumps(res), flush=True)
'''

RUN_ROT = r'''
import json, sys, torch
sys.path.insert(0, ".")
from spf_tpu_torch.ops import encryption, rot_decomp, torus
from spf_tpu_torch.params import DEFAULT_128
from spf_tpu_torch.scripts import device_ms, profiled_kernels

gen = torch.Generator(device="cuda").manual_seed(7)
radix = DEFAULT_128.pbs_radix

def inputs(p, n, b):
    acc = encryption.uniform_torus((p, n, b), gen)
    exps = torch.randint(0, 86, (p, n, b), generator=gen, device="cuda").float()
    ph = torch.randn((p, n, b), generator=gen, device="cuda") * torch.exp2(exps)
    pl = torch.randn((p, n, b), generator=gen, device="cuda") * torch.exp2((exps - 26).clamp(min=0))
    t = torch.randint(-(1 << 41), 1 << 41, (b,), generator=gen, device="cuda")
    edges = [0, 1, n - 1, n, 2 * n - 1, 2 * n, -1, -(2 * n) - 3, (1 << 40) + 7, 3 * n + 5]
    t[:min(b, len(edges))] = torch.tensor(edges[:b], device="cuda")
    return acc, (ph, pl), t

def same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) if x.dtype == torch.float32
               else torch.equal(x, y) for x, y in zip(a, b))

def copies(args, nbytes):
    n = -(-2 * 50 * 2**20 // nbytes) + 1
    def clone(a):
        return tuple(clone(x) for x in a) if isinstance(a, tuple) else a.clone()
    return [args] + [clone(args) for _ in range(n - 1)]

def kernels(acc, prod, t):
    return {
        "rotate_sub_decompose": (lambda a, tt: rot_decomp.rotate_sub_decompose(a, tt, radix),
                                 lambda a, tt: rot_decomp.rotate_sub_decompose_plain(a, tt, radix),
                                 (acc, t), acc.numel() * 16),
        "rotate_sub_decompose_acc": (
            lambda a, p, tt: rot_decomp.rotate_sub_decompose_acc(a, p, tt, radix),
            lambda a, p, tt: rot_decomp.rotate_sub_decompose_acc_plain(a, p, tt, radix),
            (acc, prod, t), acc.numel() * 32),
        "accumulate_decompose": (lambda a, p: rot_decomp.accumulate_decompose(a, p, radix),
                                 lambda a, p: rot_decomp.accumulate_decompose_plain(a, p, radix),
                                 (acc, prod), acc.numel() * 32),
    }

res = {}
for b in (256, 64):
    for name, (kernel, plain, args, nbytes) in kernels(*inputs(2, 2048, b)).items():
        if name == "accumulate_decompose" and b != 256:
            continue
        ok = same(kernel(*args), plain(*args))
        ms, host_us = device_ms(kernel, copies(args, nbytes), 50)
        res[f"{name} B={b}"] = dict(bitexact=ok, ms=ms, host_us=host_us)

# the CBS keyswitch's halves at the benchmark cycle's shapes (N = B = 2048):
# the trace's front (tr_radix, a round's table) and back, the scheme
# switch's front (ss_radix) on the strided masks of a GLEV [4, 2, N, B]
from spf_tpu_torch.ops import cbs

tr, ss = DEFAULT_128.tr_radix, DEFAULT_128.ss_radix

def ks_kernels(p, n, b, rnd):
    ct = encryption.uniform_torus((2, n, b), gen)
    glev = encryption.uniform_torus((p, 2, n, b), gen)
    _, prod, _ = inputs(2, n, b)
    src, neg = cbs._trace_tables(n, torch.device("cuda"))
    table = (src[rnd], neg[rnd])
    e = n * b
    return {
        "ks_decompose trace": (lambda c, t: rot_decomp.ks_decompose(c[:-1], tr, t),
                               lambda c, t: rot_decomp.ks_decompose_plain(c[:-1], tr, t),
                               (ct, table), e * (8 + 4 * tr.count)),
        "ks_decompose scheme switch": (lambda g: rot_decomp.ks_decompose(g[:, :-1], ss),
                                       lambda g: rot_decomp.ks_decompose_plain(g[:, :-1], ss),
                                       (glev,), p * e * (8 + 4 * ss.count)),
        "ks_round_add": (lambda q, c, t: rot_decomp.ks_round_add(q, c, t),
                         lambda q, c, t: rot_decomp.ks_round_add_plain(q, c, t),
                         (prod, ct, table), 2 * e * 24),
    }

for name, (kernel, plain, args, nbytes) in ks_kernels(4, 2048, 2048, 0).items():
    ok = same(kernel(*args), plain(*args))
    ms, host_us = device_ms(kernel, copies(args, nbytes), 20)
    bound = nbytes / 3.35e9  # ms at the HBM3 rate
    res[name] = dict(bitexact=ok, ms=ms, host_us=host_us, bound_ms=bound, share=bound / ms)
if sys.argv[1] == "check":
    bad, n = [], 0
    for nn in (2, 64, 1024, 2048):
        for i, b in enumerate((1, 3, 8, 64, 129, 256)):
            p = (1, 2, 3)[i % 3]
            for name, (kernel, plain, args, _) in kernels(*inputs(p, nn, b)).items():
                if name != "accumulate_decompose":
                    n += 1
                    if not same(kernel(*args), plain(*args)):
                        bad.append([name, p, nn, b])
            # the keyswitch's halves at every trace round of N
            for rnd in range(max(1, nn.bit_length() - 1)):
                for name, (kernel, plain, args, _) in ks_kernels(p, nn, b, rnd).items():
                    n += 1
                    if not same(kernel(*args), plain(*args)):
                        bad.append([name, p, nn, b, rnd])
    res["shapes"] = dict(checked=n, not_bitexact=bad)

# in path 2 (the single-bit PBS at DEFAULT_128, batch 256), plain and
# fuse_rot, where each rotation launch follows other kernels
import numpy as np
from spf_tpu_torch.ops.bootstrap import Bootstrap
from spf_tpu_torch.ops.lut import generate_lut_np

lwe, glwe = DEFAULT_128.l0_params, DEFAULT_128.l1_params
rng = np.random.default_rng(1)
lwe_sk = rng.integers(0, 2, lwe.dim).astype(np.int64)
bsk = encryption.generate_bsk(lwe_sk, encryption.generate_glwe_sk(glwe, gen), glwe, radix, gen)
lut = generate_lut_np([lambda m: (m + 1) % 8], glwe, 3)
cts = encryption.encrypt_lwe_np(rng, (np.arange(256, dtype=np.uint64) % 8) << np.uint64(60),
                                lwe_sk, lwe)
ct = torus.from_u64_np(cts.T.copy(), "cuda")
for form, fuse_rot in (("plain", False), ("fuse_rot", True)):
    pbs = Bootstrap(bsk, lut, glwe, radix, fuse_rot, False)
    pbs(ct)
    torch.cuda.synchronize()
    by_name = profiled_kernels(lambda: pbs(ct))
    path = {"device_ms": sum(ms for ms, _ in by_name.values())}
    for name, (ms, n) in by_name.items():
        if name.startswith("rotate_sub_decompose"):
            path[name + " ms"] = ms / n
            path["launches"] = n
    res["path 2 " + form] = path
    del pbs
print("RESULT " + json.dumps(res), flush=True)
'''

RUN_MAD = r'''
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, ".")
sys.path.append(sys.argv[2])  # the repository root: chip_smoke.py runs the paths
import chip_smoke as cs
from spf_tpu_torch.ops import mad
from spf_tpu_torch.scripts import device_ms, mad_edges, profiled_kernels

gen = torch.Generator(device="cuda").manual_seed(7)

def spectrum(*shape, exp):
    return mad_edges.spectrum(gen, shape, exp)

def same(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))

def copies(args, nbytes):
    return cs.cold_copies(args, nbytes)

res = {}
# the batched-row MAD at phase 3's shapes: [l = 4, k+1 = 2, K = 1024], B
# columns over a slot buffer of 256 GGSWs, slots random
l, kp1, k = 4, 2, 1024
rows = spectrum(256, kp1, l, kp1, k, exp=60)
d_all = spectrum(l, kp1, k, 256, exp=20)
for b in (32, 64, 129, 256):
    d = tuple(x[..., :b].contiguous() for x in d_all)
    slots = torch.randint(0, 256, (b,), generator=gen, device="cuda", dtype=torch.int32)
    distinct = int(torch.unique(slots).numel())
    nbytes = distinct * 16 * kp1 * l * kp1 * k + 16 * (l * kp1 + kp1) * k * b + 4 * b
    args = (d, rows, slots, 0)
    ok = same(mad.freq_mad_batched(*args), mad.freq_mad_batched_plain(*args))
    ms, host_us = device_ms(mad.freq_mad_batched, copies(args, nbytes), 50)
    res[f"batched B={b}"] = dict(bitexact=ok, ms=ms, host_us=host_us, distinct_slots=distinct)
del rows, d_all
# the per-plane MAD at [l = 2, K = 128] (Klo = 16, Khi = 8)
l, k, klo = 2, 128, 16
for kp1 in (3, 4, 6):
    for g in range(4):
        kernel, plain = cs.mad_fns(g)
        ns = max(1, (1 << g) - 1)
        for b in (8, 129, 256):
            args = (spectrum(l, kp1, k, b, exp=20),
                    spectrum(*((kp1, l, kp1, k) if g == 0 else (ns, kp1, l, kp1, k)), exp=60))
            if g:
                args += ((spectrum(g, klo, b, exp=0), spectrum(g, k // klo, b, exp=0)),)
            ok = same(kernel(*args), plain(*args))
            nbytes = cs.mad_bytes(g, kp1, l, k, b, klo + k // klo)
            ms, host_us = device_ms(kernel, copies(args, nbytes), 50)
            res[f"plane g={g} k+1={kp1} B={b}"] = dict(bitexact=ok, ms=ms, host_us=host_us)
if sys.argv[1] == "check":
    res["shapes"] = mad_edges.check(gen)

if "alone" in sys.argv[3:]:
    print("RESULT " + json.dumps(res), flush=True)
    sys.exit(0)

def in_path(by_name, kernel):
    # device us a launch of the kernel's instances in a profiled call, by instance
    out = {}
    for name, (ms, n) in by_name.items():
        if name.startswith(kernel):
            out[name.split("(")[0]] = dict(us=1e3 * ms / n, launches=n)
    return out

# path 5: the entry points at k + 1 = 3, 4, 6 (N = 256, n0 = 16, B = 8)
from spf_tpu_torch.ops import encryption, torus
from spf_tpu_torch.ops.bootstrap import Bootstrap
from spf_tpu_torch.ops.lut import generate_lut_np
from spf_tpu_torch.ops.multibit import MultibitBootstrap
from spf_tpu_torch.params import DEFAULT_128, GlweDef, LweDef, RadixDecomposition

lwe, radix = LweDef(dim=16, std=1e-16), RadixDecomposition(count=2, radix_log=16)
rng = np.random.default_rng(cs.SEED + 4)
lwe_sk = rng.integers(0, 2, lwe.dim).astype(np.int64)
msgs = np.arange(8, dtype=np.uint64) % 8
ct = torus.from_u64_np(encryption.encrypt_lwe_np(
    rng, msgs << np.uint64(64 - cs.BITS - 1), lwe_sk, lwe).T.copy(), "cuda")
mods, correct = [], []
for kk in cs.WIDE_KS:
    glwe = GlweDef(size=kk, degree=256, std=1e-16)
    kgen = torch.Generator().manual_seed(cs.SEED + kk)
    glwe_sk = encryption.generate_glwe_sk(glwe, kgen)
    lut = generate_lut_np([cs.lut_fn], glwe, cs.BITS)
    for group in (cs.GROUP, cs.GROUP_CBS):
        bsk = encryption.generate_multibit_bsk(lwe_sk, glwe_sk, glwe, radix, group, kgen)
        mods.append((MultibitBootstrap(bsk, lut, glwe, radix, group, device="cuda"), glwe_sk))
    bsk = encryption.generate_bsk(lwe_sk, glwe_sk, glwe, radix, kgen)
    for fuse_rot, phase_rot in cs.FORMS.values():
        mods.append((Bootstrap(bsk, lut, glwe, radix, fuse_rot, phase_rot, device="cuda"), glwe_sk))
for m, sk in mods:
    n_ok, _ = cs.decode(m(ct), sk.numpy().reshape(-1).astype(np.uint64), cs.lut_fn(msgs))
    correct.append(n_ok)
torch.cuda.synchronize()
by_name = profiled_kernels(lambda: [m(ct) for m, _ in mods])
res["path 5"] = dict(correct=correct, device_ms=sum(ms for ms, _ in by_name.values()),
                     mad_plane_kernel=in_path(by_name, "mad_plane"))
del mods

# path 6's mul8 (wide CMux waves), and path 7's mul32 (narrow) if asked
from spf_tpu_torch.runtime.wave_machine import WaveMachine
keys = cs.wave_keys()
wm = WaveMachine(keys.key, DEFAULT_128)
sk = keys.glwe_sk.cpu().numpy().astype(np.uint64)
g, out_keys, n_inst, fn = cs.intop_graph("mul", 8)
wm.schedule(g)
a_vals, b_vals, inputs = cs.intop_inputs(keys.rng, keys.lwe_sk, DEFAULT_128.l0_params, 8, n_inst)
out = wm.run(g, inputs)
torch.cuda.synchronize()
values, n_ok, margins = cs.intop_decode(out, out_keys, sk, DEFAULT_128.l1_params,
                                        [fn(int(x), int(y)) for x, y in zip(a_vals, b_vals)])
by_name = profiled_kernels(lambda: wm.run(g, inputs))
res["path 6 mul8"] = dict(correct=f"{n_ok}/{n_inst}", margin_worst=min(margins),
                          margin_median=float(np.median(margins)),
                          device_ms=sum(ms for ms, _ in by_name.values()),
                          mad_batched_kernel=in_path(by_name, "mad_batched_kernel"))
if "mul32" in sys.argv[3:]:
    import dataclasses
    from spf_tpu_torch.cpu import ArgsBuilder, FheComputer, Memory
    from spf_tpu_torch.cpu.isa import RP, SP, Asm
    from spf_tpu_torch.ops.bootstrap import bsk_to_freq
    from spf_tpu_torch.runtime.executor_u32 import U32HostEvaluation
    from spf_tpu_torch.utils import host_crypto as hc

    p = DEFAULT_128
    g01 = encryption.encrypt_ggsw_scalar(torch.tensor([0, 1], device="cuda"), keys.glwe_sk,
                                         p.l1_params, p.cbs_radix, keys.gen)
    wm = WaveMachine(dataclasses.replace(keys.key, ggsw_zero_freq=bsk_to_freq(g01[0]),
                                         ggsw_one_freq=bsk_to_freq(g01[1])), p)
    mrng = np.random.default_rng(cs.MUL32_SEED)
    cts = [hc.encrypt_uint_bits_np(mrng, v, 32, sk, p.l1_params) for v in cs.MUL32]

    def run():
        mem = Memory()
        entry = mem.allocate_program(Asm().load(1, SP, 32, offset=0).load(2, SP, 32, offset=4)
                                     .mul(3, 1, 2).store(RP, 3, 32).ret().instrs)
        call = ArgsBuilder()
        for c in cts:
            call = call.arg_encrypted(c)
        rp = FheComputer(U32HostEvaluation(p), executor=wm).run_program(
            entry, mem, call.return_value(32).build())
        return mem, rp

    mem, rp = run()
    torch.cuda.synchronize()
    got = 0
    for i in range(4):
        for j, c in enumerate(mem.load_byte(rp + i).bits):
            got |= hc.decrypt_glwe_bit_np(c, sk, p.l1_params) << (8 * i + j)
    by_name = profiled_kernels(run)
    res["path 7 mul32"] = dict(got=got, want=(cs.MUL32[0] * cs.MUL32[1]) & 0xFFFFFFFF,
                               device_ms=sum(ms for ms, _ in by_name.values()),
                               mad_batched_kernel=in_path(by_name, "mad_batched_kernel"))
print("RESULT " + json.dumps(res), flush=True)
'''

RUN_PHASE = r'''
import json, sys
import torch
sys.path.insert(0, ".")
sys.path.append(sys.argv[2])  # the repository root: chip_smoke.py's timers' copies
import chip_smoke as cs
from spf_tpu_torch.ops import phase_rot
from spf_tpu_torch.scripts import device_ms, probe_edges, profiled_kernels, step_microbench

gen = torch.Generator(device="cuda").manual_seed(7)

def same(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))

n = 2048
k = n // 2
res = {}
for b in (256, 8):
    t = probe_edges.exponents(n, b, gen)
    for order, perm in (("scrambled", phase_rot.scrambled_perm(k)), ("natural", None)):
        args = (t, n, perm)
        ok = same(phase_rot.phase_minus_one(*args), phase_rot.phase_minus_one_plain(*args))
        nbytes = 16 * k * b + 8 * b + 16 * 2 * n + 4 * k
        ms, host_us = device_ms(phase_rot.phase_minus_one, cs.cold_copies(args, nbytes), 50)
        res[f"K={k} B={b} {order}"] = dict(bitexact=ok, ms=ms, host_us=host_us)
if sys.argv[1] == "check":
    res["shapes"] = probe_edges.check_phase(gen)
if "alone" not in sys.argv[3:]:
    comps = step_microbench.components(256, torch.device("cuda"))
    for name in ("pm1 doubling", "phase step (full)"):
        fn = comps[name]
        fn()
        torch.cuda.synchronize()
        by_name = profiled_kernels(lambda: [fn() for _ in range(step_microbench.ITERS)])
        ms, launches = by_name.get(next((x for x in by_name if x.startswith("phase_kernel")),
                                        ""), (0.0, 0))
        res[name] = dict(device_us=1e3 * sum(v for v, _ in by_name.values())
                         / step_microbench.ITERS,
                         phase_kernel_us=1e3 * ms / launches if launches else None,
                         launches=launches)
print("RESULT " + json.dumps(res), flush=True)
'''

RUN_PROBE = r'''
import ctypes, json, os, sys
import torch
sys.path.insert(0, ".")
sys.path.append(sys.argv[2])  # the repository root: chip_smoke.py's timers' copies
import chip_smoke as cs
from spf_tpu_torch.kernels.build import stream_of
from spf_tpu_torch.scripts import device_ms, probe_edges, vpu_probe

gen = torch.Generator(device="cuda").manual_seed(7)
x = vpu_probe.inputs("cuda")
elems = vpu_probe.R * vpu_probe.C
floor = ctypes.CDLL(os.path.join(sys.argv[2], "spf_tpu_torch", "_build", "libfma_floor.so"))
floor.spf_fma_floor.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]

def at_offset(t, offset):  # a copy of t `offset` elements past 16 bytes (any design's package)
    buf = torch.empty((t.numel() + 4,), dtype=t.dtype, device=t.device)
    view = buf[offset:offset + t.numel()].view(t.shape)
    view.copy_(t)
    return view

def same(a, b):
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())).all())

def floor_copy(vec):
    def run(a, b):
        e = torch.empty_like(a)
        err = floor.spf_fma_floor(a.data_ptr(), b.data_ptr(), e.data_ptr(), a.numel(), vec,
                                  stream_of(a))
        if err:
            raise RuntimeError(f"spf_fma_floor: CUDA error {err}")
        return e
    return run

ab = (x["a"], x["b"])
fma_bytes = 3 * 4 * elems
# a and b one element past 16 bytes, e aligned: every element on the scalar
# path (a clone would come back aligned, so the copies are made at the offset)
offset_copies = [tuple(at_offset(t, 1) for t in ab)
                 for _ in cs.cold_copies(ab, fma_bytes)]
res = {}
for name, kernel, plain, args, nbytes in (
        ("roll", vpu_probe.roll, vpu_probe.roll_plain, (x["roll"],), 2 * 4 * elems),
        ("f32 mul chain", lambda v: vpu_probe.chain(v, "f32 mul chain"),
         lambda v: vpu_probe.chain_plain(v, "f32 mul chain"), (x["f32"],), 2 * 4 * elems),
        ("fma_probe", vpu_probe.fma_probe, vpu_probe.fma_probe_plain, ab, fma_bytes),
        ("fma_probe_fma", vpu_probe.fma_probe_fma, vpu_probe.fma_probe_fma_plain, ab, fma_bytes),
        ("fma_probe a, b at +4 bytes", vpu_probe.fma_probe, vpu_probe.fma_probe_plain,
         offset_copies[0], fma_bytes),
        ("floor copy, an element a thread", floor_copy(0), None, ab, fma_bytes),
        ("floor copy, 2 vectors a thread", floor_copy(1), None, ab, fma_bytes)):
    ok = plain is None or same(kernel(*args), plain(*args))
    copies = offset_copies if args is offset_copies[0] else cs.cold_copies(args, nbytes)
    ms, host_us = device_ms(kernel, copies, 50)
    res[name] = dict(bitexact=ok, ms=ms, host_us=host_us)
if sys.argv[1] == "check":
    res["shapes"] = probe_edges.check_roll(gen)
    res["fma shapes"] = probe_edges.check_fma(gen)
if "alone" not in sys.argv[3:]:
    res["roll in vpu_probe"] = dict(ms=1e3 * vpu_probe.timed(lambda: vpu_probe.roll(x["roll"])))
    for name, fn in (("fma_probe", vpu_probe.fma_probe), ("fma_probe_fma", vpu_probe.fma_probe_fma)):
        res[name + " in vpu_probe"] = dict(ms=1e3 * vpu_probe.timed(lambda: fn(*ab)))
print("RESULT " + json.dumps(res), flush=True)
'''

# `fma_probe`'s traffic with no arithmetic: a and b read, e written (a
# bitwise OR uses both), on the grid of one element a thread (256 threads
# a block, plain loads) and on a grid of 2 16-byte vectors of each operand
# a thread (256 threads, streaming loads and stores): the floor under a
# kernel that moves those bytes so. Built once by `main` into the
# repository's `_build/`, beside no design.
FLOOR_CU = r'''
#include <cuda_runtime.h>

__global__ void floor_scalar(const unsigned* __restrict__ a, const unsigned* __restrict__ b,
                             unsigned* __restrict__ e, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) e[i] = a[i] | b[i];
}

__global__ void floor_vec(const uint4* __restrict__ a, const uint4* __restrict__ b,
                          uint4* __restrict__ e, int nvec) {
  const int base = blockIdx.x * 512 + threadIdx.x;
  uint4 x[2], y[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = base + i * 256;
    if (v < nvec) x[i] = __ldcs(a + v), y[i] = __ldcs(b + v);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = base + i * 256;
    if (v < nvec)
      __stcs(e + v, make_uint4(x[i].x | y[i].x, x[i].y | y[i].y, x[i].z | y[i].z, x[i].w | y[i].w));
  }
}

// n a multiple of 4 and the pointers 16-byte aligned where vec is set
extern "C" int spf_fma_floor(const void* a, const void* b, void* e, int n, int vec,
                             void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    floor_vec<<<(n / 4 + 511) / 512, 256, 0, s>>>((const uint4*)a, (const uint4*)b, (uint4*)e,
                                                  n / 4);
  else
    floor_scalar<<<(n + 255) / 256, 256, 0, s>>>((const unsigned*)a, (const unsigned*)b,
                                                 (unsigned*)e, n);
  return (int)cudaGetLastError();
}
'''


def build_floor() -> str:
    """`FLOOR_CU` built into the repository's `_build/` (its library path)."""
    from ..kernels import build as kbuild

    os.makedirs(kbuild.BUILD_DIR, exist_ok=True)
    src = os.path.join(kbuild.BUILD_DIR, "fma_floor.cu")
    with open(src, "w") as fh:
        fh.write(FLOOR_CU)
    out = os.path.join(kbuild.BUILD_DIR, "libfma_floor.so")
    subprocess.run([kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o", out, src], check=True,
                   capture_output=True, timeout=600)
    return out


RUN = {"fft": RUN_FFT, "rot_decomp": RUN_ROT, "mad": RUN_MAD, "phase": RUN_PHASE,
       "probe": RUN_PROBE}
# the repository root, whose chip_smoke.py drives the paths of RUN_MAD (and
# gives RUN_PHASE and RUN_PROBE their cold copies)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD = ("import sys; sys.path.insert(0, '.'); from spf_tpu_torch.kernels import build; "
         "build.build((sys.argv[1],))")


def main(argv=None) -> list:
    import torch

    from . import card, emit

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab: no CUDA device")
    args = list(sys.argv[1:] if argv is None else argv)
    source = "fft"
    if "--source" in args:
        i = args.index("--source")
        source = args[i + 1]
        del args[i:i + 2]
    if source not in RUN:
        raise ValueError(f"kernel_ab: --source {source}: one of {sorted(RUN)}")
    check = None
    if "--check" in args:
        i = args.index("--check")
        check = args[i + 1]
        del args[i:i + 2]
    extra = []
    for flag in ("--mul32", "--alone"):
        if flag in args:
            args.remove(flag)
            extra.append(flag[2:])
    dirs = args + ([check] if check else [])
    lines = []
    if source == "probe":
        lines.append(emit(dict(floor_library=build_floor())))
    procs = {d: subprocess.Popen([sys.executable, "-c", BUILD, source], cwd=d,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for d in dirs}
    for d, proc in procs.items():
        out, _ = proc.communicate()
        log = os.path.join(d, "spf_tpu_torch", "_build", f"{source}.log")
        ptxas = []
        if os.path.exists(log):
            with open(log, errors="replace") as fh:
                ptxas = [ln.strip() for ln in fh
                         if "Function properties" in ln or "registers" in ln or "spill" in ln]
        lines.append(emit(dict(design=d, build_rc=proc.returncode, ptxas=ptxas,
                               error=out[-2000:] if proc.returncode else None)))
    for d in dirs + dirs[::-1]:
        mode = "check" if d == check else "time"
        check = None if d == check else check  # the shape check once
        run = subprocess.run([sys.executable, "-c", RUN[source], mode, ROOT, *extra], cwd=d,
                             capture_output=True, text=True, timeout=900)
        got = [ln for ln in run.stdout.splitlines() if ln.startswith("RESULT ")]
        lines.append(emit(dict(design=d, rc=run.returncode,
                               result=json.loads(got[0][7:]) if got else None,
                               error=run.stderr[-2000:] if run.returncode else None)))
    lines.append(emit(dict(card=card(torch.device("cuda", 0))["nvidia_smi"])))
    return lines


if __name__ == "__main__":
    main()
