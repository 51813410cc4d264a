"""A/B runs of designs of the FFT kernels (`csrc/fft.cu`) on one CUDA card.

    python -m spf_tpu_torch.scripts.fft_ab DIR [DIR ...] [--check DIR]

Each DIR holds a copy of the package, `DIR/spf_tpu_torch/`, whose
`csrc/fft.cu` is one design (or one diagnostic edit of a design). The
script builds every copy's FFT library at once, one nvcc each, then runs
each copy in a process of its own, in turns (DIR_1 .. DIR_n, then
DIR_n .. DIR_1), and prints one JSON line a run: `fwd_ds` at
[P, 2048, 256] for P = 4 and 8 and `inv_ds` at [P, 1024, 256] for P = 2
and 4 (DEFAULT_128 at batch 256: the paths' shapes), each held bit for bit
against its plain version and timed by `device_ms` (device ms a call, with
inputs rotating past the L2; host us a call). `--check DIR` also holds
that copy bit for bit at K in {2, 4, 8, 16, 32, 64, 1024, 2048} with B in
{1, 3, 8, 129, 256, 1024} and P in {1, 2, 4, 8}, on signed digits with a
zero lo plane, torus values and spectra of magnitude 2^70. Each run also
drives path 1 (the multi-bit PBS at DEFAULT_128, batch 256) once under
the profiler and gives the FFTs' device ms a launch there, where each
follows other kernels. The build's
lines give each kernel's registers and spills (ptxas), the last line the
card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# run in a copy's directory: imports that copy's spf_tpu_torch
RUN = r'''
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

BUILD = "import sys; sys.path.insert(0, '.'); from spf_tpu_torch.kernels import build; build.build(('fft',))"


def main(argv=None) -> list:
    import torch

    from . import card, emit

    if not torch.cuda.is_available():
        raise RuntimeError("fft_ab: no CUDA device")
    args = list(sys.argv[1:] if argv is None else argv)
    check = None
    if "--check" in args:
        i = args.index("--check")
        check = args[i + 1]
        del args[i:i + 2]
    dirs = args + ([check] if check else [])
    lines = []
    procs = {d: subprocess.Popen([sys.executable, "-c", BUILD], cwd=d, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True) for d in dirs}
    for d, proc in procs.items():
        out, _ = proc.communicate()
        log = os.path.join(d, "spf_tpu_torch", "_build", "fft.log")
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
        run = subprocess.run([sys.executable, "-c", RUN, mode], cwd=d, capture_output=True,
                             text=True, timeout=900)
        got = [ln for ln in run.stdout.splitlines() if ln.startswith("RESULT ")]
        lines.append(emit(dict(design=d, rc=run.returncode,
                               result=json.loads(got[0][7:]) if got else None,
                               error=run.stderr[-2000:] if run.returncode else None)))
    lines.append(emit(dict(card=card(torch.device("cuda", 0))["nvidia_smi"])))
    return lines


if __name__ == "__main__":
    main()
