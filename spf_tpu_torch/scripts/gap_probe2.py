"""The per-group cost of the multi-bit blind rotation with its phases
hoisted: the port's counterpart of `scripts/gap_probe2.py`.

    python -m spf_tpu_torch.scripts.gap_probe2 [--batch 256] [--group 3]

DEFAULT_128, random switched ciphertexts, LUT and multi-bit key spectra
from a seeded generator (the script's `:38-47`). Three variants of the
rotation, each run once (first call), then 3 timed synchronised calls on
inputs shifted by 1, 2, 3 (best wall time) and one profiled call (device
time); per variant one JSON line with wall and device us per group, the
kernel launches of one call and of all five:

1. "multibit.blind_rotate_multibit": the port's rotation as it is (it
   builds the phases inside the call and fences them);
2. "hoisted phases (precomputed input)": the same group steps
   (`multibit.rotate_groups`) on phase factors built before the call;
3. "in-call phases + opaque_materialize": the phases built inside the
   call and passed through `opaque_materialize`, which on the card is the
   port's fence kernel (`csrc/fence.cu`): the Pallas body of the script's
   `opaque_materialize` is the same identity copy as `phase_rot.fence`'s.
   On the port this is variant 1 written out: `blind_rotate_multibit`
   already builds its phases inside the call and passes them through the
   same fence, so the two make the same launches and should take the same
   time; the variant stays as the script's, to show that they do.

Their split between host and device time says how much of a group step
is host dispatch, which a CUDA graph would remove. The script's variant
"in-jit phases + opt barrier" has no eager PyTorch counterpart and is
left out (eager PyTorch recomputes nothing, so it has nothing to pin).
The port has one frequency order, bit reversal, so the phases use the
port's `backend_bit_images(n)`, not the XLA order that the script's
`use_pallas=False` picks. The three variants compute the same bits; the
script checks that they do.
"""

from __future__ import annotations

import argparse
import time

import torch

from .. import kernels
from ..ops import multibit, phase_rot, torus
from ..ops.encryption import uniform_torus
from ..params import DEFAULT_128
from . import card, emit, launches_since, profiled_device_ms

SEED = 0
ITERS = 3


def opaque_materialize(x: torch.Tensor) -> torch.Tensor:
    """Identity through a kernel (≙ `scripts/gap_probe2.py::opaque_materialize`):
    the port's fence copy on CUDA tensors, `clone` on CPU tensors."""
    return phase_rot.fence(x)


def variants(batch: int, group: int, device: torch.device, params=DEFAULT_128):
    """(switched ciphertexts, {name: callable(ct_sw)}) on inputs made from
    a seeded generator on `device`."""
    glwe, lwe, radix = params.l1_params, params.l0_params, params.pbs_radix
    n, k, kp1 = glwe.degree, glwe.degree // 2, glwe.size + 1
    ng = multibit.n_groups(lwe.dim, group)
    gen = torch.Generator(device=device).manual_seed(SEED)
    ct_sw = torch.randint(0, 2 * n, (lwe.dim + 1, batch), generator=gen, device=device)
    lut = uniform_torus((kp1, n), gen)
    bsk = tuple(torch.randn((ng, (1 << group) - 1, kp1, radix.count, kp1, k), generator=gen,
                            device=device) * 2.0**40 for _ in range(4))

    def acc0(c):
        return torus.monomial_mul(lut[..., None].expand(kp1, n, batch), 2 * n - c[-1])

    def real(c):
        return multibit.blind_rotate_multibit(lut[..., None], c, bsk, glwe, radix, group)

    hoisted = multibit.group_phases(multibit.padded_mask(ct_sw, group), n, group)

    def precomputed(c):
        return multibit.rotate_groups(acc0(c), *hoisted, bsk, radix, group)

    def fenced(c):
        ph = multibit.group_phases(multibit.padded_mask(c, group), n, group)
        ph_lo, ph_hi = (tuple(opaque_materialize(p) for p in x) for x in ph)
        return multibit.rotate_groups(acc0(c), ph_lo, ph_hi, bsk, radix, group)

    return ct_sw, {
        "multibit.blind_rotate_multibit": real,
        "hoisted phases (precomputed input)": precomputed,
        "in-call phases + opaque_materialize": fenced,
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--group", type=int, default=3)
    args = ap.parse_args(argv)
    device = torus.resolve_device("cuda")
    p = DEFAULT_128
    ng = multibit.n_groups(p.l0_params.dim, args.group)
    lines = [emit(dict(probe="gap_probe2", batch=args.batch, group=args.group, n_groups=ng,
                       card=card(device)))]
    ct_sw, fns = variants(args.batch, args.group, device, p)
    outs = []
    for name, fn in fns.items():
        start = kernels.launches()
        t0 = time.perf_counter()
        outs.append(fn(ct_sw))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        walls = []
        launches = None
        for i in range(ITERS):
            c = ct_sw + (i + 1)  # other exponents each call, as the script's
            mark = kernels.launches()
            t0 = time.perf_counter()
            fn(c)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches = launches_since(mark)
        dev_us = profiled_device_ms(lambda: fn(ct_sw))[0] * 1e3
        wall_us = min(walls) * 1e6
        lines.append(emit(dict(
            variant=name, first_call_s=first_s, wall_s=walls,
            wall_us_per_group=wall_us / ng,
            device_us_per_group=dev_us / ng, host_share=1.0 - dev_us / wall_us,
            launches_per_call=launches, launches=launches_since(start),
        )))
    same = all(torch.equal(o, outs[0]) for o in outs[1:])
    lines.append(emit(dict(probe="gap_probe2", variants_bit_identical=same, ok=same)))
    if not same:
        raise AssertionError("gap_probe2: the three variants of the rotation disagree")
    return lines


if __name__ == "__main__":
    main()
