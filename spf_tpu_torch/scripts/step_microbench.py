"""Time the components of one blind-rotation step at DEFAULT_128 on the
card: the port's counterpart of `scripts/tpu_step_microbench.py`.

    python -m spf_tpu_torch.scripts.step_microbench [--batch 256]

Random accumulator, exponents t and key row from a seeded generator (as
the script's `:28-35`), then, per component, ITERS = 50 calls issued back
to back and synchronised (host us per call, and the kernel launches of
those calls) and 50 more under torch.profiler (device us per call). One
JSON line per component.

Components, in the script's order: `monomial_mul`, `decompose`,
decompose + `fwd_signed`, `external_product`, `cmux`, the full step
(monomial_mul + cmux), `rotate_sub_decompose`, rot_decomp + forward FFT,
the inverse FFT + `from_ds` + add tail, the fused u32f step (rot_decomp,
FFT, `freq_mad`, inverse FFT, add); then the phase section:
`accumulate_decompose`, "pm1 doubling" (the `phase_minus_one` kernel with
`perm = scrambled_perm(K)`: the port's FFT emits plain bit reversal, as
`fft_pallas` does), "pm1 hoisted combine" (`combine_phase_minus_one` of
one step's hoisted factors as eager PyTorch operators: the rotations no
longer run it, since the MAD kernel forms the factors from the same
halves in registers), "pm1
gather" (plain indexing into the psi table, as the script does) and the
"phase step (full)": accumulate_decompose -> `fwd_ds` -> pm1 ->
`ds.cmul(dfft, pm1)` -> `freq_mad` -> `inv_ds` -> `from_ds` + add (the
cmul is plain PyTorch glue, as it is XLA glue in the script).

Differences from the script: it times each component as a `fori_loop`
inside one jit, whose result feeds the next iteration; eager PyTorch has
no counterpart, so here each call is issued on its own and nothing is
folded back into the accumulator (nothing would eliminate it). The
product pair of `accumulate_decompose` has the accumulator's shape
[k+1, N, B], which the kernel requires.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import bootstrap, ds, fft, phase_rot, rot_decomp, torus
from ..ops.encryption import uniform_torus
from ..ops.mad import freq_mad
from ..params import DEFAULT_128
from . import card, emit, time_calls

ITERS = 50
SEED = 0


def components(batch: int, device: torch.device, params=DEFAULT_128) -> dict:
    """{name: zero-argument callable} of every component, on inputs made
    from a seeded generator on `device`."""
    glwe, radix = params.l1_params, params.pbs_radix
    n, k, kp1 = glwe.degree, glwe.degree // 2, glwe.size + 1
    gen = torch.Generator(device=device).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    acc = uniform_torus((kp1, n, batch), gen)
    t = torch.randint(0, 2 * n, (batch,), generator=gen, device=device)
    row = tuple(randn(kp1, radix.count, kp1, k, scale=2.0**40) for _ in range(4))
    accf = tuple(randn(kp1, k, batch, scale=s) for s in (2.0**40, 1.0, 2.0**40, 1.0))
    prod = (randn(kp1, n, batch, scale=2.0**40), randn(kp1, n, batch))
    zeros = torch.zeros((radix.count, kp1, n, batch), device=device)
    perm = phase_rot.scrambled_perm(k)
    lo, hi = phase_rot.phase_factors_all(t[None], n)
    lo_t, hi_t = (tuple(c[0] for c in x) for x in (lo, hi))
    tabs = phase_rot._psi_table(2 * n, device)
    m1m4 = torch.remainder(1 - 4 * torch.arange(k, device=device), 4 * n)  # (1-4m) mod 4N

    def fused_step():
        digits = rot_decomp.rotate_sub_decompose(acc, t, radix)
        prod_f = freq_mad(fft.fwd_ds(digits, zeros), row)
        return torus.add(acc, bootstrap.inv_limb(prod_f))

    def pm1_gather():
        idx = (t[None, :] * m1m4[:, None]) & (2 * n - 1)
        return tuple(c[idx] for c in tabs)

    def phase_step():
        digits, acc2 = rot_decomp.accumulate_decompose(acc, prod, radix)
        dfft = fft.fwd_ds(digits, zeros)
        dfft = ds.cmul(dfft, phase_rot.phase_minus_one(t, n, perm))
        prod2 = fft.inv_ds(freq_mad(dfft, row))
        return torus.add(acc2, torus.from_ds(*prod2))

    return {
        "monomial_mul": lambda: torus.monomial_mul(acc, t),
        "decompose": lambda: torus.decompose(acc, radix),
        "decompose+fwd_signed": lambda: bootstrap.fwd_signed(torus.decompose(acc, radix)),
        "external_product": lambda: bootstrap.external_product(acc, row, radix),
        "cmux": lambda: bootstrap.cmux(acc, acc, row, radix),
        "step (monomial_mul+cmux)": lambda: bootstrap.cmux(
            acc, torus.monomial_mul(acc, t), row, radix),
        "rotate_sub_decompose": lambda: rot_decomp.rotate_sub_decompose(acc, t, radix),
        "rotate_sub_decompose+fwd": lambda: fft.fwd_ds(
            rot_decomp.rotate_sub_decompose(acc, t, radix), zeros),
        "inv+from_ds+add tail": lambda: torus.add(acc, bootstrap.inv_limb(accf)),
        "step (fused u32f)": fused_step,
        "accumulate_decompose": lambda: rot_decomp.accumulate_decompose(acc, prod, radix),
        "pm1 doubling": lambda: phase_rot.phase_minus_one(t, n, perm),
        "pm1 hoisted combine": lambda: phase_rot.combine_phase_minus_one(lo_t, hi_t),
        "pm1 gather": pm1_gather,
        "phase step (full)": phase_step,
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args(argv)
    device = torus.resolve_device("cuda")
    p = DEFAULT_128
    lines = [emit(dict(probe="step_microbench", batch=args.batch, n=p.l1_params.degree,
                       iters=ITERS, card=card(device)))]
    for name, fn in components(args.batch, device, p).items():
        lines.append(emit(dict(component=name, **time_calls(fn, ITERS))))
    lines.append(emit(dict(probe="step_microbench", ok=True)))
    return lines


if __name__ == "__main__":
    main()
