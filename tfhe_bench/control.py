"""The control readings that set the limits of `correct`, in one process for
many seeds.

    python3 -m tfhe_bench.control --workload <cell> --mode <mode> --seconds <s> --seeds <n> ...

Each seed is a run of the cell as `run.py` makes it (its own keys and
inputs, a window of `--seconds`, every output judged), with the numbers
compared printed as one JSON line. Modes:

- `control`: the control, which has to come out not correct: for a
  bootstrapping cell the plain reference (`reference/pbs.py`) put in the
  program's place and computed in float32, the precision below the
  configuration's ds32; for a cell with no plain reference of its
  ciphertexts, `plant` below;
- `plant`: the program with its f32 path switched on: every spectrum its
  FFT makes and reads rounded to f32 (the low halves of its ds32 pairs set
  to zero), key spectra included;
- `reference64`: the plain reference in float64 in the program's place
  (bootstrapping cells; it has to come out correct).

The benchmark's own runs never run this module.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from tfhe_bench import run
from tfhe_bench.reference import pbs as ref_pbs

MODES = ("control", "plant", "reference64")


@contextlib.contextmanager
def f32_spectra():
    """Switch the program's ds32 FFTs to f32 precision: the forward
    transform's spectra and the inverse transform's input spectra keep
    only their high f32 halves, its output only its high half."""
    from spf_tpu_torch.ops import fft

    fwd, inv = fft.fwd_ds, fft.inv_ds

    def fwd32(hi, lo):
        rh, _, ih, _ = fwd(hi, lo)
        return rh, torch.zeros_like(rh), ih, torch.zeros_like(ih)

    def inv32(f):
        rh, _, ih, _ = f
        hi, _ = inv((rh, torch.zeros_like(rh), ih, torch.zeros_like(ih)))
        return hi, torch.zeros_like(hi)

    fft.fwd_ds, fft.inv_ds = fwd32, inv32
    try:
        yield
    finally:
        fft.fwd_ds, fft.inv_ds = fwd, inv


def reference_in_place(dtype: torch.dtype):
    """A hook that puts the plain reference PBS in the program's place."""
    def hook(system):
        lut = torch.from_numpy(system.lut.view("int64")).to(system.device)
        bsk = system.bsk
        radix = system.shape["l"], system.radix_log
        group = system.group

        def reference(ct):
            return ref_pbs.programmable_bootstrap(ct, lut, bsk, group, *radix, dtype=dtype,
                                                  chunk=512)

        system.pbs = reference
    return hook


def readings(bench: dict, cell: str, mode: str, seeds: list, seconds: float,
             device: str = "cuda", **overrides) -> list:
    """One line of numbers a seed: {"seed", "correct", "checks", ...}."""
    _, cfg, _ = run.cell_parts(bench, cell)
    cfg = overrides.get("cfg_override") or cfg
    plain_pbs = cfg["entry"] == "multibit_pbs"
    if mode in ("control", "reference64") and not plain_pbs:
        if mode == "reference64":
            raise ValueError(f"{cell}: no plain reference of its ciphertexts")
        mode = "plant"
    hooks = None
    if mode == "control":
        hooks = reference_in_place(torch.float32)
    elif mode == "reference64":
        hooks = reference_in_place(torch.float64)
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        with f32_spectra() if mode == "plant" else contextlib.nullcontext():
            r = run.run_cell(bench, cell, seed, seconds, False, device=device, hooks=hooks,
                             **overrides)
        res = r["result"]
        line = {"cell": cell, "mode": mode, "seed": seed, "correct": res["correct"],
                "attempted": res["attempted"], "failed": res["failed"],
                "checks": res["checks"], "calls": r["info"]["calls"],
                "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        out.append(line)
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tfhe_bench.control", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=MODES, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tfhe_bench.control: no CUDA card", file=sys.stderr)
        return 2
    bench = run.load_json(f"{run.ROOT}/BENCHMARK.json")
    readings(bench, args.workload, args.mode, args.seeds, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
