"""op_noise: measure the empirical noise distributions of FHE ops on the
card and write them as JSON (≙ `examples/op_noise.py`, the reference's
`parasol_runtime/examples/op_noise`).

    python -m spf_tpu_torch.scripts.op_noise [--out noise_analysis.json]
        [--depth 8] [--trials 4]

The same parameter set (`PARAMS`) and the same JSON rows as the JAX
package's example: the GLWE encryption, the L1 -> L0 LWE keyswitch, a
chain of `depth` CMuxes and a CMux behind a circuit bootstrap, each row
`{"op", "samples", "log2_std", "log2_max"}` (log2 in torus units of
q = 2**64). Keys and samples are made on the card from a seeded
`torch.Generator`; without a card it raises. `measure(...,
device="cpu")` runs the same on the CPU.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops.u64.torus import resolve_device
from ..params import GlweDef, LweDef, Params, RadixDecomposition
from ..runtime.evaluation import Evaluation
from ..runtime.keys import generate_keys
from ..utils import noise

PARAMS = Params(
    l0_params=LweDef(dim=128, std=1e-16),
    l1_params=GlweDef(size=1, degree=256, std=1e-16),
    cbs_radix=RadixDecomposition(count=2, radix_log=9),
    pbs_radix=RadixDecomposition(count=2, radix_log=16),
    ks_radix=RadixDecomposition(count=9, radix_log=4),
    pfks_radix=RadixDecomposition(count=4, radix_log=11),
    ss_radix=RadixDecomposition(count=6, radix_log=8),
    tr_radix=RadixDecomposition(count=6, radix_log=7),
)
SEED = 0  # the example's key(0)


def measure(params: Params = PARAMS, depth: int = 8, trials: int = 4, device="cuda") -> list:
    """The example's four measurements as its JSON rows: keys from a
    generator seeded `SEED` on `device`, the measurements folding trials
    into the same generator's seed (`noise.fold_in`)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    sk, _, ck = generate_keys(gen, params, device=device)
    ev = Evaluation(ck, params, precompute_constants=False, device=device)
    results = [noise.measure_encryption_noise(gen, sk, params).as_dict(),
               noise.measure_keyswitch_noise(gen, sk, ev, params).as_dict()]
    results.extend(s.as_dict() for s in noise.measure_cmux_noise(gen, sk, ev, params,
                                                                 depth=depth, trials=trials))
    results.append(noise.measure_cbs_noise(gen, sk, ev, params, trials=trials).as_dict())
    return results


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="noise_analysis.json")
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--trials", type=int, default=4)
    args = ap.parse_args(argv)
    results = measure(PARAMS, args.depth, args.trials, device="cuda")
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    for r in results:
        print(f"{r['op']:>20}: log2(std)={r['log2_std']:7.2f} log2(max)={r['log2_max']:7.2f}")
    print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
