"""The bootstrapping service: batches of LWE ciphertexts bootstrapped
through one LUT by `spf_tpu_torch.ops.multibit.MultibitBootstrap`.

Set-up: the client's work (keys and the pool of encrypted batches, made
on the card from the seed by `frozen/keygen.py`), then the server's (the
module, whose construction turns the key into spectra). A call uploads
one batch, bootstraps it, and downloads the outputs.
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from tfhe_bench.frozen import keygen
from tfhe_bench.reference import plain
from tfhe_bench.traffic import rng_for

_KEY_STREAM, _ENC_STREAM = 1, 2


def torch_generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch generator on `device` for one use of the run's seed."""
    s = int(rng_for(seed, stream).integers(0, 1 << 63))
    return torch.Generator(device=device).manual_seed(s)


def lwe_def(dim: int, std: float):
    return types.SimpleNamespace(dim=dim, std=std)


def glwe_def(k: int, n: int, std: float):
    return types.SimpleNamespace(size=k, degree=n, std=std, log_degree=n.bit_length() - 1)


def radix_def(pair):
    return types.SimpleNamespace(count=pair[0], radix_log=pair[1])


class PbsSystem:
    def __init__(self, cfg: dict, traffic: dict, requests: list, seed: int, device: str):
        from spf_tpu_torch.ops.multibit import MultibitBootstrap
        from spf_tpu_torch.params import GlweDef, RadixDecomposition

        p = cfg["params"]
        req = traffic["request"]
        if req["op"] != "lut" or list(req["operands"]) != ["x"]:
            raise ValueError(f"{cfg['name']}: traffic must be a LUT over one operand x")
        self.device = torch.device(device)
        self.bits = req["operands"]["x"]["bits"]
        self.add = req["add"]
        self.requests = requests
        self.units_per_call = req["operands"]["x"]["count"]
        lwe = lwe_def(p["n0"], p["lwe_std"])
        glwe = glwe_def(p["k"], p["N"], p["glwe_std"])
        radix = radix_def(p["pbs_radix"])
        self.group = p["group"]
        self.radix_log = radix.radix_log
        self.shape = dict(n0=p["n0"], k=p["k"], n=p["N"], l=radix.count, group=self.group)

        # the client: keys, the LUT and the pool of encrypted batches
        gen = torch_generator(seed, _KEY_STREAM, self.device)
        lwe_sk = keygen.generate_lwe_sk(lwe, gen)
        glwe_sk = keygen.generate_glwe_sk(glwe, gen)
        bsk = keygen.generate_multibit_bsk(lwe_sk, glwe_sk, glwe, radix, self.group, gen)
        add, bits = self.add, self.bits
        self.lut = keygen.generate_lut_np([lambda x: (x + add) % (1 << bits)], glwe, bits)
        enc = torch_generator(seed, _ENC_STREAM, self.device)
        self.pool = []
        for r in requests:
            msgs = torch.from_numpy(r["x"]).to(self.device) << (64 - bits - 1)
            ct = keygen.encrypt_lwe(msgs, lwe_sk, lwe, enc)  # [B, n0+1]
            self.pool.append(ct.T.contiguous().cpu())
        self.sk_flat = glwe_sk.reshape(-1).cpu().numpy()
        self.bsk = bsk  # for a reference put in the program's place
        # the server: key spectra on the card
        self.pbs = MultibitBootstrap(
            bsk, self.lut, GlweDef(size=p["k"], degree=p["N"], std=p["glwe_std"]),
            RadixDecomposition(count=radix.count, radix_log=radix.radix_log), self.group,
            device=self.device)
        del bsk, lwe_sk, glwe_sk

    def call(self, i: int) -> torch.Tensor:
        ct = self.pool[i % len(self.pool)].to(self.device)
        return self.pbs(ct).cpu()

    def mark(self) -> None:
        pass

    def counters(self, calls: int) -> dict:
        return {}

    def shapes(self) -> dict:
        """Launch shapes of one call's step kernels: the MAD (g, k+1, l, K,
        B) and both FFTs (P polynomials, K, B)."""
        s = self.shape
        kp1, k_bins, b = s["k"] + 1, s["n"] // 2, self.units_per_call
        return {
            f"mad_horner_g{s['group']}": dict(group=s["group"], kp1=kp1, l=s["l"], k=k_bins, b=b),
            "fwd_ds": dict(p=s["l"] * kp1, k=k_bins, b=b),
            "inv_ds": dict(p=kp1, k=k_bins, b=b),
        }

    def close(self) -> None:
        self.pbs = None
        self.bsk = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, outputs: list) -> dict:
        """Every output of every call decrypted and decoded against the
        plaintext LUT of its message: `wrong` outputs (or missing ones),
        and the worst error share over all outputs."""
        t0 = time.perf_counter()
        attempted = wrong = 0
        worst = 0.0
        want_rows = self.shape["k"] * self.shape["n"] + 1
        for i, out in outputs:
            msgs = self.requests[i % len(self.requests)]["x"]
            attempted += msgs.size
            out = out.numpy()
            if out.shape != (want_rows, msgs.size):
                wrong += msgs.size
                continue
            phases = plain.lwe_phases(out.T.view(np.uint64), self.sk_flat)
            expected = plain.add_mod(msgs, self.add, self.bits)
            decoded, share = plain.decode(phases, expected, self.bits)
            wrong += int((decoded != expected).sum())
            worst = max(worst, float(share.max()))
        return {"attempted": attempted, "failed": wrong,
                "numbers": {"wrong": wrong, "err_share": worst},
                "seconds": time.perf_counter() - t0}


def make(cfg, traffic, requests, seed, device):
    return PbsSystem(cfg, traffic, requests, seed, device)
