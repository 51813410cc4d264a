"""The bit-refresh and circuit-bootstrap server: batches of L0 LWE bits
through `spf_tpu_torch.ops.cbs.ConversionCycle` (a circuit bootstrap of
each bit, a CMux of (0, q/2) under its GGSW, sample extraction, the
L1 -> L0 LWE keyswitch), each lane answered with a fresh L0 encryption of
its bit.

Set-up: the client's work (the cycle's keys and the pool of encrypted
batches, made on the card from the seed by `frozen/keygen.py`), then the
server's: the module, whose construction turns the keys into spectra and
byte planes. A call uploads one batch [n0+1, B], runs the cycle's three
stages as `ConversionCycle.forward` does (`bootstrap`, `select`,
`keyswitch`) and downloads [n0+1, B], with the GGSW spectra of
`SAMPLE` lanes of the batch (a different set each call, drawn from the
seed): the CMux of (0, q/2) reads only row k, level 0 of a GGSW, so the
output alone cannot show the other rows and levels.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tfhe_bench.frozen import keygen
from tfhe_bench.reference import cycle as ref_cycle, plain
from tfhe_bench.systems.multibit_pbs import glwe_def, lwe_def, radix_def, torch_generator
from tfhe_bench.systems.wave_machine import program_params
from tfhe_bench.traffic import rng_for

_KEY_STREAM, _ENC_STREAM, _SAMPLE_STREAM = 1, 2, 3
# the program's counters that a traced run reports
_COUNTER_PREFIX = "cbs."
# lanes a call whose GGSWs are downloaded and decrypted
SAMPLE = 8


def launch_shapes(p: dict, b: int) -> dict:
    """Launch shapes at configuration params `p` and B lanes: the circuit
    bootstrap's rotation MAD (g, k+1, l, K, B) and its FFTs (P = l (k+1)
    digit planes forward, k+1 planes back). Every inverse FFT of the cycle
    has that shape; of its 367 forward ones a call at DEFAULT_128, 321 do
    (the rotation's 319, the scheme switch's GLEV and the CMux's), and the
    reader that charges every launch at P = 8 counts 2,936 polynomial
    batches where 2,896 run (the trace's 44 at P = 6, the scheme switch's
    digits at 60 and its GLEV bodies at 4)."""
    kp1, l, k = p["k"] + 1, p["cbs_pbs_radix"][0], p["N"] // 2
    return {f"mad_horner_g{p['group_cbs']}": dict(group=p["group_cbs"], kp1=kp1, l=l, k=k, b=b),
            "fwd_ds": dict(p=l * kp1, k=k, b=b), "inv_ds": dict(p=kp1, k=k, b=b)}


class CycleSystem:
    def __init__(self, cfg: dict, traffic: dict, requests: list, seed: int, device: str):
        from spf_tpu_torch.ops.cbs import ConversionCycle
        from spf_tpu_torch.utils.profiling import DeviceSpanClock, metrics, span_clock

        p = cfg["params"]
        req = traffic["request"]
        ops = req["operands"]
        if req["op"] != "cycle" or list(ops) != ["x"] or ops["x"]["bits"] != 1:
            raise ValueError(f"{cfg['name']}: traffic must be a cycle of one operand x of 1 bit")
        self.device = torch.device(device)
        self.requests = requests
        self.units_per_call = ops["x"]["count"]
        self.params = p
        self.metrics = metrics
        self._clock_type, self._span_clock = DeviceSpanClock, span_clock
        self._clock = None
        self._mark: dict = {}
        lwe = lwe_def(p["n0"], p["lwe_std"])
        glwe = glwe_def(p["k"], p["N"], p["glwe_std"])

        # the client: the cycle's keys and the pool of encrypted batches
        gen = torch_generator(seed, _KEY_STREAM, self.device)
        lwe_sk = keygen.generate_lwe_sk(lwe, gen)
        glwe_sk = keygen.generate_glwe_sk(glwe, gen)
        bsk = keygen.generate_multibit_bsk(lwe_sk, glwe_sk, glwe, radix_def(p["cbs_pbs_radix"]),
                                           p["group_cbs"], gen)
        ak = keygen.generate_automorphism_keys(glwe_sk, glwe, radix_def(p["tr_radix"]), gen)
        ssk = keygen.generate_scheme_switch_key(glwe_sk, glwe, radix_def(p["ss_radix"]), gen)
        ksk = keygen.generate_lwe_keyswitch_key(glwe_sk.reshape(-1), lwe_sk, lwe,
                                                radix_def(p["ks_radix"]), gen)
        enc = torch_generator(seed, _ENC_STREAM, self.device)
        self.pool = []
        for r in requests:
            msgs = torch.from_numpy(r["x"]).to(self.device) << 63
            ct = keygen.encrypt_lwe(msgs, lwe_sk, lwe, enc)  # [B, n0+1]
            self.pool.append(ct.T.contiguous().cpu())
        b = self.units_per_call
        per_call = min(SAMPLE, b)
        lanes = rng_for(seed, _SAMPLE_STREAM).permutation(b)[: b // per_call * per_call]
        self.sample_lanes = lanes.reshape(-1, per_call)  # call i: row i mod rows
        self._sample_idx = torch.from_numpy(self.sample_lanes).to(self.device)
        self.lwe_sk = lwe_sk.cpu().numpy()
        self.glwe_sk_flat = glwe_sk.reshape(-1).cpu().numpy()
        self.keys = dict(bsk=bsk, ak=ak, ssk=ssk, ksk=ksk)  # for a reference in the program's place
        # the server: the keys' spectra and byte planes on the card
        self.cycle = ConversionCycle(bsk, ak, ssk, ksk, program_params(p), device=self.device)
        del bsk, ak, ssk, ksk, lwe_sk, glwe_sk

    def call(self, i: int):
        """(L0 LWE int64 [n0+1, B], the GGSW spectra of the call's sample
        lanes f32 [4, k+1, l, k+1, N/2, SAMPLE]), both on the host."""
        ct = self.pool[i % len(self.pool)].to(self.device)
        ggsw = self.cycle.bootstrap(ct)
        out = self.cycle.keyswitch(self.cycle.select(ggsw))
        idx = self._sample_idx[i % len(self._sample_idx)]
        sample = torch.stack([c.index_select(-1, idx) for c in ggsw])
        return out.cpu(), sample.cpu()

    def mark(self) -> None:
        """Start of the traced calls: the counters' base, and a device
        clock on the program's spans."""
        self._mark = self.metrics.snapshot()
        if self.device.type == "cuda":
            self._clock = self._clock_type()
            self._span_clock(self._clock)

    def counters(self, calls: int) -> dict:
        """The program's `cbs.*` counters since `mark()`, and the device ms
        of each of its spans as `<span>.device_ms` (on a card)."""
        out = {k: v - self._mark.get(k, 0) for k, v in self.metrics.snapshot().items()
               if k.startswith(_COUNTER_PREFIX)}
        if self._clock is not None:
            self._span_clock(None)
            out.update({f"{k}.device_ms": v for k, v in self._clock.totals_ms().items()})
            self._clock = None
        return out

    def shapes(self) -> dict:
        return launch_shapes(self.params, self.units_per_call)

    def close(self) -> None:
        self.cycle = None
        self.keys = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _ggsw_shares(self, sample: torch.Tensor, bits: np.ndarray) -> np.ndarray:
        """Each sample lane's worst GGSW error share (`reference/cycle.py`),
        its spectra brought back to coefficients by the program's inverse
        FFT, the transform its own CMux leaves the frequency domain by."""
        from spf_tpu_torch.ops.bootstrap import inv_limb

        p = self.params
        coeff = inv_limb(tuple(sample.to(self.device)))  # [k+1, l, k+1, N, S]
        sk = torch.from_numpy(self.glwe_sk_flat.reshape(p["k"], p["N"])).to(self.device)
        shares = ref_cycle.ggsw_error_shares(coeff.permute(4, 0, 1, 2, 3), torch.from_numpy(bits)
                                             .to(self.device), sk, p["cbs_radix"][1])
        return shares.cpu().numpy()

    def check(self, outputs: list) -> dict:
        """Every lane of every call decrypted under the L0 key and held
        against its input bit, and each call's sample of GGSWs decrypted
        under the L1 key, row by row and level by level: `wrong` lanes
        (decoding wrong, missing, answered with the input's own mask,
        which would decode right, or with a GGSW any coefficient of which
        decodes wrong), and the worst output's error share. The GGSWs'
        shares stay out of `err_share`: the program's ds32 rounding puts
        the finest level of rows j < k at up to half its step (0.37-0.48
        on the card) where the L0 outputs read under 0.2."""
        t0 = time.perf_counter()
        attempted = wrong = 0
        worst = 0.0
        p = self.params
        want_sample = (4, p["k"] + 1, p["cbs_radix"][0], p["k"] + 1, p["N"] // 2,
                       self.sample_lanes.shape[1])
        for i, (out, sample) in outputs:
            bits = self.requests[i % len(self.requests)]["x"]
            inp = self.pool[i % len(self.pool)]
            attempted += bits.size
            if tuple(out.shape) != tuple(inp.shape) or tuple(sample.shape) != want_sample:
                wrong += bits.size
                continue
            phases = plain.lwe_phases(out.numpy().T.view(np.uint64), self.lwe_sk)
            decoded, share = plain.decode(phases, bits, 1)
            bad = (decoded != bits) | (out[:-1] == inp[:-1]).all(dim=0).numpy()
            lanes = self.sample_lanes[i % len(self.sample_lanes)]
            ggsw_share = self._ggsw_shares(sample, bits[lanes])
            bad[lanes] |= ~(ggsw_share < 1)  # NaN is wrong
            wrong += int(bad.sum())
            worst = max(worst, float(share.max()))
        return {"attempted": attempted, "failed": wrong,
                "numbers": {"wrong": wrong, "err_share": worst},
                "seconds": time.perf_counter() - t0}


def make(cfg, traffic, requests, seed, device):
    return CycleSystem(cfg, traffic, requests, seed, device)
