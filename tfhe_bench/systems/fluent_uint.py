"""Encrypted 32-bit multiplies as an integer server runs them: independent
`UInt<32> * UInt<32> -> UInt<64>` products, built with the port's fluent
API (`spf_tpu_torch.runtime.fluent`: the gradeschool product of four
16 x 16 BDD multiplier blocks and the column-compressor reduction, a
refresh every 64 CMuxes), as one `FheCircuit` run by
`spf_tpu_torch.runtime.wave_machine.WaveMachine`.

Set-up: the client's work (the cycle's keys, and the pool of input sets,
each operand bit an L1 GLWE of bit * 2^63 at coefficient 0, made on the
card from the seed by `frozen/keygen.py`), then the server's: the compute
key's spectra and planes, the circuit and its schedule, built once as a
server compiles a program once, and a first run. A call hands one input
set to `WaveMachine.run`, which uploads it, runs every wave (on a card,
after the first run, as replays of CUDA graphs) and returns the output
GLWEs on the host.

A call's units are the circuit bootstraps its circuit requires
(`cbs_per_op` of the configuration a multiply), so `pbs_per_s` stays
proportional to multiplies a second; set-up raises if the schedule holds
another count.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tfhe_bench.frozen import keygen
from tfhe_bench.reference import fluent_uint as ref, plain
from tfhe_bench.systems.multibit_pbs import glwe_def, lwe_def, radix_def, torch_generator
from tfhe_bench.systems.wave_machine import program_params

_KEY_STREAM, _ENC_STREAM = 1, 2
# the program's counters that a traced run reports
_COUNTER_PREFIX = "wm."


def build_graph(width: int, n_inst: int):
    """One FheCircuit of `n_inst` independent `width`-bit products through
    the fluent API. Returns (circuit, [(a's input keys, b's input keys,
    the product's output keys, LSB first)] an instance)."""
    from spf_tpu_torch.runtime.fluent import FheCircuitCtx, UInt

    ctx = FheCircuitCtx()
    wires = []
    for _ in range(n_inst):
        a, b = UInt.input(ctx, width), UInt.input(ctx, width)
        wires.append((a.input_keys(), b.input_keys(), (a * b).output()))
    return ctx.circuit, wires


def launch_shapes(sched, params) -> dict:
    """The batched-row MAD (`mad_batched_kernel`) of every launch of a
    run, in order: a CMux wave's (each stacked wave its own), an external
    product's and a refresh's (its CBS output, one GGSW a column), each as
    [B, distinct GGSW rows it reads], from the schedule's index arrays."""
    kp1 = params.l1_params.size + 1
    launches = []
    for w in sched.waves:
        if w.group in ("cmux", "cmux_scan", "extprod"):
            sel = np.asarray(w.idx["sel"]).reshape(-1, w.width)
            launches += [[w.width, int(np.unique(row).size)] for row in sel]
        elif w.group == "refresh":
            launches.append([w.width, w.width])
    return {"mad_batched": dict(kp1=kp1, l=params.cbs_radix.count,
                                k=params.l1_params.degree // 2, launches=launches)}


class FluentUintSystem:
    def __init__(self, cfg: dict, traffic: dict, requests: list, seed: int, device: str):
        from spf_tpu_torch.runtime.executor_u32 import U32ComputeKey
        from spf_tpu_torch.runtime.wave_machine import WaveMachine, schedule_counts
        from spf_tpu_torch.utils.profiling import DeviceSpanClock, metrics, span_clock

        p = cfg["params"]
        req = traffic["request"]
        ops = req["operands"]
        if req["op"] != "mul" or sorted(ops) != ["a", "b"] or ops["a"] != ops["b"]:
            raise ValueError(f"{cfg['name']}: traffic must multiply operands a and b of one shape")
        if ops["a"]["bits"] > 32:
            raise ValueError(f"{cfg['name']}: operands of at most 32 bits")
        self.device = torch.device(device)
        self.params = p
        self.requests = requests
        self.width = ops["a"]["bits"]
        self.n_inst = ops["a"]["count"]
        self.units_per_call = cfg["cbs_per_op"] * self.n_inst
        self.metrics = metrics
        self._clock_type, self._span_clock = DeviceSpanClock, span_clock
        self._clock = None
        self._mark: dict = {}
        lwe = lwe_def(p["n0"], p["lwe_std"])
        glwe = glwe_def(p["k"], p["N"], p["glwe_std"])
        self.glwe = glwe

        # the client: the cycle's keys and the pool of encrypted input sets
        gen = torch_generator(seed, _KEY_STREAM, self.device)
        lwe_sk = keygen.generate_lwe_sk(lwe, gen)
        glwe_sk = keygen.generate_glwe_sk(glwe, gen)
        keys = dict(
            bsk=keygen.generate_multibit_bsk(lwe_sk, glwe_sk, glwe, radix_def(p["cbs_pbs_radix"]),
                                             p["group_cbs"], gen),
            ak=keygen.generate_automorphism_keys(glwe_sk, glwe, radix_def(p["tr_radix"]), gen),
            ssk=keygen.generate_scheme_switch_key(glwe_sk, glwe, radix_def(p["ss_radix"]), gen),
            ksk=keygen.generate_lwe_keyswitch_key(glwe_sk.reshape(-1), lwe_sk, lwe,
                                                  radix_def(p["ks_radix"]), gen))
        self.graph, self.wires = build_graph(self.width, self.n_inst)
        enc = torch_generator(seed, _ENC_STREAM, self.device)
        self.pool = []
        for r in requests:
            names, bits = [], []
            for j, (a_keys, b_keys, _) in enumerate(self.wires):
                for keys_, x in ((a_keys, int(r["a"][j])), (b_keys, int(r["b"][j]))):
                    names += keys_
                    bits += [(x >> idx) & 1 for idx in range(self.width)]
            msgs = torch.zeros((len(bits), glwe.degree), dtype=torch.int64, device=self.device)
            msgs[:, 0] = torch.tensor(bits, dtype=torch.int64, device=self.device) << 63
            cts = keygen.encrypt_glwe(msgs, glwe_sk, glwe, enc).cpu().numpy().view(np.uint64)
            self.pool.append(dict(zip(names, cts)))
        self.glwe_sk = glwe_sk.cpu().numpy()
        self.keys = keys  # for a reference in the program's place
        # the server: the compute key, then the circuit's schedule
        params = program_params(p)
        key = U32ComputeKey.from_coeff(keys["bsk"], keys["ak"], keys["ssk"], keys["ksk"],
                                       device=self.device)
        del lwe_sk, glwe_sk
        self.wm = WaveMachine(key, params)
        self.sched = self.wm.schedule(self.graph)
        cbs = schedule_counts(self.sched)["wm.cbs_gates"]
        if cbs != self.units_per_call:
            raise ValueError(f"{cfg['name']}: the schedule runs {cbs} circuit bootstraps a call, "
                             f"the configuration counts {cfg['cbs_per_op']} x {self.n_inst}")
        self._shapes = launch_shapes(self.sched, params)
        self.run = self.wm.run
        # the program's first run: eager, it loads every kernel; the
        # harness's warm-up run then captures the schedule's CUDA graphs,
        # so every call of the window replays them
        self.run(self.graph, self.pool[0])

    def call(self, i: int) -> dict:
        """Output key -> GLWE u64 [k+1, N] on the host."""
        return self.run(self.graph, self.pool[i % len(self.pool)])

    def mark(self) -> None:
        """Start of the traced calls: the counters' base, and a device
        clock on the program's spans."""
        self._mark = self.metrics.snapshot()
        if self.device.type == "cuda":
            self._clock = self._clock_type()
            self._span_clock(self._clock)

    def counters(self, calls: int) -> dict:
        """The program's `wm.*` counters since `mark()`, and the device ms
        of each of its spans as `<span>.device_ms` (on a card)."""
        out = {k: v - self._mark.get(k, 0) for k, v in self.metrics.snapshot().items()
               if k.startswith(_COUNTER_PREFIX)}
        if self._clock is not None:
            self._span_clock(None)
            out.update({f"{k}.device_ms": v for k, v in self._clock.totals_ms().items()})
            self._clock = None
        return out

    def shapes(self) -> dict:
        return self._shapes

    def close(self) -> None:
        self.wm = self.run = None
        self.keys = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, outputs: list) -> dict:
        """Every output bit of every product of every call decrypted and
        held against the exact product (`reference/fluent_uint.product`):
        `wrong` bits (decoding wrong, missing or misshapen, or an input
        GLWE handed back as an output) and the worst output's error
        share."""
        t0 = time.perf_counter()
        attempted = wrong = 0
        worst = 0.0
        shape = (self.glwe.size + 1, self.glwe.degree)
        for i, out in outputs:
            r = self.requests[i % len(self.requests)]
            want = ref.product(r["a"], r["b"])
            pool = self.pool[i % len(self.pool)]
            inputs = {np.ascontiguousarray(x).tobytes() for x in pool.values()}
            rows, expected = [], []
            for j, (_, _, out_keys) in enumerate(self.wires):
                for bit, key in enumerate(out_keys):
                    attempted += 1
                    ct = out.get(key)
                    if ct is None or np.shape(ct) != shape:
                        wrong += 1
                    elif np.ascontiguousarray(ct, dtype=np.uint64).tobytes() in inputs:
                        wrong += 1
                    else:
                        rows.append(ct)
                        expected.append(int(want[j] >> np.uint64(bit)) & 1)
            if rows:
                expected = np.array(expected)
                decoded, share = plain.decode(plain.glwe_phases0(np.stack(rows), self.glwe_sk),
                                              expected, 1)
                wrong += int((decoded != expected).sum())
                worst = max(worst, float(share.max()))
        return {"attempted": attempted, "failed": wrong,
                "numbers": {"wrong": wrong, "err_share": worst},
                "seconds": time.perf_counter() - t0}


def make(cfg, traffic, requests, seed, device):
    return FluentUintSystem(cfg, traffic, requests, seed, device)
