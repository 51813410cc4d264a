"""Encrypted unsigned-integer arithmetic: many instances of one integer
operation in one `FheCircuit`, run by `spf_tpu_torch.runtime.wave_machine.
WaveMachine` (circuit bootstrapping of the input bits, waves of CMuxes
through the BDD-built circuits of `spf_tpu_torch.circuits.integer`, a
refresh every 64 CMuxes).

Set-up: the client's work (the cycle's keys and the pool of encrypted
input sets, made on the card from the seed by `frozen/keygen.py`), then
the server's: the compute key's spectra and planes, and the circuit's
schedule, built once as a server compiles a program once. A call hands
one input set to `WaveMachine.run`, which uploads it, runs every wave and
returns the output GLWEs on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tfhe_bench.frozen import keygen
from tfhe_bench.reference import plain
from tfhe_bench.systems.multibit_pbs import glwe_def, lwe_def, radix_def, torch_generator

_KEY_STREAM, _ENC_STREAM = 1, 2
# the wave groups that run a circuit bootstrap
CBS_GROUPS = ("cbs", "convert", "refresh")


def program_params(p: dict):
    from spf_tpu_torch.params import GlweDef, LweDef, Params, RadixDecomposition

    def rd(pair):
        return RadixDecomposition(count=pair[0], radix_log=pair[1])

    return Params(
        l0_params=LweDef(dim=p["n0"], std=p["lwe_std"]),
        l1_params=GlweDef(size=p["k"], degree=p["N"], std=p["glwe_std"]),
        cbs_radix=rd(p["cbs_radix"]), pbs_radix=rd(p["pbs_radix"]),
        ks_radix=rd(p["ks_radix"]), pfks_radix=rd(p["pfks_radix"]),
        ss_radix=rd(p["ss_radix"]), tr_radix=rd(p["tr_radix"]),
        cbs_pbs_radix=rd(p["cbs_pbs_radix"]))


def integer_graph(op: str, width: int, n_inst: int):
    """One FheCircuit holding `n_inst` instances of a `width`-bit integer op:
    2 * width * n_inst L0 LWE inputs "b{r}" (bit idx of every instance,
    a's bits then b's), each through CBS, then the circuit of each
    instance over its bits, one OUTPUT_GLWE1 "o{j}_{wi}" an output bit.
    Returns (graph, [(instance, bit, key)])."""
    from spf_tpu_torch.circuits import integer as ic
    from spf_tpu_torch.runtime.fhe_circuit import CtType, FheCircuit, FheEdge, FheOp

    if op == "add":
        circuit = ic.ripple_carry_adder(width, emit_carry=True)
    elif op == "mul":
        circuit = ic.unsigned_multiplier(width, width)
    else:
        raise ValueError(f"unknown integer op {op!r}")
    g = FheCircuit()
    sel_all = []
    for r in range(2 * width * n_inst):
        nd = g.add_node(FheOp.INPUT_LWE0, f"b{r}")
        sel_all.append(g.insert_ciphertext_conversion(nd, CtType.LWE0, CtType.GGSW1))
    out_keys = []
    for j in range(n_inst):
        outs = g.insert_mux_circuit(circuit, [sel_all[i * n_inst + j] for i in range(2 * width)])
        for wi, o in enumerate(outs):
            on = g.add_node(FheOp.OUTPUT_GLWE1, f"o{j}_{wi}")
            g.add_edge(o, on, FheEdge.UNARY)
            out_keys.append((j, wi, f"o{j}_{wi}"))
    return g, out_keys


class WaveMachineSystem:
    def __init__(self, cfg: dict, traffic: dict, requests: list, seed: int, device: str):
        from spf_tpu_torch.runtime.executor_u32 import U32ComputeKey
        from spf_tpu_torch.runtime.wave_machine import WaveMachine

        p = cfg["params"]
        req = traffic["request"]
        ops = req["operands"]
        if sorted(ops) != ["a", "b"] or ops["a"] != ops["b"]:
            raise ValueError(f"{cfg['name']}: traffic must give operands a and b of one shape")
        self.device = torch.device(device)
        self.op = req["op"]
        self.width = ops["a"]["bits"]
        self.n_inst = ops["a"]["count"]
        self.units_per_call = self.n_inst
        self.requests = requests
        lwe = lwe_def(p["n0"], p["lwe_std"])
        glwe = glwe_def(p["k"], p["N"], p["glwe_std"])
        self.glwe = glwe

        # the client: the cycle's keys and the pool of encrypted input sets
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
            bits = np.array([(int(r["a"][j] if idx < self.width else r["b"][j])
                              >> (idx % self.width)) & 1
                             for idx in range(2 * self.width) for j in range(self.n_inst)])
            msgs = torch.from_numpy(bits).to(self.device) << 63
            rows = keygen.encrypt_lwe(msgs, lwe_sk, lwe, enc).cpu().numpy().view(np.uint64)
            self.pool.append({f"b{i}": rows[i] for i in range(rows.shape[0])})
        self.glwe_sk = glwe_sk.cpu().numpy()
        # the server: the compute key, the circuit and its schedule
        params = program_params(p)
        key = U32ComputeKey.from_coeff(bsk, ak, ssk, ksk, device=self.device)
        del bsk, ak, ssk, ksk, lwe_sk, glwe_sk
        self.graph, self.out_keys = integer_graph(self.op, self.width, self.n_inst)
        self.out_bits = 1 + max(wi for _, wi, _ in self.out_keys)
        self.wm = WaveMachine(key, params)
        self.sched = self.wm.schedule(self.graph)
        self._mark = 0

    def call(self, i: int) -> dict:
        return self.wm.run(self.graph, self.pool[i % len(self.pool)])

    def mark(self) -> None:
        self._mark = len(self.wm.wave_log)

    def counters(self, calls: int) -> dict:
        """The wave machine's own counts since `mark()`: waves run, and the
        width of every wave that runs a circuit bootstrap, in order."""
        widths = [w.width for w in self.sched.waves if w.group in CBS_GROUPS]
        return {"waves": len(self.wm.wave_log) - self._mark, "cbs_wave_widths": widths * calls}

    def shapes(self) -> dict:
        """Launch shapes of the circuit bootstrap's MAD, B left to each
        wave's width."""
        p = self.wm.params
        kp1 = p.l1_params.size + 1
        return {"mad_horner_g2": dict(group=2, kp1=kp1, l=p.cbs_pbs_radix_eff.count,
                                      k=p.l1_params.degree // 2)}

    def close(self) -> None:
        self.wm = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, outputs: list) -> dict:
        """Every output bit of every instance of every call decrypted and
        held against the plaintext result: `wrong` instances (any bit wrong
        or missing) and the worst error share over all output bits."""
        t0 = time.perf_counter()
        attempted = wrong = 0
        worst = 0.0
        n = self.glwe.degree
        for i, out in outputs:
            r = self.requests[i % len(self.requests)]
            want = plain.integer_op(self.op, r["a"], r["b"], self.out_bits)
            attempted += self.n_inst
            cts = np.zeros((len(self.out_keys), self.glwe.size + 1, n), dtype=np.uint64)
            missing = np.zeros(self.n_inst, dtype=bool)
            for row, (j, _, key) in enumerate(self.out_keys):
                ct = out.get(key)
                if ct is None or np.shape(ct) != cts.shape[1:]:
                    missing[j] = True
                else:
                    cts[row] = ct
            inst = np.array([j for j, _, _ in self.out_keys])
            bit = np.array([wi for _, wi, _ in self.out_keys])
            expected = (want[inst] >> bit) & 1
            decoded, share = plain.decode(plain.glwe_phases0(cts, self.glwe_sk), expected, 1)
            bad = missing.copy()
            np.logical_or.at(bad, inst, decoded != expected)
            wrong += int(bad.sum())
            ok_rows = ~missing[inst]
            if ok_rows.any():
                worst = max(worst, float(share[ok_rows].max()))
        return {"attempted": attempted, "failed": wrong,
                "numbers": {"wrong": wrong, "err_share": worst},
                "seconds": time.perf_counter() - t0}


def make(cfg, traffic, requests, seed, device):
    return WaveMachineSystem(cfg, traffic, requests, seed, device)
