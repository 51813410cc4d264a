"""FheCircuit executor over int64 wires, one batched wave per level.

Port of `spf_tpu/runtime/executor_u32.py`. It runs `FheCircuit` graphs
gate level by gate level: each level's gates of one kind run as one
batched call of the port's ops (`ops/bootstrap.py`, `ops/cbs.py`,
`ops/keyswitch.py`), with the gate batch on the lane (last) axis, padded
to a power of two by repeating the last lane (≙ `parasol_runtime/src/
circuit_processor/mod.rs` run_graph_blocking; one batched call a
levelized wave, SURVEY §7). `wave_machine.WaveMachine` runs the same
graphs from slot buffers and decrypts the same.

Boundary convention: inputs and outputs are host numpy u64 arrays, GLWE
[k+1, N] or LWE [n+1] (`utils/host_crypto.py` makes and reads them); the
wires live on the key's device. Plug an instance into `FheComputer(ev,
executor=...)` with `U32HostEvaluation` to run programs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import torus
from ..ops.bootstrap import as_tensor, bsk_to_freq, cmux, external_product, inv_limb, sample_extract
from ..ops.cbs import circuit_bootstrap
from ..ops.keyswitch import keyswitch_lwe, ksk_to_byte_planes
from ..ops.mux_eval_u32 import pad_lanes, trivial_bit_glwe
from ..params import Params
from ..utils.profiling import metrics
from .fhe_circuit import CircuitError, FheCircuit, FheEdge, FheOp


@dataclasses.dataclass
class U32ComputeKey:
    """Frequency-domain key material of the circuit executors.

    bsk/ak/ssk freq: 4-plane tuples of f32 spectra, made by the port's FFT
    (`bootstrap.bsk_to_freq`: the port has one frequency order, so no FFT
    backend is recorded); the LWE keyswitch key as f64 byte planes; the
    GGSW(0) / GGSW(1) constants (≙ the reference's precomputed trivial-bit
    GGSWs, `evaluation.rs:161-196`) as spectra [k+1, l, k+1, K], or None
    where no circuit uses them. All on one device, where the executors run.
    """

    bsk_freq: tuple
    ak_freq: tuple
    ssk_freq: tuple
    ksk_planes: torch.Tensor
    ggsw_zero_freq: tuple | None = None
    ggsw_one_freq: tuple | None = None

    @classmethod
    def from_coeff(cls, bsk, ak, ssk, ksk, ggsw_zero=None, ggsw_one=None,
                   device="cuda") -> "U32ComputeKey":
        """Build from coefficient-domain keys, u64 numpy or int64 tensors:
        the bootstrap key of circuit bootstrapping (multi-bit [n_groups,
        2^g-1, k+1, l, k+1, N] or single-bit [n0, k+1, l, k+1, N]), the
        automorphism keys, the scheme-switch key, the LWE keyswitch key
        [k*N, l_ks, n0+1] and the optional GGSW constants [k+1, l_cbs,
        k+1, N]. Spectra and planes are made on `device`."""
        device = torus.resolve_device(device)

        def f(x):
            return None if x is None else bsk_to_freq(as_tensor(x).to(device))

        return cls(bsk_freq=f(bsk), ak_freq=f(ak), ssk_freq=f(ssk),
                   ksk_planes=ksk_to_byte_planes(as_tensor(ksk).to(device)),
                   ggsw_zero_freq=f(ggsw_zero), ggsw_one_freq=f(ggsw_one))

    @property
    def device(self) -> torch.device:
        return self.bsk_freq[0].device


def _role(ins, role):
    for src, r in ins:
        if r == role:
            return src
    raise CircuitError(f"missing {role} input")


class U32HostEvaluation:
    """Minimal `Evaluation` stand-in binding `FheComputer` to the
    executors: the processor only needs `.params` and the two shared
    trivial GLWE bit handles (host numpy u64); all circuit execution goes
    through the executor passed as `FheComputer(..., executor=...)`."""

    class _Enc:
        def __init__(self, params: Params):
            glwe = params.l1_params
            z = np.zeros((glwe.size + 1, glwe.degree), dtype=np.uint64)
            o = z.copy()
            o[-1, 0] = np.uint64(1) << np.uint64(63)
            self._zero, self._one = z, o

        def trivial_glwe_l1_zero(self):
            return self._zero

        def trivial_glwe_l1_one(self):
            return self._one

    def __init__(self, params: Params):
        self.params = params
        self.enc = self._Enc(params)


# wire kinds carried between waves
_GLWE, _LWE1, _LWE0, _GGSW = "glwe", "lwe1", "lwe0", "ggsw"


def not_glwe(x: torch.Tensor) -> torch.Tensor:
    """Keyless NOT of GLWE bits int64 [k+1, N, W]: trivial(1) - x
    (`evaluation.rs:48`)."""
    out = torus.neg(x)
    out[-1, 0] = torus.add_small(out[-1, 0], torus.encode_const(1, 1))
    return out


class U32CircuitExecutor:
    """Level-synchronous batched executor over int64 wires.

    Compatible with `CircuitExecutor.run`'s (circuit, inputs) -> outputs
    contract, so it drops into `FheComputer`; inputs and outputs are
    numpy u64 arrays (GLWE [k+1, N], LWE0 [n0+1]).

    `whole_circuit` is accepted for the reference's signature. There the
    default compiles a whole circuit into one XLA program; PyTorch runs
    eagerly and has no such program to fuse into, so both settings run
    the same per-wave code.
    """

    def __init__(self, key: U32ComputeKey, params: Params, whole_circuit: bool = True):
        self.key = key
        self.params = params
        self.whole_circuit = whole_circuit
        # wave-size observability: (op, n_gates) per batched call
        self.wave_log: list = []

    # -- public API ----------------------------------------------------

    def run(self, circuit: FheCircuit, inputs: dict) -> dict:
        """inputs: {param: numpy u64 array} (GLWE [k+1, N] or LWE0
        [n0+1]). Returns {output param: numpy u64 array}. Each level's
        gates of one kind run as one batched call, lanes padded to the
        next power of two."""
        circuit.validate()
        in_params = {n.param for n in circuit.nodes if n.op.value.startswith("input_")}
        dev = self.key.device
        wires = {p: torus.from_u64_np(np.asarray(inputs[p]), dev) for p in in_params}
        out = self._run_waves(circuit, wires)
        return {p: torus.to_u64_np(v) for p, v in out.items()}

    # -- graph execution (host-driven waves) -----------------------------

    def _run_waves(self, circuit: FheCircuit, wires: dict) -> dict:
        levels = circuit.levelize()
        preds: dict[int, list] = {}
        refcount: dict[int, int] = {}
        for s, d, r in circuit.edges:
            preds.setdefault(d, []).append((s, r))
            refcount[s] = refcount.get(s, 0) + 1
        values: dict[int, tuple] = {}  # node -> (kind, tensor or 4-plane tuple)
        outputs: dict = {}

        def take(src):
            v = values[src]
            refcount[src] -= 1
            if refcount[src] == 0:
                del values[src]
            return v

        for level in levels:
            groups: dict[tuple, list[int]] = {}
            for nid in level:
                node = circuit.nodes[nid]
                gkey = (node.op, node.param if node.op in (FheOp.SAMPLE_EXTRACT, FheOp.MUL_XN)
                        else None)
                groups.setdefault(gkey, []).append(nid)
            for (op, gparam), nids in groups.items():
                self._exec_group(circuit, op, gparam, nids, preds, take, values, wires, outputs)
        return outputs

    def _exec_group(self, circuit, op, gparam, nids, preds, take, values, wires, outputs):
        p = self.params
        glwe = p.l1_params
        key = self.key
        g = len(nids)
        if op not in (FheOp.RETIRE, FheOp.NOP):
            self.wave_log.append((op.value, g))
            metrics.inc(f"u32exec.gates.{op.value}", g)
        pad_w = 1 << (g - 1).bit_length()

        def gather(role, want_kind):
            vals = [take(_role(preds.get(i, []), role)) for i in nids]
            kinds = {k for k, _ in vals}
            if kinds != {want_kind}:
                raise CircuitError(f"wire kinds {kinds} into {op}, want {want_kind}")
            planes = [v for _, v in vals]
            if want_kind == _GGSW:
                return tuple(pad_lanes(torch.cat([v[c] for v in planes], dim=-1), pad_w, True)
                             for c in range(4))
            return pad_lanes(torch.cat(planes, dim=-1), pad_w, True)

        def unstack(kind, out):
            for j, nid in enumerate(nids):
                values[nid] = (kind, out[..., j:j + 1])

        if op.value.startswith("input_"):
            kind = {FheOp.INPUT_GLWE1: _GLWE, FheOp.INPUT_LWE0: _LWE0,
                    FheOp.INPUT_LWE1: _LWE1}.get(op)
            if kind is None:
                raise CircuitError(f"{op} unsupported on the u32 executors")
            for nid in nids:
                v = wires[circuit.nodes[nid].param]
                if v.dim() == (1 if kind != _GLWE else 2):
                    v = v[..., None]
                values[nid] = (kind, v)
        elif op.value.startswith("output_"):
            for nid in nids:
                _, v = take(_role(preds.get(nid, []), FheEdge.UNARY))
                outputs[circuit.nodes[nid].param] = v[..., 0]
        elif op in (FheOp.RETIRE, FheOp.NOP):
            for nid in nids:
                ins = preds.get(nid, [])
                values[nid] = take(ins[0][0]) if ins else None
        elif op in (FheOp.ZERO_GLWE1, FheOp.ONE_GLWE1):
            v = trivial_bit_glwe(int(op == FheOp.ONE_GLWE1), glwe, 1, key.device)
            for nid in nids:
                values[nid] = (_GLWE, v)
        elif op in (FheOp.ZERO_GGSW1, FheOp.ONE_GGSW1):
            src = key.ggsw_one_freq if op == FheOp.ONE_GGSW1 else key.ggsw_zero_freq
            if src is None:
                raise CircuitError("circuit uses GGSW constants but the compute key has none")
            v = tuple(c[..., None] for c in src)
            for nid in nids:
                values[nid] = (_GGSW, v)
        elif op == FheOp.NOT:
            unstack(_GLWE, not_glwe(gather(FheEdge.UNARY, _GLWE)))
        elif op == FheOp.GLWE_ADD:
            a = gather(FheEdge.LEFT, _GLWE)
            b = gather(FheEdge.RIGHT, _GLWE)
            unstack(_GLWE, torus.add(a, b))
        elif op == FheOp.CMUX:
            d0 = gather(FheEdge.LOW, _GLWE)
            d1 = gather(FheEdge.HIGH, _GLWE)
            sel = gather(FheEdge.SEL, _GGSW)
            unstack(_GLWE, cmux(d0, d1, sel, p.cbs_radix))
        elif op == FheOp.MULTIPLY_GGSW_GLWE:
            x = gather(FheEdge.GLWE, _GLWE)
            sel = gather(FheEdge.GGSW, _GGSW)
            unstack(_GLWE, inv_limb(external_product(x, sel, p.cbs_radix)))
        elif op == FheOp.SAMPLE_EXTRACT:
            x = gather(FheEdge.UNARY, _GLWE)
            unstack(_LWE1, sample_extract(x, gparam or 0, glwe))
        elif op == FheOp.KEYSWITCH_L1_L0:
            x = gather(FheEdge.UNARY, _LWE1)
            unstack(_LWE0, keyswitch_lwe(x, key.ksk_planes, glwe.as_lwe_def(), p.l0_params,
                                         p.ks_radix))
        elif op == FheOp.CIRCUIT_BOOTSTRAP:
            x = gather(FheEdge.UNARY, _LWE0)
            out = circuit_bootstrap(x, key.bsk_freq, key.ak_freq, key.ssk_freq, p)
            for j, nid in enumerate(nids):
                values[nid] = (_GGSW, tuple(c[..., j:j + 1] for c in out))
        elif op == FheOp.MUL_XN:
            x = gather(FheEdge.UNARY, _GLWE)
            t = torch.full((x.shape[-1],), gparam or 0, dtype=torch.int64, device=x.device)
            unstack(_GLWE, torus.monomial_mul(x, t))
        else:
            raise CircuitError(f"{op} not supported on the u32 executors (GLEV-mode ops run "
                               "on the u64 CircuitExecutor)")

    # -- observability ---------------------------------------------------

    def wave_stats(self) -> dict:
        """Gate-batch statistics per op (the average gate batch of a
        batched call)."""
        return wave_stats(self.wave_log)


def wave_stats(wave_log: list) -> dict:
    """{op: waves, gates, mean and max batch} of a list of (op, gates)."""
    agg: dict[str, list] = {}
    for op, g in wave_log:
        agg.setdefault(op, []).append(g)
    return {
        op: {"waves": len(gs), "gates": int(np.sum(gs)),
             "mean_batch": round(float(np.mean(gs)), 1), "max_batch": int(np.max(gs))}
        for op, gs in agg.items()
    }
