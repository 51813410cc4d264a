"""Level-synchronous batched circuit executor of the u64 API.

Port of `spf_tpu/runtime/executor.py` (≙ the reference's
`CircuitProcessor`, `circuit_processor/mod.rs:62-656`, inverted): the
circuit is levelized once on the host, each level's gates are grouped by
(op, param), and each group runs as one batched call of `Evaluation`'s
ops, its inputs stacked on a new leading axis. The reference pads each
group to a power of two so that `jax.jit` sees few batch shapes; nothing
is traced here, so groups run at their own width. Each value is dropped
as soon as its last consumer has read it.

Handles: inputs are int64 tensors or the host u64 numpy arrays of
`utils.host_crypto` (GGSW inputs complex128 spectra); they are read on the
`Evaluation`'s device, and every output is an int64 (or complex128)
tensor there. The encrypted CPU hands its handles back in later flushes
as they are.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.u64 import torus
from ..utils.profiling import metrics
from .evaluation import Evaluation
from .fhe_circuit import CircuitError, FheCircuit, FheEdge, FheOp


def _role(ins, role):
    for src, r in ins:
        if r == role:
            return src
    raise CircuitError(f"missing {role} input")


class CircuitExecutor:
    """Runs `FheCircuit`s on an `Evaluation`, on the evaluation's device.

    `debug` records each dispatched group as (op, param, gates) in
    `debug_log` (≙ the reference's `debug` ring of completed task ids,
    `circuit_processor/mod.rs:35-42`); `profiler` may be set to a
    `utils.profiling.WaveProfiler` to time each group, synchronised."""

    def __init__(self, ev: Evaluation, debug: bool = False):
        self.ev = ev
        self.be = ev.be
        self.device = ev.device
        self.debug = debug
        self.debug_log: list = []
        self.profiler = None
        self._compile_cache: dict = {}

    # --- constants ---

    def _const(self, op: FheOp):
        ev = self.ev
        enc = ev.enc
        if op == FheOp.ZERO_LWE0:
            return enc.trivial_lwe_l0(0)
        if op == FheOp.ONE_LWE0:
            return enc.trivial_lwe_l0(1)
        if op == FheOp.ZERO_GLWE1:
            return enc.trivial_glwe_l1_zero()
        if op == FheOp.ONE_GLWE1:
            return enc.trivial_glwe_l1_one()
        if op == FheOp.ZERO_GGSW1:
            return ev.ggsw_zero
        if op == FheOp.ONE_GGSW1:
            return ev.ggsw_one
        if op in (FheOp.ZERO_GLEV1, FheOp.ONE_GLEV1):
            poly = torch.zeros(ev.params.l1_params.degree, dtype=torch.int64, device=self.device)
            poly[0] = int(op == FheOp.ONE_GLEV1)
            return enc.trivial_glev_l1(poly)
        raise CircuitError(f"not a constant: {op}")

    def _as_tensor(self, v):
        """An input handle on the evaluation's device."""
        if isinstance(v, np.ndarray):
            if np.iscomplexobj(v):
                return torch.from_numpy(v).to(self.device)
            return torus.from_u64_np(v, self.device)
        return v.to(self.device)

    # --- execution ---

    def run(self, circuit: FheCircuit, inputs: dict) -> dict:
        """Execute a circuit. `inputs` maps the `param` key of each INPUT_*
        node to its ciphertext; returns {output param key: ciphertext}."""
        circuit.validate()
        levels = circuit.levelize()
        preds: dict[int, list] = {}
        refcount: dict[int, int] = {}
        for s, d, r in circuit.edges:
            preds.setdefault(d, []).append((s, r))
            refcount[s] = refcount.get(s, 0) + 1

        values: dict[int, object] = {}
        outputs: dict[object, object] = {}
        profiler = self.profiler

        for li, level in enumerate(levels):
            groups: dict[tuple, list[int]] = {}
            for node_id in level:
                node = circuit.nodes[node_id]
                groups.setdefault((node.op, node.param), []).append(node_id)
            for (op, param), node_ids in groups.items():
                if self.debug:
                    self.debug_log.append((op.value, param, len(node_ids)))
                metrics.inc(f"executor.gates.{op.value}", len(node_ids))
                t0 = time.perf_counter()
                self._exec_group(circuit, op, param, node_ids, preds, refcount, values, inputs,
                                 outputs)
                if profiler is not None:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    profiler.record(li, op.value, param, len(node_ids), time.perf_counter() - t0)
        return outputs

    def compile(self, circuit: FheCircuit):
        """fn(inputs) -> outputs running `run` on this circuit, cached on
        this executor by circuit structure: the reference's interface. The
        reference traces the circuit into one XLA program here; PyTorch
        runs eagerly, so nothing is traced."""
        circuit.validate()
        key = (tuple((n.op, n.param) for n in circuit.nodes), tuple(circuit.edges))
        fn = self._compile_cache.get(key)
        if fn is None:
            fn = self._compile_cache[key] = lambda inputs: self.run(circuit, inputs)
        return fn

    def _exec_group(self, circuit, op, param, node_ids, preds, refcount, values, inputs,
                    outputs):
        ev = self.ev

        def take(src):
            v = values[src]
            refcount[src] -= 1
            if refcount[src] == 0:
                del values[src]
            return v

        def gather(role):
            vals = [take(_role(preds.get(i, []), role)) for i in node_ids]
            if len(vals) == 1:
                return vals[0], False
            return ev.be.stack(vals, axis=0), True

        def scatter(result, batched):
            if not batched:
                values[node_ids[0]] = result
                return
            for i, node_id in enumerate(node_ids):
                values[node_id] = result[i]

        if op.value.startswith("input_"):
            for node_id in node_ids:
                key = circuit.nodes[node_id].param
                if key not in inputs:
                    raise CircuitError(f"missing input {key!r}")
                values[node_id] = self._as_tensor(inputs[key])
        elif op.value.startswith("output_"):
            for node_id in node_ids:
                src = _role(preds.get(node_id, []), FheEdge.UNARY)
                outputs[circuit.nodes[node_id].param] = take(src)
        elif op in (FheOp.RETIRE, FheOp.NOP):
            for node_id in node_ids:
                ins = preds.get(node_id, [])
                values[node_id] = take(ins[0][0]) if ins else None
        elif op.value.startswith(("zero_", "one_")):
            const = self._const(op)
            for node_id in node_ids:
                values[node_id] = const
        elif op == FheOp.NOT:
            x, b = gather(FheEdge.UNARY)
            scatter(ev.not_(x), b)
        elif op == FheOp.GLWE_ADD:
            left, b1 = gather(FheEdge.LEFT)
            right, b2 = gather(FheEdge.RIGHT)
            assert b1 == b2
            scatter(ev.glwe_add(left, right), b1)
        elif op in (FheOp.CMUX, FheOp.GLEV_CMUX):
            sel, bs = gather(FheEdge.SEL)
            lo, bl = gather(FheEdge.LOW)
            hi, bh = gather(FheEdge.HIGH)
            assert bs == bl == bh
            fn = ev.cmux if op == FheOp.CMUX else ev.glev_cmux
            scatter(fn(sel, lo, hi), bs)
        elif op == FheOp.MULTIPLY_GGSW_GLWE:
            glwe, b1 = gather(FheEdge.GLWE)
            ggsw, b2 = gather(FheEdge.GGSW)
            assert b1 == b2
            scatter(ev.multiply_glwe_ggsw(glwe, ggsw), b1)
        elif op == FheOp.SAMPLE_EXTRACT:
            x, b = gather(FheEdge.UNARY)
            scatter(ev.sample_extract(x, param or 0), b)
        elif op == FheOp.KEYSWITCH_L1_L0:
            x, b = gather(FheEdge.UNARY)
            scatter(ev.keyswitch_lwe_l1_to_l0(x), b)
        elif op == FheOp.CIRCUIT_BOOTSTRAP:
            x, b = gather(FheEdge.UNARY)
            scatter(ev.circuit_bootstrap(x), b)
        elif op == FheOp.SCHEME_SWITCH:
            x, b = gather(FheEdge.UNARY)
            scatter(ev.scheme_switch(x), b)
        elif op == FheOp.MUL_XN:
            x, b = gather(FheEdge.UNARY)
            scatter(ev.mul_xn(x, param or 0), b)
        else:
            raise CircuitError(f"unhandled op {op}")
