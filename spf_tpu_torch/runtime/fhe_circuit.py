"""FheCircuit: a DAG of FHE micro-ops, and graph utilities.

(≙ reference `parasol_runtime/src/fhe_circuit.rs`: the same op set,
edge roles, mux-circuit insertion, ciphertext-conversion insertion, and
reachability pruning.)

Unlike the reference — which dispatches each node as a rayon task — this
graph is *scheduled*: the executors batch its gates into waves, each a
few batched kernel calls (`executor_u32.py`, `wave_machine.py`). A copy
of `spf_tpu/runtime/fhe_circuit.py`.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import itertools
from collections import deque

import numpy as np


class FheOp(enum.Enum):
    # inputs (value supplied at run time, `param` = input slot key)
    INPUT_LWE0 = "input_lwe0"
    INPUT_LWE1 = "input_lwe1"
    INPUT_GLWE1 = "input_glwe1"
    INPUT_GGSW1 = "input_ggsw1"
    INPUT_GLEV1 = "input_glev1"
    # outputs (`param` = output slot key)
    OUTPUT_LWE0 = "output_lwe0"
    OUTPUT_LWE1 = "output_lwe1"
    OUTPUT_GLWE1 = "output_glwe1"
    OUTPUT_GGSW1 = "output_ggsw1"
    OUTPUT_GLEV1 = "output_glev1"
    # compute
    SAMPLE_EXTRACT = "sample_extract"  # param = coefficient index
    KEYSWITCH_L1_L0 = "keyswitch"
    NOT = "not"
    GLWE_ADD = "glwe_add"
    CMUX = "cmux"
    GLEV_CMUX = "glev_cmux"
    MULTIPLY_GGSW_GLWE = "multiply_ggsw_glwe"
    CIRCUIT_BOOTSTRAP = "cbs"
    SCHEME_SWITCH = "scheme_switch"
    MUL_XN = "mul_xn"  # param = monomial power
    # constants
    ZERO_LWE0 = "zero_lwe0"
    ONE_LWE0 = "one_lwe0"
    ZERO_GLWE1 = "zero_glwe1"
    ONE_GLWE1 = "one_glwe1"
    ZERO_GGSW1 = "zero_ggsw1"
    ONE_GGSW1 = "one_ggsw1"
    ZERO_GLEV1 = "zero_glev1"
    ONE_GLEV1 = "one_glev1"
    # bookkeeping
    RETIRE = "retire"
    NOP = "nop"


class FheEdge(enum.Enum):
    LOW = "low"
    HIGH = "high"
    SEL = "sel"
    UNARY = "unary"
    GLWE = "glwe"
    GGSW = "ggsw"
    LEFT = "left"
    RIGHT = "right"


class CtType(enum.Enum):
    LWE0 = "lwe0"
    LWE1 = "lwe1"
    GLWE1 = "glwe1"
    GGSW1 = "ggsw1"
    GLEV1 = "glev1"
    NONE = "none"


# output ciphertext type of each op
OUTPUT_TYPE = {
    FheOp.INPUT_LWE0: CtType.LWE0,
    FheOp.INPUT_LWE1: CtType.LWE1,
    FheOp.INPUT_GLWE1: CtType.GLWE1,
    FheOp.INPUT_GGSW1: CtType.GGSW1,
    FheOp.INPUT_GLEV1: CtType.GLEV1,
    FheOp.OUTPUT_LWE0: CtType.LWE0,
    FheOp.OUTPUT_LWE1: CtType.LWE1,
    FheOp.OUTPUT_GLWE1: CtType.GLWE1,
    FheOp.OUTPUT_GGSW1: CtType.GGSW1,
    FheOp.OUTPUT_GLEV1: CtType.GLEV1,
    FheOp.SAMPLE_EXTRACT: CtType.LWE1,
    FheOp.KEYSWITCH_L1_L0: CtType.LWE0,
    FheOp.NOT: CtType.GLWE1,
    FheOp.GLWE_ADD: CtType.GLWE1,
    FheOp.CMUX: CtType.GLWE1,
    FheOp.GLEV_CMUX: CtType.GLEV1,
    FheOp.MULTIPLY_GGSW_GLWE: CtType.GLWE1,
    FheOp.CIRCUIT_BOOTSTRAP: CtType.GGSW1,
    FheOp.SCHEME_SWITCH: CtType.GGSW1,
    FheOp.MUL_XN: CtType.GLWE1,
    FheOp.ZERO_LWE0: CtType.LWE0,
    FheOp.ONE_LWE0: CtType.LWE0,
    FheOp.ZERO_GLWE1: CtType.GLWE1,
    FheOp.ONE_GLWE1: CtType.GLWE1,
    FheOp.ZERO_GGSW1: CtType.GGSW1,
    FheOp.ONE_GGSW1: CtType.GGSW1,
    FheOp.ZERO_GLEV1: CtType.GLEV1,
    FheOp.ONE_GLEV1: CtType.GLEV1,
    FheOp.RETIRE: CtType.NONE,
    FheOp.NOP: CtType.NONE,
}

# required input edges per op: {role: ciphertext type}
# (≙ reference `circuit_processor/task.rs` validate)
INPUT_SPEC = {
    FheOp.SAMPLE_EXTRACT: {FheEdge.UNARY: CtType.GLWE1},
    FheOp.KEYSWITCH_L1_L0: {FheEdge.UNARY: CtType.LWE1},
    FheOp.NOT: {FheEdge.UNARY: CtType.GLWE1},
    FheOp.GLWE_ADD: {FheEdge.LEFT: CtType.GLWE1, FheEdge.RIGHT: CtType.GLWE1},
    FheOp.CMUX: {
        FheEdge.SEL: CtType.GGSW1,
        FheEdge.LOW: CtType.GLWE1,
        FheEdge.HIGH: CtType.GLWE1,
    },
    FheOp.GLEV_CMUX: {
        FheEdge.SEL: CtType.GGSW1,
        FheEdge.LOW: CtType.GLEV1,
        FheEdge.HIGH: CtType.GLEV1,
    },
    FheOp.MULTIPLY_GGSW_GLWE: {FheEdge.GLWE: CtType.GLWE1, FheEdge.GGSW: CtType.GGSW1},
    FheOp.CIRCUIT_BOOTSTRAP: {FheEdge.UNARY: CtType.LWE0},
    FheOp.SCHEME_SWITCH: {FheEdge.UNARY: CtType.GLEV1},
    FheOp.MUL_XN: {FheEdge.UNARY: CtType.GLWE1},
}
for _op in (
    FheOp.OUTPUT_LWE0,
    FheOp.OUTPUT_LWE1,
    FheOp.OUTPUT_GLWE1,
    FheOp.OUTPUT_GGSW1,
    FheOp.OUTPUT_GLEV1,
    FheOp.RETIRE,
):
    INPUT_SPEC[_op] = {FheEdge.UNARY: OUTPUT_TYPE[_op]}
INPUT_SPEC[FheOp.RETIRE] = {FheEdge.UNARY: None}  # any type


class CircuitError(Exception):
    """Malformed-graph error (≙ reference RuntimeError,
    `parasol_runtime/src/runtime_error.rs`)."""


@dataclasses.dataclass
class Node:
    op: FheOp
    param: object = None


# Fresh-path bound before a GLWE mux wire is recrypted through the
# conversion cycle (see `insert_mux_circuit`). Measured ON HARDWARE
# (r5, scripts/probe_cmux_noise.py + mul8/mul16 per-bit margins): with
# the 2x16 CBS blind-rotation radix the CBS-output GGSW select noise
# was ~2^49.6, leaving deep bits at 0 to -1 bits of margin at bound 64
# (mul8 6/8); the production fix is DEFAULT_128's 4x8 `cbs_pbs_radix`
# (select noise ~2^44.6), under which bound 64 measures 3.5 bits of
# worst-case margin on the depth-510 16x16 multiplier (mul16 4/4).
DEFAULT_MUX_REFRESH_DEPTH = 64


# an edge role's code in `FheCircuit.structure_key`
_EDGE_CODE = {r: i for i, r in enumerate(FheEdge)}


class FheCircuit:
    """A mutable DAG of FHE ops. Grow it through `add_node` and `add_edge`
    only: they drop the memoised `structure_key`."""

    def __init__(self):
        self.nodes: list[Node] = []
        self.edges: list[tuple[int, int, FheEdge]] = []
        self._structure_key: bytes | None = None

    def add_node(self, op: FheOp, param=None) -> int:
        self._structure_key = None
        self.nodes.append(Node(op, param))
        return len(self.nodes) - 1

    def add_edge(self, src: int, dst: int, role: FheEdge) -> None:
        self._structure_key = None
        self.edges.append((src, dst, role))

    def structure_key(self) -> bytes:
        """A 256-bit digest of the graph's structure (every node's op and
        param, every edge, in order): equal for structurally equal
        circuits. Computed once (about a second at 5 x 10^5 nodes) and
        kept until the next `add_node` / `add_edge`, so an executor can
        key its schedules by it on every run."""
        if self._structure_key is None:
            h = hashlib.blake2b(digest_size=32)
            h.update(np.array([len(self.nodes), len(self.edges)], dtype=np.int64).tobytes())
            h.update("\x1e".join(f"{n.op.value}\x1f{n.param!r}" for n in self.nodes).encode())
            edges = itertools.chain.from_iterable((s, d, _EDGE_CODE[r]) for s, d, r in self.edges)
            h.update(np.fromiter(edges, dtype=np.int64, count=3 * len(self.edges)).tobytes())
            self._structure_key = h.digest()
        return self._structure_key

    # --- queries ---

    def in_edges(self, node: int):
        return [(s, r) for (s, d, r) in self.edges if d == node]

    def validate(self) -> None:
        """Check arity/types of every node (≙ `task.rs` validate +
        `circuit_processor/tests/faults.rs` expectations).

        Predecessors are gathered in one O(E) pass — per-node
        `in_edges` scans are O(N*E), which stalled 60k-node graphs
        (the mul16 intop circuit) for tens of minutes."""
        preds: dict[int, list] = {}
        for s, d, r in self.edges:
            preds.setdefault(d, []).append((s, r))
        for i, node in enumerate(self.nodes):
            spec = INPUT_SPEC.get(node.op)
            ins = preds.get(i, [])
            if spec is None:
                if ins and node.op != FheOp.NOP:
                    raise CircuitError(f"node {i} ({node.op}) takes no inputs")
                continue
            roles = [r for (_, r) in ins]
            if sorted(r.value for r in roles) != sorted(r.value for r in spec):
                raise CircuitError(
                    f"node {i} ({node.op}) has inputs {roles}, expected {list(spec)}"
                )
            for src, role in ins:
                want = spec[role]
                got = OUTPUT_TYPE[self.nodes[src].op]
                if want is not None and got != want:
                    raise CircuitError(
                        f"node {i} ({node.op}) input {role} has type {got}, "
                        f"expected {want}"
                    )

    def prune(self, outputs: list[int]):
        """Restrict to the ancestors of `outputs`
        (≙ `fhe_circuit.rs:516-556` prune). Returns (new_circuit,
        rename map old->new)."""
        keep = set()
        queue = deque(outputs)
        preds: dict[int, list] = {}
        for s, d, r in self.edges:
            preds.setdefault(d, []).append((s, r))
        while queue:
            cur = queue.popleft()
            if cur in keep:
                continue
            keep.add(cur)
            for s, _ in preds.get(cur, []):
                queue.append(s)
        out = FheCircuit()
        rename = {}
        for i in sorted(keep):
            rename[i] = out.add_node(self.nodes[i].op, self.nodes[i].param)
        for s, d, r in self.edges:
            if s in keep and d in keep:
                out.add_edge(rename[s], rename[d], r)
        return out, rename

    def levelize(self, outputs: list[int] | None = None) -> list[list[int]]:
        """Topological levels: level[i] = nodes whose predecessors are
        all in earlier levels. This is the level-synchronous schedule —
        gates within a level execute as one batched wave."""
        n = len(self.nodes)
        indeg = [0] * n
        succs: dict[int, list[int]] = {}
        for s, d, _ in self.edges:
            indeg[d] += 1
            succs.setdefault(s, []).append(d)
        level = [0] * n
        queue = deque(i for i in range(n) if indeg[i] == 0)
        order = []
        while queue:
            cur = queue.popleft()
            order.append(cur)
            for nxt in succs.get(cur, []):
                level[nxt] = max(level[nxt], level[cur] + 1)
                indeg[nxt] -= 1
                if indeg[nxt] == 0:
                    queue.append(nxt)
        if len(order) != n:
            raise CircuitError("circuit contains a cycle")
        levels: list[list[int]] = [[] for _ in range(max(level, default=-1) + 1)]
        for i in range(n):
            levels[level[i]].append(i)
        return levels

    # --- builders ---

    def insert_mux_circuit(self, mux_circuit, input_nodes: list[int],
                           glev: bool = False,
                           refresh_every: int | None = None):
        """Graft a `MuxCircuit` into this graph. `input_nodes` must
        produce GGSWs (inputs, CBS, or scheme-switch nodes;
        `fhe_circuit.rs:274-422`). `glev=True` uses GLEV CMuxes with
        GLEV constants (the `Muxable` GLEV mode). Returns the node ids
        of the mux circuit's outputs.

        `refresh_every` bounds the CMux-chain noise of deep circuits:
        any wire whose fresh-path length (number of chained CMuxes since
        a constant or refreshed wire) reaches the bound is re-encrypted
        through the conversion cycle (extract -> keyswitch -> CBS ->
        external product with ONE). At DEFAULT_128 on the u32 pipeline
        the measured per-CMux noise std is ~2^55-56 in torus units, so
        unrefreshed depth-510 trees (the 16x16 multiplier) exceed the
        2^62 binary decision boundary — the BENCH_SUITE r4 mul16 0/4
        failure. `None` (default) resolves to 64 for GLWE-mode muxes
        (noise ~2^58.6 at the bound: >10 sigma of headroom) and to
        no-refresh for GLEV mode; pass 0 to disable. (The reference
        needs no refresh: its f64 kernel + single-bit CBS keep
        per-CMux noise ~2^53, depth 1024 — `params.rs:103-106`.)"""
        assert len(input_nodes) == mux_circuit.num_inputs
        for n_id in input_nodes:
            if OUTPUT_TYPE[self.nodes[n_id].op] != CtType.GGSW1:
                raise CircuitError(
                    "mux circuits connect only to GGSW-producing nodes"
                )
        if refresh_every is None:
            refresh_every = 0 if glev else DEFAULT_MUX_REFRESH_DEPTH
        mux_op = FheOp.GLEV_CMUX if glev else FheOp.CMUX
        zero_op = FheOp.ZERO_GLEV1 if glev else FheOp.ZERO_GLWE1
        one_op = FheOp.ONE_GLEV1 if glev else FheOp.ONE_GLWE1
        rename = {}
        fresh_path = {}
        for i, node in enumerate(mux_circuit.nodes):
            kind = node[0]
            if kind == "zero":
                rename[i] = self.add_node(zero_op)
                fresh_path[i] = 0
            elif kind == "one":
                rename[i] = self.add_node(one_op)
                fresh_path[i] = 0
            else:
                _, sel, lo, hi = node
                idx = self.add_node(mux_op)
                self.add_edge(input_nodes[sel], idx, FheEdge.SEL)
                self.add_edge(rename[lo], idx, FheEdge.LOW)
                self.add_edge(rename[hi], idx, FheEdge.HIGH)
                fp = max(fresh_path[lo], fresh_path[hi]) + 1
                if refresh_every and fp >= refresh_every:
                    idx = self.insert_ciphertext_conversion(
                        idx, CtType.GLWE1, CtType.GGSW1
                    )
                    idx = self.insert_ciphertext_conversion(
                        idx, CtType.GGSW1, CtType.GLWE1
                    )
                    fp = 1
                rename[i] = idx
                fresh_path[i] = fp
        return [rename[o] for o in mux_circuit.outputs]

    def insert_ciphertext_conversion(
        self, cur_node: int, in_type: CtType, out_type: CtType
    ) -> int:
        """Walk the conversion cycle L0 -> (CBS) -> GGSW -> GLWE/GLEV ->
        LWE1 -> L0 from `in_type` to `out_type`
        (`fhe_circuit.rs:558-622`)."""
        if in_type == out_type:
            return cur_node
        if in_type == CtType.LWE0:
            idx = self.add_node(FheOp.CIRCUIT_BOOTSTRAP)
            self.add_edge(cur_node, idx, FheEdge.UNARY)
            nxt = CtType.GGSW1
        elif in_type == CtType.GGSW1:
            if out_type == CtType.GLEV1:
                idx = self.add_node(FheOp.GLEV_CMUX)
                zero = self.add_node(FheOp.ZERO_GLEV1)
                one = self.add_node(FheOp.ONE_GLEV1)
                self.add_edge(zero, idx, FheEdge.LOW)
                self.add_edge(one, idx, FheEdge.HIGH)
                self.add_edge(cur_node, idx, FheEdge.SEL)
                nxt = out_type
            else:
                idx = self.add_node(FheOp.MULTIPLY_GGSW_GLWE)
                one = self.add_node(FheOp.ONE_GLWE1)
                self.add_edge(one, idx, FheEdge.GLWE)
                self.add_edge(cur_node, idx, FheEdge.GGSW)
                nxt = CtType.GLWE1
        elif in_type == CtType.GLWE1:
            idx = self.add_node(FheOp.SAMPLE_EXTRACT, 0)
            self.add_edge(cur_node, idx, FheEdge.UNARY)
            nxt = CtType.LWE1
        elif in_type == CtType.LWE1:
            idx = self.add_node(FheOp.KEYSWITCH_L1_L0)
            self.add_edge(cur_node, idx, FheEdge.UNARY)
            nxt = CtType.LWE0
        elif in_type == CtType.GLEV1:
            idx = self.add_node(FheOp.SCHEME_SWITCH)
            self.add_edge(cur_node, idx, FheEdge.UNARY)
            nxt = CtType.GGSW1
        else:
            raise CircuitError(f"cannot convert from {in_type}")
        return self.insert_ciphertext_conversion(idx, nxt, out_type)
