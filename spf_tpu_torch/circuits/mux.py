"""MuxCircuit: a DAG of 2:1 multiplexer gates over boolean inputs.

(≙ reference `mux_circuits/src/lib.rs:56-170`; built from BDDs like
`lib.rs:358-445` `From<&[Bdd]>`.)

Layout: a flat node list. Node kinds:
- ("zero",) / ("one",)                  — constants
- ("mux", sel_input, lo_node, hi_node)  — select is a circuit *input
  index* (BDD decision variable; in FHE it becomes a GGSW), lo/hi are
  node ids (in FHE: GLWE operands)
Outputs are node ids. Hash-consing during construction = the
reference's CSE `optimize()` pass.
"""

from __future__ import annotations

import dataclasses
import json
import os

from .bdd import BddManager


@dataclasses.dataclass
class MuxCircuit:
    num_inputs: int
    nodes: list
    outputs: list

    @property
    def num_muxes(self) -> int:
        return sum(1 for n in self.nodes if n[0] == "mux")

    def evaluate(self, inputs) -> list:
        """Plaintext forward evaluation (≙ `test_mux_circuit`,
        `lib.rs:448+`)."""
        assert len(inputs) == self.num_inputs
        vals = {}
        for i, node in enumerate(self.nodes):
            kind = node[0]
            if kind == "zero":
                vals[i] = 0
            elif kind == "one":
                vals[i] = 1
            else:
                _, sel, lo, hi = node
                vals[i] = vals[hi] if inputs[sel] else vals[lo]
        return [vals[o] for o in self.outputs]

    @classmethod
    def from_bdds(cls, mgr: BddManager, roots: list, input_map=None) -> "MuxCircuit":
        """Convert shared BDD roots into a mux circuit. `input_map`
        optionally remaps BDD variables to circuit inputs (the
        reference's `remap_inputs`, used by the multiplier's duplicated
        variables, `mul.rs:40-55`)."""
        num_inputs = (
            mgr.num_vars if input_map is None else max(input_map) + 1 if input_map else 0
        )
        nodes = [("zero",), ("one",)]
        rename = {mgr.FALSE: 0, mgr.TRUE: 1}

        def convert(root: int) -> int:
            # explicit-stack post-order: deep BDDs (wide multipliers) would
            # overflow the C stack under recursion
            stack = [root]
            while stack:
                f = stack[-1]
                if f in rename:
                    stack.pop()
                    continue
                var, lo, hi = mgr.nodes[f]
                pending = [c for c in (lo, hi) if c not in rename]
                if pending:
                    stack.extend(pending)
                    continue
                stack.pop()
                sel = var if input_map is None else input_map[var]
                nodes.append(("mux", sel, rename[lo], rename[hi]))
                rename[f] = len(nodes) - 1
            return rename[root]

        outputs = [convert(r) for r in roots]
        return cls(num_inputs=num_inputs, nodes=nodes, outputs=outputs)


_CACHE_DIR = os.path.join(os.path.dirname(__file__), "data")


def _validate_loaded(c: MuxCircuit) -> MuxCircuit:
    """Shape-check an untrusted deserialized circuit (same stance as
    `utils/serialization.py`): every node/output reference must be a
    previously-defined node id and every select a valid input index."""
    for i, node in enumerate(c.nodes):
        kind = node[0]
        if kind in ("zero", "one"):
            continue
        if kind != "mux" or len(node) != 4:
            raise ValueError(f"bad node {node!r}")
        _, sel, lo, hi = node
        if not (0 <= sel < c.num_inputs and 0 <= lo < i and 0 <= hi < i):
            raise ValueError(f"bad mux node {node!r} at {i}")
    for o in c.outputs:
        if not 0 <= o < len(c.nodes):
            raise ValueError(f"bad output id {o}")
    return c


def save_circuit(c: MuxCircuit, path: str) -> None:
    with open(path, "w") as f:
        json.dump(
            {"num_inputs": c.num_inputs, "nodes": c.nodes, "outputs": c.outputs}, f
        )


def load_circuit(path: str) -> MuxCircuit:
    """Load a JSON-serialized circuit (plain ints/lists — no arbitrary
    code execution, unlike pickle)."""
    with open(path) as f:
        d = json.load(f)
    return _validate_loaded(
        MuxCircuit(
            num_inputs=int(d["num_inputs"]),
            nodes=[tuple(n) for n in d["nodes"]],
            outputs=[int(o) for o in d["outputs"]],
        )
    )


def _user_cache_dir() -> str:
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache"
    )
    return os.path.join(base, "spf_tpu_torch", "circuits")


def cached_circuit(name: str, builder) -> MuxCircuit:
    """Disk cache for expensive circuit builds (≙ `mux_circuits`'s
    `FileCache` / pre-serialized `src/data` blobs, `cache.rs:1-60`).

    Shipped caches live in the package `data/` dir (copies of the JAX
    package's); circuits built here are saved only under a per-user cache
    dir, never into the tree."""
    fname = name + ".json"
    for d in (_CACHE_DIR, _user_cache_dir()):
        path = os.path.join(d, fname)
        if os.path.exists(path):
            return load_circuit(path)
    circuit = builder()
    try:
        os.makedirs(_user_cache_dir(), exist_ok=True)
        save_circuit(circuit, os.path.join(_user_cache_dir(), fname))
    except OSError:
        pass
    return circuit
