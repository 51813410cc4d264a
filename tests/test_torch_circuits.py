"""The port's circuit layer (`spf_tpu_torch/circuits/`, `native/`,
`runtime/fhe_circuit.py`, `runtime/fluent.py`) and wave scheduler
(`runtime/wave_machine.py::build_schedule`) against the JAX package's.

All of it is host code: integer circuits equal node for node (the cases
of `tests/test_circuits.py`, the shipped multiplier caches, the native
BDD engine against the Python one), and the `FheCircuit` graphs that
`fluent` builds for the flows of `tests/test_wave_machine.py` and for
`bench.py --intop`'s add8, mul8 and mul16, with their wave schedules,
equal the reference's. No JAX function runs here.
"""

import os

import numpy as np
import pytest
import torch

from spf_tpu.circuits import integer as j_integer
from spf_tpu.circuits import mux as j_mux
from spf_tpu.runtime import fhe_circuit as j_fc
from spf_tpu.runtime import fluent as j_fluent
from spf_tpu.runtime import wave_machine as j_wm
from spf_tpu_torch import native
from spf_tpu_torch.native import build as native_build
from spf_tpu_torch.circuits import bdd, integer, mux
from spf_tpu_torch.runtime import fhe_circuit as fc
from spf_tpu_torch.runtime import fluent
from spf_tpu_torch.runtime import wave_machine as wm

torch.set_num_threads(1)

# (generator, arguments): the cases of tests/test_circuits.py and the rest
# of the generators at small widths
CIRCUITS = [
    ("ripple_carry_adder", (2,)), ("ripple_carry_adder", (4,)),
    ("ripple_carry_adder", (4, True)), ("ripple_carry_adder", (8, False, True)),
    ("full_subtractor", (2,)), ("full_subtractor", (4,)), ("full_subtractor", (4, True, False)),
    ("unsigned_multiplier", (2, 2)), ("unsigned_multiplier", (4, 4)),
    ("unsigned_multiplier", (3, 5)), ("mixed_width_adder", (3, 5)),
    ("gradeschool_reduce", (4, 4)),
    ("compare_equal", (3,)), ("compare_not_equal", (3,)),
    ("compare_or_maybe_equal", (3, False, False)), ("compare_or_maybe_equal", (3, True, False)),
    ("compare_or_maybe_equal", (3, False, True)), ("compare_or_maybe_equal", (3, True, True)),
    *(("bitshift", (8, 3, d, m)) for d, m in (
        ("left", "logical"), ("left", "rotate"), ("right", "logical"), ("right", "rotate"),
        ("right", "arithmetic"))),
    ("negate", (8,)), ("and_tree", (3,)), ("or_tree", (3,)), ("bitwise_and", (4,)),
    ("bitwise_or", (4,)), ("bitwise_xor", (4,)), ("popcount", (5,)),
]


def _same_circuit(got, want):
    assert got.num_inputs == want.num_inputs
    assert [tuple(n) for n in got.nodes] == [tuple(n) for n in want.nodes]
    assert list(got.outputs) == list(want.outputs)


@pytest.mark.parametrize("name, args", CIRCUITS, ids=[f"{n}{a}" for n, a in CIRCUITS])
def test_integer_circuit_node_for_node(name, args):
    _same_circuit(getattr(integer, name)(*args), getattr(j_integer, name)(*args))


@pytest.mark.parametrize("n", [8, 16])
def test_shipped_multiplier_caches_equal(n):
    """The port loads its own copy of the shipped multiplier caches
    (`circuits/data/`), the circuits bench.py's mul8 and mul16 run."""
    got = integer.unsigned_multiplier(n, n)
    _same_circuit(got, j_integer.unsigned_multiplier(n, n))
    a, b = 0xB5 << (n - 8), 0x3C
    bits = [(a >> i) & 1 for i in range(n)] + [(b >> i) & 1 for i in range(n)]
    assert sum(v << i for i, v in enumerate(got.evaluate(bits))) == a * b


def test_gradeschool_encoding_equal():
    assert integer.partition_integer(24) == j_integer.partition_integer(24)
    windows = j_integer._partial_product_windows(8, 8)
    assert integer._partial_product_windows(8, 8) == windows
    ll, hl, lh, hh = (list(range(100 * i, 100 * i + e - s)) for i, (s, e) in enumerate(windows))
    assert (integer.encode_gradeschool_reduction(8, 8, ll, hl, lh, hh)
            == j_integer.encode_gradeschool_reduction(8, 8, ll, hl, lh, hh))


def test_native_bdd_matches_python():
    """The native engine (built with g++ at first use into `_build/`) and
    the Python engine give the same node ids, alone and through a whole
    generator; the native build writes nothing beside its source."""
    mod = native.get_native_bdd()
    if mod is None:
        pytest.skip("no C++ compiler: the circuit layer runs on the Python BDD engine")
    assert mod.__file__.startswith(native_build.BUILD_DIR)
    pm, nm = bdd.PyBddManager(8), bdd.NativeBddManager(mod, 8)
    for mgr in (pm, nm):
        a, b, c = mgr.var(0), mgr.var(1), mgr.var(2)
        mgr.results = (mgr.xor(mgr.and_(a, b), c), mgr.or_(mgr.xnor(a, c), mgr.not_(b)))
    assert pm.results == nm.results
    assert [tuple(pm.nodes[i]) for i in range(len(pm.nodes))] == [
        tuple(nm.nodes[i]) for i in range(len(nm.nodes))]


def test_python_bdd_builds_the_same_circuit(monkeypatch):
    """With the native engine unavailable the Python fallback builds the
    same multiplier, node for node."""
    native_built = integer.unsigned_multiplier(4, 3)
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(native, "_cached", None)
    assert isinstance(bdd.BddManager(2), bdd.PyBddManager)
    _same_circuit(integer.unsigned_multiplier(4, 3), native_built)


def test_cached_circuit_writes_only_the_user_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    name = "test-only-adder-n3"
    c = mux.cached_circuit(name, lambda: integer.ripple_carry_adder(3))
    saved = tmp_path / "spf_tpu_torch" / "circuits" / f"{name}.json"
    assert saved.exists()
    assert not os.path.exists(os.path.join(mux._CACHE_DIR, f"{name}.json"))
    _same_circuit(mux.cached_circuit(name, lambda: pytest.fail("rebuilt")), c)
    _same_circuit(mux.load_circuit(str(saved)), j_mux.load_circuit(str(saved)))


# --- FheCircuit graphs and their wave schedules -------------------------


def _binary(op):
    return lambda pkg, ctx, n: op(pkg.UInt.input(ctx, n), pkg.UInt.input(ctx, n)).output()


def _deep_refresh(pkg, ctx, n):
    """tests/test_wave_machine.py::test_deep_refresh_circuit's graph."""
    circ = pkg.__name__.split(".")[0]
    ints = integer if circ == "spf_tpu_torch" else j_integer
    f = fc if circ == "spf_tpu_torch" else j_fc
    a, b = pkg.UInt.input(ctx, n), pkg.UInt.input(ctx, n)
    sels = [ctx.circuit.insert_ciphertext_conversion(nd, f.CtType.GLWE1, f.CtType.GGSW1)
            for nd in a.bits + b.bits]
    outs = ctx.circuit.insert_mux_circuit(ints.ripple_carry_adder(n, emit_carry=False), sels,
                                          refresh_every=2)
    for j, o in enumerate(outs):
        on = ctx.circuit.add_node(f.FheOp.OUTPUT_GLWE1, f"out{j}")
        ctx.circuit.add_edge(o, on, f.FheEdge.UNARY)


def _packed_add(pkg, ctx, n):
    (pkg.UInt.packed_input(ctx, n) + pkg.UInt.packed_input(ctx, n)).pack_output()


def _not_gate(pkg, ctx, n):
    f = fc if pkg.__name__.startswith("spf_tpu_torch") else j_fc
    i = ctx.circuit.add_node(f.FheOp.INPUT_GLWE1, "x")
    nt = ctx.circuit.add_node(f.FheOp.NOT)
    ctx.circuit.add_edge(i, nt, f.FheEdge.UNARY)
    o = ctx.circuit.add_node(f.FheOp.OUTPUT_GLWE1, "y")
    ctx.circuit.add_edge(nt, o, f.FheEdge.UNARY)


def _intop(op, width):
    """bench.py:608-641: one graph holding every instance."""
    def build(pkg, ctx, _):
        circ = pkg.__name__.split(".")[0]
        ints = integer if circ == "spf_tpu_torch" else j_integer
        f = fc if circ == "spf_tpu_torch" else j_fc
        n_inst = max(1, 64 // width)
        mc = ints.ripple_carry_adder(width, emit_carry=True) if op == "add" else \
            ints.unsigned_multiplier(width, width)
        g = ctx.circuit
        sel_all = []
        for r in range(2 * width * n_inst):
            nd = g.add_node(f.FheOp.INPUT_LWE0, f"b{r}")
            sel_all.append(g.insert_ciphertext_conversion(nd, f.CtType.LWE0, f.CtType.GGSW1))
        for j in range(n_inst):
            outs = g.insert_mux_circuit(mc, [sel_all[i * n_inst + j] for i in range(2 * width)])
            for wi, o in enumerate(outs):
                on = g.add_node(f.FheOp.OUTPUT_GLWE1, f"o{j}_{wi}")
                g.add_edge(o, on, f.FheEdge.UNARY)
    return build


GRAPHS = {
    "u2_add": (_binary(lambda a, b: a + b), 2),
    "u4_mul": (_binary(lambda a, b: a * b), 4),
    "u2_xor": (_binary(lambda a, b: a ^ b), 2),
    "u2_eq": (_binary(lambda a, b: a.eq(b)), 2),
    "u3_add": (_binary(lambda a, b: a + b), 3),
    "deep_refresh": (_deep_refresh, 4),
    "packed_add": (_packed_add, 4),
    "not_gate": (_not_gate, 1),
    "intop_add8": (_intop("add", 8), 8),
    "intop_mul8": (_intop("mul", 8), 8),
    "intop_mul16": (_intop("mul", 16), 16),
}


def _graph(pkg, name):
    build, n = GRAPHS[name]
    ctx = pkg.FheCircuitCtx()
    build(pkg, ctx, n)
    g = ctx.circuit
    return g, ([(nd.op.value, nd.param) for nd in g.nodes],
               [(s, d, r.value) for s, d, r in g.edges])


def _schedule_parts(s):
    waves = [(w.group, w.width, w.gates, sorted(w.idx),
              [np.asarray(w.idx[k]).tolist() for k in sorted(w.idx)]) for w in s.waves]
    inputs = {k: (list(names), np.asarray(sl).tolist()) for k, (names, sl) in s.inputs.items()}
    return dict(waves=waves, slot_counts=s.slot_counts, inputs=inputs, outputs=s.outputs,
                wave_log=s.wave_log, uses_ggsw_consts=s.uses_ggsw_consts)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_graph_and_schedule_equal(name):
    """The graph fluent builds and its wave schedule (waves, groups, widths,
    gate counts, every index array, slot counts, inputs and outputs) equal
    the reference's."""
    g, parts = _graph(fluent, name)
    jg, jparts = _graph(j_fluent, name)
    assert parts == jparts
    got, want = _schedule_parts(wm.build_schedule(g)), _schedule_parts(j_wm.build_schedule(jg))
    for key in want:
        assert got[key] == want[key], key
    assert all(v == 0 or v & (v - 1) == 0 for v in got["slot_counts"].values())


def test_validate_and_glev_rejected():
    g = fc.FheCircuit()
    z = g.add_node(fc.FheOp.ZERO_GLEV1)
    o = g.add_node(fc.FheOp.OUTPUT_GLEV1, "y")
    g.add_edge(z, o, fc.FheEdge.UNARY)
    with pytest.raises(fc.CircuitError):
        wm.build_schedule(g)
    bad = fc.FheCircuit()
    c = bad.add_node(fc.FheOp.CMUX)
    i = bad.add_node(fc.FheOp.INPUT_GLWE1, "x")
    bad.add_edge(i, c, fc.FheEdge.LOW)
    with pytest.raises(fc.CircuitError, match="has inputs"):
        bad.validate()
