"""Encrypted 32-bit multiplies through the port's integer path
(`runtime/fluent.py` -> `FheCircuit` -> `runtime/wave_machine.py`),
against the benchmark's plain reference (`tfhe_bench/reference/fluent_uint.py`):

- the wiring: the plaintext evaluator on the full `UInt<32> * UInt<32>`
  graph gives the exact 64-bit product, and the graph holds the circuit
  bootstraps the benchmark's configuration counts;
- on ciphertexts at N = 256, n0 = 8 with DEFAULT_128's radices and
  negligible noise: `WaveMachine.run` and the gate-by-gate reference in
  float64 agree on a `UInt<6>` product, the smallest that crosses a
  refresh; the float32 reference does not;
- the wave machine's spans and counters, and its schedule cache;
- the benchmark's new adapter and reference load no JAX.

Keys come from seeded generators through the benchmark's keygen
(`tfhe_bench/frozen/keygen.py`), as the cell makes them at full size.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from spf_tpu_torch.params import DEFAULT_128, GlweDef, LweDef
from spf_tpu_torch.runtime import wave_machine as wm
from spf_tpu_torch.runtime.executor_u32 import U32ComputeKey
from spf_tpu_torch.runtime.fhe_circuit import FheCircuit, FheEdge, FheOp
from spf_tpu_torch.utils.profiling import metrics
from tfhe_bench.frozen import keygen
from tfhe_bench.reference import cycle, fluent_uint as ref
from tfhe_bench.systems.fluent_uint import build_graph
from tfhe_bench.systems.multibit_pbs import glwe_def, lwe_def, radix_def

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "tfhe_bench", "configs", "uint32_mul_default128.json")

N, N0, GROUP, WIDTH = 256, 8, 2, 6
PARAMS = dataclasses.replace(DEFAULT_128, l0_params=LweDef(N0, 1e-16),
                             l1_params=GlweDef(1, N, 1e-16))


def _pair(r):
    return [r.count, r.radix_log]


# the reference's view of the same parameters (the benchmark configuration's keys)
REF_PARAMS = {"cbs_radix": _pair(PARAMS.cbs_radix), "cbs_pbs_radix": _pair(PARAMS.cbs_pbs_radix),
              "tr_radix": _pair(PARAMS.tr_radix), "ss_radix": _pair(PARAMS.ss_radix),
              "ks_radix": _pair(PARAMS.ks_radix), "group_cbs": GROUP}

# The comparison of output phases (every coefficient of each output GLWE's
# phase polynomial), as log2 of the largest wrapped difference (q = 2^64; a
# bit decodes wrong 2^62 away). The program rounds every product in ds32
# (about 48 significant bits) where the float64 reference's are exact, and
# each CMux rounds its wire difference to the gadget's grid (cbs_radix
# 4 x 4 keeps 16 bits: a multiple of 2^48). Where the two evaluators'
# wires lie on either side of a rounding boundary, their CMux outputs step
# 2^48 apart, and the steps add up along a chain of CMuxes and through a
# refresh's circuit bootstrap. Over five seeds the UInt<6> product's gaps
# read 2^53.8-2^54.2 (a UInt<2> product, with no refresh, 2^51.7); the
# bound leaves 2^4 above them and 2^5 below the float32 reference, whose
# outputs decode wrong (2^63.0).
OUT_GAP_LOG2 = 58


@pytest.fixture(scope="module")
def u32():
    g, wires = build_graph(32, 1)
    return dict(circuit=g, graph=ref.graph_data(g), wires=wires[0])


def _operand_cases():
    rng = np.random.default_rng(20261019)
    pairs = [tuple(int(x) for x in rng.integers(0, 1 << 32, 2)) for _ in range(16)]
    top = (1 << 32) - 1
    return pairs + [(0, top), (1, top), (top, top)]


@pytest.mark.parametrize("a,b", _operand_cases())
def test_eval_bits_gives_the_u32_product(u32, a, b):
    a_keys, b_keys, out_keys = u32["wires"]
    inputs = {k: (a >> i) & 1 for i, k in enumerate(a_keys)}
    inputs.update({k: (b >> i) & 1 for i, k in enumerate(b_keys)})
    bits = ref.eval_bits(u32["graph"], inputs)
    assert len(out_keys) == 64
    assert sum(bits[k] << i for i, k in enumerate(out_keys)) == int(ref.product(a, b)) == a * b


def test_u32_product_runs_the_configured_circuit_bootstraps(u32):
    """3,270 circuit bootstraps a multiply (256 conversions of operand bits,
    3,014 refreshes), as `cbs_per_op` of the cell's configuration counts
    them, and the schedule runs each once."""
    with open(CONFIG) as fh:
        cbs_per_op = json.load(fh)["cbs_per_op"]
    nodes = u32["circuit"].nodes
    assert sum(n.op is FheOp.CIRCUIT_BOOTSTRAP for n in nodes) == cbs_per_op == 3270
    sched = wm.build_schedule(u32["circuit"])
    counts = wm.schedule_counts(sched)
    assert counts["wm.cbs_gates"] == cbs_per_op
    by_group = {}
    for w in sched.waves:
        by_group[w.group] = by_group.get(w.group, 0) + w.gates
    assert by_group["convert"] == 256 and by_group["refresh"] == 3014
    assert counts["wm.gates"] == sum(by_group.values())


def test_product_is_exact_past_2_to_63():
    top = (1 << 32) - 1
    got = ref.product(np.array([top, 1 << 31]), np.array([top, 1 << 31]))
    assert got.dtype == np.uint64 and [int(x) for x in got] == [top * top, 1 << 62]
    with pytest.raises(ValueError):
        ref.product(1 << 32, 1)


# -- on ciphertexts at N = 256 ----------------------------------------------


@pytest.fixture(scope="module")
def small():
    """Keys, a UInt<6> product's circuit and its inputs, the wave machine
    and its outputs with the spans and counters of that run."""
    seed = 20261020
    gen = torch.Generator().manual_seed(seed)
    lwe, glwe = lwe_def(N0, 1e-16), glwe_def(1, N, 1e-16)
    lwe_sk = keygen.generate_lwe_sk(lwe, gen)
    glwe_sk = keygen.generate_glwe_sk(glwe, gen)
    keys = dict(
        bsk=keygen.generate_multibit_bsk(lwe_sk, glwe_sk, glwe,
                                         radix_def(REF_PARAMS["cbs_pbs_radix"]), GROUP, gen),
        ak=keygen.generate_automorphism_keys(glwe_sk, glwe, radix_def(REF_PARAMS["tr_radix"]), gen),
        ssk=keygen.generate_scheme_switch_key(glwe_sk, glwe, radix_def(REF_PARAMS["ss_radix"]),
                                              gen),
        ksk=keygen.generate_lwe_keyswitch_key(glwe_sk.reshape(-1), lwe_sk, lwe,
                                              radix_def(REF_PARAMS["ks_radix"]), gen))
    circuit, wires = build_graph(WIDTH, 1)
    a_keys, b_keys, out_keys = wires[0]
    a, b = (int(x) for x in np.random.default_rng(seed).integers(0, 1 << WIDTH, 2))
    bits = [(a >> i) & 1 for i in range(WIDTH)] + [(b >> i) & 1 for i in range(WIDTH)]
    msgs = torch.zeros((2 * WIDTH, N), dtype=torch.int64)
    msgs[:, 0] = torch.tensor(bits) << 63
    cts = keygen.encrypt_glwe(msgs, glwe_sk, glwe, gen).numpy().view(np.uint64)
    inputs = dict(zip(a_keys + b_keys, cts))
    key = U32ComputeKey.from_coeff(keys["bsk"], keys["ak"], keys["ssk"], keys["ksk"], device="cpu")
    machine = wm.WaveMachine(key, PARAMS)
    sched = machine.schedule(circuit)
    spans: list = []
    real_span = wm.span

    def counted(name):
        spans.append(name)
        return real_span(name)

    before = metrics.snapshot()
    wm.span = counted  # the profiler would triple the run's time on the CPU
    try:
        out = machine.run(circuit, inputs)
    finally:
        wm.span = real_span
    after = metrics.snapshot()
    return dict(keys=keys, glwe_sk=glwe_sk, circuit=circuit, out_keys=out_keys, inputs=inputs,
                want=int(ref.product(a, b)), machine=machine, sched=sched, out=out, spans=spans,
                counters={k: after[k] - before.get(k, 0) for k in after if k.startswith("wm.")})


def _phases(out: dict, keys: list, sk) -> torch.Tensor:
    cts = np.stack([np.asarray(out[k], dtype=np.uint64) for k in keys]).view(np.int64)
    return cycle.glwe_phases(torch.from_numpy(cts), sk)  # [bits, N]


def _decoded(phases: torch.Tensor) -> int:
    bits = (((phases[:, 0] + (1 << 62)) >> 63) & 1).tolist()
    return sum(b << i for i, b in enumerate(bits))


def test_small_circuit_crosses_a_refresh(small):
    groups = {w.group for w in small["sched"].waves}
    assert {"convert", "refresh"} <= groups


def test_wave_machine_and_float64_reference_agree(small):
    s = small
    r = ref.eval_encrypted(s["circuit"], s["inputs"], s["keys"], REF_PARAMS, torch.float64)
    assert set(r) == set(s["out"]) == set(s["out_keys"])
    prog, plain = (_phases(o, s["out_keys"], s["glwe_sk"]) for o in (s["out"], r))
    assert _decoded(prog) == _decoded(plain) == s["want"]
    assert cycle.gap_log2(prog, plain) < OUT_GAP_LOG2


def test_float32_reference_misses_the_gap(small):
    """The control: the same reference one precision below the port's ds32."""
    s = small
    r = ref.eval_encrypted(s["circuit"], s["inputs"], s["keys"], REF_PARAMS, torch.float32)
    prog, low = (_phases(o, s["out_keys"], s["glwe_sk"]) for o in (s["out"], r))
    assert cycle.gap_log2(prog, low) >= OUT_GAP_LOG2


def _stretches(sched) -> list:
    names = []
    for w in sched.waves:
        name = wm._SPAN_OF_GROUP.get(w.group, "wm.other")
        if not names or names[-1] != name:
            names.append(name)
    return names


def test_wave_machine_spans_and_counters_fire_with_the_schedule(small):
    """One `wm.run` span a run, then one span a stretch of waves of one
    kind, in the schedule's order; the `wm.*` counters add the schedule's
    counts."""
    s = small
    assert s["spans"] == ["wm.run"] + _stretches(s["sched"])
    assert {"wm.convert", "wm.refresh", "wm.cmux"} <= set(s["spans"])
    assert len(s["spans"]) < len(s["sched"].waves)  # not one a wave
    waves = [w for w in s["sched"].waves]
    stacked = sum(w.idx["out"].shape[0] for w in waves if w.group == "cmux_scan")
    singles = sum(1 for w in waves if w.group != "cmux_scan")
    assert s["counters"] == wm.schedule_counts(s["sched"])
    assert s["counters"]["wm.calls"] == 1
    assert s["counters"]["wm.waves"] == singles + stacked
    assert s["counters"]["wm.gates"] == sum(w.gates for w in waves)
    assert s["counters"]["wm.cbs_gates"] == sum(
        w.gates for w in waves if w.group in ("convert", "refresh", "cbs"))
    assert s["counters"]["wm.lanes"] >= s["counters"]["wm.gates"]


def test_kept_buffers_reset_to_fresh_ones(small):
    """A replayed run zeroes the buffers it keeps and sets their constants
    again (`_reset_buffers`), as a fresh run's `_new_buffers` leaves them;
    the inputs then land in the same slots."""
    m, sched = small["machine"], small["sched"]
    kept = m._new_buffers(sched)
    m._scatter_inputs(sched, kept, small["inputs"])
    def planes(b):
        return () if b is None else b if isinstance(b, tuple) else (b,)

    for b in kept.values():
        for plane in planes(b):
            plane.add_(3)
    m._reset_buffers(sched, kept)
    fresh = m._new_buffers(sched)
    for kind in fresh:
        assert len(planes(kept[kind])) == len(planes(fresh[kind]))
        for a, b in zip(planes(kept[kind]), planes(fresh[kind])):
            assert torch.equal(a, b), kind
    assert int(fresh["glwe"][-1, 0, 1]) == -(1 << 63)  # slot 1: the trivial ONE
    m._scatter_inputs(sched, kept, small["inputs"])
    names, slots = sched.inputs["glwe"]
    x = np.asarray(small["inputs"][names[0]], dtype=np.uint64).view(np.int64)
    assert torch.equal(kept["glwe"][..., int(slots[0])], torch.from_numpy(x))


# -- the schedule cache --------------------------------------------------------


def _not_circuit(extra: bool = False) -> FheCircuit:
    """x -> NOT -> y (and, with `extra`, NOT again -> z)."""
    g = FheCircuit()
    x = g.add_node(FheOp.INPUT_GLWE1, "x")
    nt = g.add_node(FheOp.NOT)
    g.add_edge(x, nt, FheEdge.UNARY)
    y = g.add_node(FheOp.OUTPUT_GLWE1, "y")
    g.add_edge(nt, y, FheEdge.UNARY)
    if extra:
        _add_not_output(g, nt, "z")
    return g


def _add_not_output(g: FheCircuit, src: int, name: str) -> None:
    nt = g.add_node(FheOp.NOT)
    g.add_edge(src, nt, FheEdge.UNARY)
    g.add_edge(nt, g.add_node(FheOp.OUTPUT_GLWE1, name), FheEdge.UNARY)


def _bit_glwe(bit: int) -> np.ndarray:
    x = np.zeros((2, N), dtype=np.uint64)
    x[1, 0] = np.uint64(bit << 63)
    return x


def test_structure_key_is_memoised_and_dropped_on_growth():
    g = _not_circuit()
    k = g.structure_key()
    assert g.structure_key() is k and len(k) == 32
    assert _not_circuit().structure_key() == k
    _add_not_output(g, 1, "z")
    assert g.structure_key() != k and g.structure_key() == _not_circuit(extra=True).structure_key()
    h = FheCircuit()
    h.add_node(FheOp.INPUT_GLWE1, 0)
    other = FheCircuit()
    other.add_node(FheOp.INPUT_GLWE1, "0")
    assert h.structure_key() != other.structure_key()  # params keep their type


def test_structurally_equal_circuits_share_one_schedule(small):
    m = small["machine"]
    n_before = len(m._schedules)
    first, second = _not_circuit(), _not_circuit()
    assert m.schedule(first) is m.schedule(second)
    outs = [m.run(c, {"x": _bit_glwe(1)}) for c in (first, second)]
    assert len(m._schedules) == n_before + 1
    np.testing.assert_array_equal(outs[0]["y"], outs[1]["y"])


def test_circuit_grown_after_its_first_run_gets_a_new_schedule(small):
    m = small["machine"]
    g = _not_circuit()
    before = metrics.snapshot().get("wavemachine.schedules", 0)
    out = m.run(g, {"x": _bit_glwe(0)})
    assert set(out) == {"y"}
    _add_not_output(g, 1, "z")
    out = m.run(g, {"x": _bit_glwe(0)})
    assert set(out) == {"y", "z"}
    np.testing.assert_array_equal(out["z"], _bit_glwe(0))  # NOT NOT x is x, noiseless
    assert metrics.snapshot()["wavemachine.schedules"] - before in (1, 2)  # y may be cached
    assert m.schedule(g) is m.schedule(_not_circuit(extra=True))


def test_schedule_cache_reads_no_graph_on_a_later_run(monkeypatch):
    """A run of a circuit already scheduled walks none of its nodes: the
    key is the memoised digest."""
    machine = wm.WaveMachine(types.SimpleNamespace(device=torch.device("cpu")), PARAMS)
    g = _not_circuit()
    machine.schedule(g)

    def boom(*_):
        raise AssertionError("the graph was walked again")

    monkeypatch.setattr(wm, "build_schedule", boom)
    monkeypatch.setattr(FheCircuit, "structure_key", lambda self: self._structure_key or boom())
    assert machine.schedule(g) is machine.schedule(g)


# -- the benchmark's new files stand alone ----------------------------------


PROBE = r"""
import os, sys
sys.path.insert(0, os.environ["REPO"])
from tfhe_bench.reference import fluent_uint
from tfhe_bench.systems import fluent_uint as system
g, wires = system.build_graph(2, 1)
bits = fluent_uint.eval_bits(fluent_uint.graph_data(g), {k: 1 for k in wires[0][0] + wires[0][1]})
assert sum(bits[k] << i for i, k in enumerate(wires[0][2])) == 9
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "spf_tpu"))
assert not bad, bad
"""


def test_new_adapter_and_reference_load_no_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, REPO=REPO, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    ref_only = subprocess.run(
        [sys.executable, "-c", "import os, sys; sys.path.insert(0, os.environ['REPO']); "
         "from tfhe_bench.reference import fluent_uint; "
         "print(sorted(m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'jaxlib', 'spf_tpu', 'spf_tpu_torch')))"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, REPO=REPO, PYTHONPATH=""))
    assert ref_only.returncode == 0, ref_only.stderr
    assert ref_only.stdout.strip() == "[]"  # the reference imports nothing of the program
