"""The u32 multiply cell (`mul32.x4`) at a size for the CPU (N = 256, n0 = 8,
no noise, two `UInt<3>` products a call): a sound run is correct; a
flipped product bit, swapped instances, a missing output, an input handed
back as an output and the float32 reference in the program's place are
not, the float64 reference is; its readers read synthetic records and
give None where the records lack what they read. On the card: the float64
gate-by-gate reference, run on the first multiply of a cell-size call,
holds the program's output phases within stated gaps; the float32 one
does not; and the replayed CUDA graphs give the eager run's bits."""

import copy

import numpy as np
import pytest
import torch

from tfhe_bench import run, trace
from tfhe_bench.mad_batched_bound import mad_batched_bound_s, mad_batched_bytes
from tfhe_bench.reference import cycle as ref_cycle, fluent_uint as ref

CELL = "mul32.x4"
WIDTH, COUNT = 3, 2
SEED = 2**31 + 78
# The comparison on the card (`compare_first_multiply`): log2 of the largest
# wrapped difference of the output GLWEs' phase polynomials, the program's
# against the gate-by-gate reference's (q = 2^64; a bit decodes wrong 2^62
# away). The program rounds its products in ds32 where the float64
# reference's are exact; each CMux rounds its wire difference to the
# gadget's grid (a multiple of 2^48), so where two wires straddle a
# rounding boundary the outputs step 2^48 apart, and past a refresh the
# two evaluators' keyswitches round the differing L1 masks to different
# L0 ciphertexts, whose circuit bootstraps carry unrelated noise: the gap
# is that of two independent noisy outputs.
OUT_GAP_LOG2 = 61


def tiny_fluent(bench) -> dict:
    _, cfg, traffic = run.cell_parts(bench, CELL)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg["params"].update(n0=8, N=256, lwe_std=1e-16, glwe_std=1e-16)
    from tfhe_bench.systems.fluent_uint import build_graph

    circuit, _ = build_graph(WIDTH, 1)
    cfg["cbs_per_op"] = sum(n.op.value == "cbs" for n in circuit.nodes)
    for spec in traffic["request"]["operands"].values():
        spec.update(bits=WIDTH, count=COUNT)
    return dict(cfg_override=cfg, traffic_override=traffic)


def _run(bench, hooks=None, seed=SEED, traced=False):
    out = run.run_cell(bench, CELL, seed, 0.0, traced, device="cpu", hooks=hooks,
                       **tiny_fluent(bench))
    return out["result"]


def test_sound_run_is_correct(bench):
    res = _run(bench)
    assert res["correct"] and res["failed"] == 0
    assert res["attempted"] == COUNT * 2 * WIDTH  # one window call: every product bit
    assert res["checks"]["err_share"]["value"] < 0.1


def test_seed_gives_distinct_products(bench):
    """The fault of swapped instances below is visible only where the two
    products of the window's call differ."""
    from tfhe_bench import traffic as gen

    traffic = tiny_fluent(bench)["traffic_override"]
    r = gen.generate(traffic, SEED)[0]
    prods = ref.product(r["a"], r["b"])
    assert prods[0] != prods[1]


def _flip(system, out):
    key = system.wires[0][2][0]
    ct = out[key].copy()
    ct[-1, 0] ^= np.uint64(1 << 63)  # + q/2: the bit flipped
    return {**out, key: ct}


def _swap(system, out):
    first, second = system.wires[0][2], system.wires[1][2]
    swapped = dict(out)
    for k0, k1 in zip(first, second):
        swapped[k0], swapped[k1] = out[k1], out[k0]
    return swapped


def _missing(system, out):
    return {k: v for k, v in out.items() if k != system.wires[1][2][-1]}


def _pass_through(system, out, inputs):
    """An input bit equal to an output's bit handed back as that output:
    it decodes right, and is caught as an input."""
    a_keys = system.wires[0][0]
    for key in system.wires[0][2]:
        for a_key in a_keys:
            if _bit(system, out[key]) == _bit(system, inputs[a_key]):
                return {**out, key: inputs[a_key]}
    raise AssertionError("no input bit equals an output bit")


def _bit(system, ct) -> int:
    from tfhe_bench.reference import plain

    phase = plain.glwe_phases0(ct[None], system.glwe_sk)[0]
    return int(((int(phase) + (1 << 62)) >> 63) & 1)


def _faulty(fault):
    def hook(system):
        real = system.run

        def faulty_run(graph, inputs):
            out = real(graph, inputs)
            return fault(system, out, inputs) if fault is _pass_through else fault(system, out)

        system.run = faulty_run
    return hook


@pytest.mark.parametrize("fault", [_flip, _swap, _missing, _pass_through],
                         ids=["bit_flipped", "instances_swapped", "output_missing", "input_passed"])
def test_fault_is_caught(bench, fault):
    res = _run(bench, _faulty(fault))
    assert not res["correct"] and res["failed"] > 0
    assert res["checks"]["wrong"]["value"] == res["failed"]


def _reference_in_place(dtype):
    def hook(system):
        system.run = lambda graph, inputs: ref.eval_encrypted(graph, inputs, system.keys,
                                                              system.params, dtype)
    return hook


@pytest.mark.parametrize("dtype, correct", [(torch.float64, True), (torch.float32, False)])
def test_reference_in_the_programs_place(bench, dtype, correct):
    res = _run(bench, _reference_in_place(dtype))
    assert res["correct"] is correct


def test_traced_tiny_run_reports_the_wave_machines_counters(bench):
    seen = {}

    def hook(system):
        real = system.counters
        system.counters = lambda calls: seen.setdefault("counters", real(calls))
        from spf_tpu_torch.runtime.wave_machine import schedule_counts

        seen["expected"] = schedule_counts(system.sched)

    res = _run(bench, hook, traced=True)
    assert res["correct"]
    assert seen["counters"] == seen["expected"]  # one traced call
    # no device on the CPU: no device trace, no span clock; the counters' reader reads
    assert set(res["metrics"]) == {"waves_per_call.mul32"}
    assert res["metrics"]["waves_per_call.mul32"]["value"] == seen["expected"]["wm.waves"]


# -- the readers ---------------------------------------------------------------


def _rec(ops, window, counters=None, shapes=None, calls=1):
    rec = {"device_ops": list(ops), "window_ns": window, "host_ops": [],
           "counters": counters or {}, "shapes": shapes or {}, "calls": calls}
    return trace.summarise(rec)


READERS = ("device_idle.mul32", "cbs_lane_device_us.mul32", "waves_per_call.mul32",
           "mad_batched_roofline")


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_without_its_records(name):
    reader = run.metric_reader(name)
    assert reader.read({}) is None
    assert reader.read(_rec([], (0, 0), counters={"wm.calls": 1})) is None


def test_cbs_lane_device_us_is_the_cbs_spans_device_time_over_the_cbs_gates():
    reader = run.metric_reader("cbs_lane_device_us.mul32")
    c = {"wm.cbs_gates": 4000, "wm.convert.device_ms": 100.0, "wm.refresh.device_ms": 700.0,
         "wm.cmux.device_ms": 999.0, "cbs.trace.device_ms": 50.0}
    assert reader.read(_rec([], (0, 1), counters=c)) == pytest.approx(200.0)
    assert reader.read(_rec([], (0, 1), counters={"wm.cbs_gates": 4000})) is None
    assert reader.read(_rec([], (0, 1), counters={"wm.refresh.device_ms": 1.0})) is None


def test_waves_per_call_reads_the_counters():
    reader = run.metric_reader("waves_per_call.mul32")
    assert reader.read(_rec([], (0, 1), counters={"wm.waves": 5058, "wm.calls": 2})) == 2529
    assert reader.read(_rec([], (0, 1), counters={"wm.waves": 5058})) is None


def test_device_idle_is_the_share_of_the_window_with_no_operation():
    reader = run.metric_reader("device_idle.mul32")
    ops = [("k", 0, 30, ""), ("k", 20, 20, ""), ("k", 60, 20, "")]
    assert reader.read(_rec(ops, (0, 100))) == pytest.approx(40.0)


def test_mad_batched_roofline_matches_launches_to_the_calls_shapes():
    reader = run.metric_reader("mad_batched_roofline")
    launches = [[256, 157], [64, 10], [32, 32]]
    shape = {"mad_batched": dict(kp1=2, l=4, k=1024, launches=launches)}
    bound = sum(mad_batched_bound_s(2, 4, 1024, b, d) for b, d in launches)
    times_ns = [50_000, 20_000, 10_000] * 2  # two calls
    ops = [("mad_batched_kernel<2>(float const*)", i * 10**6, t, "")
           for i, t in enumerate(times_ns)]
    ops.append(("fwd_ds_kernel", 0, 5, ""))
    got = reader.read(_rec(ops, (0, 10**7), shapes=shape, calls=2))
    assert got == pytest.approx(100.0 * 2 * bound / (sum(times_ns) / 1e9))
    # a launch missing from the trace: the launches no longer match the calls
    assert reader.read(_rec(ops[1:], (0, 10**7), shapes=shape, calls=2)) is None
    assert reader.read(_rec(ops, (0, 10**7), calls=2)) is None


def test_mad_batched_bytes_count_each_distinct_row_once():
    row = 16 * 2 * 4 * 2 * 1024
    digits_out = 16 * (4 * 2 + 2) * 1024 * 256 + 4 * 256
    assert mad_batched_bytes(2, 4, 1024, 256, 157) == 157 * row + digits_out
    # PERF.md's table: B = 256 over 157 distinct slots, 0.02481 ms by the bytes
    assert mad_batched_bound_s(2, 4, 1024, 256, 157) * 1e3 == pytest.approx(0.02481, abs=5e-5)


# -- on the card -----------------------------------------------------------------


def compare_first_multiply(system, out: dict, inputs: dict, dtype) -> dict:
    """The gate-by-gate reference in `dtype` on the first multiply of a call
    (its own one-product graph: the same input and output keys as the
    call's first instance) against the program's outputs `out`: the
    log2 gap of the output phases and the products each decodes to."""
    from tfhe_bench.systems.fluent_uint import build_graph

    graph, wires = build_graph(system.width, 1)
    a_keys, b_keys, out_keys = wires[0]
    assert (a_keys, b_keys, out_keys) == system.wires[0]
    r = ref.eval_encrypted(graph, {k: inputs[k] for k in a_keys + b_keys}, system.keys,
                           system.params, dtype)
    sk = torch.from_numpy(system.glwe_sk)

    def phases(o):
        cts = np.stack([np.asarray(o[k], dtype=np.uint64) for k in out_keys]).view(np.int64)
        return ref_cycle.glwe_phases(torch.from_numpy(cts), sk)

    def decoded(ph):
        return sum(int(b) << i for i, b in enumerate((((ph[:, 0] + (1 << 62)) >> 63) & 1).tolist()))

    prog, plain = phases(out), phases(r)
    return {"gap_log2": ref_cycle.gap_log2(prog, plain), "program": decoded(prog),
            "reference": decoded(plain)}


@pytest.mark.chip
def test_reference_holds_the_first_multiply_of_a_cell_size_call(card, committed):
    from tfhe_bench import traffic as gen
    from tfhe_bench.systems import fluent_uint

    from spf_tpu_torch.runtime.wave_machine import WaveMachine

    _, cfg, traffic = run.cell_parts(committed, CELL)
    seed = 2**31 + 79
    requests = gen.generate(traffic, seed)
    system = fluent_uint.make(cfg, traffic, requests, seed, "cuda")
    inputs = system.pool[0]
    out = system.call(0)  # the schedule's second run: captured, then replayed
    again = system.call(0)
    eager = WaveMachine(system.wm.key, system.wm.params).run(system.graph, inputs)
    for key in eager:  # the replays run the eager path's kernels on its operands
        np.testing.assert_array_equal(out[key], eager[key])
        np.testing.assert_array_equal(again[key], eager[key])
    want = int(ref.product(requests[0]["a"][0], requests[0]["b"][0]))
    sound = compare_first_multiply(system, out, inputs, torch.float64)
    low = compare_first_multiply(system, out, inputs, torch.float32)
    print(f"gaps (log2): float64 {sound['gap_log2']:.3f}, float32 {low['gap_log2']:.3f}")
    assert sound["program"] == sound["reference"] == want
    assert sound["gap_log2"] < OUT_GAP_LOG2
    assert low["gap_log2"] >= OUT_GAP_LOG2
