"""The conversion-cycle cell (`cycle.batch2048`) at a size for the CPU
(N = 256, n0 = 8, no noise, 8 lanes): a sound run is correct, each fault of
the timed path is not (GGSW rows and levels that the output does not read
among them), the float64 reference in the program's place is
correct and the float32 one is not, and its readers read synthetic
records. On the card: the float64 reference, put in the program's place
on a block of a cell-size call, decodes every lane and holds its phases
(GLEV, GGSW, L1) against the program's; the float32 one fails the same
comparison."""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tfhe_bench import run, trace
from tfhe_bench.frozen import roofline as rf
from tfhe_bench.reference import cycle as ref_cycle, plain

CELL = "cycle.batch2048"
# the phase comparison of the program against the float64 reference, on
# the card at the cell's size (see `compare_block`): log2 of the largest
# allowed gap. On an H100 the gaps read GLEV 2^43.9-2^44.0, GGSW 2^45.8,
# L1 2^48.1-2^48.4, and 2^62.9-2^63.0 each in float32; the bounds lie 2^4
# above the first. They grow with N: tests/test_torch_cycle_reference.py
# holds N = 64 to bounds of its own.
GLEV_GAP_LOG2 = 48
GGSW_GAP_LOG2 = 50
L1_GAP_LOG2 = 52


def tiny_cycle(bench) -> dict:
    _, cfg, traffic = run.cell_parts(bench, CELL)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg["params"].update(n0=8, N=256, lwe_std=1e-16, glwe_std=1e-16)
    traffic["request"]["operands"]["x"]["count"] = 8
    traffic["trace_calls"] = 2
    return dict(cfg_override=cfg, traffic_override=traffic)


def _run(bench, hooks=None, seed=2**31 + 77, traced=False):
    out = run.run_cell(bench, CELL, seed, 0.0, traced, device="cpu", hooks=hooks,
                       **tiny_cycle(bench))
    return out["result"]


def test_sound_run_is_correct(bench):
    res = _run(bench)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] == 8
    assert res["checks"]["err_share"]["value"] < 0.1


def _half(system, real, i):
    out, sample = real(i)
    half = out.shape[1] // 2
    return torch.cat([out[:, :half], out[:, :half]], dim=1), sample


def _alter(system, real, i):
    out, sample = real(i)
    out = out.clone()
    out[-1, 0] += 1 << 63  # the first lane's bit flipped
    return out, sample


def _swap(system, real, i):
    """Two lanes of different bits answered with each other's outputs."""
    out, sample = real(i)
    out = out.clone()
    bits = system.requests[i % len(system.requests)]["x"]
    other = int(np.flatnonzero(bits != bits[0])[0])
    out[:, [0, other]] = out[:, [other, 0]]
    return out, sample


def _pass_through(system, real, i):
    return system.pool[i % len(system.pool)].clone(), real(i)[1]


def _no_sample(system, real, i):
    return real(i)[0], torch.zeros(0)


@pytest.mark.parametrize("fault", [_half, _alter, _swap, _pass_through, _no_sample],
                         ids=["half_batch", "answer_altered", "lanes_swapped", "inputs_passed",
                              "ggsw_sample_missing"])
def test_cycle_fault_is_caught(bench, fault):
    def hook(system):
        real = system.call
        system.call = lambda i: fault(system, real, i)

    res = _run(bench, hook)
    assert not res["correct"] and res["failed"] > 0
    if fault in (_pass_through, _no_sample):  # every lane is caught
        assert res["failed"] == res["attempted"]


def _zero_rows_below_k(ggsw):
    """Rows j < k left without the scheme switch's key products."""
    return tuple(torch.cat([torch.zeros_like(c[:-1]), c[-1:]]) for c in ggsw)


def _zero_levels_after_0(ggsw):
    return tuple(torch.cat([c[:, :1], torch.zeros_like(c[:, 1:])], dim=1) for c in ggsw)


@pytest.mark.parametrize("fault", [_zero_rows_below_k, _zero_levels_after_0],
                         ids=["rows_below_k", "levels_1_to_3"])
def test_a_ggsw_the_output_does_not_read_is_still_held(bench, fault):
    """The CMux of (0, q/2) reads only row k, level 0 of each GGSW, so the
    L0 outputs stay right when the others are wrong; the sampled GGSWs are
    not."""
    def hook(system):
        real = system.cycle.bootstrap
        system.cycle.bootstrap = lambda ct: fault(real(ct))

    res = _run(bench, hook)
    assert not res["correct"] and res["failed"] > 0


def _reference_in_place(dtype):
    """The reference cycle in the program's place: its L0 output, and its
    sampled GGSWs turned into spectra by the program's forward FFT (the
    check brings them back by the inverse)."""
    def hook(system):
        from spf_tpu_torch.ops.bootstrap import bsk_to_freq

        def call(i):
            ct = system.pool[i % len(system.pool)]
            _, ggsw, _, out = ref_cycle.cycle_stages(ct, **system.keys, params=system.params,
                                                     dtype=dtype)
            lanes = torch.from_numpy(system.sample_lanes[i % len(system.sample_lanes)])
            sample = torch.stack([c.movedim(0, -1) for c in bsk_to_freq(ggsw[lanes])])
            return out, sample

        system.call = call
    return hook


@pytest.mark.parametrize("dtype, correct", [(torch.float64, True), (torch.float32, False)])
def test_reference_in_the_programs_place(bench, dtype, correct):
    res = _run(bench, _reference_in_place(dtype))
    assert res["correct"] is correct


def test_traced_tiny_run_reports_the_programs_counters(bench):
    seen = {}

    def hook(system):
        real = system.counters
        system.counters = lambda calls: seen.setdefault("counters", real(calls))

    res = _run(bench, hook, traced=True)
    assert res["correct"]
    # 2 traced calls of 8 lanes; a CBS's trace is 4 levels x log2(256) keyswitches
    assert seen["counters"] == {"cbs.calls": 2, "cbs.lanes": 16, "cbs.glwe_keyswitches": 64}
    # no device on the CPU: no device trace, no span clock
    assert res["metrics"] == {}


ISOLATED = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/tfhe_bench/tests")
import torch
torch.set_num_threads(2)
import tfhe_bench.reference.cycle
plain_only = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "spf_tpu", "spf_tpu_torch"))
from test_tfhe_bench_cycle import CELL, tiny_cycle
from tfhe_bench import run
bench = run.load_json(sys.argv[1] + "/BENCHMARK.json")
for traced in (False, True):
    assert run.run_cell(bench, CELL, 3, 0.0, traced, device="cpu", **tiny_cycle(bench))["result"]["correct"]
print(json.dumps([plain_only, run.forbidden_modules()]))
"""


def test_cycle_run_loads_no_jax_and_its_reference_nothing_of_the_port(tmp_path):
    out = subprocess.run([sys.executable, "-c", ISOLATED, run.ROOT], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], []]


def _rec(ops, window, host=(), counters=None, shapes=None):
    rec = {"device_ops": list(ops), "window_ns": window, "host_ops": list(host),
           "counters": counters or {}, "shapes": shapes or {}}
    return trace.summarise(rec)


def test_cbs_trace_device_ms_is_the_trace_spans_device_time_over_the_cbs_calls():
    reader = run.metric_reader("cbs_trace_device_ms.cycle")
    both = {"cbs.calls": 3, "cbs.trace.device_ms": 1500.0, "cbs.scheme_switch.device_ms": 99.0}
    assert reader.read(_rec([], (0, 10**8), counters=both)) == pytest.approx(500.0)
    assert reader.read(_rec([], (0, 10**8), counters={"cbs.calls": 3})) is None  # no clock
    assert reader.read(_rec([], (0, 10**8), counters={"cbs.trace.device_ms": 1.0})) is None
    assert reader.read(_rec([], (0, 10**8), counters={"cbs.calls": 0, "cbs.trace.device_ms": 1.0})) is None


def test_fft_roofline_at_the_cycles_shapes(bench):
    """The cell reports `fft_ds_roofline` from the shapes its adapter
    gives: every forward launch charged at the rotation's P = 8, every
    inverse at P = 2."""
    _, cfg, traffic = run.cell_parts(bench, CELL)
    shapes = run.system_module(cfg["entry"]).launch_shapes(
        cfg["params"], traffic["request"]["operands"]["x"]["count"])
    assert shapes["fwd_ds"] == dict(p=8, k=1024, b=2048) and shapes["inv_ds"] == dict(p=2, k=1024, b=2048)
    fwd, inv = rf.fft_bound_s(**shapes["fwd_ds"]), rf.fft_bound_s(**shapes["inv_ds"])
    ops = ([("fwd_ds_kernel", i * 10**6, int(2 * fwd * 1e9)) for i in range(4)]
           + [("inv_ds_kernel", 10**7 + i * 10**6, int(2 * inv * 1e9)) for i in range(4)])
    rec = _rec(ops, (0, 10**8), shapes=shapes)
    assert run.metric_reader("fft_ds_roofline").read(rec) == pytest.approx(50, rel=1e-5)


def test_glue_and_idle_of_the_cycle():
    ops = [("mad_horner_kernel<2, 2>", 0, 300, ""), ("at::native::add_kernel", 300, 500, "aten::add"),
           ("Memcpy DtoH (Device -> Pageable)", 900, 50, "aten::copy_")]
    rec = _rec(ops, (0, 1000))
    assert run.metric_reader("glue_device_share.cycle").read(rec) == pytest.approx(500 / 850 * 100)
    assert run.metric_reader("device_idle.cycle").read(rec) == pytest.approx(100 * 150 / 1000)
    empty = _rec([], (0, 0))
    for name in ("glue_device_share.cycle", "device_idle.cycle", "cbs_trace_device_ms.cycle",
                 "mad_horner_g2_roofline", "fft_ds_roofline"):
        assert run.metric_reader(name).read(empty) is None


def test_mad_g2_roofline_at_the_cells_batch():
    shape = dict(group=2, kp1=2, l=4, k=1024, b=2048)
    bound = rf.mad_bound_s(**shape)
    ops = [("mad_horner_kernel<2, 2>", i * 10**6, int(1.25 * bound * 1e9)) for i in range(3)]
    ops.append(("mad_horner_kernel<2, 3>", 10**8, 10**6))  # the PBS's instance: not counted
    rec = _rec(ops, (0, 2 * 10**8), shapes={"mad_horner_g2": shape})
    assert run.metric_reader("mad_horner_g2_roofline").read(rec) == pytest.approx(80, rel=1e-5)


def compare_block(system, lanes: int, dtype, pool_index: int = 0) -> dict:
    """The reference cycle (`reference/cycle.py`, in `dtype`) on the first
    `lanes` lanes of one pool batch, against the program's timed path on
    the whole batch: its GLEV levels, its GGSWs, its L1 LWE after the CMux
    and its L0 output. Returns the reference's decoding and error shares
    and the gaps (`ref_cycle.gap_log2`) of their phases: of the GLEV
    levels' and the GGSW rows' phase polynomials, of the L1 phases under
    the flat GLWE key, of the L0 phases. Ciphertexts are not compared: a
    keyswitch digit that rounds the other way changes a mask by a whole
    key row, its phase by the digit's rounding."""
    from spf_tpu_torch.ops import cbs
    from spf_tpu_torch.ops.bootstrap import inv_limb, spectra

    cyc, p = system.cycle, system.params
    ct = system.pool[pool_index].to(system.device)
    with torch.no_grad():
        acc = cbs.cbs_blind_rotate(ct, spectra(cyc, "bsk"), cyc.params)
        glev = cbs.cbs_levels(acc, spectra(cyc, "ak"), cyc.params)  # [l, k+1, N, B]
        ggsw = cbs.scheme_switch(glev, spectra(cyc, "ssk"), cyc.params.l1_params,
                                 cyc.params.cbs_radix, cyc.params.ss_radix)
        l1 = cyc.select(ggsw)
        out = cyc.keyswitch(l1)
        r_glev, r_ggsw, r_l1, r_out = ref_cycle.cycle_stages(ct[:, :lanes], **system.keys,
                                                             params=p, dtype=dtype)
        p_ggsw = inv_limb(tuple(c[..., :lanes] for c in ggsw)).permute(4, 0, 1, 2, 3)

    sk = torch.from_numpy(system.glwe_sk_flat.reshape(p["k"], p["N"])).to(system.device)
    bits = system.requests[pool_index]["x"][:lanes]
    bits_t = torch.from_numpy(bits).to(system.device)

    def glwe_gap(a, b):
        return ref_cycle.gap_log2(ref_cycle.glwe_phases(a, sk), ref_cycle.glwe_phases(b, sk))

    def phases(x, key):
        return plain.lwe_phases(x.cpu().numpy().T.view(np.uint64), key)

    def ggsw_share(g):
        return float(ref_cycle.ggsw_error_shares(g, bits_t, sk, p["cbs_radix"][1]).max())

    decoded, share = plain.decode(phases(r_out, system.lwe_sk), bits, 1)
    _, prog_share = plain.decode(phases(out[:, :lanes], system.lwe_sk), bits, 1)
    return {
        "dtype": str(dtype), "lanes": lanes,
        "decoded_all": bool(np.array_equal(decoded, bits)), "wrong": int((decoded != bits).sum()),
        "err_share": float(share.max()), "program_err_share": float(prog_share.max()),
        "ggsw_err_share": ggsw_share(r_ggsw), "program_ggsw_err_share": ggsw_share(p_ggsw),
        "glev_gap_log2": glwe_gap(glev[..., :lanes].permute(0, 3, 1, 2), r_glev),
        "ggsw_gap_log2": glwe_gap(p_ggsw, r_ggsw),
        "l1_gap_log2": ref_cycle.gap_log2(phases(l1[:, :lanes], system.glwe_sk_flat),
                                          phases(r_l1, system.glwe_sk_flat)),
        "l0_gap_log2": ref_cycle.gap_log2(phases(out[:, :lanes], system.lwe_sk),
                                          phases(r_out, system.lwe_sk)),
    }


def held(cmp: dict) -> bool:
    """The comparison: the reference decodes every lane, and its GLEV
    levels, GGSW rows and L1 phases lie within the program's ds32 rounding
    (GLEV_GAP, GGSW_GAP, L1_GAP). The L0 phases are not held: the
    keyswitch's digit rounding turns a small L1 difference into an
    unrelated rounding error of the size of the output's noise."""
    return (cmp["decoded_all"] and cmp["glev_gap_log2"] < GLEV_GAP_LOG2
            and cmp["ggsw_gap_log2"] < GGSW_GAP_LOG2 and cmp["l1_gap_log2"] < L1_GAP_LOG2)


@pytest.mark.chip
def test_reference_in_the_programs_place_on_the_card(card, committed):
    """Cell size: keys and one pool batch of 2048 lanes from a seed; the
    float64 reference on 64 of them holds, the float32 one does not."""
    _, cfg, traffic = run.cell_parts(committed, CELL)
    seed = 2**31 + 19
    reqs = run.traffic_gen.generate(traffic, seed)
    system = run.system_module(cfg["entry"]).make(cfg, traffic, reqs, seed, "cuda")
    lines = [compare_block(system, 64, dt) for dt in (torch.float64, torch.float32)]
    print(json.dumps(lines))
    assert held(lines[0]), lines[0]
    assert not held(lines[1]), lines[1]
