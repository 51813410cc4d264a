"""The plain reference against the port's plain CPU path at a tiny size,
and the control: the reference put in the program's place one precision
below the configuration's (float32) comes out not correct, in float64
correct."""

import numpy as np
import pytest
import torch

from conftest import PBS_CELL, UINT_CELL, tiny
from tfhe_bench import control, run
from tfhe_bench.reference import pbs as ref_pbs, plain
from tfhe_bench.systems import multibit_pbs


def _pbs_system(bench, seed=11):
    t = tiny(bench, PBS_CELL)
    reqs = run.traffic_gen.generate(t["traffic_override"], seed)
    return multibit_pbs.make(t["cfg_override"], t["traffic_override"], reqs, seed, "cpu")


def test_reference_pbs_agrees_with_the_ports_plain_path(bench):
    sysm = _pbs_system(bench)
    ct = sysm.pool[0]
    got = sysm.pbs(ct)  # the port, plain PyTorch on the CPU
    lut = torch.from_numpy(sysm.lut.view(np.int64))
    want = ref_pbs.programmable_bootstrap(ct, lut, sysm.bsk, sysm.group, sysm.shape["l"],
                                          sysm.radix_log, dtype=torch.float64, chunk=3)
    assert want.shape == got.shape
    expected = plain.add_mod(sysm.requests[0]["x"], sysm.add, sysm.bits)
    for out in (got, want):
        phases = plain.lwe_phases(out.numpy().T.view(np.uint64), sysm.sk_flat)
        decoded, share = plain.decode(phases, expected, sysm.bits)
        assert np.array_equal(decoded, expected) and share.max() < 1e-3
    # the same bootstrap up to the rounding of the port's ds32 products
    # (about 48 bits of products near 2^86 here: a gap near 2^44)
    p_got = plain.lwe_phases(got.numpy().T.view(np.uint64), sysm.sk_flat)
    p_want = plain.lwe_phases(want.numpy().T.view(np.uint64), sysm.sk_flat)
    gap = np.abs((p_got - p_want).view(np.int64).astype(np.float64)).max()
    assert gap < 2.0**48


def test_plain_decryption_of_glwe_coefficient_zero():
    rng = np.random.default_rng(3)
    n, k = 16, 2
    sk = rng.integers(0, 2, (k, n))
    a = rng.integers(0, 1 << 64, (1, k, n), dtype=np.uint64)
    m = np.uint64(5) << np.uint64(60)
    # b_0 = sum_i (a_i (*) s_i)_0 + m, negacyclic: a_0 s_0 - sum_{j>=1} a_j s_{N-j}
    dot = 0
    for i in range(k):
        dot += int(a[0, i, 0]) * int(sk[i, 0])
        for j in range(1, n):
            dot -= int(a[0, i, j]) * int(sk[i, n - j])
    b = np.zeros((1, 1, n), dtype=np.uint64)
    b[0, 0, 0] = (dot + int(m)) % (1 << 64)
    ct = np.concatenate([a, b], axis=1)
    assert plain.glwe_phases0(ct, sk)[0] == m


@pytest.mark.parametrize("mode, correct", [("control", False), ("reference64", True)])
def test_control_fails_and_float64_reference_passes_in_the_programs_place(bench, mode, correct):
    lines = control.readings(bench, PBS_CELL, mode, [5, 6, 7], 0.0, device="cpu",
                             **tiny(bench, PBS_CELL))
    assert [ln["correct"] for ln in lines] == [correct] * 3
    if not correct:
        assert all(ln["checks"]["err_share"]["value"] > 1 for ln in lines)


def test_plant_of_f32_spectra_fails_the_integer_cell(bench):
    lines = control.readings(bench, UINT_CELL, "control", [5, 6, 7], 0.0, device="cpu",
                             **tiny(bench, UINT_CELL))
    assert [ln["mode"] for ln in lines] == ["plant"] * 3
    assert not any(ln["correct"] for ln in lines)
