"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped (CPU, tiny sizes), the rest of the
run is driven as it is, once for each fault that a cell can have (one
chip: no exchange between chips to leave out)."""

import numpy as np
import pytest
import torch

from conftest import PBS_CELL, UINT_CELL, tiny
from tfhe_bench import run


def _run(bench, cell, hooks, seed=2**31 + 99):
    out = run.run_cell(bench, cell, seed, 0.0, False, device="cpu", hooks=hooks,
                       **tiny(bench, cell))
    return out["result"]


@pytest.mark.parametrize("cell", [PBS_CELL, UINT_CELL])
def test_sound_run_is_correct(bench, cell):
    res = _run(bench, cell, None)
    assert res["correct"] and res["failed"] == 0
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"


def _pbs_wrap(fn):
    def hook(system):
        real = system.pbs
        system.pbs = lambda ct: fn(real, ct)
    return hook


def _half(real, ct):
    out = real(ct[:, : ct.shape[1] // 2])
    return torch.cat([out, out], dim=1)


def _alter(real, ct):
    out = real(ct).clone()
    out[-1, 0] += 1 << 61  # one message step (3-bit messages) on the first answer
    return out


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_pbs_fault_is_caught(bench, monkeypatch, fault):
    hooks = None
    if fault == "state_unchanged":
        from spf_tpu_torch.ops import multibit
        monkeypatch.setattr(multibit, "rotate_groups", lambda acc, *a, **k: acc)
    elif fault == "half_batch":
        hooks = _pbs_wrap(_half)
    else:
        hooks = _pbs_wrap(_alter)
    res = _run(bench, PBS_CELL, hooks)
    assert not res["correct"] and res["failed"] > 0


def _wm_wrap(fn):
    def hook(system):
        real = system.wm.run
        system.wm.run = lambda g, inputs: fn(system, real(g, inputs))
    return hook


def _wm_half(system, out):
    """Instances of the second half answered with the first half's."""
    half = system.n_inst // 2
    return {key: out[f"o{j - half}_{wi}" if j >= half else key]
            for j, wi, key in system.out_keys}


def _wm_alter(system, out):
    key = system.out_keys[0][2]
    ct = out[key].copy()
    ct[-1, 0] ^= np.uint64(1 << 63)  # + 2^63: flips the first instance's lowest bit
    return {**out, key: ct}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_integer_fault_is_caught(bench, monkeypatch, fault):
    hooks = None
    if fault == "state_unchanged":
        from spf_tpu_torch.runtime import wave_machine as wmod
        # every CMux wave leaves the slot buffers as they were
        monkeypatch.setitem(wmod.WAVES, "cmux", lambda *a: None)
        monkeypatch.setitem(wmod.WAVES, "cmux_scan", lambda *a: None)
    elif fault == "half_batch":
        hooks = _wm_wrap(_wm_half)
    else:
        hooks = _wm_wrap(_wm_alter)
    res = _run(bench, UINT_CELL, hooks)
    assert not res["correct"] and res["failed"] > 0
