"""Shared fixtures of the harness's tests: the benchmark as committed and
tiny, noise-free versions of its cells that the CPU runs in seconds."""

import copy
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

torch.set_num_threads(2)

from tfhe_bench import run  # noqa: E402

PBS_CELL = "pbs_mb3.batch2048"
UINT_CELL = "uint_mul8.x16"


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


def with_shelved(bench: dict) -> dict:
    """The benchmark with the shelved cells' entries (`shelved_cells.json`:
    the integer cell, whose harness is whole but whose host-bound rate
    holds no bound yet) added, so that their pieces stay tested."""
    shelved = run.load_json(os.path.join(os.path.dirname(__file__), "shelved_cells.json"))
    out = copy.deepcopy(bench)
    for key, entries in shelved.items():
        have = {e["name"] for e in out[key]}
        out[key] += [e for e in entries if e["name"] not in have]
    return out


@pytest.fixture
def committed():
    """BENCHMARK.json as it stands."""
    return run.load_json(os.path.join(ROOT, "BENCHMARK.json"))


@pytest.fixture
def bench(committed):
    return with_shelved(committed)


def tiny(bench, cell: str):
    """The cell's configuration and traffic at a size for the CPU: N = 256,
    a handful of LWE key bits, no noise; 8 ciphertexts a PBS call, 2
    multiplies of 2-bit integers a circuit call."""
    _, cfg, traffic = run.cell_parts(bench, cell)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    small = cfg["entry"] == "multibit_pbs"
    cfg["params"].update(n0=16 if small else 8, N=256, lwe_std=1e-16, glwe_std=1e-16)
    for spec in traffic["request"]["operands"].values():
        if small:
            spec["count"] = 8
        else:
            spec.update(bits=2, count=2)
    traffic["trace_calls"] = 2
    return dict(cfg_override=cfg, traffic_override=traffic)


@pytest.fixture
def card():
    """Skips unless a CUDA card is present (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
