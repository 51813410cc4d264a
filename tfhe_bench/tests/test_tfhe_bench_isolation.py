"""What the harness runs loads neither JAX nor the JAX package, compared
by top-level module name whole (the port's name begins with the JAX
package's); the reference and the frozen copies load nothing of the
port; a run without a card, or without the program, prints no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

RUN_BOTH = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/tfhe_bench/tests")
import torch
torch.set_num_threads(2)
from conftest import tiny, with_shelved
from tfhe_bench import control, readers, run, trace, traffic
from tfhe_bench.systems import multibit_pbs, wave_machine
bench = with_shelved(run.load_json(sys.argv[1] + "/BENCHMARK.json"))
for cell in ("pbs_mb3.batch2048", "uint_mul8.x16"):
    for traced in (False, True):
        out = run.run_cell(bench, cell, 3, 0.0, traced, device="cpu", **tiny(bench, cell))
        assert out["result"]["correct"], out
    for m in bench["end_to_end"] + bench["per_layer"]:
        run.metric_reader(m["name"])
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in
                        ("jax", "jaxlib", "flax", "spf_tpu", "triton"))))
print(json.dumps(run.forbidden_modules()))
"""

PLAIN = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import tfhe_bench.reference.plain, tfhe_bench.reference.pbs, tfhe_bench.frozen.keygen
import tfhe_bench.frozen.roofline
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in
                        ("jax", "jaxlib", "flax", "spf_tpu", "spf_tpu_torch"))))
"""


def _py(code, *args, cwd, env=None, timeout=300):
    return subprocess.run([sys.executable, "-c", code, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=timeout, env=env or dict(os.environ, PYTHONPATH=""))


def test_a_run_of_each_cell_loads_neither_jax_nor_the_jax_package(tmp_path):
    out = _py(RUN_BOTH, ROOT, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, forbidden = (json.loads(x) for x in out.stdout.strip().splitlines()[-2:])
    assert loaded == [] and forbidden == []


def test_reference_and_frozen_copies_load_nothing_of_the_port(tmp_path):
    out = _py(PLAIN, ROOT, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_compared_whole():
    from tfhe_bench import run

    sys.modules.setdefault("spf_tpu_torch_lookalike_probe", sys)
    try:
        assert "spf_tpu_torch_lookalike_probe" not in run.forbidden_modules()
    finally:
        del sys.modules["spf_tpu_torch_lookalike_probe"]


def _bench_cmd(cwd):
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "tfhe_bench", "--workload", "pbs_mb3.batch2048",
                           "--seed", "4", "--seconds", "1", "--trace", "0"], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)


@pytest.mark.parametrize("only_paths", [False, True])
def test_no_card_or_no_program_prints_no_result(tmp_path, only_paths):
    cwd = ROOT
    if only_paths:
        shutil.copytree(os.path.join(ROOT, "tfhe_bench"), tmp_path / "tfhe_bench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
        cwd = tmp_path
    out = _bench_cmd(cwd)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
