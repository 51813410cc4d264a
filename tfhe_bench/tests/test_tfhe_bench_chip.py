"""On the card: each cell's run, as the benchmark's command makes it, gives
a result line that is correct, with every metric the cell lists (end to
end, or per layer when traced) and its device. Skips without a card."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT
from tfhe_bench import run


CELLS = [w["name"] for w in run.load_json(os.path.join(ROOT, "BENCHMARK.json"))["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_correct_on_the_card(card, committed, cell, traced):
    out = subprocess.run([sys.executable, "-m", "tfhe_bench", "--workload", cell, "--seed",
                          str(2**31 + 5), "--seconds", "3", "--trace", str(traced)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    kinds = "per_layer" if traced else "end_to_end"
    listed = {m["name"] for m in committed[kinds] if cell in m.get("workloads", [cell])}
    assert listed and set(res["metrics"]) == listed
    for name, m in res["metrics"].items():
        assert m["value"] == m["value"] and (m["unit"] != "%" or 0 < m["value"] <= 100), (name, m)
