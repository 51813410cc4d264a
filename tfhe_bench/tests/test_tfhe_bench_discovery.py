"""Every piece of a cell is found by its name, and a new cell, traffic mix
and metric are new files only: no file that is there needs an edit."""

import json
import os
import shutil
import subprocess
import sys

from conftest import PBS_CELL, ROOT, UINT_CELL
from tfhe_bench import run


def test_cells_find_their_configuration_traffic_system_and_metrics(bench):
    for w in bench["workloads"]:
        cell, cfg, traffic = run.cell_parts(bench, w["name"])
        assert cfg["name"] == w["config"]
        assert os.path.exists(os.path.join(run.PKG, "systems", f"{cfg['entry']}.py"))
        assert hasattr(run.system_module(cfg["entry"]), "make")
        assert traffic["request"]["operands"]
        for traced in (False, True):
            names = [m["name"] for m in run.cell_metrics(bench, w["name"], traced)]
            assert names, (w["name"], traced)
            for name in names:
                assert callable(run.metric_reader(name).read)


def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(bench):
    for cell in (PBS_CELL, UINT_CELL):
        e2e = {m["name"] for m in run.cell_metrics(bench, cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = run.cell_metrics(bench, cell, True)
        assert layer and all(m["moves"] in e2e for m in layer)


def test_configuration_files_are_the_benchmarks(bench):
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["security_bits"] == 128
        assert set(cfg["limits"]) == {"wrong", "err_share"}


PROBE = r"""
import json, sys
sys.path.insert(0, ".")
from tfhe_bench import run
bench = run.load_json("BENCHMARK.json")
cell, cfg, traffic = run.cell_parts(bench, "pbs_mb3.batch4096", root=".")
names = [m["name"] for m in run.cell_metrics(bench, "pbs_mb3.batch4096", True)]
value = run.metric_reader("calls_seen.pbs").read({"calls": 3})
print(json.dumps([traffic["request"]["operands"]["x"]["count"], names, value]))
"""


def test_a_new_cell_traffic_and_metric_need_no_edit(tmp_path):
    shutil.copytree(os.path.join(ROOT, "tfhe_bench"), tmp_path / "tfhe_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: (tmp_path / "tfhe_bench" / p).read_bytes()
              for p in os.listdir(tmp_path / "tfhe_bench")
              if (tmp_path / "tfhe_bench" / p).is_file()}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    # the new pieces: a traffic file, a metric file and entries in BENCHMARK.json
    with open(tmp_path / "tfhe_bench" / "traffic" / "batch2048.json") as fh:
        traffic = json.load(fh)
    traffic["request"]["operands"]["x"]["count"] = 4096
    (tmp_path / "tfhe_bench" / "traffic" / "batch4096.json").write_text(json.dumps(traffic))
    (tmp_path / "tfhe_bench" / "metrics" / "calls_seen.pbs.py").write_text(
        "def read(rec):\n    return rec.get('calls')\n")
    bench["workloads"].append({"name": "pbs_mb3.batch4096", "config": "pbs_mb3_default128",
                               "traffic": "batch4096", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "calls_seen.pbs", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "entry points",
                               "moves": "pbs_per_s", "workloads": ["pbs_mb3.batch4096"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    count, names, value = json.loads(out.stdout.strip().splitlines()[-1])
    assert count == 4096 and names == ["calls_seen.pbs"] and value == 3
    after = {p: (tmp_path / "tfhe_bench" / p).read_bytes() for p in before}
    assert after == before
