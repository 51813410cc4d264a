"""Run one cell of the benchmark once.

    python3 -m tfhe_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`. Everything a cell
needs is found by name:

- the cell (`workloads` in `BENCHMARK.json`) names a configuration and a
  traffic mix;
- the configuration is the file that `configs` in `BENCHMARK.json` gives
  it; its `entry` names the adapter `systems/<entry>.py` that sets the
  program up and calls it;
- the traffic mix is `traffic/<traffic>.json`, read by `traffic.py`;
- each metric, end to end or per layer, is read by `metrics/<name>.py`
  (`read(rec) -> number or None`).

A run: set-up (imports, CUDA, the kernel build, keygen, the server's key
conversion and schedule, a warm-up call: `setup_s`), then with `--trace 0`
calls back to back for `--seconds` (the window; the end-to-end metrics),
or with `--trace 1` `trace_calls` whole calls under the profiler (the
per-layer metrics). Then the outputs of every call are judged against
the plain reference (`reference/`), and the last line of standard output
is the result.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time

import torch

from . import trace, traffic as traffic_gen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(__file__))
# top-level modules that may not be loaded in the process that prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "spf_tpu")


class NoCard(RuntimeError):
    pass


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    """Import the file at `path` as a module of its own."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path}: no such file")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_parts(bench: dict, cell_name: str, root: str = ROOT):
    """(cell, configuration, traffic) of a cell, each read from its file."""
    cell = find(bench["workloads"], cell_name, "workload")
    cfg_entry = find(bench["configs"], cell["config"], "configuration")
    cfg = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(PKG, "traffic", f"{cell['traffic']}.json"))
    traffic_gen.check(traffic)
    return cell, cfg, traffic


def system_module(entry: str):
    if not os.path.exists(os.path.join(PKG, "systems", f"{entry}.py")):
        raise FileNotFoundError(f"no adapter systems/{entry}.py")
    return importlib.import_module(f"tfhe_bench.systems.{entry}")


def metric_reader(name: str):
    return load_module(os.path.join(PKG, "metrics", f"{name}.py"),
                       "tfhe_bench_metric_" + name.replace(".", "_").replace("-", "_"))


def cell_metrics(bench: dict, cell_name: str, traced: bool) -> list:
    """The metrics a run of the cell reports: its end-to-end metrics, or
    with tracing its per-layer metrics (those listing the cell, or with no
    list, those whose end-to-end metric the cell reports)."""
    e2e = [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in names)]


def read_metrics(metrics: list, rec: dict) -> dict:
    out = {}
    for m in metrics:
        value = metric_reader(m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def window(system, seconds: float):
    """Calls back to back, the next as soon as the last returns, until
    `seconds` have passed. Returns (outputs [(i, output)], latencies s,
    window s from the first call's start to the last call's end)."""
    outputs, lat = [], []
    t0 = time.perf_counter()
    i = 0
    while True:
        c0 = time.perf_counter()
        out = system.call(i)
        c1 = time.perf_counter()
        outputs.append((i, out))
        lat.append(c1 - c0)
        i += 1
        if c1 - t0 >= seconds:
            return outputs, lat, c1 - t0


def judge(checked: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number compared must be
    present and at most its limit."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = checked["numbers"].get(name)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and value <= limit
    return ok, checks


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: float | None = None, hooks=None,
             root: str = ROOT, cfg_override: dict | None = None,
             traffic_override: dict | None = None) -> dict:
    """One run of a cell. Returns {"result": the result line's object,
    "info": what earlier lines print}. `hooks`, for tests and the control:
    a callable given the system after set-up, which may put something in
    the program's place."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell, cfg, traffic = cell_parts(bench, cell_name, root)
    cfg = cfg_override or cfg
    traffic = traffic_override or traffic
    cuda = torch.device(device).type == "cuda"
    if cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise NoCard(f"cell {cell_name} needs {cell['chips']} CUDA card(s); "
                         f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        torch.cuda.init()
    requests = traffic_gen.generate(traffic, seed)
    system = system_module(cfg["entry"]).make(cfg, traffic, requests, seed, device)
    if hooks is not None:
        hooks(system)
    system.call(len(requests) - 1)  # warm-up: every shape the window uses
    if cuda:
        torch.cuda.synchronize()
    t_window = time.perf_counter()
    info = {"setup_s": t_window - t_start}
    if traced:
        system.mark()
        outputs, rec = trace.profile_calls(system.call, traffic["trace_calls"], cuda)
        trace.summarise(rec)
        rec.update(calls=len(outputs), units=len(outputs) * system.units_per_call,
                   shapes=system.shapes(), counters=system.counters(len(outputs)))
        info.update(traced_calls=len(outputs), device_ops=len(rec["device_ops"]))
    else:
        outputs, lat, win = window(system, seconds)
        rec = {"setup_s": t_window - t_start, "window_s": win, "latencies_s": lat,
               "calls": len(outputs), "units": len(outputs) * system.units_per_call}
        q = statistics.quantiles(lat, n=10) if len(lat) > 1 else [lat[0]] * 9
        info.update(calls=len(outputs), window_s=win,
                    latency_ms={"min": min(lat) * 1e3, "median": statistics.median(lat) * 1e3,
                                "p90": q[8] * 1e3, "max": max(lat) * 1e3},
                    calls_beyond_p90=sum(x > q[8] for x in lat))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    metrics = read_metrics(cell_metrics(bench, cell_name, traced), rec)
    # the reference judges every output once the window has closed and the
    # program's device state is freed
    system.close()
    checked = system.check(outputs)
    correct, checks = judge(checked, cfg["limits"])
    result = {
        "correct": correct,
        "attempted": checked["attempted"],
        "failed": checked["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell["chips"],
            "memory_peak_bytes": peak,
        },
    }
    if traced:
        result["device"].update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        result["breakdown"] = trace.breakdown(rec)
    result["checks"] = checks
    info["check_s"] = checked.get("seconds")
    return {"result": result, "info": info, "forbidden": forbidden_modules()}


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="tfhe_bench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    try:
        out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                       t_start=t_start)
    except NoCard as exc:
        print(f"tfhe_bench: {exc}", file=sys.stderr)
        return 2
    if out["forbidden"]:
        print(f"tfhe_bench: modules that may not be loaded were: {out['forbidden']}",
              file=sys.stderr)
        return 3
    res = out["result"]
    print(json.dumps({"info": out["info"]}), flush=True)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
