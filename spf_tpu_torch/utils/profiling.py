"""Tracing, profiling and metrics (SURVEY §5 aux subsystems).

The reference gets op-level observability from the `tracing` crate
(span-per-task in the circuit processor) and criterion's timing
harnesses. The equivalents here (a copy of `spf_tpu/utils/profiling.py`,
with the device trace through `torch.profiler`):

- `Counters` / module-level `metrics` — cheap named counters wired into
  the executor (gates dispatched per op kind), the Parasol CPU
  (instructions, graph flushes, gas), and keygen. Counters record
  *dispatches*.
- `WaveProfiler` — per-wave wall-clock profile of a `CircuitExecutor`
  run: one row per (level, op, param) batched kernel group with gate
  count and blocking execution time. Forces device sync per group, so
  use it to find hot waves, not to measure end-to-end throughput.
- `device_trace` — context manager around `torch.profiler.profile`:
  writes a Chrome trace (viewable in Perfetto) of the host operators and,
  on a CUDA device, the kernels run inside the block.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from collections import defaultdict

import torch


class Counters:
    """Named monotonic counters (≙ the reference's per-subsystem trace
    events, aggregated)."""

    def __init__(self):
        self._c: dict[str, int] = defaultdict(int)

    def inc(self, name: str, n: int = 1):
        self._c[name] += n

    def snapshot(self) -> dict:
        return dict(self._c)

    def reset(self):
        self._c.clear()


#: process-global metrics registry
metrics = Counters()


@dataclasses.dataclass
class WaveRecord:
    level: int
    op: str
    param: object
    n_gates: int
    seconds: float


class WaveProfiler:
    """Collects per-wave timings from a `CircuitExecutor` run.

    Usage::

        prof = WaveProfiler()
        ex.profiler = prof
        ex.run(circuit, inputs)
        ex.profiler = None
        print(prof.report())
    """

    def __init__(self):
        self.records: list[WaveRecord] = []

    def record(self, level: int, op: str, param, n_gates: int, seconds: float):
        self.records.append(WaveRecord(level, op, str(param), n_gates, seconds))

    @property
    def total_seconds(self) -> float:
        return sum(r.seconds for r in self.records)

    def by_op(self) -> dict:
        """Aggregate gate counts and time per op kind, sorted by time."""
        agg: dict[str, list] = defaultdict(lambda: [0, 0.0, 0])
        for r in self.records:
            a = agg[r.op]
            a[0] += r.n_gates
            a[1] += r.seconds
            a[2] += 1
        return {
            op: {"gates": g, "seconds": round(s, 6), "waves": w}
            for op, (g, s, w) in sorted(
                agg.items(), key=lambda kv: -kv[1][1]
            )
        }

    def report(self) -> str:
        lines = [f"{'op':<24}{'gates':>8}{'waves':>7}{'seconds':>10}"]
        for op, row in self.by_op().items():
            lines.append(
                f"{op:<24}{row['gates']:>8}{row['waves']:>7}"
                f"{row['seconds']:>10.4f}"
            )
        lines.append(f"{'TOTAL':<24}{'':>8}{'':>7}{self.total_seconds:>10.4f}")
        return "\n".join(lines)

    def to_json(self, path: str):
        with open(path, "w") as f:
            json.dump(
                {
                    "records": [dataclasses.asdict(r) for r in self.records],
                    "by_op": self.by_op(),
                    "total_seconds": self.total_seconds,
                },
                f,
                indent=1,
            )


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace everything executed inside the block with `torch.profiler`
    (CPU operators and, where CUDA is available, the card's kernels) and
    write it to `log_dir/trace.json` (Chrome trace format)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def timed(name: str, sink: dict | None = None):
    """Wall-clock a block (blocking is the caller's concern); records
    into `sink[name]` and the global metrics as `time_ms.<name>`."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if sink is not None:
            sink[name] = dt
        metrics.inc(f"time_ms.{name}", int(dt * 1000))
