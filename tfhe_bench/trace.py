"""The traced run's records: whole calls under `torch.profiler`, reduced to
the device's operations, the traced window, the device's busy time, and
the breakdown that the result line carries.

The profiler's raw events are read (`kineto_results.events()`): building
its parsed event tree takes minutes for a call of 10^5 launches, the raw
events seconds. Each call runs inside a `tfhe_bench.call` span; the
traced window runs from the first call's start to the last call's end,
which both hold a synchronisation (a call returns its outputs on the
host), so every device operation of the calls lies inside it.

Each device operation keeps the host operator that launched it: the
profiler links a launch to the operator it ran under
(`linked_correlation_id`). A PyTorch operator is an `aten::` operation;
the port's own kernels, launched through ctypes, run under none.
"""

from __future__ import annotations

import bisect

import torch

CALL_SPAN = "tfhe_bench.call"
TOP = 10
# how far back from a gap the search for the host's innermost operation goes
_LOOKBACK = 4000


def profile_calls(call, n: int, cuda: bool):
    """Run call(0) ... call(n - 1) under the profiler. Returns (outputs
    [(i, output)], records)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    outputs = []
    with profile(activities=acts) as prof:
        for i in range(n):
            with record_function(CALL_SPAN):
                outputs.append((i, call(i)))
    return outputs, reduce(prof.profiler.kineto_results.events())


def _name(e) -> str:
    return e.name().replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0][:120]


def reduce(events) -> dict:
    """{"device_ops": [(name, start_ns, dur_ns, launcher)] in start order,
    launcher the `aten::` operator that launched it or "", "host_ops":
    [(name, start_ns, end_ns)] in start order, "window_ns": (start, end)}."""
    dev, host, calls, aten = [], [], [], {}
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation() or e.name() == CALL_SPAN:
                continue  # a host span mirrored on the device's timeline
            dev.append((_name(e), e.start_ns(), e.duration_ns(), e.linked_correlation_id()))
        else:
            name = e.name()
            if name == CALL_SPAN:
                calls.append((e.start_ns(), e.end_ns()))
            elif name.startswith("aten::"):
                aten[e.correlation_id()] = name
            host.append((name, e.start_ns(), e.end_ns()))
    dev = [(name, s, d, aten.get(link, "") if link else "") for name, s, d, link in dev]
    dev.sort(key=lambda x: x[1])
    host.sort(key=lambda x: x[1])
    if calls:
        window = (min(c[0] for c in calls), max(c[1] for c in calls))
    else:
        window = (0, 0)
    return {"device_ops": dev, "host_ops": host, "window_ns": window}


def busy_intervals(device_ops, window) -> list:
    """The union of the device operations' intervals, clipped to the
    window, as sorted disjoint [start, end) pairs in ns."""
    w0, w1 = window
    out = []
    for _, s, d, *_ in device_ops:
        s, e = max(s, w0), min(s + d, w1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_gaps(busy, window) -> list:
    """The window's stretches with no device operation: [(start, end)] ns."""
    gaps, t = [], window[0]
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if window[1] > t:
        gaps.append((t, window[1]))
    return gaps


def host_activity(host_ops, t: int, starts=None) -> str:
    """The innermost host operation running at time t (the one that
    started last among those that cover t), or "host: no operation"."""
    starts = starts if starts is not None else [h[1] for h in host_ops]
    i = bisect.bisect_right(starts, t) - 1
    stop = max(-1, i - _LOOKBACK)
    while i > stop:
        name, s, e = host_ops[i]
        if e >= t and name != CALL_SPAN:
            return name
        i -= 1
    return "host: no operation"


def breakdown(rec: dict) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, TOP each, [[name, seconds], ...] in descending
    order."""
    by_op: dict = {}
    for name, _, d, *_ in rec["device_ops"]:
        by_op[name] = by_op.get(name, 0) + d
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    starts = [h[1] for h in rec["host_ops"]]
    by_host: dict = {}
    for s, e in idle_gaps(rec["busy"], rec["window_ns"]):
        name = host_activity(rec["host_ops"], (s + e) // 2, starts)
        by_host[name] = by_host.get(name, 0) + (e - s)
    gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
            "idle_gaps": [[n, ns / 1e9] for n, ns in gaps]}


def summarise(rec: dict) -> dict:
    """Add the busy intervals, busy_s and window_s to the records."""
    rec["busy"] = busy_intervals(rec["device_ops"], rec["window_ns"])
    rec["busy_s"] = sum(e - s for s, e in rec["busy"]) / 1e9
    rec["window_s"] = (rec["window_ns"][1] - rec["window_ns"][0]) / 1e9
    return rec
