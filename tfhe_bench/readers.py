"""Arithmetic shared by the metric readers (`metrics/<name>.py`).

Each reader takes the run's records and returns a number, or None where
it finds nothing to read; the harness then leaves the metric out.

Host-clock records (`--trace 0`): `setup_s`, `window_s` (the first call's
start to the last call's end), `latencies_s` (every call's upload to
download), `calls`, `units` (answers the calls carried).

Traced records (`--trace 1`): `device_ops` [(name, start ns, duration
ns, launcher: the `aten::` operator that launched it, or "")], `window_ns`, `busy_s` and `window_s` (the union of the device's
operations within the traced window, and the window), `calls`, `units`,
`shapes` (the launch shapes the system reports), `counters` (the
program's own counts over the traced calls).
"""

from __future__ import annotations

import statistics

from tfhe_bench.frozen import roofline as rf


def rate(rec: dict):
    """Answers completed in the window over the whole window."""
    if not rec.get("window_s") or "units" not in rec:
        return None
    return rec["units"] / rec["window_s"]


def percentile_ms(rec: dict, q: int):
    """The q-th percentile of every call's latency, ms (Python's
    `statistics.quantiles`, exclusive method)."""
    lat = rec.get("latencies_s") or []
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100)[q - 1] * 1e3


def device_idle(rec: dict):
    """The share of the traced window in which no operation ran on the
    device, %."""
    if not rec.get("window_s") or not rec.get("device_ops"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])


def launches(rec: dict, base: str, targs: tuple | None = None) -> list:
    """Durations (s) of the device operations of kernel `base`, with
    template arguments `targs` where given, in start order."""
    return [d / 1e9 for name, _, d, *_ in rec.get("device_ops", [])
            if rf.kernel_base(name) == base and (targs is None or rf.template_args(name) == targs)]


def roofline(bound_s: float, times: list):
    """Summed bounds over summed device times of the same launches, %."""
    if not times or sum(times) <= 0:
        return None
    return 100.0 * bound_s / sum(times)


def mad_roofline(rec: dict, group: int, key: str):
    """The roofline share of the k+1 = 2 MAD instance `<2, group>` over every
    traced launch, each at the shape `shapes[key]` (B there, or the widths
    `counters["cbs_wave_widths"]` of the waves that launch it, in order,
    an equal share of the launches each)."""
    shape = rec.get("shapes", {}).get(key)
    if shape is None:
        return None
    times = launches(rec, "mad_horner_kernel", (shape["kp1"], group))
    if not times:
        return None
    dims = dict(group=group, kp1=shape["kp1"], l=shape["l"], k=shape["k"])
    if "b" in shape:
        return roofline(len(times) * rf.mad_bound_s(b=shape["b"], **dims), times)
    widths = rec.get("counters", {}).get("cbs_wave_widths") or []
    if not widths or len(times) % len(widths):
        return None  # the launches cannot be matched to their waves
    per = len(times) // len(widths)
    return roofline(sum(per * rf.mad_bound_s(b=w, **dims) for w in widths), times)


def glue_share(rec: dict):
    """Device time in the kernels that PyTorch's operators launch (an
    `aten::` launcher: elementwise, index, copy and library kernels alike)
    over all device time, %. Copies and fills (Memcpy, Memset) are not
    glue, whoever asks for them; a kernel with no `aten::` launcher is the
    program's own, whatever its name. None where no operation carries a
    launcher."""
    ops = rec.get("device_ops") or []
    total = sum(op[2] for op in ops)
    launched = [op for op in ops if len(op) > 3 and op[3]]
    if not total or not launched:
        return None
    glue = sum(op[2] for op in launched if not op[0].startswith(("Memcpy", "Memset")))
    return 100.0 * glue / total
