"""cbs_trace_device_ms.cycle (ms): the device's time through the
program's `cbs.trace` spans (the homomorphic trace: 11 GLWE keyswitches a
level, four levels a circuit bootstrap), over the traced calls, per
circuit bootstrap (the program's `cbs.calls` counter). The program times
each span with a CUDA event as the host enters it and another as it
leaves (`utils.profiling.DeviceSpanClock`), so the number is the device's
work on the trace, and any idle between its kernels, however far the host
runs ahead. None where the program has no such clock or counter."""

SPAN_MS = "cbs.trace.device_ms"


def read(rec):
    counters = rec.get("counters", {})
    calls, ms = counters.get("cbs.calls"), counters.get(SPAN_MS)
    if not calls or ms is None:
        return None
    return ms / calls
