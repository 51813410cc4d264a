"""cbs_lane_device_us.mul32 (us): the device's time through the wave
machine's circuit-bootstrap waves (its `wm.convert`, `wm.refresh` and
`wm.cbs` spans, each timed by a CUDA event as the host enters it and
another as it leaves), over the traced calls, per circuit bootstrap the
schedule ran (the `wm.cbs_gates` counter). None where the program has no
such clock or counter."""

SPANS = ("wm.convert.device_ms", "wm.refresh.device_ms", "wm.cbs.device_ms")


def read(rec):
    counters = rec.get("counters", {})
    gates = counters.get("wm.cbs_gates")
    ms = [counters[s] for s in SPANS if s in counters]
    if not gates or not ms:
        return None
    return 1e3 * sum(ms) / gates
