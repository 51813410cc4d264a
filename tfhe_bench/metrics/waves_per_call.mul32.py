"""waves_per_call.mul32 (waves): the wave machine's waves over the traced
calls (its `wm.waves` counter: a stacked CMux run counts its stacked
waves) per call (`wm.calls`). None where the program has no such
counters."""


def read(rec):
    counters = rec.get("counters", {})
    waves, calls = counters.get("wm.waves"), counters.get("wm.calls")
    if not waves or not calls:
        return None
    return waves / calls
