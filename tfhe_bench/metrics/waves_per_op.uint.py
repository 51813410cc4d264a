"""waves_per_op.uint (waves): the wave machine's waves (its `wave_log`)
over the traced calls, per integer operation."""


def read(rec):
    waves = rec.get("counters", {}).get("waves")
    if not waves or not rec.get("units"):
        return None
    return waves / rec["units"]
