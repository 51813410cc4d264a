"""device_idle.mul32 (%): the traced window's share with no device
operation: the host's pace across the wave machine's waves."""

from tfhe_bench.readers import device_idle


def read(rec):
    return device_idle(rec)
