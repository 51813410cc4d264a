"""device_idle.cycle (%): the traced window's share with no device operation."""

from tfhe_bench.readers import device_idle


def read(rec):
    return device_idle(rec)
