"""pbs_per_s (PBS/s): every bootstrap completed in the window over the
whole window."""

from tfhe_bench.readers import rate


def read(rec):
    return rate(rec)
