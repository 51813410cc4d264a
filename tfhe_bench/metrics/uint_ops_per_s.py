"""uint_ops_per_s (ops/s): encrypted integer operations (instances)
completed in the window over the whole window."""

from tfhe_bench.readers import rate


def read(rec):
    return rate(rec)
