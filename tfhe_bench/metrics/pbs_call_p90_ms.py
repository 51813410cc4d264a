"""pbs_call_p90_ms (ms): the 90th percentile of every call's upload to
download time in the window."""

from tfhe_bench.readers import percentile_ms


def read(rec):
    return percentile_ms(rec, 90)
