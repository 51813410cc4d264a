"""The traffic generator: the same seed gives the same requests, every seed
the same sizes, and any whole-number seed works."""

import numpy as np
import pytest

from tfhe_bench import run, traffic as traffic_gen


@pytest.mark.parametrize("cell", ["pbs_mb3.batch2048", "uint_mul8.x16"])
def test_generator_is_deterministic_under_its_seed(bench, cell):
    _, _, traffic = run.cell_parts(bench, cell)
    seeds = (0, 7, 2**31 + 17, 2**40 + 3)
    runs = {s: traffic_gen.generate(traffic, s) for s in seeds}
    again = traffic_gen.generate(traffic, 2**31 + 17)
    assert all(np.array_equal(a[k], b[k]) for a, b in zip(runs[2**31 + 17], again) for k in a)
    first = runs[0]
    for s, reqs in runs.items():
        assert len(reqs) == traffic["pool"]
        for r, f in zip(reqs, first):
            assert sorted(r) == sorted(f)
            for k, spec in traffic["request"]["operands"].items():
                assert r[k].shape == (spec["count"],)
                assert r[k].min() >= 0 and r[k].max() < 1 << spec["bits"]
    assert not np.array_equal(runs[0][0][sorted(first[0])[0]], runs[7][0][sorted(first[0])[0]])


def test_generator_refuses_what_it_does_not_generate(bench):
    _, _, traffic = run.cell_parts(bench, "pbs_mb3.batch2048")
    for bad in ({"loop": "open"}, {"clients": 2}, {"pool": 0}, {"trace_calls": 1.5}):
        with pytest.raises(ValueError):
            traffic_gen.check({**traffic, **bad})
