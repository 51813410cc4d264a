"""The one traffic generator: turns a traffic file and a seed into the
plaintext requests of a run.

A traffic file (`traffic/<name>.json`) is data only:

    {"pool": 4, "trace_calls": 6,
     "request": {"op": "lut", "add": 1,
                 "operands": {"x": {"bits": 3, "count": 2048}}}}

A mix is one client in a closed loop: it sends its next request as soon
as the last one is answered, so calls run back to back. A file with any
other key is refused, so a mix that asks for what this generator does not
make (an open loop, several clients) cannot run as if it were this one.

- `pool`: how many distinct requests are made in set-up; the window cycles
  through them in order;
- `trace_calls`: how many whole calls the traced run profiles;
- `request`: what one call asks of the system: `op` and its parameters,
  and for each operand its message width in bits and how many messages a
  call carries. Messages are uniform over [0, 2^bits).

Every seed gives the same sizes and the same number of requests; the seed
only chooses the messages.
"""

from __future__ import annotations

import numpy as np

# the stream of messages is apart from every other use of the seed
_STREAM = 0x7AFF1C
# the keys of a traffic file
_KEYS = ("pool", "trace_calls", "request")


def check(traffic: dict) -> None:
    """Raise unless `traffic` holds what the generator reads, and nothing
    else."""
    unknown = sorted(set(traffic) - set(_KEYS))
    if unknown:
        raise ValueError(f"traffic keys {unknown}: not generated (a mix is one closed-loop client)")
    for key in ("pool", "trace_calls"):
        if not isinstance(traffic.get(key), int) or traffic[key] < 1:
            raise ValueError(f"traffic {key} must be a positive whole number")
    req = traffic.get("request")
    if not isinstance(req, dict) or not isinstance(req.get("op"), str):
        raise ValueError("traffic request must name its op")
    ops = req.get("operands")
    if not isinstance(ops, dict) or not ops:
        raise ValueError("traffic request must list its operands")
    for name, spec in ops.items():
        if not (isinstance(spec.get("bits"), int) and 1 <= spec["bits"] <= 62):
            raise ValueError(f"operand {name}: bits must be a whole number in [1, 62]")
        if not (isinstance(spec.get("count"), int) and spec["count"] >= 1):
            raise ValueError(f"operand {name}: count must be a positive whole number")


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A NumPy generator for one use of the run's seed (any whole number)."""
    return np.random.default_rng([seed % (1 << 64), stream])


def generate(traffic: dict, seed: int) -> list:
    """The run's `pool` requests: each a dict operand name -> int64
    messages [count]."""
    check(traffic)
    rng = rng_for(seed, _STREAM)
    ops = traffic["request"]["operands"]
    return [{name: rng.integers(0, 1 << spec["bits"], spec["count"], dtype=np.int64)
             for name, spec in sorted(ops.items())}
            for _ in range(traffic["pool"])]
