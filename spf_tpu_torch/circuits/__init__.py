"""Boolean circuit layer: CMux-gate circuits for integer arithmetic
(≙ reference `mux_circuits` crate).

A copy of `spf_tpu/circuits/` (the generators, the BDD engines and the
shipped circuit caches under `data/`), so that the port imports nothing
of the JAX package; `tests/test_torch_circuits.py` holds the two equal
node for node."""

from .mux import MuxCircuit  # noqa: F401
from . import integer  # noqa: F401
