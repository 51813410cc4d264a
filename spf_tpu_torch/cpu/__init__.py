"""The encrypted "Parasol" CPU: a 64-register, 32-bit-address processor
executing a custom ISA over plaintext or encrypted registers/memory
(≙ reference `parasol_cpu`).

A copy of `spf_tpu/cpu/`. The CPU is host code: plaintext state is Python
ints, ciphertext bits are the executor's GLWE handles, and every encrypted
op lowers into an `FheCircuit` that an executor runs at a flush:
`FheComputer(ev)` on an `Evaluation` runs the u64 `CircuitExecutor`;
`FheComputer(U32HostEvaluation(p), executor=WaveMachine(key, p))` runs
the wave machine on the card's kernels (`runtime/executor_u32.py`,
`runtime/wave_machine.py`)."""

from .isa import Instr, decode, encode  # noqa: F401
from .memory import Memory, Byte  # noqa: F401
from .processor import FheComputer  # noqa: F401
from .args import ArgsBuilder  # noqa: F401
from .runner import run_program  # noqa: F401
