"""One-call program runner (≙ reference `parasol_cpu/src/runner.rs:10-27`).

A copy of `spf_tpu/cpu/runner.py` that also takes the circuit executor
as a keyword and passes it to `FheComputer` (e.g. `runtime.wave_machine.
WaveMachine(key, params)` with `runtime.executor_u32.U32HostEvaluation`);
without one the computer runs the u64 `CircuitExecutor(ev)`.
"""

from __future__ import annotations

from .args import CallData
from .memory import Memory
from .processor import FheComputer


def run_program(
    ev,
    elf_or_memory,
    name: str,
    call_data: CallData,
    gas_limit: int | None = None,
    executor=None,
):
    """Load `elf_or_memory` (ELF bytes or a prepared Memory), look up the
    function entry, and run it on an `FheComputer(ev, executor)`.
    `executor` runs each flush's circuit; the default is the u64
    `CircuitExecutor(ev)`, as in the reference.

    Returns (memory, return_ptr, computer)."""
    if isinstance(elf_or_memory, (bytes, bytearray)):
        memory = Memory.new_from_elf(bytes(elf_or_memory))
        entry = memory.get_function_entry(name)
    else:
        memory = elf_or_memory
        entry = memory.get_function_entry(name) if name else 0
    proc = FheComputer(ev, executor=executor)
    return_ptr = proc.run_program(entry, memory, call_data, gas_limit)
    return memory, return_ptr, proc
