"""FheComputer: the encrypted CPU front-end.

(≙ reference `parasol_cpu/src/proc/fhe_processor.rs` + `proc/ops/*`.)

Architecture note: the reference couples a Tomasulo out-of-order
dispatcher to a rayon thread pool to overlap the crypto of many
in-flight instructions (`fhe_processor.rs:309-401`, `src/tomasulo/`).
The TPU-native equivalent implemented here is *deferred dataflow
accumulation*: because branch conditions must be plaintext
(`Error::BranchConditionNotPlaintext`), control flow never depends on
ciphertext values, so every encrypted op can lower lazily into ONE
growing `FheCircuit` whose outputs are `LazyCt` handles held in
registers and memory. The graph is flushed (levelized + executed as
wide batched XLA waves) only when an observable boundary is reached:
program end, a debug handler touching ciphertext, or the gate budget
(flow control ≙ `circuit_processor/mod.rs:83-99`). This recovers MORE
instruction-level parallelism than Tomasulo — the whole program's gate
DAG is scheduled at once — while the front-end stays a simple in-order
fetch/decode loop with the same observable semantics: plaintext-only
branches, gas accounting, first-error faulting, plaintext fast paths.

Register file: 64 registers (`fhe_processor.rs:136`), each Plaintext
{val, width} or Ciphertext (list of L1 GLWE bit handles, LSB-first;
a handle is a concrete GLWE array or an unresolved `LazyCt`).

A copy of `spf_tpu/cpu/processor.py`; the graphs it builds are the
reference's node for node. Without an executor it runs the u64
`CircuitExecutor(ev)`, as the reference does; the wave machine and the
per-wave u32 executor plug in through `executor=`. Handles are whatever
the executor takes and returns (host numpy u64 arrays for the u32
executors, tensors for the u64 one), held as objects, so the identity
folding of the two trivial bits and the `id()` caches work as written.
"""

from __future__ import annotations

import dataclasses
import logging

from ..circuits import integer as int_circuits
from ..runtime.evaluation import Evaluation
from ..runtime.executor import CircuitExecutor
from ..runtime.fhe_circuit import CtType, FheCircuit, FheEdge, FheOp
from ..utils.profiling import metrics
from .isa import INSTRUCTION_SIZE, RP, SP, decode
from .memory import EncByte, Memory, MemoryError_


class CpuError(Exception):
    pass


class BranchConditionNotPlaintext(CpuError):
    pass


class OutOfGas(CpuError):
    pass


class WidthMismatch(CpuError):
    pass


# gas costs (≙ `fhe_processor.rs:221-307`): plaintext ops cost 1,
# ciphertext ops 100k, ciphertext multiplies 500k
GAS_PLAIN = 1
GAS_CIPHERTEXT = 100_000
GAS_CIPHERTEXT_MUL = 500_000


@dataclasses.dataclass
class PtVal:
    val: int
    width: int


@dataclasses.dataclass
class CtVal:
    bits: list  # GLWE bit ciphertexts, LSB-first
    width: int


class LazyCt:
    """Unresolved GLWE bit: a node in the processor's pending circuit.

    Holds the producing node id until `FheComputer.flush` executes the
    pending graph and fills `value` (≙ the reference's ROB entry whose
    result arrives via CompletionHandler, `tomasulo/registers.rs:48`).
    """

    __slots__ = ("node", "value")

    def __init__(self, node: int):
        self.node = node
        self.value = None


class FheComputer:
    # flush the pending graph when it grows past this many nodes —
    # bounds peak HBM like the reference's sync_channel flow control
    # (`circuit_processor/mod.rs:83-99`)
    FLUSH_NODE_BUDGET = 200_000

    def __init__(self, ev, executor=None):
        """`ev` gives `.params` and the two trivial GLWE bit handles: an
        `Evaluation`, or `runtime.executor_u32.U32HostEvaluation` beside an
        executor. `executor` overrides the circuit backend: any object with
        `run(circuit, inputs) -> outputs` over GLWE bit handles, e.g.
        `runtime.wave_machine.WaveMachine(key, params)` to run every flush
        as batched CBS / CMux waves on the card's kernels, or
        `runtime.executor_u32.U32CircuitExecutor`; the default is the u64
        `CircuitExecutor(ev)`."""
        if executor is None:
            if not isinstance(ev, Evaluation):
                raise CpuError(
                    "FheComputer(ev) without an executor runs the u64 CircuitExecutor, which "
                    "needs an Evaluation; with U32HostEvaluation pass executor=WaveMachine(key, "
                    "params) (spf_tpu_torch.runtime.wave_machine) or U32CircuitExecutor")
            executor = CircuitExecutor(ev)
        self.ev = ev
        self.ex = executor
        self.registers = [PtVal(0, 32) for _ in range(64)]
        self.gas_used = 0
        self.gas_limit = None
        self.debug_handlers: dict[int, object] = {}
        # two shared trivial GLWE bit handles: identity-checked so the
        # graph builder can fold lifted plaintext bits into GGSW consts
        self._triv_bits = (
            ev.enc.trivial_glwe_l1_zero(),
            ev.enc.trivial_glwe_l1_one(),
        )
        self.flush_count = 0
        self._new_pending()

    # ------------------------------------------------------------------
    # deferred-graph plumbing
    # ------------------------------------------------------------------

    def _new_pending(self):
        self.pending = FheCircuit()
        self.pending_inputs: dict[str, object] = {}
        self._in_ctr = 0
        self._lazy: list[LazyCt] = []
        # caches, all keyed per pending epoch:
        self._input_nodes: dict[int, int] = {}  # id(concrete ct) -> input node
        self._input_keep: list = []  # keep id()'d cts alive
        self._ggsw_cache: dict[object, int] = {}  # bit key -> GGSW node
        self._const_nodes: dict[FheOp, int] = {}

    def _const_node(self, op: FheOp) -> int:
        if op not in self._const_nodes:
            self._const_nodes[op] = self.pending.add_node(op)
        return self._const_nodes[op]

    def _glwe_node(self, bit) -> int:
        """Node producing this GLWE bit inside the pending graph."""
        if isinstance(bit, LazyCt):
            if bit.value is None:
                return bit.node
            bit = bit.value  # resolved in an earlier epoch: treat as concrete
        if bit is self._triv_bits[0]:
            return self._const_node(FheOp.ZERO_GLWE1)
        if bit is self._triv_bits[1]:
            return self._const_node(FheOp.ONE_GLWE1)
        node = self._input_nodes.get(id(bit))
        if node is None:
            key = f"__in{self._in_ctr}"
            self._in_ctr += 1
            node = self.pending.add_node(FheOp.INPUT_GLWE1, key)
            self.pending_inputs[key] = bit
            self._input_nodes[id(bit)] = node
            self._input_keep.append(bit)
        return node

    def _bit_ggsw(self, bit) -> int:
        """GGSW-producing node for a select wire. Lifted plaintext bits
        fold to the precomputed GGSW constants (≙ `evaluation.rs:161-196`
        GGSW 0/1 precompute); everything else goes through the
        conversion cycle GLWE1 -> LWE1 -> LWE0 -> (CBS) -> GGSW1, cached
        per source bit so one register bit used by many instructions is
        bootstrapped only once."""
        if bit is self._triv_bits[0]:
            return self._const_node(FheOp.ZERO_GGSW1)
        if bit is self._triv_bits[1]:
            return self._const_node(FheOp.ONE_GGSW1)
        if isinstance(bit, LazyCt) and bit.value is None:
            key = ("n", bit.node)
        else:
            src_obj = bit.value if isinstance(bit, LazyCt) else bit
            key = ("c", id(src_obj))
        node = self._ggsw_cache.get(key)
        if node is None:
            src = self._glwe_node(bit)
            node = self.pending.insert_ciphertext_conversion(
                src, CtType.GLWE1, CtType.GGSW1
            )
            self._ggsw_cache[key] = node
        return node

    def _new_lazy(self, node: int) -> LazyCt:
        lz = LazyCt(node)
        self._lazy.append(lz)
        return lz

    def flush(self, memory: Memory | None = None):
        """Execute the pending graph as batched level-synchronous waves
        and substitute results into registers and memory in place."""
        if not self._lazy:
            self._new_pending()
            return
        # live handles = those reachable from architectural state
        live: dict[int, list[LazyCt]] = {}

        def visit(bits):
            for b in bits:
                if isinstance(b, LazyCt) and b.value is None:
                    live.setdefault(b.node, []).append(b)

        for r in self.registers:
            if isinstance(r, CtVal):
                visit(r.bits)
        if memory is not None:
            for eb in memory.iter_enc_bytes():
                visit(eb.bits)
        if live:
            out_nodes = []
            for node in live:
                o = self.pending.add_node(FheOp.OUTPUT_GLWE1, f"__l{node}")
                self.pending.add_edge(node, o, FheEdge.UNARY)
                out_nodes.append(o)
            pruned, _ = self.pending.prune(out_nodes)
            result = self.ex.run(pruned, self.pending_inputs)
            for node, lazies in live.items():
                val = result[f"__l{node}"]
                for lz in lazies:
                    lz.value = val

        def subst(bits):
            for i, b in enumerate(bits):
                if isinstance(b, LazyCt) and b.value is not None:
                    bits[i] = b.value

        for r in self.registers:
            if isinstance(r, CtVal):
                subst(r.bits)
        if memory is not None:
            for eb in memory.iter_enc_bytes():
                subst(eb.bits)
        self.flush_count += 1
        metrics.inc("cpu.flushes")
        self._new_pending()

    # ------------------------------------------------------------------
    # program execution
    # ------------------------------------------------------------------

    def run_program(
        self,
        entry: int,
        memory: Memory,
        call_data=None,
        gas_limit=None,
        log_instruction_execution: bool = False,
        log_register_info: bool = False,
    ):
        """Fetch/decode/execute until Ret (≙ `run_program_with_options`,
        `fhe_processor.rs:635-700`; logging flags ≙ `RunProgramOptions`,
        `fhe_processor.rs:26-103`). Returns the return-value pointer."""
        log = logging.getLogger("spf_tpu_torch.cpu")
        self.reset()
        self.gas_limit = gas_limit
        return_ptr = 0
        if call_data is not None:
            return_ptr = self._set_up_function_call(memory, call_data)
        pc = entry
        while True:
            word = memory.try_load_plaintext_dword(pc)
            instr = decode(word)
            if log_instruction_execution:
                log.info("pc=0x%08x %s %s", pc, instr.name, instr.operands)
            if instr.name == "Ret":
                break
            pc = self._execute(instr, pc, memory)
            metrics.inc("cpu.instructions")
            if len(self.pending.nodes) > self.FLUSH_NODE_BUDGET:
                self.flush(memory)
            if log_register_info and "dst" in instr.operands:
                r = instr.operands["dst"]
                log.info("  x%d = %s", r, self.registers[r])
        self.flush(memory)
        return return_ptr

    def reset(self):
        self.registers = [PtVal(0, 32) for _ in range(64)]
        self.gas_used = 0
        self.flush_count = 0
        self._new_pending()

    def _set_up_function_call(self, memory: Memory, call_data) -> int:
        """Stack-based ABI v3 (`fhe_processor.rs:543-591`): one 16-aligned
        stack allocation holding args in order then the return slot;
        RP(X10) = return ptr, SP(X2) = allocation base."""
        size = call_data.alloc_size()
        memory.try_push_arg_onto_stack([0] * size, 16)
        sp = memory.stack_ptr
        cursor = sp
        for arg in call_data.args:
            align = arg.alignment
            cursor += (align - cursor % align) % align
            for b in arg.bytes:
                memory.store_byte(cursor, b)
                cursor += 1
        return_ptr = 0
        if call_data.return_size > 0:
            align = call_data.return_alignment
            cursor += (align - cursor % align) % align
            return_ptr = cursor
        self.registers[RP] = PtVal(return_ptr, 32)
        self.registers[SP] = PtVal(sp, 32)
        return return_ptr

    # ------------------------------------------------------------------
    # gas
    # ------------------------------------------------------------------

    def _gas(self, amount: int):
        self.gas_used += amount
        if self.gas_limit is not None and self.gas_used > self.gas_limit:
            raise OutOfGas(f"gas used {self.gas_used} > limit {self.gas_limit}")

    # ------------------------------------------------------------------
    # encrypted-op plumbing
    # ------------------------------------------------------------------

    def _lift(self, v, width=None) -> CtVal:
        """Trivially lift a plaintext register to GLWE bits
        (≙ `register_to_l1glwe_by_trivial_lift`, `proc/mod.rs:205-217`).
        Uses the two shared trivial handles so the graph builder can
        identity-fold them into constants."""
        if isinstance(v, CtVal):
            return v
        w = width or v.width
        return CtVal([self._triv_bits[(v.val >> i) & 1] for i in range(w)], w)

    def _run_mux(self, circuit, operand_bits: list) -> list:
        """Graft a mux circuit over the given GLWE bit handles into the
        pending graph; returns unresolved `LazyCt` output handles."""
        sel_nodes = [self._bit_ggsw(b) for b in operand_bits]
        outs = self.pending.insert_mux_circuit(circuit, sel_nodes)
        return [self._new_lazy(o) for o in outs]

    # ------------------------------------------------------------------
    # instruction execution
    # ------------------------------------------------------------------

    def _execute(self, instr, pc: int, memory: Memory) -> int:
        name = instr.name
        regs = self.registers

        if name == "LoadI":
            self._gas(GAS_PLAIN)
            regs[instr.dst] = PtVal(instr.imm & self._mask(instr.width), instr.width)
        elif name == "Move":
            self._gas(GAS_PLAIN)
            regs[instr.dst] = regs[instr.src]
        elif name in ("Trunc", "Zext", "Sext"):
            self._gas(GAS_PLAIN)
            regs[instr.dst] = self._cast(regs[instr.src], instr.width, name)
        elif name == "Load":
            self._exec_load(instr, memory)
        elif name == "Store":
            self._exec_store(instr, memory)
        elif name in ("Add", "Sub", "Mul", "And", "Or", "Xor"):
            self._exec_binary(instr, name)
        elif name in ("AddC", "SubB"):
            self._exec_carry(instr, name)
        elif name == "Neg":
            self._exec_neg(instr)
        elif name == "Not":
            self._exec_not(instr)
        elif name.startswith("Cmp"):
            self._exec_cmp(instr, name)
        elif name in ("Shl", "Shr", "Shra", "Rotl", "Rotr"):
            self._exec_shift(instr, name)
        elif name == "Cmux":
            self._exec_cmux(instr)
        elif name == "BranchNonZero":
            cond = regs[instr.cond]
            if not isinstance(cond, PtVal):
                raise BranchConditionNotPlaintext()
            self._gas(GAS_PLAIN)
            return (pc + instr.pc_offset) & 0xFFFFFFFF if cond.val != 0 else pc + INSTRUCTION_SIZE
        elif name == "BranchZero":
            cond = regs[instr.cond]
            if not isinstance(cond, PtVal):
                raise BranchConditionNotPlaintext()
            self._gas(GAS_PLAIN)
            return (pc + instr.pc_offset) & 0xFFFFFFFF if cond.val == 0 else pc + INSTRUCTION_SIZE
        elif name == "Branch":
            self._gas(GAS_PLAIN)
            return (pc + instr.pc_offset) & 0xFFFFFFFF
        elif name == "Dbg":
            handler = self.debug_handlers.get(instr.handler_id)
            if handler is not None:
                v = regs[instr.src]
                if isinstance(v, CtVal) and any(
                    isinstance(b, LazyCt) and b.value is None for b in v.bits
                ):
                    self.flush(memory)  # handler observes ciphertext values
                handler(regs[instr.src])
        else:
            raise CpuError(f"unhandled instruction {name}")
        return pc + INSTRUCTION_SIZE

    # --- helpers ---

    @staticmethod
    def _mask(width: int) -> int:
        return (1 << width) - 1

    @staticmethod
    def _signed(val: int, width: int) -> int:
        return val - (1 << width) if val >> (width - 1) else val

    def _cast(self, v, width: int, kind: str):
        """zext appends trivial zeros, sext replicates the MSB handle,
        trunc drops handles (`proc/ops/casting.rs:15-147`)."""
        if isinstance(v, PtVal):
            if kind == "Trunc":
                return PtVal(v.val & self._mask(width), width)
            if kind == "Zext":
                return PtVal(v.val, width)
            sval = self._signed(v.val, v.width)
            return PtVal(sval & self._mask(width), width)
        if kind == "Trunc":
            return CtVal(v.bits[:width], width)
        if width <= v.width:
            return CtVal(v.bits[:width], width)
        if kind == "Zext":
            zero = self._lift(PtVal(0, 1)).bits[0]
            return CtVal(list(v.bits) + [zero] * (width - v.width), width)
        return CtVal(list(v.bits) + [v.bits[-1]] * (width - v.width), width)

    def _exec_binary(self, instr, name):
        a, b = self.registers[instr.a], self.registers[instr.b]
        if a.width != b.width:
            raise WidthMismatch(f"{name}: {a.width} != {b.width}")
        w = a.width
        if isinstance(a, PtVal) and isinstance(b, PtVal):
            self._gas(GAS_PLAIN)
            fn = {
                "Add": lambda x, y: x + y,
                "Sub": lambda x, y: x - y,
                "Mul": lambda x, y: x * y,
                "And": lambda x, y: x & y,
                "Or": lambda x, y: x | y,
                "Xor": lambda x, y: x ^ y,
            }[name]
            self.registers[instr.dst] = PtVal(fn(a.val, b.val) & self._mask(w), w)
            return
        self._gas(GAS_CIPHERTEXT_MUL if name == "Mul" else GAS_CIPHERTEXT)
        ca, cb = self._lift(a), self._lift(b)
        circuit = {
            "Add": lambda: int_circuits.ripple_carry_adder(w, emit_carry=False),
            "Sub": lambda: int_circuits.full_subtractor(w, emit_borrow=False),
            "Mul": lambda: None,
            "And": lambda: int_circuits.bitwise_and(w),
            "Or": lambda: int_circuits.bitwise_or(w),
            "Xor": lambda: int_circuits.bitwise_xor(w),
        }[name]()
        if name == "Mul":
            outs = self._mul_bits(ca.bits, cb.bits, w)
        else:
            outs = self._run_mux(circuit, ca.bits + cb.bits)
        self.registers[instr.dst] = CtVal(outs[:w], w)

    def _mul_bits(self, a_bits, b_bits, w):
        """Low word of the product (`proc/ops/mul.rs`); gradeschool
        decomposition above the circuit cutoff."""
        if w <= int_circuits.CIRCUIT_CUTOFF:
            outs = self._run_mux(
                int_circuits.unsigned_multiplier(w, w), a_bits + b_bits
            )
            return outs[:w]
        # low word only: (a_lo*b_lo) + ((a_lo*b_hi + a_hi*b_lo) << lo_n), truncated
        lo_n, _hi_n = int_circuits.partition_integer(w)
        ll_full = self._run_mux(
            int_circuits.unsigned_multiplier(lo_n, lo_n), a_bits[:lo_n] + b_bits[:lo_n]
        )
        lh = self._mul_bits(a_bits[:lo_n], b_bits[lo_n:w], w - lo_n)
        hl = self._mul_bits(a_bits[lo_n:w], b_bits[:lo_n], w - lo_n)
        hi_sum = self._run_mux(
            int_circuits.ripple_carry_adder(w - lo_n, emit_carry=False), lh + hl
        )
        top = self._run_mux(
            int_circuits.ripple_carry_adder(w - lo_n, emit_carry=False),
            ll_full[lo_n:w] + hi_sum,
        )
        return ll_full[:lo_n] + top

    def _exec_carry(self, instr, name):
        a, b = self.registers[instr.a], self.registers[instr.b]
        cin = self.registers[instr.carry_in if name == "AddC" else instr.borrow_in]
        if a.width != b.width:
            raise WidthMismatch(f"{name}: {a.width} != {b.width}")
        w = a.width
        if all(isinstance(x, PtVal) for x in (a, b, cin)):
            self._gas(GAS_PLAIN)
            c = cin.val & 1
            if name == "AddC":
                total = a.val + b.val + c
                self.registers[instr.dst] = PtVal(total & self._mask(w), w)
                self.registers[instr.carry_out] = PtVal(total >> w, 1)
            else:
                total = a.val - b.val - c
                self.registers[instr.dst] = PtVal(total & self._mask(w), w)
                self.registers[instr.borrow_out] = PtVal(1 if total < 0 else 0, 1)
            return
        self._gas(GAS_CIPHERTEXT)
        ca, cb, cc = self._lift(a), self._lift(b), self._lift(cin, 1)
        if name == "AddC":
            circuit = int_circuits.ripple_carry_adder(w, carry_in=True, emit_carry=True)
        else:
            circuit = int_circuits.full_subtractor(w, borrow_in=True, emit_borrow=True)
        outs = self._run_mux(circuit, ca.bits + cb.bits + [cc.bits[0]])
        self.registers[instr.dst] = CtVal(outs[:w], w)
        out_reg = instr.carry_out if name == "AddC" else instr.borrow_out
        self.registers[out_reg] = CtVal([outs[w]], 1)

    def _exec_neg(self, instr):
        v = self.registers[instr.src]
        w = v.width
        if isinstance(v, PtVal):
            self._gas(GAS_PLAIN)
            self.registers[instr.dst] = PtVal((-v.val) & self._mask(w), w)
            return
        self._gas(GAS_CIPHERTEXT)
        outs = self._run_mux(int_circuits.negate(w), v.bits)
        self.registers[instr.dst] = CtVal(outs, w)

    def _exec_not(self, instr):
        v = self.registers[instr.src]
        w = v.width
        if isinstance(v, PtVal):
            self._gas(GAS_PLAIN)
            self.registers[instr.dst] = PtVal((~v.val) & self._mask(w), w)
            return
        # NOT on GLWE bits is keyless (x + trivial(1); `evaluation.rs:48`)
        self._gas(GAS_PLAIN)
        bits = []
        for b in v.bits:
            if b is self._triv_bits[0]:
                bits.append(self._triv_bits[1])
            elif b is self._triv_bits[1]:
                bits.append(self._triv_bits[0])
            else:
                node = self.pending.add_node(FheOp.NOT)
                self.pending.add_edge(self._glwe_node(b), node, FheEdge.UNARY)
                bits.append(self._new_lazy(node))
        self.registers[instr.dst] = CtVal(bits, w)

    def _exec_cmp(self, instr, name):
        a, b = self.registers[instr.a], self.registers[instr.b]
        if a.width != b.width:
            raise WidthMismatch(f"{name}: {a.width} != {b.width}")
        w = a.width
        if isinstance(a, PtVal) and isinstance(b, PtVal):
            self._gas(GAS_PLAIN)
            av, bv = a.val, b.val
            if name.endswith("S"):
                av, bv = self._signed(av, w), self._signed(bv, w)
            result = {
                "CmpEq": av == bv,
                "CmpGt": av > bv, "CmpGtS": av > bv,
                "CmpGe": av >= bv, "CmpGeS": av >= bv,
                "CmpLt": av < bv, "CmpLtS": av < bv,
                "CmpLe": av <= bv, "CmpLeS": av <= bv,
            }[name]
            self.registers[instr.dst] = PtVal(int(result), 1)
            return
        self._gas(GAS_CIPHERTEXT)
        ca, cb = self._lift(a), self._lift(b)
        signed = name.endswith("S")
        if name == "CmpEq":
            circ = int_circuits.compare_equal(w)
            bits = ca.bits + cb.bits
        elif name in ("CmpGt", "CmpGtS"):
            circ = int_circuits.compare_or_maybe_equal(w, False, signed)
            bits = ca.bits + cb.bits
        elif name in ("CmpGe", "CmpGeS"):
            circ = int_circuits.compare_or_maybe_equal(w, True, signed)
            bits = ca.bits + cb.bits
        elif name in ("CmpLt", "CmpLtS"):
            circ = int_circuits.compare_or_maybe_equal(w, False, signed)
            bits = cb.bits + ca.bits  # a < b  <=>  b > a
        else:  # CmpLe / CmpLeS
            circ = int_circuits.compare_or_maybe_equal(w, True, signed)
            bits = cb.bits + ca.bits
        outs = self._run_mux(circ, bits)
        self.registers[instr.dst] = CtVal(outs, 1)

    def _exec_shift(self, instr, name):
        v = self.registers[instr.src]
        amt = self.registers[instr.shift]
        w = v.width
        if isinstance(v, PtVal) and isinstance(amt, PtVal):
            self._gas(GAS_PLAIN)
            s = amt.val % w if name in ("Rotl", "Rotr") else min(amt.val, w)
            val = v.val
            if name == "Shl":
                out = (val << s) & self._mask(w) if s < w else 0
            elif name == "Shr":
                out = val >> s if s < w else 0
            elif name == "Shra":
                out = (self._signed(val, w) >> s) & self._mask(w) if s < w else (
                    self._mask(w) if val >> (w - 1) else 0
                )
            elif name == "Rotl":
                out = ((val << s) | (val >> (w - s))) & self._mask(w) if s else val
            else:
                out = ((val >> s) | (val << (w - s))) & self._mask(w) if s else val
            self.registers[instr.dst] = PtVal(out, w)
            return
        if isinstance(amt, PtVal):
            # plaintext amount: pure handle permutation + fill
            # (`proc/ops/bitshift.rs:50-90`)
            self._gas(GAS_PLAIN)
            cv = self._lift(v)
            s = amt.val % w if name in ("Rotl", "Rotr") else min(amt.val, w)
            zero = self._lift(PtVal(0, 1)).bits[0]
            bits = cv.bits
            if name == "Shl":
                out = [zero] * s + bits[: w - s]
            elif name == "Shr":
                out = bits[s:] + [zero] * s
            elif name == "Shra":
                out = bits[s:] + [bits[-1]] * s
            elif name == "Rotl":
                out = bits[w - s :] + bits[: w - s] if s else list(bits)
            else:
                out = bits[s:] + bits[:s] if s else list(bits)
            self.registers[instr.dst] = CtVal(out[:w], w)
            return
        # encrypted amount: barrel shifter over log2(w) amount bits
        self._gas(GAS_CIPHERTEXT)
        cv = self._lift(v)
        ca = self._lift(amt)
        shift_bits = max(1, (w - 1).bit_length())
        direction = int_circuits.LEFT if name in ("Shl", "Rotl") else int_circuits.RIGHT
        mode = (
            int_circuits.ROTATE
            if name in ("Rotl", "Rotr")
            else int_circuits.ARITHMETIC
            if name == "Shra"
            else int_circuits.LOGICAL
        )
        circ = int_circuits.bitshift(w, shift_bits, direction, mode)
        outs = self._run_mux(circ, cv.bits + ca.bits[:shift_bits])
        self.registers[instr.dst] = CtVal(outs, w)

    def _exec_cmux(self, instr):
        cond = self.registers[instr.cond]
        a, b = self.registers[instr.a], self.registers[instr.b]
        if a.width != b.width:
            raise WidthMismatch("Cmux operand widths differ")
        w = a.width
        if isinstance(cond, PtVal):
            self._gas(GAS_PLAIN)
            self.registers[instr.dst] = a if cond.val != 0 else b
            return
        self._gas(GAS_CIPHERTEXT)
        ca, cb = self._lift(a), self._lift(b)
        sel = self._bit_ggsw(cond.bits[0])
        bits = []
        for i in range(w):
            m = self.pending.add_node(FheOp.CMUX)
            self.pending.add_edge(sel, m, FheEdge.SEL)
            self.pending.add_edge(self._glwe_node(cb.bits[i]), m, FheEdge.LOW)
            self.pending.add_edge(self._glwe_node(ca.bits[i]), m, FheEdge.HIGH)
            bits.append(self._new_lazy(m))
        self.registers[instr.dst] = CtVal(bits, w)

    # --- memory ops ---

    def _exec_load(self, instr, memory: Memory):
        base = self.registers[instr.src]
        if not isinstance(base, PtVal):
            raise CpuError("encrypted load address")
        w = instr.width
        nbytes = (w + 7) // 8
        addr = (base.val + instr.offset) & 0xFFFFFFFF
        bs = memory.load_bytes(addr, nbytes)
        enc_flags = [isinstance(b, EncByte) for b in bs]
        if any(enc_flags) and not all(enc_flags):
            raise CpuError("mixed plaintext/ciphertext load")
        if not any(enc_flags):
            self._gas(GAS_PLAIN)
            val = sum(b << (8 * i) for i, b in enumerate(bs))
            self.registers[instr.dst] = PtVal(val & self._mask(w), w)
        else:
            self._gas(GAS_PLAIN)  # handle moves only
            bits = []
            for b in bs:
                bits.extend(b.bits)
            self.registers[instr.dst] = CtVal(bits[:w], w)

    def _exec_store(self, instr, memory: Memory):
        base = self.registers[instr.dst]
        if not isinstance(base, PtVal):
            raise CpuError("encrypted store address")
        v = self.registers[instr.src]
        w = instr.width
        nbytes = (w + 7) // 8
        addr = (base.val + instr.offset) & 0xFFFFFFFF
        self._gas(GAS_PLAIN)
        if isinstance(v, PtVal):
            bs = [(v.val >> (8 * i)) & 0xFF for i in range(nbytes)]
        else:
            cv = self._cast(v, nbytes * 8, "Zext")
            bs = [EncByte(cv.bits[8 * i : 8 * i + 8]) for i in range(nbytes)]
        memory.store_bytes(addr, bs)
