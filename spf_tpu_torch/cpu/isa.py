"""The Parasol ISA: 8-byte fixed-width instructions, 37 opcodes.

Bit-exact encode/decode per the reference's `define_op!` expansion
(`parasol_cpu/src/proc/assembly.rs:359-474`): opcode in bits [0, 8),
then destination registers (6 bits each), source registers, meta
fields, cmeta fields, LSB-first. The width cmeta is 7 bits with 0
encoding 128; offsets are 32-bit two's complement.

Opcodes CODESYNC with Parasol-clang's ParasolInstrFormats.td.

A copy of `spf_tpu/cpu/isa.py`: the same opcodes, fields and words.
"""

from __future__ import annotations

import dataclasses

REG_BITS = 6  # 64 registers
INSTRUCTION_SIZE = 8

# field kinds: "dreg" (dst register), "sreg" (src register),
# ("meta", width), ("width", 7), ("offset", 32)
ISA = {
    "Store": (0x01, [("sreg", "dst"), ("sreg", "src"), ("width", "width"), ("offset", "offset")]),
    "Load": (0x09, [("dreg", "dst"), ("sreg", "src"), ("width", "width"), ("offset", "offset")]),
    "LoadI": (0x0A, [("dreg", "dst"), ("meta32", "imm"), ("width", "width")]),
    "Trunc": (0x11, [("dreg", "dst"), ("sreg", "src"), ("width", "width")]),
    "Zext": (0x15, [("dreg", "dst"), ("sreg", "src"), ("width", "width")]),
    "Sext": (0x16, [("dreg", "dst"), ("sreg", "src"), ("width", "width")]),
    "Move": (0x21, [("dreg", "dst"), ("sreg", "src")]),
    "Not": (0x31, [("dreg", "dst"), ("sreg", "src")]),
    "And": (0x32, [("dreg", "dst"), ("sreg", "a"), ("sreg", "b")]),
    "Or": (0x33, [("dreg", "dst"), ("sreg", "a"), ("sreg", "b")]),
    "Xor": (0x34, [("dreg", "dst"), ("sreg", "a"), ("sreg", "b")]),
    "Add": (0x41, [("dreg", "dst"), ("sreg", "a"), ("sreg", "b")]),
    "AddC": (0x42, [("dreg", "dst"), ("dreg", "carry_out"), ("sreg", "a"), ("sreg", "b"), ("sreg", "carry_in")]),
    "Sub": (0x45, [("dreg", "dst"), ("sreg", "a"), ("sreg", "b")]),
    "SubB": (0x46, [("dreg", "dst"), ("dreg", "borrow_out"), ("sreg", "a"), ("sreg", "b"), ("sreg", "borrow_in")]),
    "Neg": (0x49, [("dreg", "dst"), ("sreg", "src")]),
    "Mul": (0x51, [("dreg", "dst"), ("sreg", "a"), ("sreg", "b")]),
    "Rotl": (0x81, [("dreg", "dst"), ("sreg", "src"), ("sreg", "shift")]),
    "Rotr": (0x82, [("dreg", "dst"), ("sreg", "src"), ("sreg", "shift")]),
    "Shl": (0x85, [("dreg", "dst"), ("sreg", "src"), ("sreg", "shift")]),
    "Shr": (0x86, [("dreg", "dst"), ("sreg", "src"), ("sreg", "shift")]),
    "Shra": (0x87, [("dreg", "dst"), ("sreg", "src"), ("sreg", "shift")]),
    "CmpEq": (0x91, [("dreg", "dst"), ("sreg", "a"), ("sreg", "b")]),
    "CmpGt": (0x95, [("dreg", "dst"), ("sreg", "a"), ("sreg", "b")]),
    "CmpGtS": (0x96, [("dreg", "dst"), ("sreg", "a"), ("sreg", "b")]),
    "CmpGe": (0x97, [("dreg", "dst"), ("sreg", "a"), ("sreg", "b")]),
    "CmpGeS": (0x98, [("dreg", "dst"), ("sreg", "a"), ("sreg", "b")]),
    "CmpLt": (0x99, [("dreg", "dst"), ("sreg", "a"), ("sreg", "b")]),
    "CmpLtS": (0x9A, [("dreg", "dst"), ("sreg", "a"), ("sreg", "b")]),
    "CmpLe": (0x9B, [("dreg", "dst"), ("sreg", "a"), ("sreg", "b")]),
    "CmpLeS": (0x9C, [("dreg", "dst"), ("sreg", "a"), ("sreg", "b")]),
    "BranchNonZero": (0xB1, [("sreg", "cond"), ("meta32", "pc_offset")]),
    "BranchZero": (0xB2, [("sreg", "cond"), ("meta32", "pc_offset")]),
    "Branch": (0xB5, [("meta32", "pc_offset")]),
    "Ret": (0xBA, []),
    "Cmux": (0xC1, [("dreg", "dst"), ("sreg", "cond"), ("sreg", "a"), ("sreg", "b")]),
    "Dbg": (0xF0, [("sreg", "src"), ("meta32", "handler_id")]),
}

_BY_OPCODE = {op: (name, fields) for name, (op, fields) in ISA.items()}


class IsaError(Exception):
    pass


@dataclasses.dataclass
class Instr:
    name: str
    operands: dict

    def __getattr__(self, key):
        try:
            return self.operands[key]
        except KeyError:
            raise AttributeError(key)


def _width_enc(w: int) -> int:
    assert 0 < w <= 128, w
    return 0 if w == 128 else w


def _width_dec(w: int) -> int:
    assert 0 <= w < 128, w
    return 128 if w == 0 else w


def encode(instr: Instr) -> int:
    opcode, fields = ISA[instr.name]
    value = opcode
    shift = 8
    for kind, fname in fields:
        v = instr.operands[fname]
        if kind in ("dreg", "sreg"):
            assert 0 <= v < 64, f"register {v} out of range"
            value |= v << shift
            shift += REG_BITS
        elif kind == "meta32":
            value |= (v & 0xFFFFFFFF) << shift
            shift += 32
        elif kind == "width":
            value |= _width_enc(v) << shift
            shift += 7
        elif kind == "offset":
            value |= (v & 0xFFFFFFFF) << shift
            shift += 32
    assert shift <= 64, f"{instr.name} overflows 64 bits"
    return value


def decode(word: int) -> Instr:
    opcode = word & 0xFF
    if opcode not in _BY_OPCODE:
        raise IsaError(f"unknown opcode 0x{opcode:02x}")
    name, fields = _BY_OPCODE[opcode]
    value = word >> 8
    operands = {}
    for kind, fname in fields:
        if kind in ("dreg", "sreg"):
            operands[fname] = value & 0x3F
            value >>= REG_BITS
        elif kind == "meta32":
            v = value & 0xFFFFFFFF
            operands[fname] = v - (1 << 32) if v >= (1 << 31) else v
            value >>= 32
        elif kind == "width":
            operands[fname] = _width_dec(value & 0x7F)
            value >>= 7
        elif kind == "offset":
            v = value & 0xFFFFFFFF
            operands[fname] = v - (1 << 32) if v >= (1 << 31) else v
            value >>= 32
    return Instr(name, operands)


class Asm:
    """Assembler convenience: `Asm().add(0, 1, 2).ret().instrs`
    (the analog of hand-assembling `IsaOp` enums in reference tests)."""

    def __init__(self):
        self.instrs: list[Instr] = []

    def _emit(self, name, **operands):
        self.instrs.append(Instr(name, operands))
        return self

    def load(self, dst, src, width, offset=0):
        return self._emit("Load", dst=dst, src=src, width=width, offset=offset)

    def store(self, dst, src, width, offset=0):
        return self._emit("Store", dst=dst, src=src, width=width, offset=offset)

    def loadi(self, dst, imm, width):
        return self._emit("LoadI", dst=dst, imm=imm, width=width)

    def trunc(self, dst, src, width):
        return self._emit("Trunc", dst=dst, src=src, width=width)

    def zext(self, dst, src, width):
        return self._emit("Zext", dst=dst, src=src, width=width)

    def sext(self, dst, src, width):
        return self._emit("Sext", dst=dst, src=src, width=width)

    def move(self, dst, src):
        return self._emit("Move", dst=dst, src=src)

    def not_(self, dst, src):
        return self._emit("Not", dst=dst, src=src)

    def and_(self, dst, a, b):
        return self._emit("And", dst=dst, a=a, b=b)

    def or_(self, dst, a, b):
        return self._emit("Or", dst=dst, a=a, b=b)

    def xor(self, dst, a, b):
        return self._emit("Xor", dst=dst, a=a, b=b)

    def add(self, dst, a, b):
        return self._emit("Add", dst=dst, a=a, b=b)

    def addc(self, dst, carry_out, a, b, carry_in):
        return self._emit("AddC", dst=dst, carry_out=carry_out, a=a, b=b, carry_in=carry_in)

    def sub(self, dst, a, b):
        return self._emit("Sub", dst=dst, a=a, b=b)

    def subb(self, dst, borrow_out, a, b, borrow_in):
        return self._emit("SubB", dst=dst, borrow_out=borrow_out, a=a, b=b, borrow_in=borrow_in)

    def neg(self, dst, src):
        return self._emit("Neg", dst=dst, src=src)

    def mul(self, dst, a, b):
        return self._emit("Mul", dst=dst, a=a, b=b)

    def rotl(self, dst, src, shift):
        return self._emit("Rotl", dst=dst, src=src, shift=shift)

    def rotr(self, dst, src, shift):
        return self._emit("Rotr", dst=dst, src=src, shift=shift)

    def shl(self, dst, src, shift):
        return self._emit("Shl", dst=dst, src=src, shift=shift)

    def shr(self, dst, src, shift):
        return self._emit("Shr", dst=dst, src=src, shift=shift)

    def shra(self, dst, src, shift):
        return self._emit("Shra", dst=dst, src=src, shift=shift)

    def cmp_eq(self, dst, a, b):
        return self._emit("CmpEq", dst=dst, a=a, b=b)

    def cmp_gt(self, dst, a, b):
        return self._emit("CmpGt", dst=dst, a=a, b=b)

    def cmp_gt_s(self, dst, a, b):
        return self._emit("CmpGtS", dst=dst, a=a, b=b)

    def cmp_ge(self, dst, a, b):
        return self._emit("CmpGe", dst=dst, a=a, b=b)

    def cmp_ge_s(self, dst, a, b):
        return self._emit("CmpGeS", dst=dst, a=a, b=b)

    def cmp_lt(self, dst, a, b):
        return self._emit("CmpLt", dst=dst, a=a, b=b)

    def cmp_lt_s(self, dst, a, b):
        return self._emit("CmpLtS", dst=dst, a=a, b=b)

    def cmp_le(self, dst, a, b):
        return self._emit("CmpLe", dst=dst, a=a, b=b)

    def cmp_le_s(self, dst, a, b):
        return self._emit("CmpLeS", dst=dst, a=a, b=b)

    def branch_nonzero(self, cond, pc_offset):
        return self._emit("BranchNonZero", cond=cond, pc_offset=pc_offset)

    def branch_zero(self, cond, pc_offset):
        return self._emit("BranchZero", cond=cond, pc_offset=pc_offset)

    def branch(self, pc_offset):
        return self._emit("Branch", pc_offset=pc_offset)

    def ret(self):
        return self._emit("Ret")

    def cmux(self, dst, cond, a, b):
        return self._emit("Cmux", dst=dst, cond=cond, a=a, b=b)

    def dbg(self, src, handler_id):
        return self._emit("Dbg", src=src, handler_id=handler_id)


# register aliases (≙ `assembly.rs:484-499`)
SP = 2
T0, T1, T2 = 5, 6, 7
FP = 8
RP = 10  # return value pointer (A0)
T3, T4, T5, T6 = 28, 29, 30, 31
