"""Fluent typed-integer circuit builder.

(≙ reference `parasol_runtime/src/fluent/` — `FheCircuitCtx`, `BitNode`,
`GenericInt`/`DynamicGenericInt`, `PackedGenericInt` — and
`parasol_runtime/src/circuits/{add,mul}.rs`.)

Integers are little-endian lists of graph nodes. Encrypted ints arrive
as L1 GLWE bit ciphertexts (one bit per ciphertext, coefficient 0) or
packed (N bits in one GLWE's coefficients). Arithmetic converts operand
bits through the conversion cycle to GGSW form (SampleExtract ->
Keyswitch -> CircuitBootstrap) and grafts the corresponding mux circuit.
A copy of `spf_tpu/runtime/fluent.py`.
"""

from __future__ import annotations

import dataclasses

from ..circuits import integer as int_circuits
from .fhe_circuit import CtType, FheCircuit, FheEdge, FheOp


class FheCircuitCtx:
    """Builder context holding the graph (≙ `fluent/mod.rs:50-74`)."""

    def __init__(self):
        self.circuit = FheCircuit()
        self._input_count = 0
        self._output_count = 0

    def new_input_key(self):
        self._input_count += 1
        return f"in{self._input_count - 1}"

    def new_output_key(self):
        self._output_count += 1
        return f"out{self._output_count - 1}"


@dataclasses.dataclass
class UInt:
    """An unsigned integer as GLWE-bit graph nodes, LSB-first
    (≙ `fluent/uint.rs` GenericInt<N, L1GlweCiphertext> AND
    `fluent/dynamic_generic_int.rs` DynamicGenericInt: the reference
    needs a second, runtime-width type because Rust's const generics fix
    N at compile time — Python widths are always runtime values, so one
    class covers both).

    `mode` selects the mux representation (≙ the reference's `Muxable`
    trait, `fluent/mod.rs:362-374`): "glwe" grafts CMux trees whose
    wires are GLWE ciphertexts and converts bits onward via the full
    conversion cycle (sample extract -> keyswitch -> CBS); "glev"
    grafts GlevCMux trees whose wires are GLEV ciphertexts and converts
    onward via the cheaper scheme switch (GenericInt<N,
    L1GlevCiphertext> in the reference).

    Noise caveat (inherent to the scheme, same as the reference): each
    CMux leaves a gadget-rounding residual rho (*) s of ~q/(2 B^l_cbs)
    x sqrt(N) in the wire phase, so a *cmux-produced* GLEV's deepest
    rows degrade below the q/B^l_cbs grid after one layer. Scheme
    switching such a wire into the select of a second layer is
    therefore depth-limited; the reference's GLEV tests correspondingly
    use GGSW inputs and a single circuit layer per output
    (`fluent/mod.rs:589-631` cases use GenericInt<_, L1GgswCiphertext>
    inputs). For multi-layer circuits convert selects through the L0
    conversion cycle (noise reset via CBS), i.e. use "glwe" mode."""

    bits: list  # node ids producing GLWE1 bits, or (cttype, node) tuples
    ctx: FheCircuitCtx
    signed: bool = False
    mode: str = "glwe"

    # --- construction ---

    @classmethod
    def input(
        cls, ctx: FheCircuitCtx, n: int, signed: bool = False, mode: str = "glwe"
    ) -> "UInt":
        """Declare n encrypted input bits (L1 GLWE). Input keys are
        returned in order via `input_keys`."""
        bits = []
        for _ in range(n):
            key = ctx.new_input_key()
            bits.append(ctx.circuit.add_node(FheOp.INPUT_GLWE1, key))
        return cls(bits=bits, ctx=ctx, signed=signed, mode=mode)

    @classmethod
    def packed_input(cls, ctx: FheCircuitCtx, n: int, signed: bool = False) -> "UInt":
        """Declare one packed GLWE input carrying n bits in its first n
        coefficients and unpack it via per-coefficient sample extraction
        (≙ `packed_dynamic_generic_int_graph_node.rs:24-38`)."""
        key = ctx.new_input_key()
        packed = ctx.circuit.add_node(FheOp.INPUT_GLWE1, key)
        c = ctx.circuit
        bits = []
        for i in range(n):
            ex = c.add_node(FheOp.SAMPLE_EXTRACT, i)
            c.add_edge(packed, ex, FheEdge.UNARY)
            # L1 LWE -> L0 -> GGSW -> GLWE bit would reset noise; for
            # unpacking we only need the GLWE-bit form, so convert via the
            # cycle on use. Keep the LWE1 node; arithmetic converts onward.
            bits.append(("lwe1", ex))
        return cls(bits=bits, ctx=ctx, signed=signed)

    @property
    def n(self) -> int:
        return len(self.bits)

    def input_keys(self):
        c = self.ctx.circuit
        keys = []
        for b in self.bits:
            node = b[1] if isinstance(b, tuple) else b
            if c.nodes[node].op == FheOp.INPUT_GLWE1:
                keys.append(c.nodes[node].param)
        return keys

    # --- conversions ---

    def _bit_type(self, b) -> CtType:
        if isinstance(b, tuple):
            return CtType(b[0])
        return CtType.GLWE1

    def _bit_node(self, b) -> int:
        return b[1] if isinstance(b, tuple) else b

    def _wrap_outs(self, outs: list) -> list:
        """Mux-circuit outputs are GLWE wires in glwe mode, GLEV wires
        in glev mode."""
        if self.mode == "glev":
            return [("glev1", o) for o in outs]
        return list(outs)

    def _zero_bit(self):
        c = self.ctx.circuit
        if self.mode == "glev":
            return ("glev1", c.add_node(FheOp.ZERO_GLEV1))
        return c.add_node(FheOp.ZERO_GLWE1)

    def to_ggsw(self) -> list:
        """Convert every bit to GGSW form through the conversion cycle
        (≙ `fhe_circuit.rs:473-489` insert_mux_circuit_and_connect_inputs)."""
        c = self.ctx.circuit
        out = []
        for b in self.bits:
            out.append(
                c.insert_ciphertext_conversion(
                    self._bit_node(b), self._bit_type(b), CtType.GGSW1
                )
            )
        return out

    def output(self) -> list:
        """Emit OUTPUT_GLWE1 nodes for every bit; returns output keys."""
        c = self.ctx.circuit
        keys = []
        for b in self.bits:
            glwe = c.insert_ciphertext_conversion(
                self._bit_node(b), self._bit_type(b), CtType.GLWE1
            )
            key = self.ctx.new_output_key()
            o = c.add_node(FheOp.OUTPUT_GLWE1, key)
            c.add_edge(glwe, o, FheEdge.UNARY)
            keys.append(key)
        return keys

    def pack_output(self) -> object:
        """Pack all bits into one GLWE via MulXN shifts + a GlweAdd
        reduction tree and emit it
        (≙ `dynamic_generic_int_graph_nodes.rs:139-205`)."""
        c = self.ctx.circuit
        shifted = []
        for i, b in enumerate(self.bits):
            glwe = c.insert_ciphertext_conversion(
                self._bit_node(b), self._bit_type(b), CtType.GLWE1
            )
            if i == 0:
                shifted.append(glwe)
            else:
                m = c.add_node(FheOp.MUL_XN, i)
                c.add_edge(glwe, m, FheEdge.UNARY)
                shifted.append(m)
        while len(shifted) > 1:
            nxt = []
            for j in range(0, len(shifted) - 1, 2):
                add = c.add_node(FheOp.GLWE_ADD)
                c.add_edge(shifted[j], add, FheEdge.LEFT)
                c.add_edge(shifted[j + 1], add, FheEdge.RIGHT)
                nxt.append(add)
            if len(shifted) % 2:
                nxt.append(shifted[-1])
            shifted = nxt
        key = self.ctx.new_output_key()
        o = c.add_node(FheOp.OUTPUT_GLWE1, key)
        c.add_edge(shifted[0], o, FheEdge.UNARY)
        return key

    def resize(self, new_n: int) -> "UInt":
        """Zero- or sign-extend / truncate (≙ `fluent` resize:106)."""
        if new_n <= self.n:
            return UInt(self.bits[:new_n], self.ctx, self.signed)
        c = self.ctx.circuit
        if self.signed:
            ext = [self.bits[-1]] * (new_n - self.n)
        else:
            ext = [self._zero_bit() for _ in range(new_n - self.n)]
        return UInt(list(self.bits) + ext, self.ctx, self.signed, self.mode)

    # --- arithmetic (mux-circuit grafts; ≙ `fluent/...graph_nodes.rs:250-476`) ---

    def _binary_circuit(self, other: "UInt", circuit, num_out) -> list:
        assert self.n == other.n
        ggsw = self.to_ggsw() + other.to_ggsw()
        outs = self.ctx.circuit.insert_mux_circuit(
            circuit, ggsw, glev=self.mode == "glev"
        )
        return self._wrap_outs(outs[:num_out] if num_out else outs)

    def __add__(self, other: "UInt") -> "UInt":
        outs = self._binary_circuit(
            other, int_circuits.ripple_carry_adder(self.n, emit_carry=True), self.n
        )
        return UInt(outs, self.ctx, self.signed, self.mode)

    def __sub__(self, other: "UInt") -> "UInt":
        outs = self._binary_circuit(
            other, int_circuits.full_subtractor(self.n, emit_borrow=True), self.n
        )
        return UInt(outs, self.ctx, self.signed, self.mode)

    def __mul__(self, other: "UInt") -> "UInt":
        """Full-width n x m -> n+m product (unsigned; signed handled by
        `signed_mul`). Widths above CIRCUIT_CUTOFF use gradeschool
        decomposition (≙ `mul.rs:259-312`, `circuits/mul.rs:18-76`)."""
        if max(self.n, other.n) <= int_circuits.CIRCUIT_CUTOFF:
            ggsw = self.to_ggsw() + other.to_ggsw()
            outs = self.ctx.circuit.insert_mux_circuit(
                int_circuits.unsigned_multiplier(self.n, other.n),
                ggsw,
                glev=self.mode == "glev",
            )
            return UInt(self._wrap_outs(outs), self.ctx, False, self.mode)
        return self._gradeschool_mul(other)

    def _ggsw_of(self, b) -> int:
        return self.ctx.circuit.insert_ciphertext_conversion(
            self._bit_node(b), self._bit_type(b), CtType.GGSW1
        )

    def _gradeschool_mul(self, other: "UInt") -> "UInt":
        outs = self._mul_bits(list(self.bits), list(other.bits))
        return UInt(outs, self.ctx, False, self.mode)

    def _mul_bits(self, a: list, b: list) -> list:
        """Recursive gradeschool product over bit-handle lists, mirroring
        the reference's three cases (`circuits/mul.rs:89-195` mul_impl):
        base multiplier block; single-split add when only the longer
        operand partitions; 4 partial products + the column-compressor
        reduction circuit otherwise."""
        if len(a) < len(b):
            a, b = b, a
        n, m = len(a), len(b)
        a_lo_n, a_hi_n = int_circuits.partition_integer(n)
        b_lo_n, b_hi_n = int_circuits.partition_integer(m)
        c = self.ctx.circuit
        glev = self.mode == "glev"
        if a_hi_n == 0 and b_hi_n == 0:
            ggsw = [self._ggsw_of(x) for x in a + b]
            outs = c.insert_mux_circuit(
                int_circuits.unsigned_multiplier(n, m), ggsw, glev=glev
            )
            return self._wrap_outs(outs)
        if b_hi_n == 0:
            # b * a_lo + ((b * a_hi) << a_lo_n)  (`circuits/mul.rs:117-150`)
            ll = self._mul_bits(a[:a_lo_n], b)  # a_lo + m bits
            hl = self._mul_bits(a[a_lo_n:], b)  # a_hi + m bits
            lo, hi = ll[:a_lo_n], ll[a_lo_n:]  # hi: m bits
            inter = []
            for x, y in zip(hi, hl):
                inter += [x, y]
            inter += hl[len(hi):]
            ggsw = [self._ggsw_of(x) for x in inter]
            adder = int_circuits.mixed_width_adder(len(hi), len(hl))
            outs = c.insert_mux_circuit(adder, ggsw, glev=glev)
            # the product fits in n+m bits: the adder's top carry is 0
            return list(lo) + self._wrap_outs(outs[: n + m - a_lo_n])
        # both operands split: 4 partials + reduction (`mul.rs:152-194`)
        ll = self._mul_bits(a[:a_lo_n], b[:b_lo_n])
        hl = self._mul_bits(a[a_lo_n:], b[:b_lo_n])
        lh = self._mul_bits(a[:a_lo_n], b[b_lo_n:])
        hh = self._mul_bits(a[a_lo_n:], b[b_lo_n:])
        enc = int_circuits.encode_gradeschool_reduction(n, m, ll, hl, lh, hh)
        ggsw = [self._ggsw_of(x) for x in enc]
        outs = c.insert_mux_circuit(
            int_circuits.gradeschool_reduce(n, m), ggsw, glev=glev
        )
        return self._wrap_outs(outs)

    def _cmp(self, other: "UInt", circuit) -> "UInt":
        outs = self._binary_circuit(other, circuit, 1)
        return UInt(outs, self.ctx, mode=self.mode)

    def eq(self, other):
        return self._cmp(other, int_circuits.compare_equal(self.n))

    def neq(self, other):
        return self._cmp(other, int_circuits.compare_not_equal(self.n))

    def gt(self, other):
        return self._cmp(
            other, int_circuits.compare_or_maybe_equal(self.n, False, self.signed)
        )

    def ge(self, other):
        return self._cmp(
            other, int_circuits.compare_or_maybe_equal(self.n, True, self.signed)
        )

    def lt(self, other):
        return other.gt(self)

    def le(self, other):
        return other.ge(self)

    def __and__(self, other):
        return UInt(
            self._binary_circuit(other, int_circuits.bitwise_and(self.n), self.n),
            self.ctx,
            self.signed,
            self.mode,
        )

    def __or__(self, other):
        return UInt(
            self._binary_circuit(other, int_circuits.bitwise_or(self.n), self.n),
            self.ctx,
            self.signed,
            self.mode,
        )

    def __xor__(self, other):
        return UInt(
            self._binary_circuit(other, int_circuits.bitwise_xor(self.n), self.n),
            self.ctx,
            self.signed,
            self.mode,
        )

    def __neg__(self):
        ggsw = self.to_ggsw()
        outs = self.ctx.circuit.insert_mux_circuit(
            int_circuits.negate(self.n), ggsw, glev=self.mode == "glev"
        )
        return UInt(self._wrap_outs(outs), self.ctx, self.signed, self.mode)

    def shift(self, amount: "UInt", direction: str, mode: str) -> "UInt":
        """Barrel shift by an encrypted amount (≙ `bitshift.rs`)."""
        ggsw = self.to_ggsw() + amount.to_ggsw()
        outs = self.ctx.circuit.insert_mux_circuit(
            int_circuits.bitshift(self.n, amount.n, direction, mode),
            ggsw,
            glev=self.mode == "glev",
        )
        return UInt(self._wrap_outs(outs), self.ctx, self.signed, self.mode)

    def popcount(self) -> "UInt":
        """Number of set bits (≙ hamming-distance building block)."""
        ggsw = self.to_ggsw()
        outs = self.ctx.circuit.insert_mux_circuit(
            int_circuits.popcount(self.n), ggsw, glev=self.mode == "glev"
        )
        return UInt(self._wrap_outs(outs), self.ctx, mode=self.mode)

    def select(self, cond: "UInt", other: "UInt") -> "UInt":
        """cond ? self : other, bitwise CMux (≙ `bit.rs:97` select)."""
        assert cond.n == 1
        c = self.ctx.circuit
        sel = cond.to_ggsw()[0]
        outs = []
        for i in range(self.n):
            hi = c.insert_ciphertext_conversion(
                self._bit_node(self.bits[i]), self._bit_type(self.bits[i]), CtType.GLWE1
            )
            lo = c.insert_ciphertext_conversion(
                other._bit_node(other.bits[i]),
                other._bit_type(other.bits[i]),
                CtType.GLWE1,
            )
            m = c.add_node(FheOp.CMUX)
            c.add_edge(sel, m, FheEdge.SEL)
            c.add_edge(lo, m, FheEdge.LOW)
            c.add_edge(hi, m, FheEdge.HIGH)
            outs.append(m)
        return UInt(outs, self.ctx, self.signed)

    def as_mode(self, mode: str) -> "UInt":
        """Reinterpret with a different Muxable mode for downstream ops
        (wires convert lazily through the conversion cycle on use)."""
        return UInt(list(self.bits), self.ctx, self.signed, mode)


class Int(UInt):
    """Signed two's-complement integer (`fluent/int.rs` type aliases)."""

    def __init__(self, bits, ctx, signed=True):
        super().__init__(bits=bits, ctx=ctx, signed=True)


def _make_alias(n, signed):
    def factory(ctx: FheCircuitCtx):
        return UInt.input(ctx, n, signed)

    factory.__name__ = ("Int" if signed else "UInt") + str(n)
    factory.__doc__ = f"Declare a {factory.__name__} input (≙ `fluent/uint.rs:69-114`)."
    return factory


# width aliases (≙ reference UInt8..UInt256 / Int8..Int256)
UInt8 = _make_alias(8, False)
UInt16 = _make_alias(16, False)
UInt32 = _make_alias(32, False)
UInt64 = _make_alias(64, False)
UInt128 = _make_alias(128, False)
UInt256 = _make_alias(256, False)
Int8 = _make_alias(8, True)
Int16 = _make_alias(16, True)
Int32 = _make_alias(32, True)
Int64 = _make_alias(64, True)
Int128 = _make_alias(128, True)
Int256 = _make_alias(256, True)
