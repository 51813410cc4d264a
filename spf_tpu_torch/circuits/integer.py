"""Integer circuit generators: adders, subtractors, multipliers,
comparisons, shifts, bitwise trees.

(≙ reference `mux_circuits/src/{add,sub,mul,comparisons,bitshift,and,or,
neg}.rs`.)

All circuits are built as BDDs (with FHE-friendly variable interleaving
so carry chains stay linear) and converted to mux DAGs. Public input
layout is uniform: `[a_0..a_{n-1}] ++ [b_0..b_{m-1}] ++ [extras]`,
all LSB-first. Outputs are LSB-first.
"""

from __future__ import annotations

from .bdd import BddManager
from .mux import MuxCircuit, cached_circuit


def _interleaved_pair_vars(n: int, extras: int = 0):
    """BDD vars interleaved (a_i at 2i, b_i at 2i+1, extras at the end);
    input_map produces the public a-then-b layout."""
    mgr = BddManager(2 * n + extras)
    a = [mgr.var(2 * i) for i in range(n)]
    b = [mgr.var(2 * i + 1) for i in range(n)]
    ex = [mgr.var(2 * n + i) for i in range(extras)]
    input_map = [0] * (2 * n + extras)
    for i in range(n):
        input_map[2 * i] = i
        input_map[2 * i + 1] = n + i
    for i in range(extras):
        input_map[2 * n + i] = 2 * n + i
    return mgr, a, b, ex, input_map


def ripple_carry_adder(n: int, carry_in: bool = False, emit_carry: bool = True) -> MuxCircuit:
    """n-bit + n-bit adder; outputs n sum bits (+ carry out)
    (≙ `add.rs:13`)."""
    mgr, a, b, ex, imap = _interleaved_pair_vars(n, 1 if carry_in else 0)
    c = ex[0] if carry_in else mgr.FALSE
    sums = []
    for i in range(n):
        axb = mgr.xor(a[i], b[i])
        sums.append(mgr.xor(axb, c))
        c = mgr.or_(mgr.and_(axb, c), mgr.and_(a[i], b[i]))
    outs = sums + ([c] if emit_carry else [])
    return MuxCircuit.from_bdds(mgr, outs, imap)


def full_subtractor(n: int, borrow_in: bool = False, emit_borrow: bool = True) -> MuxCircuit:
    """n-bit - n-bit subtractor; outputs n difference bits (+ borrow out)
    (≙ `sub.rs:12`)."""
    mgr, a, b, ex, imap = _interleaved_pair_vars(n, 1 if borrow_in else 0)
    bw = ex[0] if borrow_in else mgr.FALSE
    diffs = []
    for i in range(n):
        axb = mgr.xor(a[i], b[i])
        diffs.append(mgr.xor(axb, bw))
        # borrow = ~a&b | bw&~(a^b)
        bw = mgr.or_(mgr.and_(mgr.not_(a[i]), b[i]), mgr.and_(bw, mgr.not_(axb)))
    outs = diffs + ([bw] if emit_borrow else [])
    return MuxCircuit.from_bdds(mgr, outs, imap)


def _multiplier_impl(n: int, m: int) -> MuxCircuit:
    """Burch-style array multiplier: each cell's partial product uses
    *duplicated* variables so every BDD stays tiny; duplicates are then
    remapped onto the n+m real inputs (≙ `mul.rs:30-147`,
    "Using BDDs to Verify Multipliers", J. Burch)."""
    mgr = BddManager(2 * n * m)
    # Variable order: cells along anti-diagonals, highest diagonal first
    # (the "efficient high-to-low ordering" giving O(n^3) mux trees,
    # `mul.rs:143-180` mul_bdd_encode/decode).
    cell_order = []
    start_row, start_col = m - 1, n - 1
    while True:
        j = 0
        while j <= start_col and start_row + j < m:
            cell_order.append((start_row + j, start_col - j))
            j += 1
        if start_row > 0:
            start_row -= 1
        elif start_col > 0:
            start_col -= 1
        else:
            break
    var_of_cell = {cell: 2 * k for k, cell in enumerate(cell_order)}
    # cell (row i, col j): x copy of a_j, y copy of b_i
    x = [[mgr.var(var_of_cell[(i, j)]) for j in range(n)] for i in range(m)]
    y = [[mgr.var(var_of_cell[(i, j)] + 1) for j in range(n)] for i in range(m)]
    ands = [[mgr.and_(x[i][j], y[i][j]) for j in range(n)] for i in range(m)]

    sums = [[mgr.FALSE] * n for _ in range(m)]
    carries = [[mgr.FALSE] * n for _ in range(m)]
    sums[0] = list(ands[0])

    for i in range(1, m):
        for j in range(n):
            aa = ands[i][j]
            bb = sums[i - 1][j + 1] if j < n - 1 else carries[i - 1][j]
            cin = carries[i][j - 1] if j > 0 else mgr.FALSE
            axb = mgr.xor(aa, bb)
            sums[i][j] = mgr.xor(axb, cin)
            carries[i][j] = mgr.or_(mgr.and_(axb, cin), mgr.and_(bb, aa))

    outs = [sums[i][0] for i in range(m)]
    outs += [sums[m - 1][i] for i in range(1, n)]
    outs.append(carries[m - 1][n - 1])

    input_map = [0] * (2 * n * m)
    for (i, j), v in var_of_cell.items():
        input_map[v] = j  # a_j
        input_map[v + 1] = n + i  # b_i
    return MuxCircuit.from_bdds(mgr, outs, input_map)


def unsigned_multiplier(n: int, m: int) -> MuxCircuit:
    """n x m -> n+m bit unsigned multiplier, disk-cached for common
    sizes (≙ `mul.rs:62-69`; the reference ships n8/n16/n32 blobs in
    `mux_circuits/src/data/`). Widths above CIRCUIT_CUTOFF should be
    composed via gradeschool partitioning (`mul.rs:264`
    partition_integer), not built as one BDD."""
    if n == m and n in (8, 16, 32):
        return cached_circuit(f"multiplier-n{n}-m{m}", lambda: _multiplier_impl(n, m))
    return _multiplier_impl(n, m)


# The cutoff above which multiplies are decomposed gradeschool-style
# (≙ `mul.rs:254` CIRCUIT_CUTOFF).
CIRCUIT_CUTOFF = 16


def partition_integer(n: int) -> tuple:
    """Split an n-bit integer into (lower, upper) word sizes for
    recursive multiplication (≙ `mul.rs:259-272`)."""
    if n <= CIRCUIT_CUTOFF:
        return (n, 0)
    upper = n // 2
    lower = n - upper
    return (lower, upper)


def mixed_width_adder(n: int, m: int) -> MuxCircuit:
    """Ripple adder between an n-bit and an m-bit integer, producing
    max(n, m) + 1 bits (top bit = carry out). Input layout matches the
    reference (`add.rs:13-56`): a and b interleaved until the shorter
    operand is exhausted, then the remaining bits of the longer one."""
    assert n > 0 and m > 0
    lo, hi = min(n, m), max(n, m)
    mgr = BddManager(n + m)
    carry = mgr.FALSE
    outs = []
    for i in range(lo):
        a, b = mgr.var(2 * i), mgr.var(2 * i + 1)
        axb = mgr.xor(a, b)
        outs.append(mgr.xor(axb, carry))
        carry = mgr.or_(mgr.and_(axb, carry), mgr.and_(a, b))
    for i in range(hi - lo):
        a = mgr.var(2 * lo + i)
        outs.append(mgr.xor(a, carry))
        carry = mgr.and_(a, carry)
    outs.append(carry)
    return MuxCircuit.from_bdds(mgr, outs)


def _partial_product_windows(n: int, m: int) -> list:
    """Column spans [start, end) of the 4 gradeschool partial products
    x = a_hi<<a_lo | a_lo, y = b_hi<<b_lo | b_lo, in the per-column
    emission order of `mul.rs:308-386`: ll, hl, lh, hh."""
    a_lo, a_hi = partition_integer(n)
    b_lo, b_hi = partition_integer(m)
    return [
        (0, a_lo + b_lo),  # a_lo * b_lo
        (a_lo, a_lo + a_hi + b_lo),  # a_hi * b_lo << a_lo
        (b_lo, b_lo + a_lo + b_hi),  # a_lo * b_hi << b_lo
        (a_lo + b_lo, n + m),  # a_hi * b_hi << (a_lo + b_lo)
    ]


def encode_gradeschool_reduction(
    n: int, m: int, a_lo_b_lo, a_hi_b_lo, a_lo_b_hi, a_hi_b_hi
) -> list:
    """Interleave the 4 partial-product bit lists column-major (LSB
    column first) for `gradeschool_reduce` (≙ `mul.rs:286-386`; the
    six explicit sections there are exactly this coverage walk).
    Element type is arbitrary (ints for tests, graph node ids in the
    fluent layer)."""
    assert n >= m
    windows = _partial_product_windows(n, m)
    parts = [a_lo_b_lo, a_hi_b_lo, a_lo_b_hi, a_hi_b_hi]
    for p, (s, e) in zip(parts, windows):
        assert len(p) == e - s, (len(p), s, e)
    out = []
    for j in range(n + m):
        for p, (s, e) in zip(parts, windows):
            if s <= j < e:
                out.append(p[j - s])
    return out


def _count_ones(mgr, bits: list) -> list:
    """Binary counter of a list of BDD bits via carry-save full/half
    adders; returns LSB-first count bits (no trailing zeros)."""
    levels = [list(bits)]
    d = 0
    out = []
    while d < len(levels):
        lev = levels[d]
        while len(lev) >= 2:
            if len(lev) >= 3:
                a, b, c = lev.pop(), lev.pop(), lev.pop()
                axb = mgr.xor(a, b)
                s = mgr.xor(axb, c)
                carry = mgr.or_(mgr.and_(axb, c), mgr.and_(a, b))
            else:
                a, b = lev.pop(), lev.pop()
                s = mgr.xor(a, b)
                carry = mgr.and_(a, b)
            lev.append(s)
            if d + 1 == len(levels):
                levels.append([])
            levels[d + 1].append(carry)
        out.append(lev[0] if lev else mgr.FALSE)
        d += 1
    while out and out[-1] == mgr.FALSE:
        out.pop()
    return out


def _gradeschool_reduce_impl(n: int, m: int) -> MuxCircuit:
    """4-way column-compressor sum of the gradeschool partial products
    (≙ `mul.rs:428-585` gradeschool_reduce_impl; that code tracks the
    per-section carry budget by hand — here a generic binary counter per
    column produces the identical function). Input layout is the
    `encode_gradeschool_reduction` order; output is the n+m-bit
    product."""
    assert n >= m
    windows = _partial_product_windows(n, m)
    mgr = BddManager(2 * (n + m))
    v = 0
    outs = []
    carries: dict[int, list] = {}
    for j in range(n + m):
        bits = []
        for s, e in windows:
            if s <= j < e:
                bits.append(mgr.var(v))
                v += 1
        bits.extend(carries.pop(j, []))
        cnt = _count_ones(mgr, bits)
        outs.append(cnt[0] if cnt else mgr.FALSE)
        for d in range(1, len(cnt)):
            if j + d < n + m:  # the product fits in n+m bits
                carries.setdefault(j + d, []).append(cnt[d])
    assert v == 2 * (n + m)
    return MuxCircuit.from_bdds(mgr, outs)


def gradeschool_reduce(n: int, m: int) -> MuxCircuit:
    """Disk-cached gradeschool reduction (≙ `mul.rs:391-398`; the
    reference ships `gradeschool-reduction-n64-m64`)."""
    if (n, m) == (64, 64):
        return cached_circuit(
            "gradeschool-reduction-n64-m64", lambda: _gradeschool_reduce_impl(n, m)
        )
    return _gradeschool_reduce_impl(n, m)


def compare_equal(n: int) -> MuxCircuit:
    """a == b (≙ `comparisons.rs:19`)."""
    mgr, a, b, _, imap = _interleaved_pair_vars(n)
    eq = mgr.TRUE
    for i in range(n):
        eq = mgr.and_(eq, mgr.xnor(a[i], b[i]))
    return MuxCircuit.from_bdds(mgr, [eq], imap)


def compare_not_equal(n: int) -> MuxCircuit:
    """a != b (≙ `comparisons.rs:46`)."""
    mgr, a, b, _, imap = _interleaved_pair_vars(n)
    eq = mgr.TRUE
    for i in range(n):
        eq = mgr.and_(eq, mgr.xnor(a[i], b[i]))
    return MuxCircuit.from_bdds(mgr, [mgr.not_(eq)], imap)


def compare_or_maybe_equal(n: int, or_equal: bool, signed: bool) -> MuxCircuit:
    """a > b (or >=), unsigned or signed two's complement
    (≙ `comparisons.rs:79,127`). Single output bit."""
    mgr, a, b, _, imap = _interleaved_pair_vars(n)
    # LSB-up recurrence: gt_i = a_i & ~b_i | (a_i==b_i) & gt_{i-1}
    gt = mgr.TRUE if or_equal else mgr.FALSE
    for i in range(n):
        a_i, b_i = a[i], b[i]
        if signed and i == n - 1:
            # sign bit: a positive (0) and b negative (1) means a > b
            win = mgr.and_(mgr.not_(a_i), b_i)
        else:
            win = mgr.and_(a_i, mgr.not_(b_i))
        gt = mgr.or_(win, mgr.and_(mgr.xnor(a_i, b_i), gt))
    return MuxCircuit.from_bdds(mgr, [gt], imap)


LOGICAL = "logical"
ARITHMETIC = "arithmetic"
ROTATE = "rotate"
LEFT = "left"
RIGHT = "right"


def bitshift(n: int, shift_bits: int, direction: str, mode: str) -> MuxCircuit:
    """Barrel shifter over an encrypted shift amount
    (≙ `bitshift.rs:18-49`).

    Inputs: n data bits (LSB-first) then `shift_bits` shift-amount bits
    (LSB-first). Outputs: n shifted bits. Modes: logical (zero fill),
    arithmetic (sign fill, right only), rotate.
    """
    assert direction in (LEFT, RIGHT)
    assert mode in (LOGICAL, ARITHMETIC, ROTATE)
    # shift variables first so each output BDD is a tree over the shift
    # amount with data variables at the leaves
    mgr = BddManager(shift_bits + n)
    s = [mgr.var(i) for i in range(shift_bits)]
    d = [mgr.var(shift_bits + i) for i in range(n)]

    def source(out_idx: int, amount: int) -> int:
        if direction == LEFT:
            src = out_idx - amount
        else:
            src = out_idx + amount
        if mode == ROTATE:
            return d[src % n]
        if 0 <= src < n:
            return d[src]
        if mode == ARITHMETIC and direction == RIGHT:
            return d[n - 1]
        return mgr.FALSE

    outs = []
    for j in range(n):
        # mux tree over shift bits, MSB at the top
        def build(bit: int, amount: int) -> int:
            if bit < 0:
                return source(j, amount)
            return mgr.ite(
                s[bit], build(bit - 1, amount + (1 << bit)), build(bit - 1, amount)
            )

        outs.append(build(shift_bits - 1, 0))

    input_map = list(range(n, n + shift_bits)) + list(range(n))
    return MuxCircuit.from_bdds(mgr, outs, input_map)


def and_tree(n: int) -> MuxCircuit:
    """AND reduction of n inputs (≙ `and.rs:6`)."""
    mgr = BddManager(n)
    acc = mgr.TRUE
    for i in range(n):
        acc = mgr.and_(acc, mgr.var(i))
    return MuxCircuit.from_bdds(mgr, [acc])


def or_tree(n: int) -> MuxCircuit:
    """OR reduction of n inputs (≙ `or.rs:6`)."""
    mgr = BddManager(n)
    acc = mgr.FALSE
    for i in range(n):
        acc = mgr.or_(acc, mgr.var(i))
    return MuxCircuit.from_bdds(mgr, [acc])


def negate(n: int) -> MuxCircuit:
    """Two's complement negation: ~a + 1 (≙ `neg.rs`). Single operand of
    n bits; outputs n bits."""
    mgr = BddManager(n)
    a = [mgr.var(i) for i in range(n)]
    c = mgr.TRUE  # +1 carry into the inverted bits
    outs = []
    for i in range(n):
        na = mgr.not_(a[i])
        outs.append(mgr.xor(na, c))
        c = mgr.and_(na, c)
    return MuxCircuit.from_bdds(mgr, outs)


def bitwise_and(n: int) -> MuxCircuit:
    """Elementwise a & b over n-bit operands."""
    mgr, a, b, _, imap = _interleaved_pair_vars(n)
    outs = [mgr.and_(a[i], b[i]) for i in range(n)]
    return MuxCircuit.from_bdds(mgr, outs, imap)


def bitwise_or(n: int) -> MuxCircuit:
    mgr, a, b, _, imap = _interleaved_pair_vars(n)
    outs = [mgr.or_(a[i], b[i]) for i in range(n)]
    return MuxCircuit.from_bdds(mgr, outs, imap)


def bitwise_xor(n: int) -> MuxCircuit:
    mgr, a, b, _, imap = _interleaved_pair_vars(n)
    outs = [mgr.xor(a[i], b[i]) for i in range(n)]
    return MuxCircuit.from_bdds(mgr, outs, imap)


def popcount(n: int) -> MuxCircuit:
    """Population count of n input bits -> ceil(log2(n+1)) output bits
    (used by hamming-distance style programs)."""
    mgr = BddManager(n)
    out_w = (n).bit_length()
    # BDD integer accumulator: list of output-bit BDDs, add 1 per input
    acc = [mgr.FALSE] * out_w
    for i in range(n):
        carry = mgr.var(i)
        for j in range(out_w):
            s = mgr.xor(acc[j], carry)
            carry = mgr.and_(acc[j], carry)
            acc[j] = s
    return MuxCircuit.from_bdds(mgr, acc)


def convert_value_to_bits(value: int, n: int) -> list:
    """LSB-first bit list of `value` (≙ `util.rs` convert_value_to_bits)."""
    return [(value >> i) & 1 for i in range(n)]
