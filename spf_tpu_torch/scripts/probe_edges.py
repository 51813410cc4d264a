"""The edge shapes of the probe kernels `roll` and `fma_probe`
(`csrc/probe.cu`) and `phase_minus_one` (`csrc/phase.cu`), held bit for
bit on a CUDA card against their plain versions.

`roll` carries the roll in its index: a thread reads x[(r − iters·shift)
mod rows, c] once for each of its ROLL_CHAINS elements and runs their
`iters` adds interleaved, ROLL_UNROLL a loop iteration. The shapes a
tiled design can break (ROLL_CASES): rows not a multiple of 8, columns
not a multiple of 4, a size that no block's element count divides, shift
0, rows − 1 and negative, iters 0, 1, 7, 9, 15 and 17 (around one
unrolled iteration of 8 or 16 steps), iters·shift beyond 2^31, 4099 rows
(more than two shared-memory column buffers of 4 columns would hold), one
row and one column.

`phase_minus_one` is COLS columns x ROWS low indices a block, the columns'
doubling factors staged in shared memory, 2^H bins a thread by H register
levels: every K of PHASE_KS (K = 2 has fewer levels than H) with every B
of PHASE_BS (B = 1 and 8 narrow column tiles with one register level,
B = 33 one live column in its last tile), in natural and in scrambled
order, t at its edges and beyond 2N (`exponents`).

`phase_factors` (the hoisted phase factors of every step) is one step x
COLS columns x T low indices a block, COLS narrowed at a small B or a
short grid: every K of PHASE_KS (K = 2 and 8 with halves of fewer bits
than its register levels, odd log2 K with Klo != Khi) with B = 1 and 33
(FACTOR_BS), FACTOR_STEPS steps, a at its edges and beyond 2N.

`fma_probe` splits its n elements into a scalar head, 16-byte vectors and
a scalar tail where a, b and e share their offset from a 16-byte
boundary, and takes every element scalar where they do not
(`vpu_probe.fma_split`): every n of FMA_NS (below, at and above one
vector, a block's worth, the probe's [1024, 512] and 3 past it) with a, b
and e each at every element offset 0-3 from a 16-byte boundary (e written
through `out`), both entry points; the first and last elements of each
operand are FMA_SPECIAL's pairs: ±0, ±inf, NaN, subnormals, products
that overflow and products that underflow (where the fma error is no
longer the exact error). NaN equals NaN whatever its payload.

`check_roll(gen)` / `check_phase(gen)` / `check_phase_factors(gen)` /
`check_fma(gen)` run them on the generator's device and return
{"checked": n, "not_bitexact": [labels]}; `chip_smoke.py` phase 3 calls
them all and `kernel_ab --source probe|phase --check` all but
`check_phase_factors`, with a CUDA generator (on CPU tensors the wrappers
run their plain versions).
"""

from __future__ import annotations

import itertools
import math

import torch

from ..ops import phase_rot
from . import vpu_probe

ROLL_CASES = (  # label, rows, cols, iters, shift
    ("rows 13", 13, 512, 400, 8),
    ("cols 509", 1027, 509, 400, 8),
    ("shift 0", 1021, 37, 400, 0),
    ("shift rows - 1", 1021, 37, 400, 1020),
    ("shift -3", 1021, 37, 400, -3),
    ("iters 0", 1024, 512, 0, 8),
    ("iters 1", 1024, 512, 1, 8),
    ("iters 7", 517, 33, 7, 5),
    ("iters 9", 517, 33, 9, 5),
    ("iters 15", 517, 33, 15, 5),
    ("iters 17", 517, 33, 17, 5),
    ("iters x shift beyond 2^31", 65539, 3, 32769, 65538),
    ("rows 4099", 4099, 130, 400, 8),
    ("one row", 1, 5, 400, 0),
    ("one column", 7, 1, 400, 3),
)
FMA_NS = (1, 3, 4, 5, 127, 129, 4097, 1024 * 512, 1024 * 512 + 3)
FMA_OFFSETS = tuple(itertools.product(range(4), repeat=3))  # elements of a, b, e past 16 bytes
_SPECIAL = (0.0, -0.0, math.inf, -math.inf, math.nan, 2.0**-149, -(2.0**-140), 2.0**-126,
            1.3 * 2.0**-70, -1.7 * 2.0**-60, 1.5 * 2.0**100, 3.0, -1.0 / 3.0)
# every pair of _SPECIAL (overflow: 2^100·2^100; underflow: 2^-70·2^-60 and
# below), then products of two values near 2^-70 whose f32 product is
# subnormal: its exact error is far below the least subnormal
FMA_SPECIAL = tuple(itertools.product(_SPECIAL, repeat=2)) + tuple(
    (x * 2.0**-70, y * 2.0**-70) for x, y in itertools.product((1.1, 1.7, 1.9), (1.3, 1.45)))
PHASE_KS = (2, 4, 8, 64, 1024, 2048)
PHASE_BS = (1, 8, 33, 256)
FACTOR_BS = (1, 33)
FACTOR_STEPS = 3


def exponents(n: int, b: int, gen) -> torch.Tensor:
    """Rotation exponents t int64 [b]: 0, 1, N − 1, N, 2N − 1, 2N, 3N + 5,
    2^32 − 1, −1, −2N − 3 and 2^40 + 7 first, random in [0, 2N) after."""
    t = torch.randint(0, 2 * n, (b,), generator=gen, device=gen.device)
    edges = [0, 1, n - 1, n, 2 * n - 1, 2 * n, 3 * n + 5, (1 << 32) - 1, -1, -2 * n - 3,
             (1 << 40) + 7][:b]
    t[:len(edges)] = torch.tensor(edges, device=gen.device)
    return t


def _same(got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want))


def check_roll(gen) -> dict:
    """`roll` at every shape of ROLL_CASES against `roll_plain`, bit for bit."""
    bad = []
    for label, rows, cols, iters, shift in ROLL_CASES:
        x = torch.rand((rows, cols), generator=gen, device=gen.device)
        if not _same(vpu_probe.roll(x, iters, shift), vpu_probe.roll_plain(x, iters, shift)):
            bad.append(f"{label} [{rows}, {cols}] iters={iters} shift={shift}")
    return dict(checked=len(ROLL_CASES), not_bitexact=bad)


def check_phase(gen) -> dict:
    """`phase_minus_one` at every K of PHASE_KS x B of PHASE_BS, natural and
    scrambled order, against `phase_minus_one_plain`, bit for bit."""
    bad, n_checked = [], 0
    for k in PHASE_KS:
        n = 2 * k
        for b in PHASE_BS:
            t = exponents(n, b, gen)
            for perm in (None, phase_rot.scrambled_perm(k)):
                n_checked += 1
                if not _same(phase_rot.phase_minus_one(t, n, perm),
                             phase_rot.phase_minus_one_plain(t, n, perm)):
                    bad.append(f"K={k} B={b} {'natural' if perm is None else 'scrambled'}")
    return dict(checked=n_checked, not_bitexact=bad)


def check_phase_factors(gen) -> dict:
    """`phase_factors_all` at every K of PHASE_KS x B of FACTOR_BS against
    `phase_factors_all_plain`, bit for bit."""
    bad, n_checked = [], 0
    for k in PHASE_KS:
        n = 2 * k
        for b in FACTOR_BS:
            a = torch.stack([exponents(n, b, gen) for _ in range(FACTOR_STEPS)])
            n_checked += 1
            got = sum(phase_rot.phase_factors_all(a, n), ())
            if not _same(got, sum(phase_rot.phase_factors_all_plain(a, n), ())):
                bad.append(f"K={k} B={b}")
    return dict(checked=n_checked, not_bitexact=bad)


def same_or_nan(got, want) -> bool:
    """f32 tensors equal bit for bit, a NaN equal to a NaN whatever its payload."""
    g, w = got.view(torch.int32), want.view(torch.int32)
    return bool(((g == w) | (torch.isnan(got) & torch.isnan(want))).all())


def fma_operands(gen, n: int):
    """a, b f32 [n] in [-1, 1), their first and last elements FMA_SPECIAL's
    pairs (as many as fit)."""
    a, b = (torch.rand((n,), generator=gen, device=gen.device) * 2 - 1 for _ in range(2))
    special = torch.tensor(FMA_SPECIAL, dtype=torch.float32, device=gen.device)
    m = min(n, special.shape[0])
    a[:m], b[:m] = special[:m, 0], special[:m, 1]
    a[n - m:], b[n - m:] = special[-m:, 1], special[-m:, 0]
    return a, b


def at_offset(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of x as a view `offset` elements past a 16-byte boundary."""
    buf = torch.empty((x.numel() + 4,), dtype=x.dtype, device=x.device)
    if buf.data_ptr() % 16:
        raise RuntimeError("at_offset: an allocation off a 16-byte boundary")
    view = buf[offset:offset + x.numel()].view(x.shape)
    view.copy_(x)
    return view


def check_fma(gen) -> dict:
    """Both `fma_probe` entry points at every n of FMA_NS and every offset
    of a, b and e (FMA_OFFSETS) against their plain versions, bit for bit
    (NaN as NaN)."""
    bad, n_checked = [], 0
    entries = ((vpu_probe.fma_probe, vpu_probe.fma_probe_plain),
               (vpu_probe.fma_probe_fma, vpu_probe.fma_probe_fma_plain))
    for n in FMA_NS:
        a0, b0 = fma_operands(gen, n)
        for (oa, ob, oe), (kernel, plain) in itertools.product(FMA_OFFSETS, entries):
            a, b = at_offset(a0, oa), at_offset(b0, ob)
            out = at_offset(torch.full_like(a0, float("nan")), oe)
            n_checked += 1
            if not same_or_nan(kernel(a, b, out), plain(a, b)):
                bad.append(f"{kernel.__name__} n={n} offsets a={oa} b={ob} e={oe}")
    return dict(checked=n_checked, not_bitexact=bad)
