"""The edge shapes of the probe kernels `roll` (`csrc/probe.cu`) and
`phase_minus_one` (`csrc/phase.cu`), held bit for bit on a CUDA card
against their plain versions.

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

`check_roll(gen)` / `check_phase(gen)` run them on the generator's device
and return {"checked": n, "not_bitexact": [labels]}; `chip_smoke.py`
phase 3 and `kernel_ab --source probe|phase --check` call them with a CUDA
generator (on CPU tensors the wrappers run their plain versions).
"""

from __future__ import annotations

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
PHASE_KS = (2, 4, 8, 64, 1024, 2048)
PHASE_BS = (1, 8, 33, 256)


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
