"""The rotation kernels' tile schedule (`csrc/rot_decomp.cu`), on the CPU.

`rotate_sub_decompose` and `rotate_sub_decompose_acc` stage BC whole
columns of one polynomial, all N rows, in a row-major shared-memory tile,
and split a tile's output rows between `splits` blocks. This test reads
BC, the block size and the split limit from the source, runs that
schedule in numpy block by block (the last column tile partial, each
block writing only its own rows of the digits and of acc_out, every
element written by exactly one block) and holds the result bit for bit
against `rotate_sub_decompose(_acc)_plain`, at edge and random t. It also
checks the tile's index map against the shared-memory banks: the 64-bit
reads of a half-warp (32 banks of 4 bytes) never put two lanes on one
bank.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from spf_tpu_torch.ops import rot_decomp, torus
from spf_tpu_torch.params import RadixDecomposition

torch.set_num_threads(1)

SOURCE = (Path(__file__).resolve().parents[1] / "spf_tpu_torch" / "csrc" / "rot_decomp.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


BC, THREADS, MAX_SPLITS = _const("BC"), _const("ROT_THREADS"), _const("MAX_SPLITS")
ROWS = THREADS // BC  # the rows a pass of a block covers
N = 64
RADIX = RadixDecomposition(count=2, radix_log=16)
MASK = (1 << 64) - 1


def _splits(p, b, sms):
    """launch_rotation's split of a tile's output rows for acc [p, N, b]."""
    return max(1, min(sms // (p * -(-b // BC)), MAX_SPLITS, N))


def _schedule(acc, t, prod, sms):
    """The kernels' blocks in turn: acc u64 [P, N, B] (numpy), t int [B],
    prod (ph, pl) or None -> (digits f32 [count, P, N, B], acc_out or None,
    the split, the most lanes of a half-warp on one bank)."""
    p_, n, b = acc.shape
    tiles = -(-b // BC)
    splits = _splits(p_, b, sms)
    acc_t = torus.from_u64_np(acc)
    if prod is not None:  # acc' on the way in, as the kernel forms it
        acc_t = torus.add(acc_t, torus.from_ds(*prod))
    acc_p = torus.to_u64_np(acc_t)
    digits = np.full((RADIX.count, p_, n, b), np.nan, dtype=np.float32)
    acc_out = np.zeros_like(acc) if prod is not None else None
    written = np.zeros((p_, n, b), dtype=np.int64)
    worst = 0
    tid = np.arange(THREADS)
    col, r0 = tid % BC, tid // BC
    for blk in range(p_ * tiles * splits):  # split fastest
        split, pt = blk % splits, blk // splits
        c0, p = pt % tiles * BC, pt // tiles
        live = c0 + col < b
        tile = np.zeros(n * BC, dtype=np.uint64)  # [n][BC], row-major
        for j in range(n):
            for c in range(min(BC, b - c0)):
                tile[j * BC + c] = acc_p[p, j, c0 + c]
        lo, hi = split * n // splits, (split + 1) * n // splits
        tc = np.where(live, t[np.minimum(c0 + col, b - 1)] % (2 * n), 0)
        for j0 in range(lo, hi, ROWS):
            j = j0 + r0
            on = live & (j < hi)
            s = j - tc
            s = np.where(s < 0, s + 2 * n, s)
            neg = s >= n
            src = np.where(neg, s - n, s)
            for idx in (src, j):  # the gather, then the element itself
                words = 2 * (idx * BC + col)
                for half in range(THREADS // 16):
                    lanes = slice(16 * half, 16 * half + 16)
                    mine = words[lanes][on[lanes]]
                    if mine.size:
                        worst = max(worst, np.bincount(np.concatenate([mine, mine + 1]) % 32).max())
            x = tile[np.where(on, src, 0) * BC + col].astype(object)
            own = tile[np.where(on, j, 0) * BC + col].astype(object)
            diff = [((-xi if ng else xi) - oi) & MASK for xi, ng, oi in zip(x, neg, own)]
            d = torus.decompose(torus.from_u64_np(np.array(diff, dtype=np.uint64)), RADIX).numpy()
            for lane in np.nonzero(on)[0]:
                jj, cc = j[lane], c0 + col[lane]
                digits[:, p, jj, cc] = d[:, lane]
                written[p, jj, cc] += 1
                if acc_out is not None:
                    acc_out[p, jj, cc] = own[lane]
    assert (written == 1).all(), "an element written by no block or by two"
    return digits, acc_out, splits, worst


def _t(rng, b):
    t = rng.integers(-(1 << 41), 1 << 41, size=b)
    edges = [0, 1, N - 1, N, 2 * N - 1, 2 * N, -1, -(2 * N) - 3, (1 << 40) + 7, 3 * N + 5]
    t[:min(b, len(edges))] = edges[:b]
    return t


@pytest.mark.parametrize("fused", [False, True], ids=["rotate_sub_decompose", "rotate_sub_decompose_acc"])
@pytest.mark.parametrize("p, b, sms, splits", [(1, 3, 132, 8), (2, 8, 132, 8), (2, 13, 132, 8),
                                               (1, 13, 4, 2), (2, 8, 1, 1)])
def test_tile_schedule_matches_plain(fused, p, b, sms, splits):
    rng = np.random.default_rng(7 * p + b + fused)
    acc = rng.integers(0, 1 << 64, size=(p, N, b), dtype=np.uint64)
    t = _t(rng, b)
    prod = None
    if fused:
        ph = (rng.standard_normal((p, N, b)) * 2.0**40).astype(np.float32)
        ph.reshape(-1)[:4] = [2.0**31, -(2.0**31), 2.0**63, 2.0**84]
        pl = rng.standard_normal((p, N, b)).astype(np.float32)
        prod = (torch.from_numpy(ph), torch.from_numpy(pl))
    digits, acc_out, got_splits, worst = _schedule(acc, t, prod, sms)
    assert got_splits == splits
    tt = torch.from_numpy(t)
    if fused:
        want, want_acc = rot_decomp.rotate_sub_decompose_acc_plain(torus.from_u64_np(acc), prod, tt, RADIX)
        np.testing.assert_array_equal(acc_out, torus.to_u64_np(want_acc))
    else:
        want = rot_decomp.rotate_sub_decompose_plain(torus.from_u64_np(acc), tt, RADIX)
    np.testing.assert_array_equal(digits.view(np.uint32), want.numpy().view(np.uint32))
    assert worst == 1, f"{worst} lanes of a half-warp on one shared-memory bank"
