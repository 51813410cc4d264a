"""The MAD kernels' block schedules (`csrc/mad.cu`), on the CPU.

`mad_batched_kernel` is BATCHED_BINS bins x BATCHED_THREADS / BATCHED_BINS
columns a block, each column's GGSW row read in place at its slot;
`mad_planes_kernel` (k + 1 != 2) is a bin and 32 * W columns a block
(W = PLANE_W_WIDE, _MID or _NARROW, by B), W warps an output plane, the
key rows, the digit spectra and the phase factors staged once;
`mad_plane_kernel` is one plane and up to THREADS columns a block, chosen
by the launcher's `one_plane` rule. This test reads those constants from
the source and runs each schedule in PyTorch, all blocks of a launch at
once: the batched kernel's row index map equals `_gathered_rows` in both
layouts, every (o, bin, col) is written by exactly one block, a column
whose slot lies outside [0, nslots) writes NaN, and the result is bit for
bit the plain version's. K = 32, 36 and 40, ragged B.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from spf_tpu_torch.ops import ds, mad

torch.set_num_threads(1)

SOURCE = (Path(__file__).resolve().parents[1] / "spf_tpu_torch" / "csrc" / "mad.cu").read_text()


def _const(name):
    return int(re.search(rf"\b{name} = (\d+)[;,]", SOURCE).group(1))


THREADS, BINS = _const("BATCHED_THREADS"), _const("BATCHED_BINS")
COLS = THREADS // BINS
PLANE_WARPS = (_const("PLANE_W_WIDE"), _const("PLANE_W_MID"), _const("PLANE_W_NARROW"))
PLANE_MAX_KP1 = _const("PLANE_MAX_KP1")
ONE_PLANE_COLS = _const("THREADS")
ONE_PLANE_PRODUCTS, ONE_PLANE_STEPS, ONE_PLANE_B = (
    _const("ONE_PLANE_PRODUCTS"), _const("ONE_PLANE_STEPS"), _const("ONE_PLANE_B"))


def _spectrum(rng, *shape, exp):
    hi = [rng.standard_normal(shape).astype(np.float32) * np.float32(2.0**exp) for _ in range(2)]
    out = []
    for h in hi:
        out += [h, h * rng.standard_normal(shape).astype(np.float32) * np.float32(2.0**-25)]
    return tuple(torch.from_numpy(x) for x in out)


def batched_schedule(dfft, rows, slots, slot_axis):
    """mad_batched_kernel's blocks, all at once: a block BINS bins x COLS
    columns, thread t the bin t % BINS and the column t // BINS of its
    tile, each row element read in place at s * s_slot + ((i * l + j) *
    (k+1) + o) * s_ijo + bin * s_bin -> (out 4 planes [k+1, K, B],
    written counts)."""
    l, kp1, k, b = dfft[0].shape
    nslots = rows[0].shape[slot_axis]
    s_slot, s_ijo, s_bin = (kp1 * l * kp1 * k, k, 1) if slot_axis == 0 else (1, k * nslots, nslots)
    # each computing column's row (a column outside [0, nslots) computes none)
    gathered = mad._gathered_rows(
        rows, None if slots is None else slots.long().clamp(0, nslots - 1), slot_axis)
    dflat = [c.reshape(-1) for c in dfft]
    rflat = [c.reshape(-1) for c in rows]
    bx, by = np.meshgrid(np.arange(-(-b // COLS)), np.arange(-(-k // BINS)), indexing="ij")
    tid = np.arange(THREADS)
    bins = by.reshape(-1, 1) * BINS + tid % BINS  # [NB, T]
    cols = bx.reshape(-1, 1) * COLS + tid // BINS
    live = (bins < k) & (cols < b)
    nb, t = np.nonzero(live)
    bins, cols = bins[nb, t], cols[nb, t]
    s = cols if slots is None else slots.numpy()[cols]
    ok = (s >= 0) & (s < nslots)
    base = np.where(ok, s.astype(np.int64) * s_slot + bins * s_bin, 0)
    acc = [tuple(torch.zeros(len(cols)) for _ in range(4)) for _ in range(kp1)]
    for i in range(kp1):
        for j in range(l):
            d = tuple(dflat[p][(j * kp1 + i) * k * b + bins * b + cols] for p in range(4))
            for o in range(kp1):
                at = base + ((i * l + j) * kp1 + o) * s_ijo
                r = tuple(rflat[p][at] for p in range(4))
                for p in range(4):  # the row element read is _gathered_rows'
                    assert torch.equal(r[p][ok], gathered[p][i, j, o, bins[ok], cols[ok]])
                acc[o] = ds.cadd(acc[o], ds.cmul(d, r))
    out = [torch.full((kp1, k, b), -1.0) for _ in range(4)]
    written = torch.zeros((kp1, k, b), dtype=torch.int64)
    for o in range(kp1):
        for p in range(4):
            out[p][o, bins, cols] = torch.where(torch.from_numpy(ok), acc[o][p], float("nan"))
        written[o].index_put_((torch.from_numpy(bins), torch.from_numpy(cols)),
                              torch.ones(len(bins), dtype=torch.int64), accumulate=True)
    return tuple(out), written


@pytest.mark.parametrize("layout", ["slot buffer", "batched row", "batched row, slots",
                                    "slot buffer, outside", "batched row, outside"])
@pytest.mark.parametrize("kp1, k, b", [(2, 32, 33), (2, 40, 48), (3, 36, 62), (2, 32, 1)])
def test_batched_schedule_matches_plain(layout, kp1, k, b):
    l = 2
    rng = np.random.default_rng(kp1 * 1000 + k * 10 + b)
    nslots = b if layout == "batched row" else 7
    dfft = _spectrum(rng, l, kp1, k, b, exp=20)
    if layout.startswith("slot buffer"):
        rows, axis = _spectrum(rng, nslots, kp1, l, kp1, k, exp=60), 0
    else:
        rows, axis = _spectrum(rng, kp1, l, kp1, k, nslots, exp=60), -1
    slots = None if layout == "batched row" else torch.from_numpy(
        rng.integers(0, nslots, b).astype(np.int32))
    want = mad.freq_mad_batched_plain(dfft, rows, slots, axis)
    if layout.endswith("outside"):  # a slot of -1 and one of nslots: those columns NaN
        bad = [0, b - 1]
        slots[bad[0]], slots[bad[-1]] = -1, nslots
        want = tuple(w.clone() for w in want)
        for w in want:
            w[..., bad] = float("nan")
    out, written = batched_schedule(dfft, rows, slots, axis)
    assert (written == 1).all(), "an output written by no block or by two"
    for got, w in zip(out, want):
        np.testing.assert_array_equal(got.numpy().view(np.uint32), w.numpy().view(np.uint32))


def plane_warps(b):
    """The launcher's warps an output plane (a block 32 * W columns): the W
    that pads B least, the wider on a tie."""
    best = PLANE_WARPS[0]
    for w in PLANE_WARPS[1:]:
        if -(-b // (32 * w)) * 32 * w < -(-b // (32 * best)) * 32 * best:
            best = w
    return best


def test_plane_warps_by_width():
    assert [plane_warps(b) for b in (1, 8, 33, 64, 129, 256, 384)] == [1, 1, 2, 2, 1, 4, 4]


def one_plane(group, kp1, l, b):
    """The launcher's choice of the one-plane kernel."""
    products = max(1, (1 << group) - 1) * kp1
    return (b % ONE_PLANE_COLS == 0 and products <= ONE_PLANE_PRODUCTS) or (
        b <= ONE_PLANE_B and products * l <= ONE_PLANE_STEPS)


def test_one_plane_where_measured_faster():
    assert [one_plane(g, kp1, 2, 256) for g, kp1 in ((0, 6), (1, 4), (2, 4), (2, 6), (3, 3))] \
        == [True, True, True, False, False]
    shapes = ((0, 3, 8), (0, 4, 8), (1, 3, 8), (0, 3, 129))
    assert [one_plane(g, kp1, 2, b) for g, kp1, b in shapes] == [True, False, True, False]


def _phase_factors(halves, group, bins, cols):
    """u_j at (bins, cols) as combine_phase_minus_one forms them."""
    lo, hi = halves
    klo = lo[0].shape[1]
    out = []
    for j in range(group):
        f = ds.cmul(tuple(c[j][bins // klo, cols] for c in hi),
                    tuple(c[j][bins % klo, cols] for c in lo))
        out.append((*ds.add(f[0], f[1], -1.0, 0.0), f[2], f[3]))
    return out


def one_plane_schedule(dfft, row, halves, group):
    """mad_plane_kernel's blocks, all at once: block (column tile, bin, o),
    thread c the column c of its tile, the spectra read in its (i, j) loop
    -> (out 4 planes [k+1, K, B], written counts)."""
    l, kp1, k, b = dfft[0].shape
    ns = max(1, (1 << group) - 1)
    rflat = [c.reshape(-1) for c in row]
    dflat = [c.reshape(-1) for c in dfft]
    bx, bins, o = (x.reshape(-1, 1) for x in np.meshgrid(
        np.arange(-(-b // ONE_PLANE_COLS)), np.arange(k), np.arange(kp1), indexing="ij"))
    cols = bx * ONE_PLANE_COLS + np.arange(ONE_PLANE_COLS)  # [NB, T]
    nb, t = np.nonzero(cols < b)
    bins, o, cols = bins[nb, 0], o[nb, 0], cols[nb, t]
    mads = [tuple(torch.zeros(len(cols)) for _ in range(4)) for _ in range(ns)]
    for ij in range(kp1 * l):
        i, j = ij // l, ij % l
        d = tuple(dflat[p][(j * kp1 + i) * k * b + bins * b + cols] for p in range(4))
        for m in range(ns):
            at = (((m * kp1 + i) * l + j) * kp1 + o) * k + bins
            mads[m] = ds.cadd(mads[m], ds.cmul(d, tuple(rflat[p][at] for p in range(4))))
    v = mad.nested_subset_sum(mads, _phase_factors(halves, group, bins, cols), group) \
        if group else mads[0]
    out = [torch.full((kp1, k, b), -1.0) for _ in range(4)]
    written = torch.zeros((kp1, k, b), dtype=torch.int64)
    for p in range(4):
        out[p][o, bins, cols] = v[p]
    written.index_put_(tuple(torch.from_numpy(x) for x in (o, bins, cols)),
                       torch.ones(len(cols), dtype=torch.int64), accumulate=True)
    return tuple(out), written


def plane_schedule(dfft, row, halves, group):
    """mad_plane_kernel's blocks, all at once -> (out 4 planes [k+1, K,
    B], written counts)."""
    l, kp1, k, b = dfft[0].shape
    assert kp1 <= PLANE_MAX_KP1
    PLANE_COLS = 32 * plane_warps(b)  # noqa: N806 (the kernel's name)
    ns = max(1, (1 << group) - 1)
    nij = kp1 * l
    rflat = [c.reshape(-1) for c in row]
    dflat = [c.reshape(-1) for c in dfft]
    nbx = -(-b // PLANE_COLS)
    bx, bins = np.meshgrid(np.arange(nbx), np.arange(k), indexing="ij")
    col0, bin_ = bx.reshape(-1, 1) * PLANE_COLS, bins.reshape(-1, 1)  # [NB, 1]
    # the bin's key rows into every plane: key[(ij * NS + m) * kp1 + oo]
    e = np.arange(nij * ns * kp1)
    oo, m, ij = e % kp1, e // kp1 % ns, e // (kp1 * ns)
    at = (((m * kp1 + ij // l) * l + ij % l) * kp1 + oo) * k + bin_  # [NB, E]
    key = [rflat[p][at] for p in range(4)]
    # the tile's digit spectra [ij][p][PLANE_COLS]
    e = np.arange(nij * PLANE_COLS)
    cc, ij = e % PLANE_COLS, e // PLANE_COLS
    spec_live = col0 + cc < b
    spec_at = np.where(spec_live, (ij % l * kp1 + ij // l) * k * b + bin_ * b + col0 + cc, 0)
    spec = [torch.where(torch.from_numpy(spec_live), dflat[p][spec_at], float("nan"))
            for p in range(4)]
    # the phase factors of the tile's columns, once: [G][p][PLANE_COLS]
    u = _phase_factors(halves, group, bin_, np.minimum(col0 + np.arange(PLANE_COLS), b - 1)) \
        if group else []
    # thread (o, c)
    tid = np.arange(PLANE_COLS * kp1)
    c, o = tid % PLANE_COLS, tid // PLANE_COLS
    mads = [tuple(torch.zeros(len(col0), len(tid)) for _ in range(4)) for _ in range(ns)]
    for ij in range(nij):
        d = tuple(s[:, ij * PLANE_COLS + c] for s in spec)
        for mm in range(ns):
            r = tuple(kk[:, (ij * ns + mm) * kp1 + o] for kk in key)
            mads[mm] = ds.cadd(mads[mm], ds.cmul(d, r))
    if group:
        v = mad.nested_subset_sum(mads, [tuple(x[:, c] for x in uj) for uj in u], group)
    else:
        v = mads[0]
    live = col0 + c < b
    nb, t = np.nonzero(live)
    out = [torch.full((kp1, k, b), -1.0) for _ in range(4)]
    written = torch.zeros((kp1, k, b), dtype=torch.int64)
    oi, bi, ci = o[t], bin_[nb, 0], (col0 + c)[nb, t]
    for p in range(4):
        out[p][oi, bi, ci] = v[p][nb, t]
    written.index_put_(tuple(torch.from_numpy(x) for x in (oi, bi, ci)),
                       torch.ones(len(t), dtype=torch.int64), accumulate=True)
    return tuple(out), written


@pytest.mark.parametrize("kp1, group, b", [(3, 0, 33), (3, 3, 1), (4, 1, 64), (6, 2, 33),
                                           (6, 3, 40), (4, 3, 128), (3, 0, 8), (4, 2, 128)])
def test_plane_schedule_matches_plain(kp1, group, b):
    l, k, klo = 2, 32, 8
    rng = np.random.default_rng(kp1 * 100 + group * 10 + b)
    ns = max(1, (1 << group) - 1)
    dfft = _spectrum(rng, l, kp1, k, b, exp=20)
    row = _spectrum(rng, *((kp1, l, kp1, k) if group == 0 else (ns, kp1, l, kp1, k)), exp=60)
    halves = None
    if group:
        halves = (_spectrum(rng, group, klo, b, exp=0), _spectrum(rng, group, k // klo, b, exp=0))
        want = mad.mad_horner_combine_plain(dfft, row, halves, group)
    else:
        want = mad.freq_mad_plain(dfft, row)
    schedule = one_plane_schedule if one_plane(group, kp1, l, b) else plane_schedule
    out, written = schedule(dfft, row, halves, group)
    assert (written == 1).all(), "an output written by no block or by two"
    for got, w in zip(out, want):
        np.testing.assert_array_equal(got.numpy().view(np.uint32), w.numpy().view(np.uint32))
