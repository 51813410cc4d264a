"""The MAD kernels' block schedules (`csrc/mad.cu`), on the CPU.

`mad_batched_kernel` is BATCHED_BINS bins x BATCHED_THREADS / BATCHED_BINS
columns a block, each column's GGSW row read in place at its slot;
`mad_planes_kernel` (k + 1 != 2) is a bin and 32 * W columns a block
(W = PLANE_W_WIDE, _MID or _NARROW, by B), W warps an output plane, the
key rows, the digit spectra and the phase factors staged once;
`mad_plane_kernel` is one plane and up to THREADS columns a block, chosen
by the launcher's `one_plane` rule; `ks_mad_kernel` (the keyswitch MAD)
is one bin, KS_THREADS columns and one batch entry a block, each digit
spectrum loaded two products ahead. This test reads those constants from
the source and runs each schedule in PyTorch, all blocks of a launch at
once: the batched kernel's row index map equals `_gathered_rows` in both
layouts, every (o, bin, col) is written by exactly one block, a column
whose slot lies outside [0, nslots) writes NaN, and the result is bit for
bit the plain version's. K = 32, 36 and 40, ragged B.

The keyswitch MAD's plain version is also held bit for bit against the
loops that circuit bootstrapping ran before it had a kernel (the trace's
GLWE keyswitch and the scheme switch's rows), and its wrapper against
misshapen inputs.
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
KS_THREADS = _const("KS_THREADS")


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


def ks_schedule(dfft, row, init, init_plane):
    """ks_mad_kernel's blocks, all at once: a block KS_THREADS columns of
    one bin and one batch entry z, thread t the column t of its tile; the
    key row staged as key[e] = row[e * K + bin], e = (i * l + j) * (k+1) +
    o; spectrum (i, j) read at ((j * L + z) * k_in + i) * K * B + bin * B +
    col, two products ahead of its use; the initial plane at z * K * B +
    bin * B + col; output plane o at (z * (k+1) + o) * K * B + bin * B +
    col -> (out 4 planes [L?, k+1, K, B], written counts)."""
    shape = tuple(dfft[0].shape)
    l, k_in, k, b = shape[0], *shape[-3:]
    nz = shape[1] if len(shape) == 5 else 1
    kp1 = row[0].shape[2]
    n, plane = k_in * l, k * b
    dflat = [c.reshape(-1) for c in dfft]
    rflat = [c.reshape(-1) for c in row]
    bx, bins, z, tid = np.meshgrid(np.arange(-(-b // KS_THREADS)), np.arange(k), np.arange(nz),
                                   np.arange(KS_THREADS), indexing="ij")
    cols = bx * KS_THREADS + tid
    live = cols < b
    bins, z, cols = bins[live], z[live], cols[live]
    idx = bins * b + cols

    def spec(i, j):
        return tuple(dflat[p][((j * nz + z) * k_in + i) * plane + idx] for p in range(4))

    zero = tuple(torch.zeros(len(cols)) for _ in range(4))
    acc = [zero] * kp1
    d0 = spec(0, 0)
    d1 = (spec(0, 1) if l > 1 else spec(1, 0)) if n > 1 else zero
    if init is not None:
        acc[init_plane] = tuple(c.reshape(-1)[z * plane + idx] for c in init)
    pi, pj = 2 // l, 2 % l
    for ij in range(n):
        d2 = zero
        if ij + 2 < n:
            d2 = spec(pi, pj)
            pj += 1
            if pj == l:
                pj, pi = 0, pi + 1
        for o in range(kp1):
            e = ij * kp1 + o
            acc[o] = ds.cadd(acc[o], ds.cmul(d0, tuple(rflat[p][e * k + bins] for p in range(4))))
        d0, d1 = d1, d2
    out = [torch.full((nz * kp1 * plane,), -1.0) for _ in range(4)]
    written = torch.zeros(nz * kp1 * plane, dtype=torch.int64)
    for o in range(kp1):
        at = torch.from_numpy((z * kp1 + o) * plane + idx)
        for p in range(4):
            out[p][at] = acc[o][p]
        written.index_put_((at,), torch.ones(len(at), dtype=torch.int64), accumulate=True)
    lead = shape[1:-3]
    return tuple(c.reshape(*lead, kp1, k, b) for c in out), written


def _ks_inputs(rng, kp1, k_in, l, nz, k, b, with_init, batched=True):
    lead = (nz,) if batched else ()
    dfft = _spectrum(rng, l, *lead, k_in, k, b, exp=20)
    row = _spectrum(rng, k_in, l, kp1, k, exp=60)
    init = _spectrum(rng, *lead, k, b, exp=60) if with_init else None
    return dfft, row, init


@pytest.mark.parametrize("kp1, k_in, l, nz, init_plane, b", [
    (2, 1, 6, 1, None, 33), (2, 1, 1, 1, None, 129), (2, 1, 2, 3, 1, 1), (3, 2, 3, 4, 0, 130),
    (6, 5, 2, 2, 5, 7), (4, 3, 1, 2, 2, 128), (3, 1, 15, 1, 2, 64)])
def test_ks_schedule_matches_plain(kp1, k_in, l, nz, init_plane, b):
    k = 36
    rng = np.random.default_rng(kp1 * 1000 + k_in * 100 + l * 10 + b)
    dfft, row, init = _ks_inputs(rng, kp1, k_in, l, nz, k, b, init_plane is not None)
    plane = 0 if init_plane is None else init_plane
    want = mad.freq_mad_ks_plain(dfft, row, init, plane)
    out, written = ks_schedule(dfft, row, init, plane)
    assert (written == 1).all(), "an output written by no thread or by two"
    for got, w in zip(out, want):
        np.testing.assert_array_equal(got.numpy().view(np.uint32), w.numpy().view(np.uint32))


def _trace_keyswitch_loops(dfft, ksk_row, init, init_plane):
    """The product of `cbs.keyswitch_glwe` as its loops ran in PyTorch
    (digit spectra [l, k, K, B], key row [k, l, k+1, K]); an initial plane
    placed as the scheme switch places it."""
    l, k = dfft[0].shape[:2]
    shape = (k + 1, *dfft[0].shape[2:])
    acc = tuple(torch.zeros(shape, dtype=torch.float32) for _ in range(4))
    if init is not None:
        for z, c in zip(acc, init):
            z[init_plane] = c
    for i in range(k):
        for j in range(l):
            d = tuple(c[j, i][None] for c in dfft)  # [1, K, B]
            g = tuple(c[i, j][..., None] for c in ksk_row)  # [k+1, K, 1]
            acc = ds.cadd(acc, ds.cmul(d, g))
    return acc


def _scheme_switch_row_loops(dfft, ssk_row, b_fft, j):
    """Row j of `cbs.scheme_switch` as its loops ran in PyTorch (digit
    spectra [l_ss, l, k, K, B], key row [k, l_ss, k+1, K], GLEV(b) spectra
    [l, K, B] in column j, or none)."""
    l_ss, l_ggsw, k, k2, bb = dfft[0].shape
    acc = tuple(torch.zeros((l_ggsw, k + 1, k2, bb), dtype=torch.float32) for _ in range(4))
    if b_fft is not None:
        for z, bf in zip(acc, b_fft):
            z[:, j] = bf
    for r in range(k):
        for jj in range(l_ss):
            d = tuple(c[jj, :, r][:, None] for c in dfft)  # [l, 1, K, B]
            g = tuple(c[r, jj][..., None] for c in ssk_row)  # [k+1, K, 1]
            acc = ds.cadd(acc, ds.cmul(d, g))
    return acc


@pytest.mark.parametrize("kp1", [2, 3])
@pytest.mark.parametrize("nz", [1, 4])
@pytest.mark.parametrize("with_init", [False, True])
def test_freq_mad_ks_plain_is_the_cbs_loops(kp1, nz, with_init):
    """L = 1 on the trace's [l, k, K, B] spectra, L = 4 on the scheme
    switch's [l_ss, L, k, K, B], the initial plane the last one (the
    scheme switch's column j = k - 1)."""
    rng = np.random.default_rng(kp1 * 10 + nz + 100 * with_init)
    k_in, l, k, b = kp1 - 1, 3, 8, 5
    batched = nz > 1
    dfft, row, init = _ks_inputs(rng, kp1, k_in, l, nz, k, b, with_init, batched)
    plane = k_in - 1 if with_init else 0
    got = mad.freq_mad_ks_plain(dfft, row, init, plane)
    if batched:
        want = _scheme_switch_row_loops(dfft, row, init, plane)
    else:
        want = _trace_keyswitch_loops(dfft, row, init, plane)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy().view(np.uint32), w.numpy().view(np.uint32))


def _misshapen(rng, case):
    """(dfft, key row, init, init_plane) of freq_mad_ks with one fault."""
    kp1, k_in, l, nz, k, b = 2, 1, 3, 2, 8, 5
    dfft, row, init = _ks_inputs(rng, kp1, k_in, l, nz, k, b, True)
    if case == "key row k_in":
        row = _spectrum(rng, k_in + 1, l, kp1, k, exp=60)
    elif case == "key row l":
        row = _spectrum(rng, k_in, l + 1, kp1, k, exp=60)
    elif case == "key row K":
        row = _spectrum(rng, k_in, l, kp1, 2 * k, exp=60)
    elif case == "k+1 = 5":
        dfft, row, init = _ks_inputs(rng, 5, 4, l, nz, k, b, True)
    elif case == "k+1 = 8":
        dfft, row, init = _ks_inputs(rng, 8, 7, l, nz, k, b, True)
    elif case == "spectra rank":
        dfft = tuple(c[0, 0] for c in dfft)
    elif case == "planes differ":
        dfft = (*dfft[:3], dfft[3][..., :-1])
    elif case == "init batch":
        init = tuple(c[:1] for c in init)
    elif case == "init plane":
        return dfft, row, init, kp1
    return dfft, row, init, 0


@pytest.mark.parametrize("case", ["key row k_in", "key row l", "key row K", "k+1 = 5",
                                  "k+1 = 8", "spectra rank", "planes differ", "init batch",
                                  "init plane"])
def test_freq_mad_ks_rejects_misshapen_inputs(case):
    args = _misshapen(np.random.default_rng(7), case)
    with pytest.raises(ValueError, match="freq_mad_ks"):
        mad.freq_mad_ks(*args)
