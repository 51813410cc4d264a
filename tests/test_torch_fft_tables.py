"""The FFT kernels' constants and pass schedule (`csrc/fft.cu`), on the CPU.

The kernels read one compact table a direction (`fft.kernel_tables_np`):
the twiddle of the stage with half h at index n in row h + n, the twist
of row r in row K + r. `test_kernel_tables_hold_stage_words` holds every
such row, for every K the kernels take, to the f32 words of
`_stage_tables`, the plain version's constants, at each row where the
plain version uses them. `test_pass_schedule_matches_plain` runs the
kernels' schedule in PyTorch: R = min(8, K) points a thread, log2(R)
stages a pass on the rows that differ in the pass's bits, the tables
read at the kernels' indices, and holds it bit for bit against
`fwd_ds_plain` / `inv_ds_plain`.
"""

import numpy as np
import pytest
import torch

from spf_tpu_torch.ops import ds, fft

torch.set_num_threads(1)

KS = [1 << e for e in range(1, 12)]  # 2 .. 2048


def _words(x):
    return np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_tables_hold_stage_words(inverse):
    for k in KS:
        consts, halves = fft._stage_tables(k, inverse)
        consts = consts[:, :, 0]
        tab = fft.kernel_tables_np(k, inverse)
        assert tab.shape == (2 * k, 4) and tab.dtype == np.float32
        r = np.arange(k)
        for s, h in enumerate(halves):
            b_rows = r[r % (2 * h) >= h]
            assert not consts[5 * s, b_rows].any()  # the is_a channel: b-rows
            np.testing.assert_array_equal(
                _words(consts[5 * s + 1:5 * s + 5, b_rows].T), _words(tab[h + b_rows % h]),
                err_msg=f"K = {k}, half {h}")
        tb = 5 * len(halves)
        np.testing.assert_array_equal(_words(consts[tb:tb + 4].T), _words(tab[k:]),
                                      err_msg=f"K = {k}, twist")
        assert not tab[0].any()


def _row(t, j, lo, s):
    """fft.cu's row_of: the row of a thread's j-th point in a pass over
    the bits [lo, lo + s)."""
    return (t & ((1 << lo) - 1)) | (j << lo) | ((t >> lo) << (lo + s))


def _schedule(vals, k, inverse):
    """The kernels' passes, all threads of a column at once: fwd (hi, lo)
    [2K, B] -> 4 planes [K, B]; inverse 4 planes -> (hi, lo)."""
    r_pts = min(8, k)
    s = r_pts.bit_length() - 1
    log_k = k.bit_length() - 1
    nfull, rem = divmod(log_k, s)
    tab = torch.from_numpy(fft.kernel_tables_np(k, inverse))
    t = torch.arange(k // r_pts)
    b = vals[0].shape[-1]

    def entry(i):
        return tuple(tab[i, q][:, None] for q in range(4))

    def lo_of(p):
        if inverse:
            return s * p if p < nfull else log_k - s
        return log_k - s * (p + 1) if p < nfull else 0

    lo_b = lo_of(0)
    rows = [_row(t, j, lo_b, s) for j in range(r_pts)]
    if inverse:
        x = [tuple(c[r] for c in vals) for r in rows]
    else:
        hi, lo = vals
        x = [ds.cmul((hi[r], lo[r], hi[r + k], lo[r + k]), entry(k + r)) for r in rows]
    for p in range(nfull + (rem > 0)):
        if p:  # the exchange: every point to its row, then the next pass's rows
            full = [torch.empty((k, b)) for _ in range(4)]
            for r, v in zip(rows, x):
                for q in range(4):
                    full[q][r] = v[q]
            lo_b = lo_of(p)
            rows = [_row(t, j, lo_b, s) for j in range(r_pts)]
            x = [tuple(c[r] for c in full) for r in rows]
        active = range(s) if p < nfull else (range(s - rem, s) if inverse else range(rem))
        base = _row(t, 0, lo_b, s)
        for i in (active if inverse else reversed(active)):
            h = 1 << (lo_b + i)
            for j in range(r_pts):
                if j & (1 << i):
                    continue
                jb = j | (1 << i)
                w = entry(h + ((base & (h - 1)) | ((j & ((1 << i) - 1)) << lo_b)))
                a = x[j]
                if inverse:
                    tt = ds.cmul(x[jb], w)
                    x[j], x[jb] = ds.cadd(a, tt), ds.csub(a, tt)
                else:
                    x[j], x[jb] = ds.cadd(a, x[jb]), ds.cmul(ds.csub(a, x[jb]), w)
    if not inverse:
        out = [torch.empty((k, b)) for _ in range(4)]
        for r, v in zip(rows, x):
            for q in range(4):
                out[q][r] = v[q]
        return tuple(out)
    ohi = torch.empty((2 * k, b))
    olo = torch.empty_like(ohi)
    for r, v in zip(rows, x):
        rh, rl, ih, il = ds.cmul(v, entry(k + r))
        ohi[r], olo[r], ohi[r + k], olo[r + k] = rh, rl, ih, il
    return ohi, olo


@pytest.mark.parametrize("k", [2, 4, 16, 32, 64, 128])
def test_pass_schedule_matches_plain(k):
    """K = 2 and 4 (one pass, R = K), 16 (3 + 1 stages), 32 (3 + 2), 64
    (3 + 3), 128 (3 + 3 + 1); torus-like hi/lo and signed digits with a
    zero lo plane."""
    rng = np.random.default_rng(k)
    b = 3
    hi = torch.from_numpy(rng.integers(-(1 << 15), 1 << 15, size=(2 * k, b)).astype(np.float32))
    lo = torch.from_numpy((rng.standard_normal((2 * k, b)) * 2.0**-10).astype(np.float32))
    for lo_plane in (lo, torch.zeros_like(lo)):
        want = fft.fwd_ds_plain(hi, lo_plane)
        got = _schedule((hi, lo_plane), k, False)
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        back = fft.inv_ds_plain(want)
        for g, w in zip(_schedule(want, k, True), back):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
