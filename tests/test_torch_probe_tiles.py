"""The block schedules of the probe kernels `roll` (`csrc/probe.cu`) and
`phase_minus_one` (`csrc/phase.cu`), and of the hoisted phase factors'
`phase_factors_kernel` (`csrc/phase.cu`), on the CPU.

This test reads each kernel's constants from its source and runs its
schedule in PyTorch, every thread of a launch at once, against the plain
version, bit for bit, at the edge shapes of
`spf_tpu_torch.scripts.probe_edges`:

- `roll`: ROLL_THREADS threads a block, ROLL_CHAINS elements a thread
  ROLL_THREADS apart, each read once at its index-carried source (e −
  off·cols) mod rows·cols with off = iters·shift mod rows reduced in
  64-bit (also for iters·shift beyond 2^31, checked on the index alone),
  the chains' adds interleaved ROLL_UNROLL steps a loop iteration, each
  output written once;
- `phase_minus_one`: COLS (MAX_COLS, or the least power of two >= B)
  columns x threads / COLS low indices a block (THREADS threads, halved
  down to MIN_THREADS while the grid has fewer than MIN_BLOCKS blocks),
  C and q_0 .. q_{J-1} of
  the block's columns staged per block (the last column repeated past
  B), seq[r] by r's set bits lowest first (a warp spans 32 / COLS low
  indices, whose chains take different bits at once), H = min(REG_LEVELS, log2 K)
  levels in registers (1 at B <= NARROW_B), bin m stored at row perm^-1[m]; every output
  written once;
- `phase_factors_kernel`: one step x COLS columns x T low indices a
  block (COLS = FACTOR_COLS, or the least power of two >= B, halved while
  the grid has fewer than MIN_BLOCKS blocks; T = the lo half's low
  indices, then the hi half's), C and q_0 .. q_{J-1} of the block's
  columns staged per block (the last column repeated past B), bin r of a
  half from its seed (C, or one for hi) by r's set bits lowest first,
  min(FACTOR_LEVELS, the half's bits) levels in registers; every output
  of both [4, steps, K_half, B] tensors written once;
- `fma_probe`: the wrapper's split (`vpu_probe.fma_split`) of n elements
  into a scalar head, 16-byte vectors and a scalar tail, or every element
  scalar, from the addresses of a, b and e, and the kernel's grid over it
  (FMA_THREADS threads a block, FMA_VEC vectors a thread in the vector
  blocks, 4·FMA_VEC scalars a thread in the blocks after them): every
  element loaded and stored once, every vector 16-byte aligned in all
  three operands, the plain versions under the split equal to the plain
  versions, at every n and offset of `probe_edges.check_fma`.

Also `scripts.per_call_device`, which reads a profile's device time per
call from the events it kept.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from spf_tpu_torch.ops import ds, phase_rot
from spf_tpu_torch.scripts import per_call_device, probe_edges, vpu_probe

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "spf_tpu_torch" / "csrc"


def _const(source, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text()).group(1))


ROLL_THREADS, ROLL_CHAINS, ROLL_UNROLL = (
    _const("probe.cu", n) for n in ("ROLL_THREADS", "ROLL_CHAINS", "ROLL_UNROLL"))
FMA_THREADS, FMA_VEC = (_const("probe.cu", n) for n in ("FMA_THREADS", "FMA_VEC"))
THREADS, MIN_THREADS, MIN_BLOCKS, MAX_COLS, REG_LEVELS, NARROW_B, MAX_ENTRIES = (
    _const("phase.cu", n) for n in ("THREADS", "MIN_THREADS", "MIN_BLOCKS", "MAX_COLS",
                                    "REG_LEVELS", "NARROW_B", "MAX_ENTRIES"))
FACTOR_COLS, FACTOR_LEVELS, FACTOR_MAX_LOG_K, FACTOR_THREADS = (
    _const("phase.cu", n) for n in ("FACTOR_COLS", "FACTOR_LEVELS", "FACTOR_MAX_LOG_K",
                                    "FACTOR_THREADS"))


def roll_source(rows, cols, iters, shift):
    """The roll kernel's launch: (flat element of each (block, thread,
    chain) [NB, T, CH], its flat source, live mask), the offset reduced as
    `spf_roll` reduces it (the wrapper takes shift mod rows)."""
    shift %= rows
    n = rows * cols
    off = (iters % rows) * shift % rows  # < rows^2 < 2^62: no int64 overflow
    back = off * cols
    per_block = ROLL_THREADS * ROLL_CHAINS
    blocks = -(-n // per_block)
    base = (np.arange(blocks, dtype=np.int64)[:, None] * per_block
            + np.arange(ROLL_THREADS, dtype=np.int64)[None, :])
    e = base[..., None] + np.arange(ROLL_CHAINS, dtype=np.int64) * ROLL_THREADS
    src = np.where(e >= back, e - back, e - back + n)
    return e, src, e < n


def roll_schedule(x, iters, shift):
    rows, cols = x.shape
    e, src, live = roll_source(rows, cols, iters, shift)
    n = rows * cols
    reads = np.bincount(src[live], minlength=n)
    assert (reads == 1).all(), "an input read by no thread or by two"
    v = torch.where(torch.from_numpy(live),
                    x.reshape(-1)[torch.from_numpy(np.where(live, src, 0))], 0.0)
    chains = list(v.unbind(-1))

    def step():  # one add on each of a thread's chains, in turn
        for i in range(ROLL_CHAINS):
            chains[i] = chains[i] + 1.0

    s = 0
    while s + ROLL_UNROLL <= iters:
        for _ in range(ROLL_UNROLL):
            step()
        s += ROLL_UNROLL
    for _ in range(iters - s):
        step()
    v = torch.stack(chains, -1)
    out = torch.full((n,), float("nan"))
    out[torch.from_numpy(e[live])] = v[torch.from_numpy(live)]
    written = np.bincount(e[live], minlength=n)
    assert (written == 1).all(), "an output written by no thread or by two"
    return out.reshape(rows, cols)


SMALL_ROLLS = [c for c in probe_edges.ROLL_CASES if c[1] * c[2] * c[3] <= 1 << 28]


@pytest.mark.parametrize("label, rows, cols, iters, shift", SMALL_ROLLS,
                         ids=[c[0] for c in SMALL_ROLLS])
def test_roll_schedule_matches_plain(label, rows, cols, iters, shift):
    x = torch.from_numpy(np.random.default_rng(rows * 31 + cols).random((rows, cols))
                         .astype(np.float32))
    got = roll_schedule(x, iters, shift)
    want = vpu_probe.roll_plain(x, iters, shift)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))


@pytest.mark.parametrize("rows, cols, iters, shift", [
    *((c[1], c[2], c[3], c[4]) for c in probe_edges.ROLL_CASES),
    (65539, 3, (1 << 31) - 1, 65538), (3, 2, (1 << 31) - 1, 2), ((1 << 20) + 7, 1, 4099, -5)])
def test_roll_source_index(rows, cols, iters, shift):
    """The index-carried source row equals iters rolls by shift, by exact
    integer arithmetic, also where iters·shift is beyond 2^31 (where the
    adds are too many to run here)."""
    e, src, live = roll_source(rows, cols, iters, shift)
    r, c = e[live] // cols, e[live] % cols
    want = ((r - iters * shift) % rows) * cols + c  # Python ints in numpy int64: below 2^62
    np.testing.assert_array_equal(src[live], want)


def _exponents(n, b):
    gen = torch.Generator().manual_seed(n * 1000 + b)
    return probe_edges.exponents(n, b, gen)


def phase_schedule(t, n, perm):
    """phase_kernel's blocks, all at once -> (4 planes [K, B], written counts)."""
    k = n // 2
    log_k = k.bit_length() - 1
    b = t.shape[0]
    h = 1 if b <= NARROW_B else min(REG_LEVELS, log_k)
    cols = MAX_COLS
    while cols > 1 and b <= cols // 2:
        cols //= 2
    low = log_k - h
    assert log_k + 1 <= MAX_ENTRIES

    def grid(threads):
        return -(-b // cols), -(-(1 << low) // (threads // cols))

    threads = THREADS  # halved while the grid has fewer than MIN_BLOCKS blocks
    while (threads > MIN_THREADS and threads // cols > 1
           and np.prod(grid(threads)) < MIN_BLOCKS):
        threads //= 2
    rows = threads // cols
    grid_x, grid_y = grid(threads)
    mask = 2 * n - 1
    tabs = phase_rot._psi_table(2 * n, torch.device("cpu"))

    # the stage: [grid_x, entries, cols] per plane, the last column repeated past B
    col = torch.clamp(torch.arange(grid_x)[:, None] * cols + torch.arange(cols)[None, :],
                      max=b - 1)
    tt = t[col] & 0xFFFFFFFF  # the kernel's uint32 t
    e = torch.arange(log_k + 1)[None, :, None]
    idx = torch.where(e == 0, tt[:, None, :], -(tt[:, None, :] << (e + 1))) & mask
    stage = tuple(p[idx] for p in tabs)

    bx, by, tid = np.meshgrid(np.arange(grid_x), np.arange(grid_y), np.arange(threads),
                              indexing="ij")
    tx, ty = tid % cols, tid // cols
    c, r = bx * cols + tx, by * rows + ty
    live = (c < b) & (r < (1 << low))
    bx, tx, c, r = (torch.from_numpy(a[live]) for a in (bx, tx, c, r))

    def entry(ent):
        return tuple(p[bx, ent, tx] for p in stage)

    loc = [entry(torch.zeros_like(r))]
    bits = r.clone()
    while bool((bits != 0).any()):  # one set bit a lane an iteration, lowest first
        on = bits != 0
        j = torch.where(on, (bits & -bits).float().log2().long(), 0)
        prod = ds.cmul(loc[0], entry(j + 1))
        loc[0] = tuple(torch.where(on, p, q) for p, q in zip(prod, loc[0]))
        bits = bits & (bits - 1)
    for lvl in range(h):
        qj = entry(torch.full_like(r, low + lvl + 1))
        loc += [ds.cmul(loc[i], qj) for i in range(1 << lvl)]

    inv = None if perm is None else torch.from_numpy(np.argsort(np.asarray(perm)))
    out = [torch.full((k, b), float("nan")) for _ in range(4)]
    written = torch.zeros((k, b), dtype=torch.int64)
    for i, v in enumerate(loc):
        m = r + (i << low)
        row = m if inv is None else inv[m]
        re_h, re_l = ds.add(v[0], v[1], -1.0, 0.0)
        for o, val in zip(out, (re_h, re_l, v[2], v[3])):
            o[row, c] = val
        written.index_put_((row, c), torch.ones_like(row), accumulate=True)
    return tuple(out), written


@pytest.mark.parametrize("order", ["natural", "scrambled"])
@pytest.mark.parametrize("b", probe_edges.PHASE_BS)
@pytest.mark.parametrize("k", probe_edges.PHASE_KS)
def test_phase_schedule_matches_plain(k, b, order):
    n = 2 * k
    t = _exponents(n, b)
    perm = None if order == "natural" else phase_rot.scrambled_perm(k)
    got, written = phase_schedule(t, n, perm)
    assert (written == 1).all(), "an output written by no thread or by two"
    for g, w in zip(got, phase_rot.phase_minus_one_plain(t, n, perm)):
        np.testing.assert_array_equal(g.numpy().view(np.int32), w.numpy().view(np.int32))


def factors_schedule(a, n):
    """phase_factors_kernel's blocks, all at once -> ((lo, hi) 4 planes
    each, written counts of lo and hi)."""
    steps, b = a.shape
    log_k = (n // 2).bit_length() - 1
    assert log_k <= FACTOR_MAX_LOG_K and log_k + 1 <= MAX_ENTRIES
    j_half = log_k // 2

    def half(bits):  # (m, its register levels, its low indices)
        levels = min(FACTOR_LEVELS, bits)
        return bits, levels, 1 << (bits - levels)

    hl, hh = half(j_half), half(log_k - j_half)
    t = hl[2] + hh[2]
    cols = FACTOR_COLS
    while cols > 1 and b <= cols // 2:
        cols //= 2
    while cols > 1 and steps * -(-b // cols) < MIN_BLOCKS:
        cols //= 2
    assert cols * t <= FACTOR_THREADS
    col_blocks = -(-b // cols)
    nblocks = steps * col_blocks
    mask = 2 * n - 1
    tabs = phase_rot._psi_table(2 * n, torch.device("cpu"))

    # the stage: [blocks, entries, cols] per plane, the last column repeated past B
    bid = torch.arange(nblocks)
    step, c0 = bid // col_blocks, (bid % col_blocks) * cols
    col = torch.clamp(c0[:, None] + torch.arange(cols)[None, :], max=b - 1)
    ai = a[step[:, None], col] & 0xFFFFFFFF  # the kernel's uint32 a
    e = torch.arange(log_k + 1)[None, :, None]
    idx = torch.where(e == 0, ai[:, None, :], -(ai[:, None, :] << (log_k + 2 - e))) & mask
    stage = tuple(p[idx] for p in tabs)

    blk, y, x = (torch.from_numpy(v) for v in np.meshgrid(
        np.arange(nblocks), np.arange(t), np.arange(cols), indexing="ij"))
    c = c0[blk] + x
    live = c < b
    blk, y, x, c = (v[live] for v in (blk, y, x, c))
    is_hi = y >= hl[2]
    r = torch.where(is_hi, y - hl[2], y)
    q0 = torch.where(is_hi, 1 + j_half, 1)
    bits_m = torch.where(is_hi, hh[0], hl[0])
    levels = torch.where(is_hi, hh[1], hl[1])
    low = bits_m - levels

    def entry(ent):
        ent = torch.clamp(ent, max=log_k)  # a lane past its half's levels reads no entry
        return tuple(p[blk, ent, x] for p in stage)

    zero = torch.zeros(r.shape)
    seed = entry(torch.zeros_like(r))
    loc = [tuple(torch.where(is_hi, o, s) for o, s in zip((zero + 1.0, zero, zero, zero), seed))]
    bits = r.clone()
    while bool((bits != 0).any()):  # one set bit a lane an iteration, lowest first
        on = bits != 0
        j = torch.where(on, (bits & -bits).float().log2().long(), 0)
        prod = ds.cmul(loc[0], entry(q0 + j))
        loc[0] = tuple(torch.where(on, p, q) for p, q in zip(prod, loc[0]))
        bits = bits & (bits - 1)
    for lvl in range(FACTOR_LEVELS):
        qj = entry(q0 + low + lvl)
        loc += [ds.cmul(loc[i], qj) for i in range(1 << lvl)]

    step = step[blk]
    outs, written = [], []
    for (m, _, _), side in ((hl, ~is_hi), (hh, is_hi)):
        outs.append(torch.full((4, steps, 1 << m, b), float("nan")))
        written.append(torch.zeros((steps, 1 << m, b), dtype=torch.int64))
    for i, v in enumerate(loc):
        stored = i < (1 << levels)
        binr = r + (i << low)
        for h, side in enumerate((~is_hi, is_hi)):
            sel = stored & side
            at = (step[sel], binr[sel], c[sel])
            for p in range(4):
                outs[h][p][at] = v[p][sel]
            written[h].index_put_(at, torch.ones_like(at[0]), accumulate=True)
    return tuple(tuple(o.unbind(0)) for o in outs), written


FACTOR_SHAPES = [(k, b, 3) for k in (2, 4, 8, 32, 64, 1024, 2048) for b in (1, 33, 256)] + [
    (64, 1024, 5), (1024, 1024, 5)]  # the last two keep FACTOR_COLS columns a block


@pytest.mark.parametrize("k,b,steps", FACTOR_SHAPES)
def test_phase_factors_schedule_matches_plain(k, b, steps):
    n = 2 * k
    gen = torch.Generator().manual_seed(k * 1000 + b)
    a = torch.stack([probe_edges.exponents(n, b, gen) for _ in range(steps)])
    got, written = factors_schedule(a, n)
    for w in written:
        assert (w == 1).all(), "an output written by no thread or by two"
    want = phase_rot.phase_factors_all_plain(a, n)
    for g_half, w_half in zip(got, want):
        for g, w in zip(g_half, w_half):
            np.testing.assert_array_equal(g.numpy().view(np.int32), w.numpy().view(np.int32))


def fma_schedule(n, head, nvec):
    """`launch_fma_probe`'s grid over the split (head, nvec): the first
    element of each live vector (a thread's FMA_VEC vectors FMA_THREADS
    apart, in the first ceil(nvec / (FMA_THREADS·FMA_VEC)) blocks) and
    each live scalar element (4·FMA_VEC a thread, FMA_THREADS apart, in
    the blocks after them: the head, then the tail)."""
    per_vec_block, per_scalar_block = FMA_THREADS * FMA_VEC, FMA_THREADS * 4 * FMA_VEC
    vec_blocks = -(-nvec // per_vec_block)
    s = n - 4 * nvec
    scalar_blocks = -(-s // per_scalar_block)
    tid = np.arange(FMA_THREADS)
    v = (np.arange(vec_blocks)[:, None, None] * per_vec_block + tid[None, :, None]
         + np.arange(FMA_VEC)[None, None, :] * FMA_THREADS).reshape(-1)
    j = (np.arange(scalar_blocks)[:, None, None] * per_scalar_block + tid[None, :, None]
         + np.arange(4 * FMA_VEC)[None, None, :] * FMA_THREADS).reshape(-1)
    j = j[j < s]
    return head + 4 * v[v < nvec], np.where(j < head, j, j - head + head + 4 * nvec)


def _fma_ptrs(n, offsets):
    """a, b and e as CPU views at the given element offsets past 16 bytes."""
    views = []
    for o in offsets:
        buf = torch.empty(n + 4)
        assert buf.data_ptr() % 16 == 0
        views.append(buf[o:o + n])
    return views


@pytest.mark.parametrize("n", probe_edges.FMA_NS)
def test_fma_split_covers_once_and_matches_plain(n):
    gen = torch.Generator().manual_seed(n)
    a0, b0 = probe_edges.fma_operands(gen, n)
    want = [f(a0, b0) for f in (vpu_probe.fma_probe_plain, vpu_probe.fma_probe_fma_plain)]
    for offsets in probe_edges.FMA_OFFSETS:
        a, b, e = _fma_ptrs(n, offsets)
        head, nvec = vpu_probe.fma_split(a.data_ptr(), b.data_ptr(), e.data_ptr(), n)
        vec, scalar = fma_schedule(n, head, nvec)
        elems = np.concatenate([(vec[:, None] + np.arange(4)).reshape(-1), scalar])
        assert ((elems >= 0) & (elems < n)).all(), f"{offsets}: an element outside [0, n)"
        assert (np.bincount(elems, minlength=n) == 1).all(), \
            f"{offsets}: an element read and written by no thread or by two"
        for x in (a, b, e):  # each vector 16-byte aligned in every operand
            assert ((x.data_ptr() + 4 * vec) % 16 == 0).all(), f"{offsets}: a vector misaligned"
        idx = torch.from_numpy(elems)
        for plain, w in zip((vpu_probe.fma_probe_plain, vpu_probe.fma_probe_fma_plain), want):
            got = torch.full((n,), float("nan"))
            got[idx] = plain(a0[idx], b0[idx])
            assert probe_edges.same_or_nan(got, w), f"{offsets}: not the plain version"


@pytest.mark.parametrize("n", (1, 2, 3, 4, 5, 7, 4097))
def test_fma_split_path_choice(n):
    """Vectors where a, b and e share their offset from 16 bytes (a head
    bringing them to it, at most 3, then as many whole vectors as fit),
    every element scalar where they do not; the same from real views."""
    for oa, ob, oe in probe_edges.FMA_OFFSETS:
        head, nvec = vpu_probe.fma_split(64 + 4 * oa, 1024 + 4 * ob, 4096 + 4 * oe, n)
        if oa == ob == oe:
            want_head = min(n, (4 - oa) % 4)
            assert (head, nvec) == (want_head, (n - want_head) // 4)
            assert 0 <= n - head - 4 * nvec < 4
        else:
            assert (head, nvec) == (n, 0)
        a, b, e = _fma_ptrs(n, (oa, ob, oe))
        assert vpu_probe.fma_split(a.data_ptr(), b.data_ptr(), e.data_ptr(), n) == (head, nvec)


def test_fma_wrapper_out_on_cpu():
    """On CPU tensors the wrappers run their plain versions, into `out` if
    given (the view check_fma writes through)."""
    gen = torch.Generator().manual_seed(3)
    a, b = probe_edges.fma_operands(gen, 129)
    for kernel, plain in ((vpu_probe.fma_probe, vpu_probe.fma_probe_plain),
                          (vpu_probe.fma_probe_fma, vpu_probe.fma_probe_fma_plain)):
        out = probe_edges.at_offset(torch.zeros(129), 3)
        got = kernel(a, b, out)
        assert got.data_ptr() == out.data_ptr()
        assert probe_edges.same_or_nan(got, plain(a, b))


def test_per_call_device_counts_kept_events():
    """A port kernel's time is the mean of the events kept times the
    launches counted (a dropped event does not read low), its shortfall
    reported; PyTorch's kernels are summed as kept."""
    by_name = {"phase_kernel<2, 16>": [0.049 * 4.0, 49], "elementwise_kernel": [0.5, 10],
               "mad_horner_kernel<2, 3>": [1.0, 50], "mad_horner_kernel<2, 2>": [1.0, 50]}
    launches = {"phase_minus_one": 50, "mad_horner": 50, "mad_horner_g2": 50}
    got = per_call_device(by_name, launches, 50)
    assert got["events_short"] == {"phase_kernel": 1}
    assert got["kernel_us"]["phase_kernel"] == pytest.approx(4.0)
    assert got["kernel_us"]["mad_horner_kernel"] == pytest.approx(20.0)
    assert got["device_us"] == pytest.approx((0.2 + 0.5 + 2.0) * 1e3 / 50)
    full = per_call_device({**by_name, "phase_kernel<2, 16>": [0.2, 50]}, launches, 50)
    assert full["events_short"] == {} and full["device_us"] == pytest.approx(got["device_us"])
    with pytest.raises(RuntimeError):
        per_call_device({}, {"roll": 1}, 1)


def test_time_calls_profiles_again_when_events_drop(monkeypatch):
    """`time_calls` profiles another window while the profiler kept no event
    of a port kernel that launched, and raises after PROFILE_TRIES such
    windows."""
    import spf_tpu_torch.scripts as sc

    monkeypatch.setattr(sc.torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(sc, "launches_since", lambda before: {"roll": 4})
    windows = iter([{}, {"roll_kernel": [0.02, 4]}])
    monkeypatch.setattr(sc, "profiled_kernels", lambda fn: next(windows))
    got = sc.time_calls(lambda: None, 4)
    assert got["profiled_windows"] == 2
    assert got["kernel_us"] == {"roll_kernel": pytest.approx(5.0)}
    monkeypatch.setattr(sc, "profiled_kernels", lambda fn: {})
    with pytest.raises(sc.EventsDropped):
        sc.time_calls(lambda: None, 4)
