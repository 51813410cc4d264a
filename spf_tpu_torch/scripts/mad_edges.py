"""The edge shapes of `csrc/mad.cu`'s tiled kernels, held bit for bit on a
CUDA card against their plain versions.

`mad_batched_kernel` (`ops.mad.freq_mad_batched`) is 8 bins x 32 columns
a block, each column's row read at its slot; `ops.mad.mad_horner` /
`freq_mad` at k + 1 != 2 run `mad_planes_kernel` (a bin and 32-128
columns a block, the column tile chosen by B) or `mad_plane_kernel` (one
plane and up to 128 columns a block), chosen by g, k + 1 and B. The
shapes below are those a tiled design can break:

- the batched-row MAD at [l = 4, k + 1 = 2, K = 1024] over a slot buffer
  of 256 GGSWs at B = 1, 31, 33, 62 and 255; every column on one slot; a
  slot of -1 and one of `nslots` among valid ones (their columns NaN);
  K = 32, 64, 128 and 40 (no bin tile divides it) with ragged B; k + 1 =
  3, 4 and 6 at K = 128, l = 2 and 4, B = 33 and 62; each in both layouts (a slot buffer
  [S, k+1, l, k+1, K] with slots, a batched row [k+1, l, k+1, K, S] with
  and without slots);
- the MAD at k + 1 = 3, 4, 6 and each g in 0..3 at [l = 2, K = 128] with
  B = 1, 8, 129 and 256 (each column tile and both kernels); also l = 4,
  K = 32, B = 33 and 256 (above 48 KB of shared memory at k + 1 = 6).

`check(gen)` runs them all on the generator's device and returns
{"checked": n, "not_bitexact": [labels]} (`check_batched`, `check_plane`
one kernel's); `chip_smoke.py` phase 3 and `kernel_ab --source mad
--check` call them with a CUDA generator (on CPU tensors the wrappers run
their plain versions).
"""

from __future__ import annotations

import torch

from ..ops import mad

BATCHED_SLOTS = 256


def spectrum(gen, shape, exp):
    """4 random f32 planes of a ds32 complex spectrum of magnitude 2^exp."""
    out = []
    for _ in range(2):
        hi = torch.randn(shape, generator=gen, device=gen.device) * 2.0**exp
        out += [hi, hi * torch.randn(shape, generator=gen, device=gen.device) * 2.0**-25]
    return tuple(out)


def batched_plain(dfft, rows, slots=None, slot_axis: int = -1):
    """`freq_mad_batched_plain`, with NaN outputs for a column whose slot
    lies outside [0, nslots), as the kernel defines them."""
    if slots is None:
        return mad.freq_mad_batched_plain(dfft, rows, slots, slot_axis)
    bad = (slots < 0) | (slots >= rows[0].shape[slot_axis])
    out = mad.freq_mad_batched_plain(dfft, rows, torch.where(bad, 0, slots), slot_axis)
    return tuple(o.masked_fill(bad, float("nan")) for o in out)


def batched_cases(gen):
    """(label, args of freq_mad_batched) at the edge shapes."""
    cases = []

    every_layout = ("slot buffer", "batched row", "batched row, slots")

    def add(label, kp1, l, k, b, slots_of, layouts=every_layout):
        d = spectrum(gen, (l, kp1, k, b), 20)
        for layout in layouts:
            n = BATCHED_SLOTS if layout != "batched row" else b
            if layout == "slot buffer":
                rows, axis = spectrum(gen, (n, kp1, l, kp1, k), 60), 0
            else:
                rows, axis = spectrum(gen, (kp1, l, kp1, k, n), 60), -1
            slots = None if layout == "batched row" else slots_of(n, b)
            cases.append((f"{label} {layout} k+1={kp1} l={l} K={k} B={b}", (d, rows, slots, axis)))

    def rand(n, b):
        return torch.randint(0, n, (b,), generator=gen, device=gen.device, dtype=torch.int32)

    def one(n, b):
        return torch.full((b,), n // 3, device=gen.device, dtype=torch.int32)

    def outside(n, b):
        s = rand(n, b)
        s[b // 4], s[(3 * b) // 4] = -1, n
        return s

    for b in (1, 31, 33, 62, 255):
        add("width", 2, 4, 1024, b, rand, ("slot buffer",))
    add("one slot", 2, 4, 1024, 256, one, ("slot buffer", "batched row, slots"))
    add("slots outside", 2, 4, 1024, 62, outside, ("slot buffer", "batched row, slots"))
    for k in (32, 64, 128, 40):
        for b in (33, 48, 62):
            add("bins", 2, 4, k, b, rand)
    for kp1 in (3, 4, 6):
        for l in (2, 4):
            for b in (33, 62):
                add("k+1", kp1, l, 128, b, rand)
    return cases


def plane_cases(gen):
    """(label, group, args of mad_horner / freq_mad) at the per-plane edges."""
    cases = []
    for kp1 in (3, 4, 6):
        for group in range(4):
            ns = max(1, (1 << group) - 1)
            for l, k, klo, bs in ((2, 128, 16, (1, 8, 129, 256)), (4, 32, 8, (33, 256))):
                for b in bs:
                    d = spectrum(gen, (l, kp1, k, b), 20)
                    row_shape = (kp1, l, kp1, k) if group == 0 else (ns, kp1, l, kp1, k)
                    args = (d, spectrum(gen, row_shape, 60))
                    if group:
                        args += ((spectrum(gen, (group, klo, b), 0),
                                  spectrum(gen, (group, k // klo, b), 0)),)
                    cases.append((f"plane g={group} k+1={kp1} l={l} K={k} B={b}", group, args))
    return cases


def _same(got, want) -> bool:
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want))


def check_batched(gen) -> dict:
    """The batched-row MAD at every edge shape, kernel against plain
    version, bit for bit (NaN bits included): {"checked": n,
    "not_bitexact": [labels]}."""
    cases = batched_cases(gen)
    bad = [label for label, args in cases
           if not _same(mad.freq_mad_batched(*args), batched_plain(*args))]
    return dict(checked=len(cases), not_bitexact=bad)


def check_plane(gen, group: int) -> dict:
    """The per-plane MAD's g-instance at every edge shape, as check_batched."""
    cases = [(label, args) for label, g, args in plane_cases(gen) if g == group]
    bad = []
    for label, args in cases:
        if group == 0:
            got, want = mad.freq_mad(*args), mad.freq_mad_plain(*args)
        else:
            got = mad.mad_horner(*args, group)
            want = mad.mad_horner_combine_plain(*args, group)
        if not _same(got, want):
            bad.append(label)
    return dict(checked=len(cases), not_bitexact=bad)


def check(gen) -> dict:
    """Every edge shape of both kernels."""
    res = [check_batched(gen)] + [check_plane(gen, g) for g in range(4)]
    return dict(checked=sum(r["checked"] for r in res),
                not_bitexact=[label for r in res for label in r["not_bitexact"]])
