"""The frequency-domain MAD of a blind-rotation step, with or without
Horner subset phases.

Port of `spf_tpu/ops/mad_pallas.py::mad_horner_fused`. Per group t it
evaluates

    prod_f = sum_S (prod_{j in S} u_j) (x) MAD(dfft, BSK[t, S])

over the 2^g - 1 nonempty subsets S, with the sum Horner-factored
(`nested_subset_sum`). Everything is elementwise in (K, B). The kernel
(`csrc/mad.cu`) keeps the reference's order of evaluation, so it agrees
with the plain version (`freq_mad_plain` per subset +
`nested_subset_sum`) bit for bit, at any K and B. The kernel is built for
g = 3 (the multi-bit PBS), g = 2 (the rotation inside circuit
bootstrapping) and g = 1 (the single-bit phase_rot step, where it is
exactly `cmul(freq_mad(..), pm1)`, `bootstrap_u32.py:278-280`), and its
g = 0 instance is `freq_mad`: the MAD of one key row with no phase
(`bootstrap_u32.freq_mad`, XLA glue on the TPU), the frequency-domain
half of the single-bit plain and fuse_rot steps.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..kernels.build import check_cuda, dispatch, stream_of
from . import ds

MAD_KP1 = (2,)  # the k + 1 the kernel is built for (csrc/mad.cu); g: kernels.MAD_BY_GROUP


def freq_mad_plain(dfft, ggsw_row):
    """Frequency-domain MAD: digit spectra [l, k+1, K, B] x one GGSW row
    [k+1, l, k+1, K], or a batched row [k+1, l, k+1, K, B] (a GGSW per
    batch column, as circuit bootstrapping makes them) -> 4 planes
    [k+1, K, B] (≙ `bootstrap_u32.freq_mad`, same order of accumulation)."""
    l, kp1 = dfft[0].shape[:2]
    shape = (kp1, *dfft[0].shape[2:])
    batched = ggsw_row[0].dim() == 5
    acc = tuple(torch.zeros(shape, dtype=torch.float32, device=dfft[0].device) for _ in range(4))
    for i in range(kp1):
        for j in range(l):
            d = tuple(c[j, i][None] for c in dfft)  # [1, K, B]
            # [k+1, K, B] or [k+1, K, 1]
            g = tuple(c[i, j] if batched else c[i, j][..., None] for c in ggsw_row)
            acc = ds.cadd(acc, ds.cmul(d, g))
    return acc


def nested_subset_sum(mads, u, group: int):
    """Horner-factored sum_S (prod_{j in S} u_j) (x) mads[S - 1] over the
    nonempty subsets S of {0..g-1}:

        R(j, base) = u_j (x) (M[base|2^j] + R(j+1, base|2^j)) + R(j+1, base)
    """

    def rec(j, base):
        if j == group:
            return None
        with_j = base | (1 << j)
        inner = rec(j + 1, with_j)
        t = mads[with_j - 1] if inner is None else ds.cadd(mads[with_j - 1], inner)
        term = ds.cmul(t, u[j])
        rest = rec(j + 1, base)
        return term if rest is None else ds.cadd(term, rest)

    return rec(0, 0)


def mad_horner_plain(dfft, row, u, group: int):
    """dfft: 4 planes [l, k+1, K, B]; row: 4 planes [2^g-1, k+1, l, k+1, K];
    u: 4 planes [g, K, B] (per-bit phase-minus-one factors) -> 4 planes
    [k+1, K, B]."""
    ns = row[0].shape[0]
    mads = [freq_mad_plain(dfft, tuple(c[m] for c in row)) for m in range(ns)]
    u_list = [tuple(c[j] for c in u) for j in range(group)]
    return nested_subset_sum(mads, u_list, group)


def _mad_cuda(dfft, row, u, group):
    """The kernel's g-instance; row [2^g-1, k+1, l, k+1, K] for g >= 1,
    [k+1, l, k+1, K] for g = 0 (u unread)."""
    kernel = kernels.MAD_BY_GROUP.get(group)
    l, kp1, k_, b = dfft[0].shape
    ns = (1 << group) - 1
    if kp1 not in MAD_KP1 or kernel is None:
        raise ValueError(f"mad_horner: no kernel for k+1 = {kp1}, g = {group}")
    want_row = (kp1, l, kp1, k_) if group == 0 else (ns, kp1, l, kp1, k_)
    if tuple(row[0].shape) != want_row or (group and tuple(u[0].shape) != (group, k_, b)):
        raise ValueError(f"mad_horner: shapes {dfft[0].shape}, {row[0].shape}, "
                         f"{None if u is None else u[0].shape} for g = {group}")
    dfft, row = ([c.contiguous() for c in x] for x in (dfft, row))
    u = dfft if group == 0 else [c.contiguous() for c in u]  # g = 0: never read
    check_cuda("mad_horner", *dfft, *row, *u)
    if k_ * b >= 1 << 31:
        raise ValueError("mad_horner: too many elements for one launch")
    out = [torch.empty((kp1, k_, b), dtype=torch.float32, device=dfft[0].device) for _ in range(4)]
    kernel(
        *(c.data_ptr() for c in (*dfft, *row, *u, *out)),
        kp1, l, group, k_, b, stream_of(dfft[0]),
    )
    return tuple(out)


def mad_horner(dfft, row, u, group: int):
    """The CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    if group < 1:
        raise ValueError(f"mad_horner: group {group} < 1 (freq_mad is the g = 0 MAD)")
    return dispatch("mad_horner", dfft[0], _mad_cuda, mad_horner_plain,
                    dfft, row, u, group)


def freq_mad(dfft, ggsw_row):
    """The MAD of digit spectra [l, k+1, K, B] with one key row [k+1, l,
    k+1, K]: the kernel's g = 0 instance on CUDA tensors, `freq_mad_plain`
    on CPU tensors."""
    return dispatch("freq_mad", dfft[0], lambda d, r: _mad_cuda(d, r, None, 0),
                    freq_mad_plain, dfft, ggsw_row)
