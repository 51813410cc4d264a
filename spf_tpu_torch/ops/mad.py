"""Multi-bit MAD + Horner subset phases: the frequency-domain half of a
multi-bit blind-rotation step.

Port of `spf_tpu/ops/mad_pallas.py::mad_horner_fused`. Per group t it
evaluates

    prod_f = sum_S (prod_{j in S} u_j) (x) MAD(dfft, BSK[t, S])

over the 2^g - 1 nonempty subsets S, with the sum Horner-factored
(`nested_subset_sum`). Everything is elementwise in (K, B). The kernel
(`csrc/mad.cu`) keeps the reference's order of evaluation, so it agrees
with the plain version (`freq_mad` per subset + `nested_subset_sum`) bit
for bit, at any K and B.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..kernels.build import check_cuda, dispatch, stream_of
from . import ds
from .bootstrap import freq_mad

MAD_KP1 = (2,)  # the k + 1 and g the kernel is built for (csrc/mad.cu)
MAD_GROUPS = (3,)


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
    mads = [freq_mad(dfft, tuple(c[m] for c in row)) for m in range(ns)]
    u_list = [tuple(c[j] for c in u) for j in range(group)]
    return nested_subset_sum(mads, u_list, group)


def _mad_horner_cuda(dfft, row, u, group):
    l, kp1, k_, b = dfft[0].shape
    ns = (1 << group) - 1
    if kp1 not in MAD_KP1 or group not in MAD_GROUPS:
        raise ValueError(f"mad_horner: no kernel for k+1 = {kp1}, g = {group}")
    if tuple(row[0].shape) != (ns, kp1, l, kp1, k_) or tuple(u[0].shape) != (group, k_, b):
        raise ValueError(f"mad_horner: shapes {dfft[0].shape}, {row[0].shape}, {u[0].shape}")
    dfft, row, u = ([c.contiguous() for c in x] for x in (dfft, row, u))
    check_cuda("mad_horner", *dfft, *row, *u)
    if k_ * b >= 1 << 31:
        raise ValueError("mad_horner: too many elements for one launch")
    out = [torch.empty((kp1, k_, b), dtype=torch.float32, device=dfft[0].device) for _ in range(4)]
    kernels.MAD_HORNER(
        *(c.data_ptr() for c in (*dfft, *row, *u, *out)),
        kp1, l, group, k_, b, stream_of(dfft[0]),
    )
    return tuple(out)


def mad_horner(dfft, row, u, group: int):
    """The CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    return dispatch("mad_horner", dfft[0], _mad_horner_cuda, mad_horner_plain,
                    dfft, row, u, group)
