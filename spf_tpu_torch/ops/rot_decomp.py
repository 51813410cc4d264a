"""Accumulate and decompose: the coefficient-domain half of a
phase-rotation blind-rotation step.

Port of `spf_tpu/ops/rot_decomp_pallas.py::accumulate_decompose`: fold the
previous step's inverse-FFT output (a ds f32 pair) into the torus
accumulator, rounding it mod 2^64, and emit the signed gadget digits of
the new accumulator as f32 planes [count, k+1, N, B]. Integer-exact: the
kernel (`csrc/rot_decomp.cu`) and the plain version agree bit for bit.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..kernels.build import check_cuda, dispatch, stream_of
from ..params import TORUS_BITS, RadixDecomposition
from . import torus


def accumulate_decompose_plain(acc, prod, radix: RadixDecomposition):
    """acc int64 [k+1, N, B], prod ds pair of f32 [k+1, N, B] ->
    (digits f32 [count, k+1, N, B], new acc)."""
    acc = torus.add(acc, torus.from_ds(*prod))
    return torus.decompose(acc, radix).to(torch.float32), acc


def _accumulate_decompose_cuda(acc, prod, radix):
    ph, pl = (c.contiguous() for c in prod)
    acc = acc.contiguous()
    check_cuda("accumulate_decompose", ph, pl)
    check_cuda("accumulate_decompose", acc, dtype=torch.int64)
    if acc.shape != ph.shape or ph.shape != pl.shape or acc.device != ph.device:
        raise ValueError(f"accumulate_decompose: shapes {acc.shape}, {ph.shape}, {pl.shape}")
    if radix.count * radix.radix_log > TORUS_BITS or radix.radix_log > 31:
        raise ValueError(f"accumulate_decompose: unsupported radix {radix}")
    e = acc.numel()
    if e >= 1 << 31:
        raise ValueError("accumulate_decompose: too many elements for one launch")
    acc_out = torch.empty_like(acc)
    digits = torch.empty((radix.count, *acc.shape), dtype=torch.float32, device=acc.device)
    kernels.ACCUMULATE_DECOMPOSE(
        acc.data_ptr(), ph.data_ptr(), pl.data_ptr(), acc_out.data_ptr(),
        digits.data_ptr(), e, radix.count, radix.radix_log, stream_of(acc),
    )
    return digits, acc_out


def accumulate_decompose(acc, prod, radix: RadixDecomposition):
    """The CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    return dispatch("accumulate_decompose", acc, _accumulate_decompose_cuda,
                    accumulate_decompose_plain, acc, prod, radix)
