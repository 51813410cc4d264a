"""The coefficient-domain half of a blind-rotation step: accumulate,
rotate and decompose.

Port of `spf_tpu/ops/rot_decomp_pallas.py`, three entry points, each with
its plain version:

- `accumulate_decompose` (the phase-rotation steps): fold the previous
  step's inverse-FFT output (a ds f32 pair) into the torus accumulator,
  rounding it mod 2^64, and emit the signed gadget digits of the new
  accumulator;
- `rotate_sub_decompose` (the single-bit plain step): the digits of
  acc·X^t − acc, t per batch column;
- `rotate_sub_decompose_acc` (the single-bit fuse_rot step): accumulate
  as above, then the digits of acc'·X^t − acc'.

Digits are f32 planes [count, k+1, N, B]. Integer-exact: the kernels
(`csrc/rot_decomp.cu`) and the plain versions agree bit for bit. Unlike
the TPU kernels, which pad the batch to 128 lanes, they take any B.
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


def rotate_sub_decompose_plain(acc, t, radix: RadixDecomposition):
    """acc int64 [k+1, N, B], t int64 [B] -> digits f32 [count, k+1, N, B]
    of acc·X^t − acc."""
    diff = torus.sub(torus.monomial_mul(acc, t), acc)
    return torus.decompose(diff, radix).to(torch.float32)


def rotate_sub_decompose_acc_plain(acc, prod, t, radix: RadixDecomposition):
    """acc' = acc + round(prod), then (digits of acc'·X^t − acc', acc')."""
    acc = torus.add(acc, torus.from_ds(*prod))
    return rotate_sub_decompose_plain(acc, t, radix), acc


def _check(name, acc, radix, prod=(), t=None):
    ts = () if t is None else (t,)
    check_cuda(name, acc, *prod, *ts, dtype=None)  # one device, contiguous
    check_cuda(name, acc, *ts, dtype=torch.int64)
    if prod:
        check_cuda(name, *prod)
    if any(p.shape != acc.shape for p in prod):
        raise ValueError(f"{name}: shapes {tuple(acc.shape)}, {[tuple(p.shape) for p in prod]}")
    if t is not None and (acc.dim() < 2 or tuple(t.shape) != (acc.shape[-1],)):
        raise ValueError(f"{name}: t shape {tuple(t.shape)} for acc {tuple(acc.shape)}")
    if radix.count * radix.radix_log > TORUS_BITS or radix.radix_log > 31:
        raise ValueError(f"{name}: unsupported radix {radix}")
    if acc.numel() >= 1 << 31:
        raise ValueError(f"{name}: too many elements for one launch")


def _accumulate_decompose_cuda(acc, prod, radix):
    acc = acc.contiguous()
    ph, pl = (c.contiguous() for c in prod)
    _check("accumulate_decompose", acc, radix, prod=(ph, pl))
    acc_out = torch.empty_like(acc)
    digits = torch.empty((radix.count, *acc.shape), dtype=torch.float32, device=acc.device)
    kernels.ACCUMULATE_DECOMPOSE(
        acc.data_ptr(), ph.data_ptr(), pl.data_ptr(), acc_out.data_ptr(),
        digits.data_ptr(), acc.numel(), radix.count, radix.radix_log, stream_of(acc),
    )
    return digits, acc_out


def _rotate_sub_decompose_cuda(acc, t, radix):
    acc, t = acc.contiguous(), t.contiguous()
    _check("rotate_sub_decompose", acc, radix, t=t)
    n, b = acc.shape[-2:]
    digits = torch.empty((radix.count, *acc.shape), dtype=torch.float32, device=acc.device)
    kernels.ROTATE_SUB_DECOMPOSE(
        acc.data_ptr(), t.data_ptr(), digits.data_ptr(), acc.numel(), n, b,
        radix.count, radix.radix_log, stream_of(acc),
    )
    return digits


def _rotate_sub_decompose_acc_cuda(acc, prod, t, radix):
    acc, t = acc.contiguous(), t.contiguous()
    ph, pl = (c.contiguous() for c in prod)
    _check("rotate_sub_decompose_acc", acc, radix, prod=(ph, pl), t=t)
    n, b = acc.shape[-2:]
    acc_out = torch.empty_like(acc)
    digits = torch.empty((radix.count, *acc.shape), dtype=torch.float32, device=acc.device)
    kernels.ROTATE_SUB_DECOMPOSE_ACC(
        acc.data_ptr(), ph.data_ptr(), pl.data_ptr(), t.data_ptr(), acc_out.data_ptr(),
        digits.data_ptr(), acc.numel(), n, b, radix.count, radix.radix_log, stream_of(acc),
    )
    return digits, acc_out


def accumulate_decompose(acc, prod, radix: RadixDecomposition):
    """The CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    return dispatch("accumulate_decompose", acc, _accumulate_decompose_cuda,
                    accumulate_decompose_plain, acc, prod, radix)


def rotate_sub_decompose(acc, t, radix: RadixDecomposition):
    """The CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    return dispatch("rotate_sub_decompose", acc, _rotate_sub_decompose_cuda,
                    rotate_sub_decompose_plain, acc, t, radix)


def rotate_sub_decompose_acc(acc, prod, t, radix: RadixDecomposition):
    """The CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    return dispatch("rotate_sub_decompose_acc", acc, _rotate_sub_decompose_acc_cuda,
                    rotate_sub_decompose_acc_plain, acc, prod, t, radix)
