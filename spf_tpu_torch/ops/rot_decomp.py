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

and the coefficient-domain halves of circuit bootstrapping's GLWE
keyswitch (`ops/cbs.py`), each with its plain version too:

- `ks_decompose`: the digits of GLWE masks, or of their images under a
  trace round's automorphism X -> X^k, read in place;
- `ks_round_add`: the keyswitch's output from the inverse FFT's ds pair
  (rounded, negated, b added), and in a trace round its sum with the
  round's ciphertext.

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


def _mapped(x, table):
    """x [..., N, B] under a trace round's automorphism: row d is x's row
    src[d], negated where neg[d]; x itself for table None."""
    if table is None:
        return x
    src, neg = table
    x = x[..., src, :]
    return torch.where(neg[:, None], -x, x)


def ks_decompose_plain(masks, radix: RadixDecomposition, table=None):
    """masks int64 [..., N, B] (a GLWE mask [k, N, B], or masks [L, k, N, B])
    -> digits f32 [count, ..., N, B] of the masks, or with table = (src int64
    [N], neg bool [N]) of their images under a trace round's automorphism."""
    return torus.decompose(_mapped(masks, table), radix).to(torch.float32)


def ks_round_add_plain(prod, ct, table=None, accumulate: bool = True):
    """prod: the inverse FFT's ds pair f32 [k+1, N, B] of a keyswitch product;
    ct int64 [k+1, N, B] -> the keyswitch of ct (of its image under `table`):
    −round(prod), plus b on row k; with `accumulate`, ct plus that."""
    out = torus.neg(torus.from_ds(*prod))
    out[-1] = torus.add(out[-1], _mapped(ct[-1], table))
    return torus.add(ct, out) if accumulate else out


def _check_table(name, x, table, n):
    """The contiguous (src, neg) of a trace round on x's device, or None."""
    if table is None:
        return None
    src, neg = (t.contiguous() for t in table)
    check_cuda(name, src, neg, dtype=None)
    if src.device != x.device:
        raise ValueError(f"{name}: table on {src.device}, data on {x.device}")
    if src.dtype != torch.int64 or neg.dtype != torch.bool:
        raise TypeError(f"{name}: table dtypes {src.dtype}, {neg.dtype}, want int64, bool")
    if tuple(src.shape) != (n,) or tuple(neg.shape) != (n,):
        raise ValueError(f"{name}: table shapes {tuple(src.shape)}, {tuple(neg.shape)}, "
                         f"want ({n},)")
    return src, neg


def _ptrs(table):
    return (None, None) if table is None else tuple(t.data_ptr() for t in table)


def _ks_decompose_cuda(masks, radix, table=None):
    if masks.dim() not in (3, 4):
        raise ValueError(f"ks_decompose: masks {tuple(masks.shape)}, want [(L,) k, N, B]")
    m4 = masks if masks.dim() == 4 else masks[None]
    lead, r, n, b = m4.shape
    inner = r * n * b
    # blocks of [k, N, B] contiguous, any stride between them
    if m4.stride()[1:] != (n * b, b, 1) or (lead > 1 and m4.stride(0) < inner):
        m4 = m4.contiguous()
    stride = m4.stride(0) if lead > 1 else inner
    check_cuda("ks_decompose", m4[0], dtype=torch.int64)  # the current device, int64
    table = _check_table("ks_decompose", m4, table, n)
    if radix.count * radix.radix_log > TORUS_BITS or radix.radix_log > 31:
        raise ValueError(f"ks_decompose: unsupported radix {radix}")
    e = lead * inner
    if e >= 1 << 31:
        raise ValueError("ks_decompose: too many elements for one launch")
    digits = torch.empty((radix.count, *masks.shape), dtype=torch.float32, device=masks.device)
    kernels.KS_DECOMPOSE(
        m4.data_ptr(), *_ptrs(table), digits.data_ptr(), e, inner, stride, n, b,
        radix.count, radix.radix_log, stream_of(masks),
    )
    return digits


def _ks_round_add_cuda(prod, ct, table=None, accumulate=True):
    ct = ct.contiguous()
    ph, pl = (c.contiguous() for c in prod)
    check_cuda("ks_round_add", ct, ph, pl, dtype=None)
    check_cuda("ks_round_add", ct, dtype=torch.int64)
    check_cuda("ks_round_add", ph, pl)
    if ct.dim() != 3 or ph.shape != ct.shape or pl.shape != ct.shape:
        raise ValueError(f"ks_round_add: ct {tuple(ct.shape)}, prod {tuple(ph.shape)}, "
                         f"{tuple(pl.shape)}, want one shape [k+1, N, B]")
    _, n, b = ct.shape
    table = _check_table("ks_round_add", ct, table, n)
    if ct.numel() >= 1 << 31:
        raise ValueError("ks_round_add: too many elements for one launch")
    out = torch.empty_like(ct)
    kernels.KS_ROUND_ADD(
        ct.data_ptr(), ph.data_ptr(), pl.data_ptr(), *_ptrs(table), out.data_ptr(), ct.numel(),
        n, b, int(accumulate), stream_of(ct),
    )
    return out


def ks_decompose(masks, radix: RadixDecomposition, table=None):
    """The CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    return dispatch("ks_decompose", masks, _ks_decompose_cuda, ks_decompose_plain, masks, radix,
                    table)


def ks_round_add(prod, ct, table=None, accumulate: bool = True):
    """The CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    return dispatch("ks_round_add", ct, _ks_round_add_cuda, ks_round_add_plain, prod, ct, table,
                    accumulate)
