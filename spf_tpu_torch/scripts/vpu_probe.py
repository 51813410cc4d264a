"""Probe the card's raw rates: the port's counterpart of
`scripts/vpu_probe.py`.

    python -m spf_tpu_torch.scripts.vpu_probe

Sections, each probe one JSON line with its rate and its time:

1. f32 chains: ITERS = 400 dependent element-wise steps on [R, C] =
   [1024, 512], resident on chip (`chain`, `csrc/probe.cu`): mul, add,
   mul+add, 2mul+1add, mul/select. Rate = R·C·ITERS·ops per step / time
   (the script's count of ops per step), against the card's peak rate for
   the body: the instructions of one step (`BODIES`' mix) on the pipes
   that can take them (`scripts.steps_per_clock`).
2. The fma question: e = a·b − p with p = a·b. `fma_probe` as written
   (no contraction: 0 everywhere) and `fma_probe_fma`, __fmaf_rn(a, b, -p)
   (the exact error term), each counted as the script counts: nonzero,
   and equal (np.isclose) to the f64 error; plus the count that equals the
   f64 error cast to f32 bit for bit. The script's XLA variant is the plain
   PyTorch `a*b - p`.
3. i32 chains: mul, add, mul+add, shift, and, "fermat", against the
   card's peak rate for each body, as in section 1.
4. Matrix products (XLA outside any kernel in the script; plain
   `torch.matmul` here): 50 products accumulated, as the script's loop.
   bf16 -> f32 (PyTorch's bf16 product returns bf16, accumulated in f32
   inside the library, and is widened after); f32 with TF32 off; int8 ->
   int32 through `torch._int_mm`, which takes 2-D operands only, so a
   batched int8 product is a loop over the batch. Rates against the data
   sheet's dense tensor-core peaks (bf16 989, int8 1979 T/s) and its f32
   peak outside the tensor cores (67 TFLOP/s).
5. `roll`: ITERS steps of roll(v, 8, axis=0) + 1.0, against the card's
   peak rate for its adds.

Each kernel's wrapper runs the kernel on CUDA tensors and its plain
version (here) on CPU tensors. A chain whose rate is above the card's
peak for its body was folded by the compiler: the kernel emits each
integer op as its own gated PTX op to stop that (`csrc/probe.cu`),
`chip_smoke.py` counts each chain kernel's SASS opcodes and fails on a
chain above its peak. Times are device times (CUDA events, the calls
queued behind a spin kernel).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import kernels
from ..kernels.build import check_cuda, dispatch, stream_of
from ..ops import torus
from . import card, chain_peak_per_s, device_ms, emit

R, C = 1024, 512
ITERS = 400
ROLL_SHIFT = 8

# the f32 roundings of the script's Python floats (JAX's weak typing)
C1 = float(np.float32(1.000001))
C2 = float(np.float32(0.0000001))
C3 = float(np.float32(0.0000002))

# name: (one step of the chain, the script's count of ops per step, the
# instructions of one step by class, `scripts.steps_per_clock`); the
# kernel's body index is the position in this dict (csrc/probe.cu). The
# select of mul/select is a predicate on the mul and the add (its SASS has
# FSETP, FMUL, FADD and no FSEL); fermat is and, shift, mul, sub, add.
BODIES = {
    "f32 mul chain": (lambda v: v * C1, 1, {"fma": 1}),
    "f32 add chain": (lambda v: v + C2, 1, {"fma": 1}),
    "f32 mul+add chain": (lambda v: v * C1 + C2, 2, {"fma": 2}),
    "f32 2mul+1add (ILP)": (lambda v: (v * C1) + (v * C3), 3, {"fma": 3}),
    "f32 mul/select chain": (lambda v: torch.where(v > 0, v * C1, v + C2), 2,
                             {"fma": 2, "alu": 1}),
    "i32 mul chain": (lambda v: v * 3, 1, {"imad": 1}),
    "i32 add chain": (lambda v: v + 3, 1, {"iadd": 1}),
    "i32 mul+add chain": (lambda v: (v * 3) + 3, 2, {"imad": 1, "iadd": 1}),
    "i32 shift chain": (lambda v: v >> 16, 1, {"alu": 1}),
    "i32 and chain": (lambda v: v & 0xFFFF, 1, {"alu": 1}),
    "i32 fermat modmul-ish": (lambda v: (v & 0xFFFF) - (v >> 16) + (v * 3), 4,
                              {"alu": 2, "imad": 1, "iadd": 2}),
}
ROLL_MIX = {"fma": 1}  # its adds; a roll by 8 of a column can be a renaming
F32_BODIES = tuple(b for b in BODIES if b.startswith("f32"))


def chain_plain(x: torch.Tensor, body: str, iters: int = ITERS) -> torch.Tensor:
    step = BODIES[body][0]
    for _ in range(iters):
        x = step(x)
    return x


def _chain_cuda(x, body, iters):
    dtype = torch.float32 if body in F32_BODIES else torch.int32
    x = x.contiguous()
    check_cuda("chain", x, dtype=dtype)
    if x.numel() >= 1 << 31:
        raise ValueError("chain: too many elements for one launch")
    out = torch.empty_like(x)
    kernels.CHAIN(x.data_ptr(), out.data_ptr(), x.numel(), iters, list(BODIES).index(body),
                  stream_of(x))
    return out


def chain(x: torch.Tensor, body: str, iters: int = ITERS) -> torch.Tensor:
    """`iters` dependent steps of `body` on every element of x (f32 for
    the f32 bodies, int32 for the i32 ones, which wrap)."""
    return dispatch("chain", x, _chain_cuda, chain_plain, x, body, iters)


def _into(out, e):
    if out is None:
        return e
    out.copy_(e)
    return out


def fma_probe_plain(a, b, out=None):
    p = a * b
    return _into(out, a * b - p)


def fma_probe_fma_plain(a, b, out=None):
    """The exact error of the product a·b: (f64(a)·f64(b) − f64(p)) in
    f32, rounded once (`fma`'s single rounding, subnormals included)."""
    p = a * b
    return _into(out, (a.double() * b.double() - p.double()).float())


FMA_VECTOR = 16  # bytes of the kernel's vector loads and stores


def fma_split(ptr_a: int, ptr_b: int, ptr_e: int, n: int) -> tuple:
    """How `fma_probe`'s kernel splits n f32 elements, from the three
    addresses: (head, nvec). Where a, b and e sit at one offset from a
    16-byte boundary, a scalar head of up to 3 elements brings them to it
    and nvec 16-byte vectors follow (then a scalar tail of n − head −
    4·nvec < 4); where their offsets differ, every element is scalar:
    (n, 0)."""
    offsets = {p % FMA_VECTOR for p in (ptr_a, ptr_b, ptr_e)}
    if len(offsets) != 1:
        return n, 0
    head = min(n, (FMA_VECTOR - offsets.pop()) % FMA_VECTOR // 4)
    return head, (n - head) // 4


def _fma_cuda(kernel, name):
    def run(a, b, out=None):
        a, b = a.contiguous(), b.contiguous()
        e = torch.empty_like(a) if out is None else out
        check_cuda(name, a, b, e)
        if a.shape != b.shape or e.shape != a.shape or a.numel() >= 1 << 31:
            raise ValueError(f"{name}: shapes {tuple(a.shape)}, {tuple(b.shape)}, "
                             f"{tuple(e.shape)}")
        n = a.numel()
        kernel(a.data_ptr(), b.data_ptr(), e.data_ptr(), n,
               *fma_split(a.data_ptr(), b.data_ptr(), e.data_ptr(), n), stream_of(a))
        return e
    return run


def fma_probe(a: torch.Tensor, b: torch.Tensor, out=None) -> torch.Tensor:
    """a*b - p with p = a*b, as written (0 without FP contraction), into
    `out` if given (a contiguous f32 tensor of a's shape)."""
    return dispatch("fma_probe", a, _fma_cuda(kernels.FMA_PROBE, "fma_probe"),
                    fma_probe_plain, a, b, out)


def fma_probe_fma(a: torch.Tensor, b: torch.Tensor, out=None) -> torch.Tensor:
    """fma(a, b, -p) with p = a*b: the exact error of the product, into
    `out` if given."""
    return dispatch("fma_probe_fma", a, _fma_cuda(kernels.FMA_PROBE_FMA, "fma_probe_fma"),
                    fma_probe_fma_plain, a, b, out)


def roll_plain(x: torch.Tensor, iters: int = ITERS, shift: int = ROLL_SHIFT) -> torch.Tensor:
    for _ in range(iters):
        x = torch.roll(x, shift, 0) + 1.0
    return x


def _roll_cuda(x, iters, shift):
    x = x.contiguous()
    check_cuda("roll", x)
    if x.dim() != 2 or x.numel() == 0 or max(x.shape) >= 1 << 31 or not 0 <= iters < 1 << 31:
        raise ValueError(f"roll: shape {tuple(x.shape)}, iters {iters}: want [rows, cols], "
                         "each and iters below 2^31")
    out = torch.empty_like(x)
    kernels.ROLL(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], shift % x.shape[0],
                 iters, stream_of(x))
    return out


def roll(x: torch.Tensor, iters: int = ITERS, shift: int = ROLL_SHIFT) -> torch.Tensor:
    """`iters` steps of roll(x, shift, axis=0) + 1.0 on f32 [rows, cols]."""
    return dispatch("roll", x, _roll_cuda, roll_plain, x, iters, shift)


def inputs(device, rows: int = R, cols: int = C, seed: int = 0) -> dict:
    """The probes' inputs, from numpy generators as the script makes them:
    f32 chain and roll inputs in [1, 2) and [0, 1), i32 in [1, 100), fma
    operands in [-1, 1)."""
    rng = np.random.default_rng(seed)
    out = dict(
        f32=rng.random((rows, cols)).astype(np.float32) + 1.0,
        i32=rng.integers(1, 100, (rows, cols)).astype(np.int32),
        a=(rng.random((rows, cols)) * 2 - 1).astype(np.float32),
        b=(rng.random((rows, cols)) * 2 - 1).astype(np.float32),
        roll=rng.random((rows, cols)).astype(np.float32),
    )
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def fma_counts(err: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> dict:
    """The script's counts (nonzero; np.isclose to the f64 error) and the
    bit-exact count against the f64 error cast to f32, over the elements
    whose product error does not underflow."""
    a64, b64 = a.double().cpu().numpy(), b.double().cpu().numpy()
    p = (a * b).double().cpu().numpy()
    true = a64 * b64 - p
    e = err.cpu().numpy()
    normal = np.abs(p) >= 2.0**-100  # the error ~2^-24 |p| stays a normal f32
    return dict(
        nonzero=int(np.count_nonzero(e)), size=int(e.size),
        exact_match_isclose=int(np.count_nonzero(np.isclose(e.astype(np.float64), true))),
        bit_exact_vs_f64_error=int(np.count_nonzero(
            (e.view(np.int32) == true.astype(np.float32).view(np.int32)) & normal)),
        underflow_excluded=int(np.count_nonzero(~normal)),
    )


def timed(fn, reps: int = 5) -> float:
    """Seconds per call of fn, device time (`scripts.device_ms`)."""
    return device_ms(fn, [()], reps)[0] / 1e3


MM_CASES = (  # name, m, k, n, dtype, batch (the script's section 4)
    ("int8 mm 4096x128x128", 4096, 128, 128, torch.int8, 1),
    ("bf16 mm 4096x128x128", 4096, 128, 128, torch.bfloat16, 1),
    ("int8 mm 8192x256x256", 8192, 256, 256, torch.int8, 1),
    ("int8 bmm 32x2048x64x64", 2048, 64, 64, torch.int8, 32),
    ("int8 bmm 64x256x32x32", 256, 32, 32, torch.int8, 64),
    ("f32 mm 4096x128x128", 4096, 128, 128, torch.float32, 1),
)
MM_STEPS = 50
DATASHEET_PEAK = {torch.int8: 1979e12, torch.bfloat16: 989e12, torch.float32: 67e12}


def mm_rate(m, k, n, dtype, batch, device, gen: np.random.Generator):
    """(seconds of MM_STEPS accumulated products, their operations)."""
    if dtype == torch.int8:
        a = torch.from_numpy(gen.integers(-100, 100, (batch, m, k)).astype(np.int8)).to(device)
        b = torch.from_numpy(gen.integers(-100, 100, (batch, k, n)).astype(np.int8)).to(device)
        acc_dtype = torch.int32
    else:
        a = torch.from_numpy(gen.random((batch, m, k)).astype(np.float32)).to(device, dtype)
        b = torch.from_numpy(gen.random((batch, k, n)).astype(np.float32)).to(device, dtype)
        acc_dtype = torch.float32

    def product():
        if dtype == torch.int8:  # 2-D only: a loop over the batch
            return torch.stack([torch._int_mm(a[i], b[i]) for i in range(batch)])
        return torch.matmul(a, b).to(acc_dtype)

    def run():
        acc = torch.zeros((batch, m, n), dtype=acc_dtype, device=device)
        for _ in range(MM_STEPS):
            acc = acc + product()
        return acc

    return timed(run), 2 * batch * m * k * n * MM_STEPS


def main(argv=None) -> list:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    device = torus.resolve_device("cuda")
    hw = card(device)
    lines = [emit(dict(probe="vpu_probe", rows=R, cols=C, iters=ITERS, card=hw))]
    x = inputs(device)

    def chain_line(body):
        _, ops_per_step, mix = BODIES[body]
        src = x["f32"] if body in F32_BODIES else x["i32"]
        dt = timed(lambda: chain(src, body))
        ops = R * C * ITERS * ops_per_step
        peak = chain_peak_per_s(ops_per_step, mix, hw)
        return emit(dict(probe=body, tops_per_s=ops / dt / 1e12, ms=dt * 1e3, ops=ops,
                         mix=mix, peak_tops_per_s=peak / 1e12, share_of_peak=ops / dt / peak))

    lines += [chain_line(b) for b in F32_BODIES]
    a, b = x["a"], x["b"]
    for name, fn in (("fma contraction (as written)", fma_probe),
                     ("fma contraction (__fmaf_rn)", fma_probe_fma),
                     ("fma contraction (plain PyTorch)", fma_probe_plain)):
        dt = timed(lambda: fn(a, b))
        lines.append(emit(dict(probe=name, ms=dt * 1e3, **fma_counts(fn(a, b), a, b))))
    lines += [chain_line(b) for b in BODIES if b not in F32_BODIES]

    # the f32 case times IEEE f32 products, not TF32; the caller's setting is restored
    matmul = torch.backends.cuda.matmul
    precision = matmul.fp32_precision
    matmul.fp32_precision = "ieee"
    gen = np.random.default_rng(0)
    try:
        for name, m, k, n, dtype, batch in MM_CASES:
            dt, ops = mm_rate(m, k, n, dtype, batch, device, gen)
            peak = DATASHEET_PEAK[dtype]
            lines.append(emit(dict(probe=name, tops_per_s=ops / dt / 1e12, ms=dt * 1e3, ops=ops,
                                   against="data sheet peak", peak_tops_per_s=peak / 1e12,
                                   share_of_peak=ops / dt / peak)))
    finally:
        matmul.fp32_precision = precision

    dt = timed(lambda: roll(x["roll"]))
    ops = R * C * ITERS
    peak = chain_peak_per_s(1, ROLL_MIX, hw)
    lines.append(emit(dict(probe="roll(8,axis=0)+add chain", trolls_per_s=ops / dt / 1e12,
                           ms=dt * 1e3, ops=ops, mix=ROLL_MIX, peak_tops_per_s=peak / 1e12,
                           share_of_peak=ops / dt / peak)))
    return lines


if __name__ == "__main__":
    main()
