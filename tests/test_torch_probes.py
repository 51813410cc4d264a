"""The plain versions of the probe kernels (`spf_tpu_torch/scripts/vpu_probe.py`:
`chain`, `fma_probe`, `roll`; `gap_probe2.opaque_materialize`) against the
Pallas kernels of the TPU scripts, at [R, C] = [16, 128] and ITERS = 5.

The scripts under `scripts/` run their probes when imported, so the Pallas
bodies are copied here, as written there (`scripts/vpu_probe.py:44-56`,
`:85-91`, `:170-175`; `scripts/gap_probe2.py:166-181`), and run with
`interpret=True` on the CPU.

- Bit for bit: the i32 chains, the f32 chains that feed no mul into an
  add, the roll and the copy. The chains that feed a mul into an add are
  compared with the script's body run op by op under `jax.disable_jit()`:
  the interpret call is jitted, and XLA:CPU contracts the mul and add.
- The plain `fma_probe` is 0 everywhere, as JAX run op by op gives; its
  fused form is the f64 error of the product.
- The card's peak rate for each chain body (`scripts.steps_per_clock`),
  against the rates worked out by hand.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from spf_tpu_torch.ops import phase_rot
from spf_tpu_torch.scripts import chain_peak_per_s, gap_probe2, steps_per_clock, vpu_probe

torch.set_num_threads(1)

R, C = 16, 128
ITERS = 5

# the script's bodies (scripts/vpu_probe.py:75-82, :127-135)
JAX_BODIES = {
    "f32 mul chain": lambda v, i: v * 1.000001,
    "f32 add chain": lambda v, i: v + 0.0000001,
    "f32 mul+add chain": lambda v, i: v * 1.000001 + 0.0000001,
    "f32 2mul+1add (ILP)": lambda v, i: (v * 1.000001) + (v * 0.0000002),
    "f32 mul/select chain": lambda v, i: jnp.where(v > 0, v * 1.000001, v + 0.0000001),
    "i32 mul chain": lambda v, i: v * 3,
    "i32 add chain": lambda v, i: v + 3,
    "i32 mul+add chain": lambda v, i: (v * 3) + 3,
    "i32 shift chain": lambda v, i: v >> 16,
    "i32 and chain": lambda v, i: v & 0xFFFF,
    "i32 fermat modmul-ish": lambda v, i: (v & 0xFFFF) - (v >> 16) + (v * 3),
}
OP_BY_OP = ("f32 mul+add chain", "f32 2mul+1add (ILP)")


def _vmem_call(kern, x):
    return pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(x)


def chain_pallas(body, x):
    """scripts/vpu_probe.py:44-56, ITERS steps."""
    def kern(x_ref, o_ref):
        def step(i, v):
            return body(v, i)

        o_ref[...] = jax.lax.fori_loop(0, ITERS, step, x_ref[...])

    return _vmem_call(kern, x)


def roll_pallas(x):
    """scripts/vpu_probe.py:170-175."""
    def roll_kernel(x_ref, o_ref):
        def step(i, v):
            return pltpu.roll(v, 8, axis=0) + jnp.float32(1.0)

        o_ref[...] = jax.lax.fori_loop(0, ITERS, step, x_ref[...])

    return _vmem_call(roll_kernel, x)


def opaque_materialize_pallas(x):
    """scripts/gap_probe2.py:166-181."""
    def _copy_kernel(s_ref, d_ref):
        d_ref[...] = s_ref[...]

    m = x.shape[0]
    rest = x.shape[1:]
    return pl.pallas_call(
        _copy_kernel,
        grid=(m,),
        in_specs=[pl.BlockSpec((1,) + rest, lambda i: (i,) + (0,) * len(rest))],
        out_specs=pl.BlockSpec((1,) + rest, lambda i: (i,) + (0,) * len(rest)),
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True,
    )(x)


@pytest.fixture(scope="module")
def x():
    return {k: v.numpy() for k, v in vpu_probe.inputs("cpu", R, C).items()}


def _bits(a):
    return np.asarray(a).view(np.int32)


def test_body_order_matches_kernel_table():
    """The kernel picks a body by its position in vpu_probe.BODIES."""
    assert list(vpu_probe.BODIES) == list(JAX_BODIES)


@pytest.mark.parametrize("body", list(JAX_BODIES))
def test_chain_plain_matches_pallas(body, x):
    src = x["f32"] if body.startswith("f32") else x["i32"]
    got = vpu_probe.chain(torch.from_numpy(src), body, ITERS)  # the plain version on the CPU
    if body in OP_BY_OP:
        with jax.disable_jit():
            want = jnp.asarray(src)
            for i in range(ITERS):
                want = JAX_BODIES[body](want, i)
    else:
        want = chain_pallas(JAX_BODIES[body], jnp.asarray(src))
    assert got.numpy().dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


# the card's peak operations per clock per SM for each body (the script's
# count of ops per step): f32 add and mul on both FMA pipes (128); an
# integer multiply on the FMA heavy pipe alone (64), an integer add on it or
# on the ALU (128); logic and shift on the ALU (64); mul/select issues a
# compare (ALU) and both predicated arms, 3 instructions for 2 ops at 128
# issue slots; fermat issues 5 instructions (and, shift, mul, sub, add) for
# its 4 ops.
PEAK_OPS_PER_CLOCK = {
    "f32 mul chain": 128, "f32 add chain": 128, "f32 mul+add chain": 128,
    "f32 2mul+1add (ILP)": 128, "f32 mul/select chain": 256 / 3,
    "i32 mul chain": 64, "i32 add chain": 128, "i32 mul+add chain": 128,
    "i32 shift chain": 64, "i32 and chain": 64, "i32 fermat modmul-ish": 4 * 128 / 5,
}


@pytest.mark.parametrize("body", list(PEAK_OPS_PER_CLOCK))
def test_chain_peak_rate(body):
    _, ops, mix = vpu_probe.BODIES[body]
    assert ops * steps_per_clock(mix) == pytest.approx(PEAK_OPS_PER_CLOCK[body])
    hw = dict(sms=132, max_sm_clock_mhz=1980.0)
    assert chain_peak_per_s(ops, mix, hw) == pytest.approx(
        PEAK_OPS_PER_CLOCK[body] * 132 * 1.98e9)


def test_roll_plain_matches_pallas(x):
    got = vpu_probe.roll(torch.from_numpy(x["roll"]), ITERS)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(roll_pallas(jnp.asarray(x["roll"]))))


def test_fma_probe_plain(x):
    a, b = (torch.from_numpy(x[k]) for k in "ab")
    with jax.disable_jit():
        ja, jb = jnp.asarray(x["a"]), jnp.asarray(x["b"])
        p = ja * jb
        want = ja * jb - p
    got = vpu_probe.fma_probe(a, b)
    assert not np.any(np.asarray(want)) and not torch.any(got)
    exact = (a.double() * b.double() - (a * b).double()).float()
    fused = vpu_probe.fma_probe_fma(a, b)
    assert torch.equal(fused.view(torch.int32), exact.view(torch.int32))
    assert vpu_probe.fma_counts(fused, a, b)["bit_exact_vs_f64_error"] == R * C


def test_opaque_materialize_matches_pallas():
    rng = np.random.default_rng(3)
    f = rng.standard_normal((3, 3, 32, 8)).astype(np.float32)
    want = opaque_materialize_pallas(jnp.asarray(f))
    got = gap_probe2.opaque_materialize(torch.from_numpy(f))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert torch.equal(got, phase_rot.fence_plain(torch.from_numpy(f)))


def test_i32_chain_wraps_as_jax(x):
    """40 steps of the fermat body overflow int32: both wrap the same way."""
    src = x["i32"]
    got = vpu_probe.chain_plain(torch.from_numpy(src), "i32 fermat modmul-ish", 40)
    with jax.disable_jit():
        want = jnp.asarray(src)
        for i in range(40):
            want = JAX_BODIES["i32 fermat modmul-ish"](want, i)
    assert np.abs(np.asarray(want).astype(np.int64)).max() > 1 << 30
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
