"""The plain versions of the port's kernels against the JAX package.

Each module that holds a CUDA kernel (`fft`, `rot_decomp`, `mad`,
`phase_rot`) has a plain PyTorch version, which is what its wrapper runs
on a CPU tensor. These tests hold the plain versions against the JAX
functions on the same seeded inputs: bit for bit against the reference
run op by op, or against a Pallas kernel in interpret mode. The CUDA
kernels themselves are held against the plain versions on the card by
`chip_smoke.py`.

Op by op means outside any `jit`, where XLA:CPU cannot contract a
multiply and an add. The FFT comparison runs under `jax.disable_jit()`.
The phase and MAD comparisons run eagerly instead: every jnp operator
is still its own XLA computation (the ds arithmetic is Python operators
on arrays), and eager operators are the ones the blind-rotation
reference of tests/test_torch_multibit.py compiles at the same shapes,
so one process compiles each of them once.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spf_tpu.ops import bootstrap_u32 as bu
from spf_tpu.ops import fft_pallas as fp
from spf_tpu.ops import limb32 as lb
from spf_tpu.ops import multibit as jmb
from spf_tpu.ops import phase_rot as jpr
from spf_tpu.params import RadixDecomposition as JRadix
from spf_tpu_torch.ops import fft, mad, phase_rot, rot_decomp, torus
from spf_tpu_torch.params import RadixDecomposition

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _flush_denormals():
    """XLA:CPU flushes subnormal f32 values to zero; PyTorch keeps them.
    Compare like with like by flushing them here too (the ds error terms
    of values below ~2^-100 otherwise differ in the last bit)."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _eq_planes(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w), err_msg=f"plane {i}")


@pytest.mark.parametrize("n", [64])
def test_fft_plain_matches_twins(n):
    """fwd_ds_plain/inv_ds_plain == fft_pallas.fwd_ds_ref/inv_ds_ref, on
    torus values (as the key conversion feeds it: row 0) and on signed
    digits with a zero lo plane (as the blind rotation feeds it: row 1).
    The shapes are those of the blind rotation of tests/test_torch_multibit.py.
    Every K runs the same stage loop, and each new shape costs the
    reference seconds of op-by-op compiles, so one N is compared here;
    N = 256 is held to the inverse by test_fft_plain_roundtrip."""
    rng = np.random.default_rng(n)
    x = rng.integers(0, 1 << 64, size=(2, n, 8), dtype=np.uint64)
    hi, lo = torus.to_ds(torus.from_u64_np(x))
    digits = torch.from_numpy(rng.integers(-(1 << 15), 1 << 15, size=(2, n, 8)).astype(np.float32))
    hi = torch.stack([hi, digits])
    lo = torch.stack([lo, torch.zeros_like(digits)])
    f = fft.fwd_ds(hi, lo)  # CPU tensors: the plain version
    back = fft.inv_ds(f)
    with jax.disable_jit():
        fj = fp.fwd_ds_ref(jnp.asarray(hi.numpy()), jnp.asarray(lo.numpy()))
        _eq_planes(f, fj)
        _eq_planes(back, fp.inv_ds_ref(fj))


def test_fft_plain_roundtrip():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1 << 64, size=(256, 4), dtype=np.uint64)
    back = torus.from_ds(*fft.inv_ds_plain(fft.fwd_ds_plain(*torus.to_ds(torus.from_u64_np(x)))))
    err = (torus.to_u64_np(back) - x).astype(np.int64)
    assert np.abs(err).max() < (1 << 24)


def test_accumulate_decompose_matches_interpret_kernel():
    from spf_tpu.ops.rot_decomp_pallas import accumulate_decompose

    rng = np.random.default_rng(3)
    acc = rng.integers(0, 1 << 64, size=(2, 64, 128), dtype=np.uint64)
    ph = (rng.standard_normal((2, 64, 128)) * 2.0**40).astype(np.float32)
    ph[0, 0, :4] = [2.0**31, -(2.0**31), 2.0**63, 2.0**84]  # clamp and reduction edges
    pl = rng.standard_normal((2, 64, 128)).astype(np.float32)
    digs_j, acc_j = accumulate_decompose(
        lb.from_u64_np(acc), (jnp.asarray(ph), jnp.asarray(pl)), JRadix(2, 16), interpret=True
    )
    digs, acc2 = rot_decomp.accumulate_decompose(
        torus.from_u64_np(acc), (torch.from_numpy(ph), torch.from_numpy(pl)), RadixDecomposition(2, 16)
    )
    np.testing.assert_array_equal(torus.to_u64_np(acc2), lb.to_u64_np(acc_j))
    np.testing.assert_array_equal(_bits(digs.numpy()), _bits(digs_j))


def _rand_planes(rng, shape):
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(4))


def _mad_operands(rng, group, k_, b, l=2, kp1=2):
    ns = (1 << group) - 1
    dfft = _rand_planes(rng, (l, kp1, k_, b))
    row = _rand_planes(rng, (ns, kp1, l, kp1, k_))
    u = _rand_planes(rng, (group, k_, b))
    return dfft, row, u


def _t(planes):
    return tuple(torch.from_numpy(c) for c in planes)


def _j(planes):
    return tuple(jnp.asarray(c) for c in planes)


@pytest.mark.parametrize("group", [2, 3])
def test_mad_horner_plain_matches_freq_mad(group):
    """The plain version == freq_mad per subset + _nested_subset_sum, op
    by op (eagerly), bit for bit, at K = 32 and B = 8 (not multiples of
    128)."""
    from spf_tpu.params import GlweDef as JGlwe

    k_, b = 32, 8
    rng = np.random.default_rng(group)
    dfft, row, u = _mad_operands(rng, group, k_, b)
    got = mad.mad_horner_plain(_t(dfft), _t(row), _t(u), group)
    glwe = JGlwe(size=1, degree=2 * k_, std=0.0)
    jd, jr, ju = _j(dfft), _j(row), _j(u)
    mads = [bu.freq_mad(jd, tuple(c[m] for c in jr), glwe, JRadix(2, 16))
            for m in range((1 << group) - 1)]
    want = jmb._nested_subset_sum(mads, [tuple(c[j] for c in ju) for j in range(group)], group)
    _eq_planes(got, want)


def test_mad_horner_plain_matches_interpret_kernel():
    """Against `mad_pallas.mad_horner_fused` in interpret mode, with the
    tolerance of tests/test_fft_pallas.py::TestMadPallas: the interpreted
    kernel runs under jit, where XLA:CPU contracts FP operations."""
    from spf_tpu.ops.mad_pallas import mad_horner_fused

    rng = np.random.default_rng(42)
    dfft, row, u = _mad_operands(rng, 1, 128, 128)
    got = mad.mad_horner_plain(_t(dfft), _t(row), _t(u), 1)
    want = mad_horner_fused(_j(dfft), _j(row), _j(u), 1, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-2, atol=1e-3)


def _phase_halves(rng, group, n, b):
    """Real phase factor halves of one step, g bits: 4 planes [g, Klo, B]
    and [g, Khi, B] (numpy), from random exponents."""
    lo, hi = phase_rot.phase_factors_all(torch.from_numpy(rng.integers(0, 2 * n, (group, b))), n)
    return tuple(c.numpy() for c in lo), tuple(c.numpy() for c in hi)


@pytest.mark.parametrize("group", [1, 2, 3])
def test_mad_horner_forms_its_phases(group):
    """mad_horner(dfft, row, (lo, hi), g) on CPU tensors == each bit's
    combine_phase_minus_one, then mad_horner_plain, bit for bit; and == the
    JAX package's combine_phase_minus_one + freq_mad per subset +
    _nested_subset_sum, op by op (eagerly), at K = 32 (Klo = 4, Khi = 8),
    B = 8."""
    from spf_tpu.params import GlweDef as JGlwe

    k_, b = 32, 8
    rng = np.random.default_rng(20 + group)
    dfft, row, _ = _mad_operands(rng, group, k_, b)
    lo, hi = _phase_halves(rng, group, 2 * k_, b)
    got = mad.mad_horner(_t(dfft), _t(row), (_t(lo), _t(hi)), group)

    u = [phase_rot.combine_phase_minus_one(tuple(torch.from_numpy(c[j]) for c in lo),
                                           tuple(torch.from_numpy(c[j]) for c in hi))
         for j in range(group)]
    plain = mad.mad_horner_plain(_t(dfft), _t(row),
                                 tuple(torch.stack([uj[c] for uj in u]) for c in range(4)), group)
    for g, w in zip(got, plain):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))

    glwe = JGlwe(size=1, degree=2 * k_, std=0.0)
    jd, jr = _j(dfft), _j(row)
    ju = [jpr.combine_phase_minus_one(tuple(jnp.asarray(c[j]) for c in lo),
                                      tuple(jnp.asarray(c[j]) for c in hi))
          for j in range(group)]
    mads = [bu.freq_mad(jd, tuple(c[m] for c in jr), glwe, JRadix(2, 16))
            for m in range((1 << group) - 1)]
    _eq_planes(got, jmb._nested_subset_sum(mads, ju, group))


@pytest.mark.parametrize("bad", ["device", "halves"])
def test_mad_horner_refuses(bad):
    """The wrapper refuses a tensor on neither the CPU nor CUDA, and halves
    whose Klo * Khi is not K."""
    k_, b, group = 32, 8, 2
    dev = "meta" if bad == "device" else "cpu"
    dfft = tuple(torch.zeros((2, 2, k_, b), device=dev) for _ in range(4))
    row = tuple(torch.zeros((3, 2, 2, 2, k_), device=dev) for _ in range(4))
    khi = 8 if bad == "device" else 4  # Klo * Khi = 16 != K
    lo = tuple(torch.zeros((group, 4, b), device=dev) for _ in range(4))
    hi = tuple(torch.zeros((group, khi, b), device=dev) for _ in range(4))
    with pytest.raises(ValueError, match="unsupported device" if bad == "device" else "halves"):
        mad.mad_horner(dfft, row, (lo, hi), group)


@pytest.mark.parametrize("package", ["spf_tpu_torch.params", "spf_tpu.params"])
def test_mad_kp1_covers_every_glwe_set(package):
    """`mad.MAD_KP1`, the k + 1 the MAD kernel takes on the card, holds the
    k + 1 of every GLWE set and of every parameter set's L1 GLWE in both
    packages (the reference's: 2, 3, 4 and 6)."""
    mod = importlib.import_module(package)
    sets = [v for v in vars(mod).values() if isinstance(v, mod.GlweDef)]
    sets += [v.l1_params for v in vars(mod).values() if isinstance(v, mod.Params)]
    kp1 = {g.size + 1 for g in sets}
    assert package == "spf_tpu_torch.params" or kp1 == {2, 3, 4, 6}
    assert kp1 <= set(mad.MAD_KP1), f"{package}: k + 1 {sorted(kp1)}, kernel {mad.MAD_KP1}"


def test_phase_factors_match_reference():
    """phase_factors_all (bit-reversed order) and combine_phase_minus_one
    == phase_rot's `use_pallas=True` order, op by op (eagerly), bit for
    bit: at N = 64 (K = 32: Klo = 4, Khi = 8) and N = 256 (K = 128, also
    odd log2 K: Klo = 8, Khi = 16)."""
    rng = np.random.default_rng(9)
    for n, shape, steps in ((64, (18, 8), (0, 17)), (256, (5, 3), (0, 4))):
        a = rng.integers(0, 2 * n, size=shape)
        lo, hi = phase_rot.phase_factors_all(torch.from_numpy(a), n)
        assert (lo[0].shape[1], hi[0].shape[1]) == phase_rot.factor_halves(n)
        jlo, jhi = jpr.phase_factors_all(jnp.asarray(a.astype(np.uint32)), n, use_pallas=True)
        _eq_planes(lo, jlo)
        _eq_planes(hi, jhi)
        for t in steps:
            got = phase_rot.combine_phase_minus_one(tuple(c[t] for c in lo),
                                                    tuple(c[t] for c in hi))
            want = jpr.combine_phase_minus_one(tuple(c[t] for c in jlo),
                                               tuple(c[t] for c in jhi))
            _eq_planes(got, want)
        assert phase_rot.backend_bit_images(n) == jpr.backend_bit_images(n, use_pallas=True)


def test_phase_factors_layout():
    """Each half is the 4 planes of one contiguous [4, steps, K_half, B]
    tensor, as the kernel stores them; the multi-bit rotation's
    `group_phases` and a step's slice are views of them (no copy)."""
    from spf_tpu_torch.ops import multibit

    n, group, ng, b = 256, 3, 4, 5
    a = torch.from_numpy(np.random.default_rng(3).integers(0, 2 * n, size=(ng * group, b)))
    halves = phase_rot.phase_factors_all(a, n)
    grouped = multibit.group_phases(a, n, group)

    def one_tensor(planes):  # the 4 planes at their offsets in one storage
        base = planes[0].untyped_storage().data_ptr()
        assert all(c.is_contiguous() and c.untyped_storage().data_ptr() == base for c in planes)
        assert [c.data_ptr() - base for c in planes] == [p * planes[0].numel() * 4
                                                         for p in range(4)]

    for planes, g_planes, kh in zip(halves, grouped, phase_rot.factor_halves(n)):
        assert all(c.shape == (ng * group, kh, b) for c in planes)
        one_tensor(planes)
        one_tensor(g_planes)  # group_phases' reshape is a view
        for c, gc in zip(planes, g_planes):
            assert gc.shape == (ng, group, kh, b)
            assert torch.equal(gc.reshape(c.shape), c)
            assert gc[2].is_contiguous()  # a step's slice, as `rotate_groups` takes it


@pytest.mark.parametrize("bad", ["dtype", "rank", "device", "empty", "n"])
def test_phase_factors_refuses(bad):
    """The wrapper refuses a non-int64 a, a rank other than 2, a device
    that is neither the CPU nor CUDA, an empty a and an N whose K is not
    a power of two in [2, 2048]."""
    n = 64
    a = torch.zeros((3, 4), dtype=torch.int64)
    err = ValueError
    if bad == "dtype":
        a, err = a.int(), TypeError
    elif bad == "rank":
        a = a[0]
    elif bad == "device":
        a = a.to("meta")
    elif bad == "empty":
        a = a[:0]
    for n in (2, 48, 8192) if bad == "n" else (n,):
        with pytest.raises(err):
            phase_rot.phase_factors_all(a, n)


def test_fence_is_a_copy():
    x = torch.randn(3, 4, 5, generator=torch.Generator().manual_seed(0))
    y = phase_rot.fence(x)
    assert torch.equal(x, y) and y.data_ptr() != x.data_ptr()


def test_wrappers_run_plain_only_on_cpu():
    """A wrapper runs its plain version only for a CPU tensor: any other
    device that is not CUDA is refused, never computed on quietly."""
    t = torch.zeros((2, 64, 8), device="meta")
    planes = (t, t, t, t)
    with pytest.raises(ValueError):
        fft.fwd_ds(t, t)
    with pytest.raises(ValueError):
        fft.inv_ds(planes)
    with pytest.raises(ValueError):
        rot_decomp.accumulate_decompose(t.long(), (t, t), RadixDecomposition(2, 16))
    with pytest.raises(ValueError):
        mad.mad_horner(planes, planes, (planes, planes), 1)
    with pytest.raises(ValueError):
        phase_rot.fence(t)
    with pytest.raises(ValueError):
        phase_rot.phase_factors_all(t[0].long(), 64)
