"""The port's single-bit PBS (`ops/bootstrap.py`, the rotation kernels of
`ops/rot_decomp.py`) against the JAX package.

Both packages get the same numpy keys (made with the JAX package's numpy
mirror, `host_crypto.encrypt_ggsw_scalar_np`) and the same ciphertexts,
at n0 = 8, N = 64, B = 8.

- The plain versions of `rotate_sub_decompose(_acc)` == the Pallas
  kernels in interpret mode, bit for bit, at random t and its edges.
- Bit for bit: one step and the whole rotation in the plain and fuse_rot
  forms (which give the same bits) against the composition of
  `blind_rotate_u32`'s plain form (`bootstrap_u32.py:317-322`), and the
  phase_rot form against its TPU-branch composition (`:251-282`: the
  (phase − 1) factor multiplies the MAD output), both built from the JAX
  package's functions with the bit-reversed FFT twins and run op by op
  (eagerly, outside any `jit`).
- Decrypt level: the port's PBS in each form decodes every message as
  `programmable_bootstrap_u32(use_pallas=False)` does (another FFT order,
  so not bit for bit).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spf_tpu.ops import bootstrap_u32 as bu
from spf_tpu.ops import fft_pallas as fp
from spf_tpu.ops import limb32 as lb
from spf_tpu.ops import phase_rot as jpr
from spf_tpu.ops.fft_ds32_t import _cmul
from spf_tpu.params import GlweDef as JGlwe
from spf_tpu.params import LweDef as JLwe
from spf_tpu.params import RadixDecomposition as JRadix
from spf_tpu.utils import host_crypto as hc
from spf_tpu_torch import convert
from spf_tpu_torch.ops import bootstrap, encryption, fft, mad, rot_decomp, torus
from spf_tpu_torch.ops.lut import generate_lut_np
from spf_tpu_torch.params import GlweDef, LweDef, RadixDecomposition

torch.set_num_threads(1)

LWE = LweDef(dim=8, std=1e-16)
GLWE = GlweDef(size=1, degree=64, std=1e-16)
RADIX = RadixDecomposition(count=2, radix_log=16)
J_GLWE, J_RADIX = JGlwe(1, 64, 1e-16), JRadix(2, 16)
BITS = 3
B = 8
N = GLWE.degree
FORMS = {"plain": (False, False), "fuse_rot": (True, False), "phase_rot": (False, True)}


@pytest.fixture(autouse=True)
def _flush_denormals():
    """XLA:CPU flushes subnormal f32 values to zero; PyTorch keeps them
    (see tests/test_torch_ops.py)."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _lut_fn(x):
    return (x + 1) % 8


@pytest.fixture(scope="module")
def material():
    rng = np.random.default_rng(2024)
    lwe_sk = rng.integers(0, 2, LWE.dim).astype(np.uint64)
    glwe_sk = rng.integers(0, 2, (GLWE.size, GLWE.degree)).astype(np.uint64)
    bsk = np.stack([hc.encrypt_ggsw_scalar_np(rng, int(s), glwe_sk, J_GLWE, J_RADIX)
                    for s in lwe_sk])  # u64 [8, 2, 2, 2, 64]
    msgs = np.arange(B, dtype=np.uint64) % 8
    ct = encryption.encrypt_lwe_np(rng, msgs << np.uint64(64 - BITS - 1), lwe_sk, LWE)
    lut = generate_lut_np([_lut_fn], GLWE, BITS)
    return dict(lwe_sk=lwe_sk, glwe_sk=glwe_sk, bsk=bsk, ct=ct.T.copy(), msgs=msgs, lut=lut)


@pytest.fixture(scope="module")
def spectra(material):
    """The key spectra, made by the port's FFT (held against the JAX twin
    by tests/test_torch_multibit.py::test_key_spectra_bit_for_bit)."""
    return bootstrap.bsk_to_freq(torus.from_u64_np(material["bsk"]))


def _ct_sw(material):
    return torus.modulus_switch(torus.from_u64_np(material["ct"]), 0, 0, GLWE.log_degree + 1)


# The JAX package's integer limb functions, each jitted once for the module
# and put in place of the eager one while a reference runs (the three
# references below share the compiles): integer arithmetic, and the
# products by powers of two of from_ds / to_ds (exact, so an fma rounds them
# alike), have the same bits jitted as op by op, and one compile a function
# costs less than its eager operators' compiles. The ds32 arithmetic stays
# eager.
_JITTED_INTEGER_FNS = [
    (lb, "add", jax.jit(lb.add)),
    (lb, "sub", jax.jit(lb.sub)),
    (lb, "from_ds", jax.jit(lb.from_ds)),
    (lb, "to_ds", jax.jit(lb.to_ds)),
    (lb, "decompose", jax.jit(lb.decompose, static_argnums=1)),
    (lb, "modulus_switch", jax.jit(lb.modulus_switch, static_argnums=(1, 2, 3))),
    (bu, "monomial_mul_u32", jax.jit(bu.monomial_mul_u32)),
    (bu, "sample_extract_u32", jax.jit(bu.sample_extract_u32, static_argnums=(1, 2))),
]


@contextlib.contextmanager
def _jitted_integer_fns():
    with pytest.MonkeyPatch.context() as mp:
        for module, name, fn in _JITTED_INTEGER_FNS:
            mp.setattr(module, name, fn)
        yield mp


def _reference_start(material, spectra):
    spectra = tuple(jnp.asarray(c.numpy()) for c in spectra)
    ct_sw = lb.modulus_switch(lb.from_u64_np(material["ct"]), 0, 0, GLWE.log_degree + 1)
    lut = lb.from_u64_np(material["lut"])
    lut_b = tuple(jnp.broadcast_to(c[..., None], (2, N, B)) for c in lut)
    acc = bu.monomial_mul_u32(lut_b, jnp.uint32(2 * N) - ct_sw[-1])
    return spectra, ct_sw[:-1], acc


@pytest.fixture(scope="module")
def reference_plain(material, spectra):
    """`blind_rotate_u32`'s plain form, each step cmux_u32(acc,
    monomial_mul_u32(acc, a_i)) with the bit-reversed FFT twins, its ds32
    arithmetic op by op; step 0 recorded."""
    with _jitted_integer_fns():
        return _reference_plain(material, spectra)


def _reference_plain(material, spectra):
    spectra, a, acc = _reference_start(material, spectra)
    step0 = None
    for i in range(LWE.dim):
        rotated = bu.monomial_mul_u32(acc, a[i])
        digits = lb.decompose(lb.sub(rotated, acc), J_RADIX).astype(jnp.float32)
        dfft = fp.fwd_ds_ref(digits, jnp.zeros_like(digits))
        prod_f = bu.freq_mad(dfft, tuple(c[i] for c in spectra), J_GLWE, J_RADIX)
        prod = fp.inv_ds_ref(prod_f)
        if i == 0:
            step0 = dict(acc=acc, digits=digits, dfft=dfft, prod_f=prod_f, prod=prod)
        acc = lb.add(acc, lb.from_ds(*prod))
    return dict(step0=step0, final=acc)


@pytest.fixture(scope="module")
def reference_phase_rot(material, spectra):
    """`blind_rotate_u32`'s phase_rot form in its TPU branch, its ds32
    arithmetic op by op."""
    with _jitted_integer_fns():
        return _reference_phase_rot(material, spectra)


def _reference_phase_rot(material, spectra):
    spectra, a, acc = _reference_start(material, spectra)
    ph_lo, ph_hi = jpr.phase_factors_all(a, N, use_pallas=True)
    prod = (jnp.zeros((2, N, B), jnp.float32), jnp.zeros((2, N, B), jnp.float32))
    for i in range(LWE.dim):
        acc = lb.add(acc, lb.from_ds(*prod))
        digits = lb.decompose(acc, J_RADIX).astype(jnp.float32)
        dfft = fp.fwd_ds_ref(digits, jnp.zeros_like(digits))
        pm1 = jpr.combine_phase_minus_one(tuple(c[i] for c in ph_lo), tuple(c[i] for c in ph_hi))
        prod_f = _cmul(bu.freq_mad(dfft, tuple(c[i] for c in spectra), J_GLWE, J_RADIX), pm1)
        prod = fp.inv_ds_ref(prod_f)
    return lb.add(acc, lb.from_ds(*prod))


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _eq_planes(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w), err_msg=f"plane {i}")


def _eq_torus(got, want_limb):
    np.testing.assert_array_equal(torus.to_u64_np(got), lb.to_u64_np(want_limb))


@pytest.mark.parametrize("fused", [False, True], ids=["rotate_sub_decompose", "rotate_sub_decompose_acc"])
def test_rotation_plain_matches_interpret_kernel(fused):
    """The plain versions == the Pallas kernels in interpret mode (integer
    work: no FP contraction question), at random t and its edges 0, 1,
    N−1, N, 2N−1 (and 2N, the identity, which the LUT rotation reaches)."""
    from spf_tpu.ops import rot_decomp_pallas as rdp

    rng = np.random.default_rng(31 + fused)
    acc = rng.integers(0, 1 << 64, size=(2, N, 16), dtype=np.uint64)
    t = rng.integers(0, 2 * N, size=16)
    t[:6] = [0, 1, N - 1, N, 2 * N - 1, 2 * N]
    tj = jnp.asarray(t.astype(np.uint32))
    if fused:
        ph = (rng.standard_normal((2, N, 16)) * 2.0**40).astype(np.float32)
        ph[0, 0, :4] = [2.0**31, -(2.0**31), 2.0**63, 2.0**84]  # clamp and reduction edges
        pl = rng.standard_normal((2, N, 16)).astype(np.float32)
        digs_j, acc_j = rdp.rotate_sub_decompose_acc(
            lb.from_u64_np(acc), (jnp.asarray(ph), jnp.asarray(pl)), tj, J_RADIX, interpret=True)
        digs, acc2 = rot_decomp.rotate_sub_decompose_acc(
            torus.from_u64_np(acc), (torch.from_numpy(ph), torch.from_numpy(pl)),
            torch.from_numpy(t), RADIX)
        _eq_torus(acc2, acc_j)
    else:
        digs_j = rdp.rotate_sub_decompose(lb.from_u64_np(acc), tj, J_RADIX, interpret=True)
        digs = rot_decomp.rotate_sub_decompose(torus.from_u64_np(acc), torch.from_numpy(t), RADIX)
    np.testing.assert_array_equal(_bits(digs.numpy()), _bits(digs_j))


def test_one_step_bit_for_bit(material, spectra, reference_plain):
    """Every intermediate of step 0 of the plain form; the fuse_rot step
    (zero product folded in) gives the same digits and accumulator."""
    ref = reference_plain["step0"]
    lut = torus.from_u64_np(material["lut"])[..., None].expand(2, N, B)
    ct_sw = _ct_sw(material)
    acc = torus.monomial_mul(lut, 2 * N - ct_sw[-1])
    _eq_torus(acc, ref["acc"])
    digits = rot_decomp.rotate_sub_decompose(acc, ct_sw[0], RADIX)
    _eq_planes((digits,), (ref["digits"],))
    zero = torch.zeros((2, N, B))
    digits_f, acc_f = rot_decomp.rotate_sub_decompose_acc(acc, (zero, zero), ct_sw[0], RADIX)
    assert torch.equal(digits_f, digits) and torch.equal(acc_f, acc)
    dfft = fft.fwd_ds(digits, torch.zeros_like(digits))
    _eq_planes(dfft, ref["dfft"])
    prod_f = mad.freq_mad(dfft, tuple(c[0] for c in spectra))
    _eq_planes(prod_f, ref["prod_f"])
    _eq_planes(fft.inv_ds(prod_f), ref["prod"])


@pytest.mark.parametrize("fuse_rot", [False, True], ids=["plain", "fuse_rot"])
def test_blind_rotation_bit_for_bit(material, spectra, reference_plain, fuse_rot):
    lut = torus.from_u64_np(material["lut"])[..., None]
    got = bootstrap.blind_rotate(lut, _ct_sw(material), spectra, GLWE, RADIX, fuse_rot=fuse_rot)
    _eq_torus(got, reference_plain["final"])


def test_phase_rot_bit_for_bit(material, spectra, reference_phase_rot):
    lut = torus.from_u64_np(material["lut"])[..., None]
    got = bootstrap.blind_rotate(lut, _ct_sw(material), spectra, GLWE, RADIX, phase_rot=True)
    _eq_torus(got, reference_phase_rot)


def _decode(out_u64_bt, glwe_sk):
    phase = encryption.lwe_phase_np(out_u64_bt, np.asarray(glwe_sk).reshape(-1))
    rb = (phase >> np.uint64(64 - BITS - 1)) & np.uint64(1)
    return ((phase >> np.uint64(64 - BITS)) + rb) & np.uint64(7)


def _python_fori_loop(lower, upper, body, init, **_):
    val = init
    for i in range(lower, upper):
        val = body(i, val)
    return val


@pytest.fixture(scope="module")
def reference_decoded(material):
    """`programmable_bootstrap_u32(use_pallas=False)` (plain form, XLA FFT
    order), decoded. It runs op by op, eagerly: its `fori_loop` becomes a
    Python loop and the `jit` of its key conversion is dropped, which is
    what `jax.disable_jit()` does to them at a third of the dispatch cost;
    its integer limb functions run jitted, as in the references above."""
    with _jitted_integer_fns() as mp:
        mp.setattr(jax.lax, "fori_loop", _python_fori_loop)
        mp.setattr(jax, "jit", lambda f, **_: f)
        freq = bu.bsk_to_freq_u32(material["bsk"], use_pallas=False)
        ref = bu.programmable_bootstrap_u32(
            lb.from_u64_np(material["ct"]), lb.from_u64_np(material["lut"]), freq,
            JLwe(LWE.dim, 1e-16), J_GLWE, J_RADIX, use_pallas=False,
        )
    return _decode(lb.to_u64_np(ref).T, material["glwe_sk"])


@pytest.mark.parametrize("form", list(FORMS))
def test_pbs_decrypts_as_reference(material, reference_decoded, form):
    """Each form, its keys carried across as a limb pair (`convert.bootstrap`),
    decodes as the reference and as the LUT on every message."""
    fuse_rot, phase_rot = FORMS[form]
    pbs = convert.bootstrap(convert.u64_to_limbs(material["bsk"]), material["lut"], J_GLWE,
                            J_RADIX, fuse_rot, phase_rot, device="cpu")
    out = pbs(torus.from_u64_np(material["ct"]))
    got = _decode(torus.to_u64_np(out).T, material["glwe_sk"])
    np.testing.assert_array_equal(got, reference_decoded)
    np.testing.assert_array_equal(got, _lut_fn(material["msgs"]))


def test_port_keygen_pbs_decrypts():
    """The port's own single-bit key (`generate_bsk`): every form decodes
    every message."""
    gen = torch.Generator().manual_seed(8)
    lwe_sk = encryption.generate_lwe_sk(LWE, gen)
    glwe_sk = encryption.generate_glwe_sk(GLWE, gen)
    bsk = encryption.generate_bsk(lwe_sk, glwe_sk, GLWE, RADIX, gen)
    assert tuple(bsk.shape) == (LWE.dim, 2, RADIX.count, 2, N)
    msgs = np.arange(B, dtype=np.uint64)
    ct = encryption.encrypt_lwe_np(np.random.default_rng(4), msgs << np.uint64(60),
                                   lwe_sk.numpy(), LWE)
    sk = glwe_sk.numpy().astype(np.uint64)
    for fuse_rot, phase_rot in FORMS.values():
        pbs = bootstrap.Bootstrap(bsk, generate_lut_np([_lut_fn], GLWE, BITS), GLWE, RADIX,
                                  fuse_rot, phase_rot, device="cpu")
        out = pbs(torus.from_u64_np(ct.T.copy()))
        np.testing.assert_array_equal(_decode(torus.to_u64_np(out).T, sk), _lut_fn(msgs))


def test_wrappers_run_plain_only_on_cpu():
    """The new wrappers refuse a device that is neither CPU nor CUDA."""
    t = torch.zeros((2, N, 4), device="meta")
    planes = (t, t, t, t)
    tt = torch.zeros((4,), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        rot_decomp.rotate_sub_decompose(t.long(), tt, RADIX)
    with pytest.raises(ValueError):
        rot_decomp.rotate_sub_decompose_acc(t.long(), (t, t), tt, RADIX)
    with pytest.raises(ValueError):
        mad.freq_mad(planes, planes)
    with pytest.raises(ValueError, match="group"):
        mad.mad_horner(planes, planes, (planes, planes), 0)


def test_bootstrap_rejects_a_multibit_key(material):
    with pytest.raises(ValueError, match="bsk shape"):
        bootstrap.Bootstrap(material["bsk"][:, None], material["lut"], GLWE, RADIX, device="cpu")
