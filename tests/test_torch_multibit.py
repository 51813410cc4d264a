"""The port's multi-bit PBS slice against the JAX package.

Both packages get the same numpy keys (made with the JAX package's numpy
mirror, `host_crypto.encrypt_ggsw_scalar_np`) and the same ciphertexts.

- Bit for bit: one group step and the whole blind rotation at n0 = 16,
  N = 64, g = 3 (padded to 18), against the same composition built from
  the JAX package's TPU-branch functions (`multibit.py:213-271`), run op
  by op (eagerly, outside any `jit`).
- Decrypt level: the port's PBS decodes every message as
  `programmable_bootstrap_multibit_u32(use_pallas=False)` does (another
  FFT order, so not bit for bit).
- The port's own keygen decrypts, and its exact negacyclic product equals
  the numpy mirror's.
"""

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
from spf_tpu.params import GlweDef as JGlwe
from spf_tpu.params import LweDef as JLwe
from spf_tpu.params import RadixDecomposition as JRadix
from spf_tpu.utils import host_crypto as hc
from spf_tpu_torch import convert
from spf_tpu_torch.ops import bootstrap, encryption, fft, mad, multibit, phase_rot, rot_decomp, torus
from spf_tpu_torch.ops.lut import generate_lut_np
from spf_tpu_torch.params import GlweDef, LweDef, RadixDecomposition

torch.set_num_threads(1)

LWE = LweDef(dim=16, std=1e-16)
GLWE = GlweDef(size=1, degree=64, std=1e-16)
RADIX = RadixDecomposition(count=2, radix_log=16)
J_GLWE, J_RADIX = JGlwe(1, 64, 1e-16), JRadix(2, 16)
GROUP = 3
BITS = 3
B = 8


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
    rng = np.random.default_rng(777)
    lwe_sk = rng.integers(0, 2, LWE.dim).astype(np.uint64)
    glwe_sk = rng.integers(0, 2, (GLWE.size, GLWE.degree)).astype(np.uint64)
    prods = multibit.multibit_key_products_np(lwe_sk, GROUP)
    bsk = np.stack([
        np.stack([hc.encrypt_ggsw_scalar_np(rng, int(m), glwe_sk, J_GLWE, J_RADIX) for m in row])
        for row in prods
    ])  # u64 [6, 7, 2, 2, 2, 64]
    msgs = np.arange(B, dtype=np.uint64) % 8
    ct = encryption.encrypt_lwe_np(rng, msgs << np.uint64(64 - BITS - 1), lwe_sk, LWE)
    lut = generate_lut_np([_lut_fn], GLWE, BITS)
    return dict(lwe_sk=lwe_sk, glwe_sk=glwe_sk, bsk=bsk, ct=ct.T.copy(), msgs=msgs, lut=lut)


@pytest.fixture(scope="module")
def spectra(material):
    """The key spectra, made by the port's FFT; test_key_spectra_bit_for_bit
    holds them against the JAX package's Pallas-order FFT twin."""
    return bootstrap.bsk_to_freq(torus.from_u64_np(material["bsk"]))


# The JAX package's integer limb functions, each jitted once for the module
# and put in place of the eager one while a reference runs (both references
# below share the compiles): integer arithmetic, and the products by powers
# of two of from_ds / to_ds (exact, so an fma rounds them alike), have the
# same bits jitted as op by op, and one compile a
# function costs less than its eager operators' compiles. The ds32
# arithmetic stays eager.
_J_MONOMIAL_MUL = jax.jit(bu.monomial_mul_u32)
_J_SAMPLE_EXTRACT = jax.jit(bu.sample_extract_u32, static_argnums=(1, 2))
_JITTED_INTEGER_FNS = [
    (lb, "add", jax.jit(lb.add)),
    (lb, "from_ds", jax.jit(lb.from_ds)),
    (lb, "to_ds", jax.jit(lb.to_ds)),
    (lb, "decompose", jax.jit(lb.decompose, static_argnums=1)),
    (lb, "modulus_switch", jax.jit(lb.modulus_switch, static_argnums=(1, 2, 3))),
    (bu, "monomial_mul_u32", _J_MONOMIAL_MUL), (jmb, "monomial_mul_u32", _J_MONOMIAL_MUL),
    (bu, "sample_extract_u32", _J_SAMPLE_EXTRACT), (jmb, "sample_extract_u32", _J_SAMPLE_EXTRACT),
]


def _jit_integer_fns(mp):
    for module, name, fn in _JITTED_INTEGER_FNS:
        mp.setattr(module, name, fn)


@pytest.fixture(scope="module")
def reference(material, spectra):
    with pytest.MonkeyPatch.context() as mp:
        _jit_integer_fns(mp)
        return _reference(material, spectra)


def _reference(material, spectra):
    """The JAX TPU-branch composition, op by op, recording step 0. It
    takes the port's key spectra (checked on their own below).

    Its ds32 arithmetic runs eagerly outside any `jit`, where every jnp
    operator is its own XLA computation, exactly as under
    `jax.disable_jit()` (no FP contraction across operators; the FFT test
    of tests/test_torch_ops.py runs the same functions under
    `disable_jit()` and gets the same bits), at a third of the dispatch
    cost per operator; its integer limb functions run jitted
    (`_JITTED_INTEGER_FNS`)."""
    n = GLWE.degree
    spectra = tuple(jnp.asarray(c.numpy()) for c in spectra)
    ct_sw = lb.modulus_switch(lb.from_u64_np(material["ct"]), 0, 0, GLWE.log_degree + 1)
    a, b = ct_sw[:-1], ct_sw[-1]
    ng = spectra[0].shape[0]
    a = jnp.concatenate([a, jnp.zeros((ng * GROUP - a.shape[0], B), a.dtype)], axis=0)
    lut = lb.from_u64_np(material["lut"])
    lut_b = tuple(jnp.broadcast_to(c[..., None], (2, n, B)) for c in lut)
    acc = bu.monomial_mul_u32(lut_b, jnp.uint32(2 * n) - b)
    acc0 = acc
    ph_lo, ph_hi = jpr.phase_factors_all(a, n, use_pallas=True)
    ph_lo = tuple(c.reshape(ng, GROUP, *c.shape[1:]) for c in ph_lo)
    ph_hi = tuple(c.reshape(ng, GROUP, *c.shape[1:]) for c in ph_hi)
    prod = (jnp.zeros((2, n, B), jnp.float32), jnp.zeros((2, n, B), jnp.float32))
    step0 = None
    for t in range(ng):
        acc = lb.add(acc, lb.from_ds(*prod))
        digits_f = lb.decompose(acc, J_RADIX).astype(jnp.float32)
        dfft = fp.fwd_ds_ref(digits_f, jnp.zeros_like(digits_f))
        u = [
            jpr.combine_phase_minus_one(
                tuple(c[t, j] for c in ph_lo), tuple(c[t, j] for c in ph_hi)
            )
            for j in range(GROUP)
        ]
        row = tuple(c[t] for c in spectra)
        mads = [bu.freq_mad(dfft, tuple(c[m] for c in row), J_GLWE, J_RADIX) for m in range(7)]
        prod_f = jmb._nested_subset_sum(mads, u, GROUP)
        prod = fp.inv_ds_ref(prod_f)
        if t == 0:
            step0 = dict(acc=acc, digits=digits_f, dfft=dfft, u=u, prod_f=prod_f, prod=prod)
    final = lb.add(acc, lb.from_ds(*prod))
    return dict(ct_sw=ct_sw, acc0=acc0, step0=step0, final=final)


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _eq_planes(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w), err_msg=f"plane {i}")


def _eq_torus(got, want_limb):
    np.testing.assert_array_equal(torus.to_u64_np(got), lb.to_u64_np(want_limb))


def test_key_spectra_bit_for_bit(material, spectra):
    """The port's key conversion (to_ds, FFT, transposes) against
    limb32.to_ds + fft_pallas.fwd_ds_ref on the 32 polynomials of the
    first group's first four subsets, laid out as [2, 2, N, 8] (the shape
    of the blind rotation's digit transform)."""
    n, k = GLWE.degree, GLWE.degree // 2
    polys = material["bsk"][0, :4].reshape(32, n)  # [subset, i, j, o] flattened
    x = np.ascontiguousarray(polys.reshape(2, 2, 8, n).transpose(0, 1, 3, 2))
    want = fp.fwd_ds_ref(*lb.to_ds(lb.from_u64_np(x)))  # [2, 2, K, 8], eager op by op
    got = tuple(c[0, :4].reshape(2, 2, 8, k).transpose(2, 3) for c in spectra)
    _eq_planes(got, want)


def test_one_group_step_bit_for_bit(material, spectra, reference):
    """Modulus switch, LUT rotation and every intermediate of group step 0."""
    ref = reference["step0"]
    n = GLWE.degree
    ct_sw = torus.modulus_switch(torus.from_u64_np(material["ct"]), 0, 0, GLWE.log_degree + 1)
    np.testing.assert_array_equal(ct_sw.numpy(), np.asarray(reference["ct_sw"]).astype(np.int64))
    lut = torus.from_u64_np(material["lut"])[..., None].expand(2, n, B)
    acc = torus.monomial_mul(lut, 2 * n - ct_sw[-1])
    _eq_torus(acc, reference["acc0"])

    a = torch.cat([ct_sw[:-1], torch.zeros((2, B), dtype=torch.int64)])
    ph_lo, ph_hi = phase_rot.phase_factors_all(a, n)
    zero = torch.zeros((2, n, B))
    digits, acc = rot_decomp.accumulate_decompose(acc, (zero, zero), RADIX)
    _eq_torus(acc, ref["acc"])
    _eq_planes((digits,), (ref["digits"],))
    dfft = fft.fwd_ds(digits, torch.zeros_like(digits))
    _eq_planes(dfft, ref["dfft"])
    u = [
        phase_rot.combine_phase_minus_one(tuple(c[j] for c in ph_lo), tuple(c[j] for c in ph_hi))
        for j in range(GROUP)
    ]
    for uj, rj in zip(u, ref["u"]):
        _eq_planes(uj, rj)
    halves = (tuple(c[:GROUP] for c in ph_lo), tuple(c[:GROUP] for c in ph_hi))
    prod_f = mad.mad_horner(dfft, tuple(c[0] for c in spectra), halves, GROUP)
    _eq_planes(prod_f, ref["prod_f"])
    _eq_planes(fft.inv_ds(prod_f), ref["prod"])


def test_blind_rotation_bit_for_bit(material, spectra, reference):
    lut = torus.from_u64_np(material["lut"])[..., None]
    ct_sw = torus.modulus_switch(torus.from_u64_np(material["ct"]), 0, 0, GLWE.log_degree + 1)
    got = multibit.blind_rotate_multibit(lut, ct_sw, spectra, GLWE, RADIX, GROUP)
    _eq_torus(got, reference["final"])


def _decode(out_u64_bt, glwe_sk):
    phase = encryption.lwe_phase_np(out_u64_bt, np.asarray(glwe_sk).reshape(-1))
    rb = (phase >> np.uint64(64 - BITS - 1)) & np.uint64(1)
    return ((phase >> np.uint64(64 - BITS)) + rb) & np.uint64(7)


def _python_fori_loop(lower, upper, body, init, **_):
    val = init
    for i in range(lower, upper):
        val = body(i, val)
    return val


def test_pbs_decrypts_as_reference(material, monkeypatch):
    """Decode-equal with the JAX package's CPU branch (XLA FFT order) on
    the same keys, and equal to the LUT on every message.

    The reference runs op by op, eagerly: its `fori_loop` becomes a Python
    loop and the `jit` of its key conversion is dropped, which is what
    `jax.disable_jit()` does to them, at a third of the dispatch cost per
    operator (compiling the loop body under `jit` takes minutes on CPU);
    its integer limb functions run jitted, as in `reference`.
    Its cost grows with the number of groups, so the keys are cut to
    their first two groups (n0 = 6: the first 6 LWE key bits, whose
    multi-bit key is the first two rows of the BSK); the bit-for-bit
    tests above run all six groups."""
    n0 = 2 * GROUP
    ct = encryption.encrypt_lwe_np(
        np.random.default_rng(778), material["msgs"] << np.uint64(64 - BITS - 1),
        material["lwe_sk"][:n0], LweDef(dim=n0, std=1e-16),
    ).T.copy()
    bsk = material["bsk"][:2]
    pbs = convert.multibit_bootstrap(bsk, convert.u64_to_limbs(material["lut"]),
                                     J_GLWE, J_RADIX, GROUP, device="cpu")
    out = pbs(torus.from_u64_np(ct))
    got = _decode(torus.to_u64_np(out).T, material["glwe_sk"])
    monkeypatch.setattr(jax.lax, "fori_loop", _python_fori_loop)
    monkeypatch.setattr(jax, "jit", lambda f, **_: f)
    _jit_integer_fns(monkeypatch)
    freq = bu.bsk_to_freq_u32(bsk, use_pallas=False)
    ref = jmb.programmable_bootstrap_multibit_u32(
        lb.from_u64_np(ct), lb.from_u64_np(material["lut"]), freq,
        JLwe(n0, 1e-16), J_GLWE, J_RADIX, GROUP, use_pallas=False,
    )
    want = _decode(lb.to_u64_np(ref).T, material["glwe_sk"])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _lut_fn(material["msgs"]))


def test_negacyclic_mul_binary_matches_numpy_mirror():
    rng = np.random.default_rng(11)
    a = rng.integers(0, 1 << 64, size=(3, 64), dtype=np.uint64)
    s = rng.integers(0, 2, 64).astype(np.uint64)
    got = encryption.negacyclic_mul_binary(torus.from_u64_np(a), torch.from_numpy(s.astype(np.int64)))
    for i in range(3):
        np.testing.assert_array_equal(torus.to_u64_np(got[i]), hc.negacyclic_mul_binary_np(a[i], s))


def test_port_keygen_pbs_decrypts():
    """The port's own keys: GGSW rows decrypt to their messages, and a
    PBS with its multi-bit key decodes every message."""
    gen = torch.Generator().manual_seed(5)
    lwe_sk = encryption.generate_lwe_sk(LWE, gen)
    glwe_sk = encryption.generate_glwe_sk(GLWE, gen)
    ggsw = encryption.encrypt_ggsw_scalar(torch.tensor([1]), glwe_sk, GLWE, RADIX, gen)
    sk = glwe_sk.numpy().astype(np.uint64)
    for i in range(GLWE.size + 1):
        for j in range(RADIX.count):
            phase = hc.decrypt_glwe_np(torus.to_u64_np(ggsw[0, i, j]), sk, J_GLWE)
            msg = np.zeros(GLWE.degree, np.uint64)
            msg[0] = 1
            if i < GLWE.size:
                msg = np.uint64(0) - sk[i]
            want = msg << np.uint64(64 - RADIX.radix_log * (j + 1))
            assert np.abs((phase - want).astype(np.int64)).max() < (1 << 20)

    bsk = encryption.generate_multibit_bsk(lwe_sk, glwe_sk, GLWE, RADIX, GROUP, gen)
    pbs = multibit.MultibitBootstrap(bsk, generate_lut_np([_lut_fn], GLWE, BITS), GLWE, RADIX,
                                     GROUP, device="cpu")
    msgs = np.arange(B, dtype=np.uint64)
    ct = encryption.encrypt_lwe_np(np.random.default_rng(3), msgs << np.uint64(60), lwe_sk.numpy(), LWE)
    out = pbs(torus.from_u64_np(ct.T.copy()))
    np.testing.assert_array_equal(_decode(torus.to_u64_np(out).T, sk), _lut_fn(msgs))


def test_default_device_without_card_fails_loudly(material):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multibit.MultibitBootstrap(material["bsk"], material["lut"], GLWE, RADIX, GROUP)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.to_tensor(material["lut"])
