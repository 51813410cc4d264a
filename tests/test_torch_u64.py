"""The u64 API's operations (`spf_tpu_torch/ops/u64/`) against the JAX
package's u64 family (`spf_tpu/ops/{torus,decomp,poly,ciphertext,
encryption,fft,fft_ops,keyswitch,automorphism,bootstrap,cbs}.py`), on the
CPU at the parameters of `tests/test_torch_wave_machine.py` (k = 1,
N = 64, n0 = 32; k = 2 where a function loops over k).

Keys come from the port's keygen and go to JAX as numpy (`convert.
key_arrays`): the c128 spectra the same values in both packages. Inputs
are made with numpy from a seed. The JAX references run as jitted
programs (`J`), their blind rotation's `fori_loop` as a Python loop over
its jitted body (`python_fori_loop`).

- Bit for bit: every integer-only function (torus encode / decode /
  reduction, decompose, the monomial and automorphism permutations, the
  exact negacyclic product, modulus switch, sample extract, rotations,
  the LWE keyswitch) and the decryption of the same ciphertexts.
- Within TOL = 2^32 as int64 (2^-32 of the torus): every function through
  the c128 backend on the same inputs (FFT, external product, CMux, GLEV
  CMux, GLWE keyswitch, scheme switch); frequency-domain outputs are
  compared after one common inverse (the port's). pocketfft and XLA's FFT
  agree to a few ulps, not bit for bit.
- Chained functions (the blind rotation, the trace, circuit bootstrapping):
  each step within TOL on the same input, and the whole chain decrypting
  to the same messages, with phases within PHASE_TOL. Once a step's last
  ulps decide a gadget digit's rounding, the two ciphertexts are different
  encryptions of one message: their raw bits part, their phases do not.
The largest differences are printed (`-s`) and recorded in CHANGES.md.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spf_tpu import params as jparams
from spf_tpu.ops import automorphism as j_auto
from spf_tpu.ops import bootstrap as j_bs
from spf_tpu.ops import cbs as j_cbs
from spf_tpu.ops import ciphertext as j_ct
from spf_tpu.ops import decomp as j_decomp
from spf_tpu.ops import encryption as j_enc
from spf_tpu.ops import fft as j_fft
from spf_tpu.ops import fft_ops as j_fo
from spf_tpu.ops import keyswitch as j_ks
from spf_tpu.ops import poly as j_poly
from spf_tpu.ops import torus as j_torus
from spf_tpu_torch import convert
from spf_tpu_torch.ops import keyswitch as port_ks
from spf_tpu_torch.ops import torus as port_torus
from spf_tpu_torch.ops.u64 import automorphism, bootstrap, cbs, ciphertext, decomp
from spf_tpu_torch.ops.u64 import encryption as enc
from spf_tpu_torch.ops.u64 import fft, fft_ops, keyswitch, poly, rng
from spf_tpu_torch.ops.u64 import torus as t64
from spf_tpu_torch.params import GlweDef, LweDef, Params, RadixDecomposition
from spf_tpu_torch.runtime import generate_keys

torch.set_num_threads(1)

TOL = 2.0**32
PHASE_TOL = 2.0**48  # 14 bits below the 2^62 decision boundary of a bit
P = Params(
    l0_params=LweDef(dim=32, std=1e-16),
    l1_params=GlweDef(size=1, degree=64, std=1e-16),
    cbs_radix=RadixDecomposition(count=2, radix_log=9),
    pbs_radix=RadixDecomposition(count=2, radix_log=16),
    ks_radix=RadixDecomposition(count=9, radix_log=4),
    pfks_radix=RadixDecomposition(count=4, radix_log=11),
    ss_radix=RadixDecomposition(count=6, radix_log=8),
    tr_radix=RadixDecomposition(count=6, radix_log=7),
)
P2 = dataclasses.replace(P, l1_params=GlweDef(size=2, degree=64, std=1e-16))
GLWE, LWE = P.l1_params, P.l0_params
N = GLWE.degree
SEEN: dict = {}  # test name -> largest difference seen, as log2


_JIT: dict = {}


def J(fn, *static):
    """The JAX reference `fn` with its trailing static arguments bound, as
    one jitted XLA program, compiled once per (fn, statics). Only for
    functions without a `fori_loop` (whose jitted body takes a minute to
    compile here); compiling one program is cheaper than compiling each
    eager operator, and XLA's contractions stay within the tolerances."""
    key = (fn, static)
    if key not in _JIT:
        _JIT[key] = jax.jit(lambda *a: fn(*a, *static))
    return _JIT[key]


def jp(obj):
    """A port parameter dataclass -> the JAX package's."""
    cls = getattr(jparams, type(obj).__name__)
    return cls(**{f.name: jp(getattr(obj, f.name)) if dataclasses.is_dataclass(
        getattr(obj, f.name)) else getattr(obj, f.name) for f in dataclasses.fields(obj)})


def jx(t):
    """A port tensor -> a jnp array (int64 as u64 bits, complex as it is)."""
    if isinstance(t, torch.Tensor):
        return jnp.asarray(t.numpy() if t.is_complex() else port_torus.to_u64_np(t))
    return jnp.asarray(t)


def tt(a) -> torch.Tensor:
    """A jnp or numpy u64 array -> int64 tensor; complex -> complex128 tensor."""
    a = np.array(a)
    if np.iscomplexobj(a):
        return torch.from_numpy(a)
    return port_torus.from_u64_np(a.astype(np.uint64))


def same(got: torch.Tensor, want) -> bool:
    return got.shape == tuple(np.shape(want)) and np.array_equal(
        port_torus.to_u64_np(got), np.asarray(want).astype(np.uint64))


def delta(got: torch.Tensor, want) -> float:
    """Largest |got - want| as wrapping int64 (frequency values after the
    port's inverse)."""
    if got.is_complex():
        got, want = fft.C128.inv(got), fft.C128.inv(tt(want))
    want = want if isinstance(want, torch.Tensor) else tt(want)
    assert got.shape == want.shape
    return float((got - want).to(torch.float64).abs().max())


def record(name: str, d: float, tol: float):
    SEEN[name] = max(SEEN.get(name, -1.0), float(np.log2(d + 1)))
    assert d <= tol, f"{name}: |delta| = 2^{np.log2(d + 1):.2f} > 2^{np.log2(tol):.0f}"


def u64s(rng_, shape) -> np.ndarray:
    return rng_.integers(0, 1 << 64, size=shape, dtype=np.uint64)


def glwe_phase(ct, sk, glwe) -> torch.Tensor:
    return enc.decrypt_glwe(ct if isinstance(ct, torch.Tensor) else tt(ct), sk, glwe)


@pytest.fixture
def python_fori_loop(monkeypatch):
    """`lax.fori_loop` as a Python loop over its body jitted once: the JAX
    blind rotation runs step by step as written, each step one compiled
    program, instead of compiling the loop (a minute here) or each eager
    operator (seconds)."""
    def fori_loop(lower, upper, body, init):
        step = jax.jit(body)
        carry = init
        for i in range(lower, upper):
            carry = step(i, carry)
        return carry

    monkeypatch.setattr(jax.lax, "fori_loop", fori_loop)


@pytest.fixture(scope="module")
def keys():
    """The port's keys at P (and at P2 for k = 2), with the JAX view of
    their arrays."""
    out = {}
    for name, p in (("k1", P), ("k2", P2)):
        sk, pk, ck = generate_keys(7 if name == "k1" else 8, p, device="cpu")
        arrays = {**convert.key_arrays(sk), **convert.key_arrays(ck)}
        out[name] = dict(p=p, jp=jp(p), sk=sk, pk=pk, ck=ck,
                         j={k: jnp.asarray(v) for k, v in arrays.items()})
    return out


@pytest.fixture(scope="module", autouse=True)
def _report():
    yield
    print("\nlargest differences (log2 |delta|):", {k: round(v, 2) for k, v in SEEN.items()})


# --- torus ------------------------------------------------------------------


EDGES = np.array([0, 1, 2, (1 << 62) - 1, 1 << 62, (1 << 63) - 1, 1 << 63, (1 << 63) + 1,
                  (1 << 64) - 2, (1 << 64) - 1, 0xDEADBEEFBEEFDEAD], dtype=np.uint64)


def _torus_inputs():
    return np.concatenate([EDGES, u64s(np.random.default_rng(1), 501)])


@pytest.mark.parametrize("bits", [1, 2, 5, 31, 32, 63])
def test_torus_encode_decode(bits):
    x = _torus_inputs()
    assert same(t64.decode(tt(x), bits), j_torus.decode(jnp.asarray(x), bits))
    assert same(t64.encode(tt(x), bits), j_torus.encode(jnp.asarray(x), bits))
    for v in (0, 1, 3, (1 << bits) - 1, 1 << 70):
        assert t64.encode(v, bits) == int(np.uint64(j_torus.encode(v, bits)).astype(np.int64))
    assert same(t64.switch_modulus_smaller(tt(x), bits),
                j_torus.switch_modulus_smaller(jnp.asarray(x), bits))


@pytest.mark.parametrize("n", [0, 1, 2, 7, 31, 32, 33, 62, 63])
def test_torus_shr_round(n):
    x = _torus_inputs()
    assert same(t64.shr_round(tt(x), n), j_torus.shr_round(jnp.asarray(x), n))
    assert t64.shr_round is port_torus.shr_round  # the port's one implementation


def test_torus_signed_f64_and_reduction():
    x = _torus_inputs()
    np.testing.assert_array_equal(t64.to_signed_f64(tt(x)).numpy(),
                                  np.asarray(j_torus.to_signed_f64(jnp.asarray(x))))
    rng_ = np.random.default_rng(2)
    mags = [0.0, 1.0, 2.0**52, 2.0**62, 2.0**63 - 1024, 2.0**63, 2.0**64 - 2048, 2.0**64,
            2.0**64 + 4096, 2.0**70, 2.0**85, 3.0 * 2.0**63]
    f = np.concatenate([np.array(mags), -np.array(mags),
                        np.round(rng_.standard_normal(400) * 2.0**rng_.integers(0, 90, 400))])
    assert same(t64.f64_to_torus(torch.from_numpy(f)), j_torus.f64_to_torus(jnp.asarray(f)))


# --- decomposition ----------------------------------------------------------------


@pytest.mark.parametrize("radix", [(2, 16), (4, 8), (2, 9), (9, 4), (6, 7), (6, 8), (15, 3),
                                   (16, 4), (32, 2)])
def test_decompose(radix):
    r = RadixDecomposition(*radix)
    x = _torus_inputs().reshape(1, -1)
    jr = jp(r)
    got = decomp.decompose(tt(x), r)
    assert same(got, j_decomp.decompose(jnp.asarray(x), jr))
    assert torch.equal(got, port_torus.decompose(tt(x), r).to(torch.int64))
    assert same(decomp.radix_round(tt(x), r), j_decomp.radix_round(jnp.asarray(x), jr))
    for a, b in zip(decomp.decompose_lsb_first(tt(x), r),
                    j_decomp.decompose_lsb_first(jnp.asarray(x), jr)):
        assert same(a, b)
    assert same(decomp.recompose(got, r), j_decomp.recompose(j_decomp.decompose(
        jnp.asarray(x), jr), jr))
    assert decomp.decomposition_factor(0, r) == j_decomp.decomposition_factor(0, jr)


# --- polynomials ------------------------------------------------------------------


def test_negacyclic_products():
    rng_ = np.random.default_rng(3)
    a, p = u64s(rng_, (3, N)), u64s(rng_, (3, N))
    a[0, :4] = EDGES[-4:]
    assert same(poly.negacyclic_matrix(tt(p[0])), j_poly.negacyclic_matrix(jnp.asarray(p[0])))
    assert same(poly.negacyclic_mul_exact(tt(a), tt(p)),
                j_poly.negacyclic_mul_exact(jnp.asarray(a), jnp.asarray(p)))
    s = rng_.integers(0, 2, N).astype(np.uint64)
    assert same(poly.negacyclic_mul_exact(tt(a), tt(s)),
                j_poly.negacyclic_mul_exact(jnp.asarray(a), jnp.asarray(s)))


def test_monomial_and_automorphism():
    rng_ = np.random.default_rng(4)
    a = u64s(rng_, (2, 2, N))
    for t in (0, 1, 5, N - 1, N, N + 3, 2 * N - 1, 2 * N, 3 * N + 7, -1, -N - 2):
        assert same(poly.monomial_mul(tt(a), t), j_poly.monomial_mul(jnp.asarray(a), t)), t
    ts = rng_.integers(-3 * N, 3 * N, (2, 1))
    assert same(poly.monomial_mul_batch(tt(a), torch.from_numpy(ts)),
                j_poly.monomial_mul_batch(jnp.asarray(a), jnp.asarray(ts)))
    for k in (1, 3, N // 2 + 1, N + 1, 2 * N - 1):
        assert same(poly.pow_k(tt(a), k), j_poly.pow_k(jnp.asarray(a), k)), k
    assert same(poly.shr_round_poly(tt(a), 6), j_poly.shr_round_poly(jnp.asarray(a), 6))


# --- ciphertexts ------------------------------------------------------------------


@pytest.mark.parametrize("glwe", [GLWE, P2.l1_params])
def test_sample_extract_and_rotations(glwe):
    rng_ = np.random.default_rng(5)
    ct = u64s(rng_, (3, glwe.size + 1, N))
    for h in (0, 1, N // 2, N - 1):
        assert same(ciphertext.sample_extract(tt(ct), h, glwe),
                    j_ct.sample_extract(jnp.asarray(ct), h, jp(glwe)))
    m = int(EDGES[6])
    assert same(ciphertext.glwe_rotate(tt(ct), t64.encode(1, 1)),
                j_ct.glwe_rotate(jnp.asarray(ct), j_torus.encode(1, 1)))
    lwe = u64s(rng_, (4, 9))
    assert same(ciphertext.lwe_rotate(tt(lwe), t64.u64(m)), j_ct.lwe_rotate(jnp.asarray(lwe), m))
    assert same(ciphertext.glwe_mod_switch_and_expand_pow_2(tt(ct), 6),
                j_ct.glwe_mod_switch_and_expand_pow_2(jnp.asarray(ct), 6))
    assert same(ciphertext.glwe_sub(tt(ct), tt(ct[::-1].copy())),
                j_ct.glwe_sub(jnp.asarray(ct), jnp.asarray(ct[::-1])))


@pytest.mark.parametrize("args", [(0, 0, 10), (0, 0, 7), (0, 1, 7), (0, 2, 12), (2, 1, 12),
                                  (0, 0, 32), (0, 3, 32), (1, 0, 40), (0, 0, 63)])
def test_modulus_switch(args):
    x = _torus_inputs()
    got = ciphertext.lwe_modulus_switch(tt(x), *args)
    assert same(got, j_ct.lwe_modulus_switch(jnp.asarray(x), *args))
    if args[2] - args[1] < 32 and args[2] + args[1] <= 32:  # results below 2^32
        assert torch.equal(got, port_torus.modulus_switch(tt(x), *args))
    if args == (0, 0, 10):
        assert int(ciphertext.modulus_switch(t64.u64(0xDEADBEEFBEEFDEAD), *args)) == 0b1101111011


# --- encryption -------------------------------------------------------------------


def test_rng():
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    assert torch.equal(rng.normal_torus(g, 0.0, (5,)), torch.zeros(5, dtype=torch.int64))
    assert torch.equal(g.get_state(), state)  # std 0 draws nothing
    assert set(rng.binary(g, (400,)).tolist()) == {0, 1}
    u = port_torus.to_u64_np(rng.uniform_torus(g, (4000,)))
    assert (u >> np.uint64(63)).mean() > 0.4 and (u & np.uint64(1)).mean() > 0.4
    e = rng.normal_torus(g, 1e-10, (4000,)).to(torch.float64) * 2.0**-64
    assert 0.8e-10 < float(e.std()) < 1.2e-10


def test_decrypt_parity(keys):
    """The same ciphertexts decrypt to the same bits in both packages: random
    ones to the same phases, the port's encryptions to their messages."""
    kk = keys["k1"]
    sk, jsk = kk["sk"], kk["j"]
    rng_ = np.random.default_rng(6)
    msg = rng_.integers(0, 2, N).astype(np.uint64)
    lwe_ct, glwe_ct = u64s(rng_, (3, LWE.dim + 1)), u64s(rng_, (GLWE.size + 1, N))
    glev = u64s(rng_, (P.cbs_radix.count, GLWE.size + 1, N))
    ggsw = u64s(rng_, (GLWE.size + 1, P.cbs_radix.count, GLWE.size + 1, N))
    assert same(enc.decrypt_lwe(tt(lwe_ct), sk.lwe_0, LWE),
                J(j_enc.decrypt_lwe, jp(LWE))(jnp.asarray(lwe_ct), jsk["lwe_0"]))
    assert same(enc.decrypt_glwe(tt(glwe_ct), sk.glwe_1, GLWE),
                J(j_enc.decrypt_glwe, jp(GLWE))(jnp.asarray(glwe_ct), jsk["glwe_1"]))
    for i in range(P.cbs_radix.count):
        assert same(enc.decrypt_glev_at(tt(glev), sk.glwe_1, GLWE, P.cbs_radix, i),
                    J(j_enc.decrypt_glev_at, jp(GLWE), jp(P.cbs_radix), i)(
                        jnp.asarray(glev), jsk["glwe_1"]))
    assert same(enc.decrypt_ggsw(tt(ggsw), sk.glwe_1, GLWE, P.cbs_radix),
                J(j_enc.decrypt_ggsw, jp(GLWE), jp(P.cbs_radix))(jnp.asarray(ggsw), jsk["glwe_1"]))
    for fn, args in ((enc.trivial_lwe, (t64.encode(1, 1), LWE)),
                     (enc.trivial_glwe, (t64.encode(tt(msg), 1), GLWE)),
                     (enc.trivial_glev, (tt(msg), GLWE, P.cbs_radix)),
                     (enc.trivial_ggsw, (tt(msg), GLWE, P.cbs_radix))):
        jfn = getattr(j_enc, fn.__name__)
        jargs = [jx(a) if isinstance(a, torch.Tensor) else jp(a) if dataclasses.is_dataclass(a)
                 else a for a in args]
        assert same(fn(*args, device="cpu"), jfn(*jargs)), fn.__name__

    g = torch.Generator().manual_seed(12)
    m = tt(msg)
    c = enc.encrypt_glwe(g, t64.encode(m, 1), sk.glwe_1, GLWE)
    assert same(t64.decode(enc.decrypt_glwe(c, sk.glwe_1, GLWE), 1), msg)
    assert same(t64.decode(tt(J(j_enc.decrypt_glwe, jp(GLWE))(jx(c), jsk["glwe_1"])), 1), msg)
    c = enc.encrypt_lwe(g, t64.encode(1, 1), sk.lwe_0, LWE)
    assert int(j_torus.decode(J(j_enc.decrypt_lwe, jp(LWE))(jx(c), jsk["lwe_0"]), 1)) == 1
    c = enc.encrypt_glev(g, m, sk.glwe_1, GLWE, P.cbs_radix)
    assert same(tt(J(j_enc.decrypt_glev_at, jp(GLWE), jp(P.cbs_radix), 1)(jx(c), jsk["glwe_1"])),
                msg)
    c = enc.encrypt_ggsw(g, m * 3, sk.glwe_1, GLWE, P.cbs_radix)
    assert same(tt(J(j_enc.decrypt_ggsw, jp(GLWE), jp(P.cbs_radix))(jx(c), jsk["glwe_1"])),
                msg * np.uint64(3))
    c = enc.encrypt_ggsw_scalar(g, torch.tensor([1, 0]), sk.glwe_1, GLWE, P.cbs_radix)
    assert c.shape == (2, 2, P.cbs_radix.count, 2, N)
    assert [int(enc.decrypt_ggsw(c[i], sk.glwe_1, GLWE, P.cbs_radix)[0]) for i in (0, 1)] == [1, 0]
    ct = enc.rlwe_encrypt_public(g, t64.encode(m, 1), kk["pk"].rlwe_1, GLWE)
    assert same(t64.decode(tt(J(j_enc.decrypt_glwe, jp(GLWE))(jx(ct), jsk["glwe_1"])), 1), msg)


# --- the c128 backend and the frequency-domain ops ------------------------------------


def test_backend_names():
    """Both of the reference's backends by name (ds32 is `fft_ds32.DS32`,
    held bit for bit in tests/test_torch_fft_ds32.py); an unknown name
    raises."""
    from spf_tpu_torch.ops.u64.fft_ds32 import DS32

    assert fft.get_backend("c128") is fft.C128 and fft.get_backend(fft.C128) is fft.C128
    assert fft.get_backend("ds32") is DS32 and fft.get_backend(DS32) is DS32
    assert DS32.name == j_fft.get_backend("ds32").name == "ds32"
    with pytest.raises(ValueError):
        fft.get_backend("c64")


def test_fft():
    rng_ = np.random.default_rng(7)
    x = u64s(rng_, (4, 3, N))
    got, want = fft.C128.fwd_torus(tt(x)), J(j_fft.C128.fwd_torus)(jnp.asarray(x))
    record("fft fwd_torus", delta(got, want), TOL)
    record("fft round trip", delta(fft.C128.inv(got), x), TOL)
    digits = rng_.integers(-(1 << 15), 1 << 15, (4, 2, N))
    got = fft.C128.fwd_signed(torch.from_numpy(digits))
    record("fft fwd_signed", delta(got, J(j_fft.C128.fwd_signed)(jnp.asarray(digits))), TOL)
    prod = got * fft.C128.fwd_torus(tt(x[:, :2]))  # a product spectrum, as the MADs make
    record("fft inv", delta(fft.C128.inv(prod), J(j_fft.C128.inv)(jnp.asarray(prod.numpy()))), TOL)


def _ggsw_fft(kk, bits):
    g = torch.Generator().manual_seed(13)
    p = kk["p"]
    ggsw = enc.encrypt_ggsw_scalar(g, torch.tensor(bits), kk["sk"].glwe_1, p.l1_params,
                                   p.cbs_radix)
    return fft_ops.ggsw_to_fft(ggsw)


@pytest.mark.parametrize("k", ["k1", "k2"])
def test_external_product_and_cmux(keys, k):
    kk = keys[k]
    p, jpp = kk["p"], kk["jp"]
    glwe = p.l1_params
    rng_ = np.random.default_rng(8)
    sel = _ggsw_fft(kk, [1, 0, 1, 1])  # [4, k+1, l, k+1, N/2]
    d0, d1 = u64s(rng_, (4, glwe.size + 1, N)), u64s(rng_, (4, glwe.size + 1, N))
    args = (glwe, p.cbs_radix)
    jargs = (jpp.l1_params, jpp.cbs_radix)
    got = fft_ops.external_product_fft(tt(d0), sel, *args)
    record("external_product_fft", delta(got, J(j_fo.external_product_fft, *jargs)(
        jnp.asarray(d0), jx(sel))), TOL)
    got = fft_ops.external_product(tt(d0), sel[0], *args)  # one GGSW for the batch
    record("external_product", delta(got, J(j_fo.external_product, *jargs)(
        jnp.asarray(d0), jx(sel[0]))), TOL)
    got = fft_ops.cmux(tt(d0), tt(d1), sel, *args)
    record("cmux", delta(got, J(j_fo.cmux, *jargs)(jnp.asarray(d0), jnp.asarray(d1), jx(sel))), TOL)
    sk = kk["sk"].glwe_1
    # and it selects, to within the gadget's rounding of (d1 - d0): 2^45 a
    # coefficient at 2x9, times <= (k+1) N / 2 key terms < 2^52
    for i, bit in enumerate([1, 0, 1, 1]):
        want = (d1 if bit else d0)[i]
        d = glwe_phase(got[i], sk, glwe) - glwe_phase(want, sk, glwe)
        assert float(d.to(torch.float64).abs().max()) < 2.0**52
    g0, g1 = u64s(rng_, (4, 2, glwe.size + 1, N)), u64s(rng_, (4, 2, glwe.size + 1, N))
    got = fft_ops.glev_cmux(tt(g0), tt(g1), sel, *args)
    record("glev_cmux", delta(got, J(j_fo.glev_cmux, *jargs)(jnp.asarray(g0), jnp.asarray(g1),
                                                            jx(sel))), TOL)


@pytest.mark.parametrize("k", ["k1", "k2"])
def test_keyswitch_glwe_and_scheme_switch(keys, k):
    kk = keys[k]
    p, jpp, ck = kk["p"], kk["jp"], kk["ck"]
    glwe = p.l1_params
    rng_ = np.random.default_rng(9)
    ct = u64s(rng_, (3, glwe.size + 1, N))
    got = fft_ops.keyswitch_glwe_to_glwe(tt(ct), ck.auto_keys[2], glwe, p.tr_radix)
    record("keyswitch_glwe_to_glwe", delta(got, J(j_fo.keyswitch_glwe_to_glwe, jpp.l1_params, jpp.tr_radix)(
        jnp.asarray(ct), jx(ck.auto_keys[2]))), TOL)
    glev = u64s(rng_, (3, p.cbs_radix.count, glwe.size + 1, N))
    got = fft_ops.scheme_switch_fft(tt(glev), ck.ssk, glwe, p.cbs_radix, p.ss_radix)
    record("scheme_switch_fft", delta(got, J(j_fo.scheme_switch_fft, jpp.l1_params, jpp.cbs_radix, jpp.ss_radix)(
        jnp.asarray(glev), jx(ck.ssk))), TOL)


def test_lwe_keyswitch(keys):
    """Bit for bit with JAX's exact u64 keyswitch. The u32 family's
    byte-plane keyswitch (`ops.keyswitch.keyswitch_lwe`, batch last) rounds
    its sums through a ds32 pair: a different function, within TOL of it."""
    kk = keys["k1"]
    ck, sk = kk["ck"], kk["sk"]
    old = GLWE.as_lwe_def()
    rng_ = np.random.default_rng(10)
    ct = u64s(rng_, (5, old.dim + 1))
    got = keyswitch.keyswitch_lwe_to_lwe(tt(ct), ck.ksk, old, LWE, P.ks_radix)
    assert same(got, J(j_ks.keyswitch_lwe_to_lwe, jp(old), jp(LWE), jp(P.ks_radix))(
        jnp.asarray(ct), kk["j"]["ksk"]))
    planes = port_ks.ksk_to_byte_planes(ck.ksk)
    record("lwe keyswitch vs the byte-plane one",
           delta(got.t(), port_ks.keyswitch_lwe(tt(ct).t(), planes, old, LWE, P.ks_radix)), TOL)
    assert torch.equal(keyswitch.keyswitch_lwe_to_lwe(tt(ct[0]), ck.ksk, old, LWE, P.ks_radix,
                                                      ck.ksk_planes), got[0])
    g = torch.Generator().manual_seed(14)
    bit_ct = enc.encrypt_lwe(g, t64.encode(1, 1), sk.lwe_1, old)
    out = keyswitch.keyswitch_lwe_to_lwe(bit_ct, ck.ksk, old, LWE, P.ks_radix, ck.ksk_planes)
    assert int(t64.decode(enc.decrypt_lwe(out, sk.lwe_0, LWE), 1)) == 1


def test_key_layouts(keys):
    """The keys decrypt to what they encrypt, in the reference's layouts."""
    kk = keys["k2"]
    p, sk, ck = kk["p"], kk["sk"], kk["ck"]
    glwe = p.l1_params
    bsk = fft.C128.inv(ck.bsk)
    assert ck.bsk.shape == (p.l0_params.dim, 3, p.pbs_radix.count, 3, N // 2)
    assert [int(enc.decrypt_ggsw(bsk[i], sk.glwe_1, glwe, p.pbs_radix)[0]) for i in range(8)] \
        == sk.lwe_0[:8].tolist()
    assert ck.ksk.shape == (glwe.size * N, p.ks_radix.count, p.l0_params.dim + 1)
    ak = fft.C128.inv(ck.auto_keys)
    assert ak.shape == (glwe.log_degree, glwe.size, p.tr_radix.count, 3, N)
    mapped = poly.pow_k(sk.glwe_1, N // 2 + 1)  # round i = 2
    got = enc.decrypt_glev_at(ak[1, 1], sk.glwe_1, glwe, p.tr_radix, 0)
    assert same(got, port_torus.to_u64_np(mapped[1]) & np.uint64((1 << 7) - 1))
    ssk = fft.C128.inv(ck.ssk)
    s01 = poly.negacyclic_mul_exact(sk.glwe_1[0], sk.glwe_1[1])
    for i, j in ((0, 1), (1, 0)):
        got = enc.decrypt_glev_at(ssk[i, j], sk.glwe_1, glwe, p.ss_radix, 0)
        assert same(got, port_torus.to_u64_np(s01) & np.uint64(0xFF))


# --- chained: trace, blind rotation, circuit bootstrapping ------------------------------


def _bit_lwes(kk, bits):
    g = torch.Generator().manual_seed(15)
    msgs = torch.tensor([t64.encode(b, 1) for b in bits])
    return enc.encrypt_lwe(g, msgs, kk["sk"].lwe_0, kk["p"].l0_params)


def test_trace(keys):
    kk = keys["k1"]
    ck, sk, jsk = kk["ck"], kk["sk"], kk["j"]
    rng_ = np.random.default_rng(16)
    msg = rng_.integers(0, 2, (2, N)).astype(np.uint64) << np.uint64(50)
    g = torch.Generator().manual_seed(17)
    ct = enc.encrypt_glwe(g, tt(msg), sk.glwe_1, GLWE)
    out = ct
    for i in range(1, GLWE.log_degree + 1):  # each round on the same input
        mapped = automorphism.glwe_pow_k(out, N // (1 << (i - 1)) + 1)
        assert same(mapped, j_auto.glwe_pow_k(jx(out), N // (1 << (i - 1)) + 1))
        step = fft_ops.keyswitch_glwe_to_glwe(mapped, ck.auto_keys[i - 1], GLWE, P.tr_radix)
        record("trace round", delta(step, J(j_fo.keyswitch_glwe_to_glwe, jp(GLWE), jp(P.tr_radix))(
            jx(mapped), jx(ck.auto_keys[i - 1]))), TOL)
        out = out + step
    got = automorphism.trace(ct, ck.auto_keys, GLWE, P.tr_radix)
    assert torch.equal(got, out)
    want = J(j_auto.trace, jp(GLWE), jp(P.tr_radix))(jx(ct), jsk["auto_keys"])
    ph, jph = glwe_phase(got, sk.glwe_1, GLWE), glwe_phase(want, sk.glwe_1, GLWE)
    record("trace phase", delta(ph, jph), PHASE_TOL)
    expect = np.zeros_like(msg)
    expect[:, 0] = msg[:, 0] * np.uint64(N)  # the constant term times N, the rest zero
    assert same(t64.decode(ph, 14), t64.decode(tt(expect), 14).numpy().view(np.uint64))


def test_blind_rotate_and_pbs(keys, python_fori_loop):
    """Every CMux of the rotation within TOL on the same accumulator; the
    PBS of both packages decrypting to the LUT's values, phases within
    PHASE_TOL."""
    kk = keys["k1"]
    ck, sk, jsk = kk["ck"], kk["sk"], kk["j"]
    bits = 2
    lut = bootstrap.generate_lut([lambda x: (3 * x + 1) % 4], GLWE, bits, device="cpu")
    assert same(lut, j_bs.generate_lut([lambda x: (3 * x + 1) % 4], jp(GLWE), bits))
    g = torch.Generator().manual_seed(18)
    msgs = [0, 1, 2, 3]
    cts = enc.encrypt_lwe(g, torch.tensor([t64.encode(m, bits + 1) for m in msgs]),
                          sk.lwe_0, LWE)
    switched = ciphertext.lwe_modulus_switch(cts, 0, 0, GLWE.log_degree + 1)
    a, b = switched[..., :-1], switched[..., -1]
    acc = poly.monomial_mul_batch(lut, (2 * N - b)[..., None])
    for i in range(LWE.dim):
        rotated = poly.monomial_mul_batch(acc, a[..., i, None])
        nxt = fft_ops.cmux(acc, rotated, ck.bsk[i], GLWE, P.pbs_radix)
        record("blind_rotate step", delta(nxt, J(j_fo.cmux, jp(GLWE), jp(P.pbs_radix))(
            jx(acc), jx(rotated), jsk["bsk"][i])), TOL)
        acc = nxt
    assert torch.equal(bootstrap.blind_rotate(lut, switched, ck.bsk, LWE, GLWE, P.pbs_radix), acc)
    got = bootstrap.programmable_bootstrap_univariate(cts, lut, ck.bsk, LWE, GLWE, P.pbs_radix)
    want = j_bs.programmable_bootstrap_univariate(jx(cts), jx(lut), jsk["bsk"], jp(LWE),
                                                  jp(GLWE), jp(P.pbs_radix))
    assert same(got, ciphertext.sample_extract(acc, 0, GLWE))
    ph = enc.decrypt_lwe(got, sk.lwe_1, GLWE.as_lwe_def())
    jph = enc.decrypt_lwe(tt(want), sk.lwe_1, GLWE.as_lwe_def())
    record("pbs phase", delta(ph, jph), PHASE_TOL)
    assert t64.decode(ph, bits).tolist() == t64.decode(jph, bits).tolist() \
        == [(3 * m + 1) % 4 for m in msgs]

    # the bivariate PBS: inputs at 2 * 1 + 1 bits packed as 2 l + r, the
    # LUT over 2 bits, the output decoded at 2 bits
    lut2 = bootstrap.generate_bivariate_lut(lambda x, y: x ^ y, GLWE, 1, device="cpu")
    assert same(lut2, j_bs.generate_bivariate_lut(lambda x, y: x ^ y, jp(GLWE), 1))
    pairs = [(0, 0), (0, 1), (1, 0), (1, 1)]
    left, right = (enc.encrypt_lwe(g, torch.tensor([t64.encode(p[i], 3) for p in pairs]),
                                   sk.lwe_0, LWE) for i in (0, 1))
    got = bootstrap.programmable_bootstrap_bivariate(left, right, lut2, ck.bsk, LWE, GLWE,
                                                     P.pbs_radix, 1)
    want = j_bs.programmable_bootstrap_bivariate(jx(left), jx(right), jx(lut2), jsk["bsk"],
                                                 jp(LWE), jp(GLWE), jp(P.pbs_radix), 1)
    ph = enc.decrypt_lwe(got, sk.lwe_1, GLWE.as_lwe_def())
    jph = enc.decrypt_lwe(tt(want), sk.lwe_1, GLWE.as_lwe_def())
    record("bivariate pbs phase", delta(ph, jph), PHASE_TOL)
    assert t64.decode(ph, 2).tolist() == t64.decode(jph, 2).tolist() == [l ^ r for l, r in pairs]


def test_blind_rotation_by_encrypted_shift(keys):
    kk = keys["k1"]
    sk, jsk = kk["sk"], kk["j"]
    g = torch.Generator().manual_seed(19)
    shift = bootstrap.generate_blind_rotation_shift(g, 5, sk.glwe_1, GLWE, P.cbs_radix)
    assert shift.shape == (GLWE.log_degree, 2, P.cbs_radix.count, 2, N // 2)
    msg = torch.zeros(N, dtype=torch.int64)
    msg[7] = t64.encode(1, 1)
    ct = enc.encrypt_glwe(g, msg, sk.glwe_1, GLWE)
    got = bootstrap.blind_rotation(ct, shift, GLWE, P.cbs_radix)
    want = J(j_bs.blind_rotation, jp(GLWE), jp(P.cbs_radix))(jx(ct), jx(shift))
    ph, jph = glwe_phase(got, sk.glwe_1, GLWE), glwe_phase(want, sk.glwe_1, GLWE)
    record("blind_rotation phase", delta(ph, jph), PHASE_TOL)
    assert torch.nonzero(t64.decode(ph, 1)).flatten().tolist() == [2]  # X^7 * X^-5


def test_circuit_bootstrap_stages(keys, python_fori_loop):
    """Each stage of the CBS on the same input: the multi-function PBS step
    by step, the trace rows, the scheme switch within TOL; every stage and
    the whole CBS decrypting alike in both packages."""
    kk = keys["k1"]
    ck, sk, jsk = kk["ck"], kk["sk"], kk["j"]
    jpp = kk["jp"]
    glwe = GLWE
    assert same(cbs.multifunctional_cbs_lut(glwe, P.cbs_radix, device="cpu"),
                j_cbs.multifunctional_cbs_lut(jp(glwe), jp(P.cbs_radix)))
    cts = _bit_lwes(kk, [0, 1, 1, 0])
    lo_j = j_cbs.hi_noise_lwe_to_lo_noise_glwe(jx(cts), jsk["bsk"], jp(LWE), jp(glwe),
                                               jp(P.pbs_radix), jp(P.cbs_radix))
    lo = cbs.hi_noise_lwe_to_lo_noise_glwe(cts, ck.bsk, LWE, glwe, P.pbs_radix, P.cbs_radix)
    record("cbs pbs phase", delta(glwe_phase(lo, sk.glwe_1, glwe),
                                  glwe_phase(lo_j, sk.glwe_1, glwe)), PHASE_TOL)
    glev_j = J(j_cbs.mod_switch_trace_and_rotate, jp(glwe), jp(P.tr_radix), jp(P.cbs_radix))(
        jx(lo), jsk["auto_keys"])
    glev = cbs.mod_switch_trace_and_rotate(lo, ck.auto_keys, glwe, P.tr_radix, P.cbs_radix)
    for i in range(P.cbs_radix.count):
        record("cbs glev phase", delta(glwe_phase(glev[:, i], sk.glwe_1, glwe),
                                       glwe_phase(tt(glev_j)[:, i], sk.glwe_1, glwe)), PHASE_TOL)
        assert torch.equal(enc.decrypt_glev_at(glev, sk.glwe_1, glwe, P.cbs_radix, i)[:, 0],
                           torch.tensor([0, 1, 1, 0]))
    ggsw = fft_ops.scheme_switch_fft(glev, ck.ssk, glwe, P.cbs_radix, P.ss_radix)
    record("cbs scheme_switch", delta(ggsw, J(j_fo.scheme_switch_fft, jpp.l1_params, jpp.cbs_radix, jpp.ss_radix)(
        jx(glev), jsk["ssk"])), TOL)
    full = cbs.circuit_bootstrap(cts, ck.bsk, ck.auto_keys, ck.ssk, P)
    assert torch.equal(full, ggsw)  # the three stages, composed
    coeff = fft.C128.inv(full)
    assert [int(enc.decrypt_ggsw(coeff[i], sk.glwe_1, glwe, P.cbs_radix)[0]) for i in range(4)] \
        == [0, 1, 1, 0]
