"""The port's conversion cycle (`ops/cbs.py`, `ops/keyswitch.py`, the
keygen of `ops/encryption.py`) against the JAX package, at N = 64.

Keys and ciphertexts are made with numpy (the JAX package's numpy mirror,
`host_crypto`) and handed to both packages.

- Bit for bit against `cbs_u32`'s and `keyswitch_u32`'s functions, run
  op by op (eagerly, outside any `jit`; the trace's `scan` as a Python
  loop), with the bit-reversed FFT twins (`fft_pallas.fwd_ds_ref`,
  `inv_ds_ref`) in place of their FFT: `keyswitch_glwe`, `trace`,
  `scheme_switch` followed by the CMux of a batched GGSW, `keyswitch_lwe`,
  the CBS LUT, `shr_round`, `encode_const`, `add_small` and the modulus
  switch at log_v = 2.
- Decrypt level, the port only: the whole cycle with the numpy keys
  carried across (`convert.conversion_cycle`), with a multi-bit (g = 2)
  and a single-bit key (phase_rot form), and with the port's own keys.
  The jitted JAX `circuit_bootstrap_u32` is no reference here: compiling
  it takes minutes on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spf_tpu.ops import bootstrap_u32 as bu
from spf_tpu.ops import cbs_u32 as cu
from spf_tpu.ops import encryption_u32 as eu
from spf_tpu.ops import fft_pallas as fp
from spf_tpu.ops import keyswitch_u32 as ku
from spf_tpu.ops import limb32 as lb
from spf_tpu.params import DEFAULT_128 as J_DEFAULT_128
from spf_tpu.params import GlweDef as JGlwe
from spf_tpu.params import LweDef as JLwe
from spf_tpu.params import RadixDecomposition as JRadix
from spf_tpu.utils import host_crypto as hc
from spf_tpu_torch import convert
from spf_tpu_torch.ops import bootstrap, cbs, encryption, keyswitch, multibit, torus
from spf_tpu_torch.params import RadixDecomposition

torch.set_num_threads(1)

N = 64
B = 4
GROUP = 2
# DEFAULT_128's radices at N = 64, n0 = 8, with negligible noise
J_PARAMS = dataclasses.replace(J_DEFAULT_128, l0_params=JLwe(8, 1e-16),
                               l1_params=JGlwe(1, N, 1e-16))
PARAMS = convert.param(J_PARAMS)
LWE, GLWE = PARAMS.l0_params, PARAMS.l1_params
P_CANON = 64  # polynomials per twin FFT call, so that every call shares one shape


@pytest.fixture(autouse=True)
def _flush_denormals():
    """XLA:CPU flushes subnormal f32 values to zero; PyTorch keeps them
    (see tests/test_torch_ops.py)."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _glev_np(rng, msg, glwe_sk, radix):
    """GLEV of a small-integer polynomial (int64 [N]) with the numpy mirror:
    level j encrypts msg * q/B^(j+1)."""
    m = msg.astype(np.int64).astype(np.uint64)
    return np.stack([
        hc.encrypt_glwe_np(rng, m * np.uint64(1 << (64 - radix.radix_log * (j + 1))), glwe_sk,
                           J_PARAMS.l1_params)
        for j in range(radix.count)
    ])


def _pow_k_np(s, k_exp):
    j = np.arange(N)
    out = np.zeros(N, np.int64)
    out[(j * k_exp) % N] = s.astype(np.int64) * (1 - 2 * (((j * k_exp) // N) % 2))
    return out


@pytest.fixture(scope="module")
def keys():
    """The cycle's keys in the coefficient domain, u64, from the numpy
    mirror; and their spectra, made by the port's FFT."""
    p = J_PARAMS
    rng = np.random.default_rng(64)
    lwe_sk = rng.integers(0, 2, LWE.dim).astype(np.uint64)
    glwe_sk = rng.integers(0, 2, (1, N)).astype(np.uint64)
    prods = multibit.multibit_key_products_np(lwe_sk, GROUP)
    mb = np.stack([
        np.stack([hc.encrypt_ggsw_scalar_np(rng, int(m), glwe_sk, p.l1_params, p.cbs_pbs_radix)
                  for m in row])
        for row in prods
    ])  # [4, 3, 2, 4, 2, N]
    single = np.stack([hc.encrypt_ggsw_scalar_np(rng, int(s), glwe_sk, p.l1_params, p.cbs_pbs_radix)
                       for s in lwe_sk])  # [8, 2, 4, 2, N]
    ak = np.stack([
        _glev_np(rng, _pow_k_np(glwe_sk[0], N // (1 << (i - 1)) + 1), glwe_sk, p.tr_radix)[None]
        for i in range(1, GLWE.log_degree + 1)
    ])  # [6, 1, 6, 2, N]
    ss = hc.negacyclic_mul_binary_np(glwe_sk[0], glwe_sk[0]).view(np.int64)
    ssk = _glev_np(rng, ss, glwe_sk, p.ss_radix)[None, None]  # [1, 1, 15, 2, N]
    flat_sk = glwe_sk.reshape(-1)
    with np.errstate(over="ignore"):  # host_crypto's u64 sums wrap by design
        ksk = np.stack([
            np.stack([hc.encrypt_lwe_np(rng, int(s) << (64 - p.ks_radix.radix_log * (j + 1)),
                                        lwe_sk, p.l0_params)
                      for j in range(p.ks_radix.count)])
            for s in flat_sk
        ])  # [N, 6, 9]
    return dict(lwe_sk=lwe_sk, glwe_sk=glwe_sk, mb=mb, single=single, ak=ak, ssk=ssk, ksk=ksk,
                ak_freq=bootstrap.bsk_to_freq(torus.from_u64_np(ak)),
                ssk_freq=bootstrap.bsk_to_freq(torus.from_u64_np(ssk)))


def _canon_fwd(hi, lo):
    """fwd_ds_ref on [P_CANON, N, B] rows: the inputs flattened and padded,
    the outputs cut back (each polynomial and column transforms alone)."""
    lead = hi.shape[:-2]
    p = int(np.prod(lead)) if lead else 1
    pad = ((0, P_CANON - p), (0, 0), (0, 0))
    f = fp.fwd_ds_ref(*(jnp.pad(x.reshape(p, *x.shape[-2:]), pad) for x in (hi, lo)))
    return tuple(c[:p].reshape(*lead, *c.shape[-2:]) for c in f)


def _python_scan(f, init, xs):
    carry, ys = init, []
    for i in range(jax.tree_util.tree_leaves(xs)[0].shape[0]):
        carry, y = f(carry, jax.tree_util.tree_map(lambda x: x[i], xs))
        ys.append(y)
    return carry, None if ys[0] is None else jax.tree_util.tree_map(lambda *y: jnp.stack(y), *ys)


@pytest.fixture
def twins(monkeypatch):
    """The JAX functions with the bit-reversed FFT twins in place of
    their backend's FFT, and `scan` as a Python loop."""
    def fwd_signed(digits, use_pallas=None):
        d = digits.astype(jnp.float32)
        return _canon_fwd(d, jnp.zeros_like(d))

    def fwd_limb(a, use_pallas=None):
        return _canon_fwd(*lb.to_ds(a))

    def inv_limb(f, use_pallas=None):
        return lb.from_ds(*fp.inv_ds_ref(f))

    for mod in (cu, bu):
        monkeypatch.setattr(mod, "fwd_signed", fwd_signed)
        monkeypatch.setattr(mod, "inv_limb", inv_limb)
    monkeypatch.setattr(cu, "fwd_limb", fwd_limb)
    monkeypatch.setattr(jax.lax, "scan", _python_scan)


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _eq_planes(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w), err_msg=f"plane {i}")


def _eq_torus(got, want_limb):
    np.testing.assert_array_equal(torus.to_u64_np(got), lb.to_u64_np(want_limb))


def _jplanes(planes):
    return tuple(jnp.asarray(c.numpy()) for c in planes)


def _random_torus(seed, shape):
    return np.random.default_rng(seed).integers(0, 1 << 64, size=shape, dtype=np.uint64)


def test_keyswitch_glwe_bit_for_bit(keys, twins):
    ct = _random_torus(1, (2, N, B))
    row = tuple(c[3] for c in keys["ak_freq"])
    got = cbs.keyswitch_glwe(torus.from_u64_np(ct), row, GLWE, PARAMS.tr_radix)
    want = cu.keyswitch_glwe_u32(lb.from_u64_np(ct), _jplanes(row), J_PARAMS.l1_params,
                                 J_PARAMS.tr_radix)
    _eq_torus(got, want)


def test_trace_bit_for_bit(keys, twins):
    ct = _random_torus(2, (2, N, B))
    got = cbs.trace(torus.from_u64_np(ct), keys["ak_freq"], GLWE, PARAMS.tr_radix)
    want = cu.trace_u32(lb.from_u64_np(ct), _jplanes(keys["ak_freq"]), J_PARAMS.l1_params,
                        J_PARAMS.tr_radix)
    _eq_torus(got, want)


def test_scheme_switch_and_batched_cmux_bit_for_bit(keys, twins):
    """The GGSW spectra of a scheme switch, then a CMux under them (one
    GGSW per batch column, the MAD with a batched row)."""
    glev = _random_torus(3, (PARAMS.cbs_radix.count, 2, N, B))
    got = cbs.scheme_switch(torus.from_u64_np(glev), keys["ssk_freq"], GLWE, PARAMS.cbs_radix,
                            PARAMS.ss_radix)
    want = cu.scheme_switch_u32(lb.from_u64_np(glev), _jplanes(keys["ssk_freq"]), J_PARAMS.l1_params,
                                J_PARAMS.cbs_radix, J_PARAMS.ss_radix)
    _eq_planes(got, want)
    d0, d1 = _random_torus(4, (2, N, B)), _random_torus(5, (2, N, B))
    sel = bootstrap.cmux(torus.from_u64_np(d0), torus.from_u64_np(d1), got, PARAMS.cbs_radix)
    want_sel = bu.cmux_u32(lb.from_u64_np(d0), lb.from_u64_np(d1), want, J_PARAMS.l1_params,
                           J_PARAMS.cbs_radix)
    _eq_torus(sel, want_sel)


def test_keyswitch_lwe_bit_for_bit(keys):
    """Exact f32 products of byte planes against the reference's bf16
    products with f32 accumulation (both exact below 2^24)."""
    ct = _random_torus(6, (N + 1, B))
    planes = keyswitch.ksk_to_byte_planes(keys["ksk"])
    got = keyswitch.keyswitch_lwe(torus.from_u64_np(ct), planes, GLWE.as_lwe_def(), LWE,
                                  PARAMS.ks_radix)
    jplanes = ku.ksk_to_byte_planes(keys["ksk"])
    np.testing.assert_array_equal(planes.numpy(), np.asarray(jplanes, dtype=np.float32))
    want = ku.keyswitch_lwe_u32(lb.from_u64_np(ct), jplanes, J_PARAMS.l1_params.as_lwe_def(),
                                J_PARAMS.l0_params, J_PARAMS.ks_radix)
    _eq_torus(got, want)


def test_keyswitch_lwe_under_tf32_setting(keys):
    """A caller's `fp32_precision = "tf32"` neither raises in the keyswitch
    nor changes its bits (the product runs in f64, which the setting does
    not reach); the setting is restored after."""
    ct = _random_torus(6, (N + 1, B))
    matmul = torch.backends.cuda.matmul
    old = matmul.fp32_precision
    matmul.fp32_precision = "tf32"
    try:
        got = keyswitch.keyswitch_lwe(torus.from_u64_np(ct), keyswitch.ksk_to_byte_planes(keys["ksk"]),
                                      GLWE.as_lwe_def(), LWE, PARAMS.ks_radix)
        assert matmul.fp32_precision == "tf32"
    finally:
        matmul.fp32_precision = old
    want = ku.keyswitch_lwe_u32(lb.from_u64_np(ct), ku.ksk_to_byte_planes(keys["ksk"]),
                                J_PARAMS.l1_params.as_lwe_def(), J_PARAMS.l0_params,
                                J_PARAMS.ks_radix)
    _eq_torus(got, want)


@pytest.mark.parametrize("n, count, log_b", [(64, 4, 4), (128, 2, 9), (64, 3, 5)])
def test_cbs_lut_matches(n, count, log_b):
    got = cbs.multifunctional_cbs_lut_np(convert.param(JGlwe(1, n, 0.0)), RadixDecomposition(count, log_b))
    want = cu.multifunctional_cbs_lut_np(JGlwe(1, n, 0.0), JRadix(count, log_b))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 11, 31, 32, 33, 63])
def test_shr_round_matches(n):
    x = _random_torus(7, (64,))
    x[:4] = [0, (1 << 64) - 1, 1 << 63, (1 << 63) - 1]
    got = torus.shr_round(torus.from_u64_np(x), n)
    _eq_torus(got, lb.shr_round(lb.from_u64_np(x), n))


def test_encode_const_and_add_small_match():
    x = _random_torus(8, (64,))
    x[:2] = [(1 << 64) - 1, (1 << 64) - (1 << 62)]
    for val, bits in [(1, 2), (1, 1), (3, 5), (1, 9), (5, 64), (0, 3)]:
        c = torus.encode_const(val, bits)
        hi, lo = lb.encode_const(val, bits)
        assert c % (1 << 64) == (hi << 32) | lo
        _eq_torus(torus.add_small(torus.from_u64_np(x), c), lb.add_small(lb.from_u64_np(x), hi, lo))


def test_modulus_switch_log_v_matches():
    """The CBS input switch: log_v = 2 (cbs_u32.py:218)."""
    x = _random_torus(9, (LWE.dim + 1, 16))
    x[0, :3] = [(1 << 64) - 1, 1 << 63, 0]
    got = torus.modulus_switch(torus.from_u64_np(x), 0, 2, GLWE.log_degree + 1)
    want = lb.modulus_switch(lb.from_u64_np(x), 0, 2, GLWE.log_degree + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def _decode_bits(out, lwe_sk, bits_in):
    phase = encryption.lwe_phase_np(torus.to_u64_np(out).T, lwe_sk)
    dec = ((phase >> np.uint64(63)) + ((phase >> np.uint64(62)) & np.uint64(1))) & np.uint64(1)
    np.testing.assert_array_equal(dec, bits_in)
    err = (phase - (bits_in.astype(np.uint64) << np.uint64(63))).astype(np.int64)
    return 62 - np.log2(max(float(np.abs(err).max()), 1.0))


def _bits_ct(lwe_sk, seed):
    bits_in = (np.arange(B) % 2).astype(np.uint64)
    ct = encryption.encrypt_lwe_np(np.random.default_rng(seed), bits_in << np.uint64(63), lwe_sk, LWE)
    return bits_in, torus.from_u64_np(ct.T.copy())


@pytest.mark.parametrize("kind", ["multibit", "single_bit_phase_rot"])
def test_cycle_decrypts_with_carried_keys(keys, kind):
    """The whole cycle, its numpy keys carried across as u64 and limb
    pairs (`convert.conversion_cycle`): a fresh L0 encryption of each bit."""
    bsk = keys["mb"] if kind == "multibit" else convert.u64_to_limbs(keys["single"])
    cycle = convert.conversion_cycle(bsk, convert.u64_to_limbs(keys["ak"]), keys["ssk"], keys["ksk"],
                                     J_PARAMS, phase_rot=kind != "multibit", device="cpu")
    bits_in, ct = _bits_ct(keys["lwe_sk"], 10)
    out = cycle(ct)
    assert tuple(out.shape) == (LWE.dim + 1, B)
    assert _decode_bits(out, keys["lwe_sk"], bits_in) > 4


def test_port_keygen_decrypts_and_cycles():
    """The port's own keys: each automorphism, scheme-switch and keyswitch
    key decrypts to its message, and a cycle with them (multi-bit, g = 2)
    decrypts."""
    gen = torch.Generator().manual_seed(12)
    p = PARAMS
    lwe_sk = encryption.generate_lwe_sk(LWE, gen)
    glwe_sk = encryption.generate_glwe_sk(GLWE, gen)
    sk = glwe_sk.numpy().astype(np.uint64)
    ak = encryption.generate_automorphism_keys(glwe_sk, GLWE, p.tr_radix, gen)
    ssk = encryption.generate_scheme_switch_key(glwe_sk, GLWE, p.ss_radix, gen)
    ksk = encryption.generate_lwe_keyswitch_key(glwe_sk.reshape(-1), lwe_sk, LWE, p.ks_radix, gen)
    assert tuple(ak.shape) == (GLWE.log_degree, 1, p.tr_radix.count, 2, N)
    assert tuple(ssk.shape) == (1, 1, p.ss_radix.count, 2, N)
    assert tuple(ksk.shape) == (N, p.ks_radix.count, LWE.dim + 1)

    def check_glev(glev, msg, radix):
        for j in range(radix.count):
            phase = hc.decrypt_glwe_np(torus.to_u64_np(glev[j]), sk, GLWE)
            want = msg.astype(np.int64).astype(np.uint64) << np.uint64(64 - radix.radix_log * (j + 1))
            assert np.abs((phase - want).astype(np.int64)).max() < (1 << 20)

    for i in range(GLWE.log_degree):
        k_exp = N // (1 << i) + 1
        want = _pow_k_np(sk[0], k_exp)
        jh, jl = eu._pow_k_limb_binary(jnp.asarray(sk[0].astype(np.uint32)), k_exp)
        np.testing.assert_array_equal(want.view(np.uint64), lb.to_u64_np((jh, jl)))
        check_glev(ak[i, 0], want, p.tr_radix)
    check_glev(ssk[0, 0], hc.negacyclic_mul_binary_np(sk[0], sk[0]).view(np.int64), p.ss_radix)
    phases = encryption.lwe_phase_np(torus.to_u64_np(ksk).reshape(-1, LWE.dim + 1),
                                     lwe_sk.numpy().astype(np.uint64)).reshape(N, -1)
    for j in range(p.ks_radix.count):
        want = sk.reshape(-1) << np.uint64(64 - p.ks_radix.radix_log * (j + 1))
        assert np.abs((phases[:, j] - want).astype(np.int64)).max() < (1 << 20)

    bsk = encryption.generate_multibit_bsk(lwe_sk, glwe_sk, GLWE, p.cbs_pbs_radix, GROUP, gen)
    cycle = cbs.ConversionCycle(bsk, ak, ssk, ksk, p, device="cpu")
    bits_in, ct = _bits_ct(lwe_sk.numpy().astype(np.uint64), 13)
    assert _decode_bits(cycle(ct), lwe_sk.numpy().astype(np.uint64), bits_in) > 4


def test_cycle_rejects_misshapen_keys(keys):
    with pytest.raises(ValueError, match="ak shape"):
        cbs.ConversionCycle(keys["mb"], keys["ak"][:3], keys["ssk"], keys["ksk"], PARAMS,
                            device="cpu")
    with pytest.raises(ValueError, match="ksk shape"):
        cbs.ConversionCycle(keys["mb"], keys["ak"], keys["ssk"], keys["ksk"][:, :3], PARAMS,
                            device="cpu")
