"""The port's parameters, int64 torus arithmetic and ds32 arithmetic
against the JAX package, bit for bit.

`spf_tpu_torch.ops.torus` against `spf_tpu.ops.limb32` on random u64
values and on the f32 -> i32 clamp edges of `limb32.to_ds`/`from_ds`;
`spf_tpu_torch.ops.ds` against `spf_tpu.ops.ds` and the complex helpers
of `fft_ds32_t`, run op by op under `jax.disable_jit()` (under `jit`,
XLA:CPU contracts FP operations and the error terms change).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spf_tpu import params as jparams
from spf_tpu.ops import ds as jds
from spf_tpu.ops import fft_ds32_t as jft
from spf_tpu.ops import limb32 as lb
from spf_tpu_torch import convert, params
from spf_tpu_torch.ops import ds, torus

torch.set_num_threads(1)

RNG = np.random.default_rng(2024)
EDGES = np.array(
    [0, 1, (1 << 64) - 1, 1 << 63, (1 << 63) - 1, (1 << 32) - 1, 1 << 32,
     1 << 31, 0x7FFFFFFF_FFFFFFFF, 0x7FFFFFFF_00000000, 0x80000000_00000000,
     0x7FFFFFFF_80000000, 0xFFFFFFFF_80000000, 0x00000000_80000000,
     0x7FFF8000_00000000, 0xFFFF8000_00000000],
    dtype=np.uint64,
)


def _u64(shape):
    return RNG.integers(0, 1 << 64, size=shape, dtype=np.uint64)


def _values():
    return np.concatenate([EDGES, _u64(4096)])


def _limb(x):
    return lb.from_u64_np(x)


def _port(x):
    return torus.from_u64_np(x)


def _eq_limb(port_t, limb_pair):
    np.testing.assert_array_equal(torus.to_u64_np(port_t), lb.to_u64_np(limb_pair))


def _eq_f32(port_t, jax_a):
    """Bit-for-bit equality of f32 values (sign of zero included)."""
    got = port_t.numpy().view(np.uint32)
    want = np.asarray(jax_a, dtype=np.float32).view(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["DEFAULT_128", "TEST_PARAMS"])
def test_params_match_field_for_field(name):
    ref = getattr(jparams, name)
    got = getattr(params, name)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert convert.param(ref) == got


def test_u64_roundtrip_and_limbs():
    x = _values()
    np.testing.assert_array_equal(torus.to_u64_np(_port(x)), x)
    hi, lo = convert.u64_to_limbs(x)
    np.testing.assert_array_equal(convert.limbs_to_u64(hi, lo), x)
    np.testing.assert_array_equal(lb.to_u64_np((hi, lo)), x)
    np.testing.assert_array_equal(torus.to_u64_np(convert.to_tensor((hi, lo), device="cpu")), x)
    lwe_sk, glwe_sk = convert.secret_keys(np.array([0, 1, 1], np.uint64), np.array([[1, 0]], np.uint64), "cpu")
    assert lwe_sk.dtype == glwe_sk.dtype == torch.int64
    assert lwe_sk.tolist() == [0, 1, 1] and glwe_sk.tolist() == [[1, 0]]


def test_add_sub_neg():
    x, y = _values(), _u64(EDGES.size + 4096)
    _eq_limb(torus.add(_port(x), _port(y)), lb.add(_limb(x), _limb(y)))
    _eq_limb(torus.sub(_port(x), _port(y)), lb.sub(_limb(x), _limb(y)))
    _eq_limb(torus.neg(_port(x)), lb.neg(_limb(x)))


@pytest.mark.parametrize("count,log_b", [(2, 16), (4, 8)])
def test_decompose(count, log_b):
    radix = params.RadixDecomposition(count=count, radix_log=log_b)
    jradix = jparams.RadixDecomposition(count=count, radix_log=log_b)
    x = _values()
    got = torus.decompose(_port(x), radix)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(lb.decompose(_limb(x), jradix)))


@pytest.mark.parametrize("log_chi,log_v,log_modulus", [
    (0, 0, 12), (0, 0, 9), (2, 0, 12), (0, 3, 13),
    # log_modulus 32: the reference's u32 result wraps where log_modulus + log_v > 32
    (0, 1, 32), (0, 2, 32), (0, 3, 32),
])
def test_modulus_switch(log_chi, log_v, log_modulus):
    x = np.concatenate([_values(), np.array([0xFFFFFFFF_00000000], dtype=np.uint64)])
    got = torus.modulus_switch(_port(x), log_chi, log_v, log_modulus)
    want = np.asarray(lb.modulus_switch(_limb(x), log_chi, log_v, log_modulus))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_to_ds():
    """Bit for bit on random values and the edges, among them hi limb
    0x7FFFFFFF: f32(2^31 - 1) rounds up to 2^31, which limb32 clamps
    below +2^31 and carries as a residual."""
    x = _values()
    got = torus.to_ds(_port(x))
    with jax.disable_jit():
        want = lb.to_ds(_limb(x))
    for g, w in zip(got, want):
        _eq_f32(g, w)
    i = int(np.nonzero(x == 0x7FFFFFFF_00000000)[0][0])
    assert float(got[0][i]) + float(got[1][i]) == float(0x7FFFFFFF * 2**32)


# ds pairs whose residues hit the f32 -> i32 clamp (+2^31 saturates to
# 2^31 - 1 in limb32's casts, where PyTorch's own cast would wrap to -2^31)
# and the mod 2^64 reductions
FROM_DS_EDGES = np.array(
    [[e, 0.0] for e in (2.0**31, -(2.0**31), 3 * 2.0**31, 2.0**63, 2.0**64 + 2.0**31, -(2.0**63))]
    + [[e, e] for e in (2.0**31, -(2.0**31), 2.0**63)] + [[0.0, 2.0**31], [1.0, 2.0**31]],
    dtype=np.float32,
)


def _ds_inputs(n):
    """ds pairs over a wide range of magnitudes (IFFT outputs reach ~2^85),
    then the edges."""
    exps = RNG.integers(0, 86, size=n)
    v = RNG.standard_normal(n) * np.exp2(exps)
    vh = v.astype(np.float32)
    vl = (RNG.standard_normal(n) * np.exp2(np.maximum(exps - 26, 0))).astype(np.float32)
    return np.concatenate([vh, FROM_DS_EDGES[:, 0]]), np.concatenate([vl, FROM_DS_EDGES[:, 1]])


def test_from_ds():
    vh, vl = _ds_inputs(8192)
    got = torus.from_ds(torch.from_numpy(vh), torch.from_numpy(vl))
    want = lb.from_ds(jnp.asarray(vh), jnp.asarray(vl))
    _eq_limb(got, want)
    assert int(got[8192]) == (1 << 31) - 1  # the +2^31 residue saturated


def _ds_operands(n):
    x = RNG.standard_normal(n) * np.exp2(RNG.integers(-20, 60, size=n))
    return ds.from_f64_array(x)


def _two_prod_operands(against):
    """f32 operands a, b. For "f64": exponents over a wide range, with pairs
    near 2^60 * 2^60 and 2^-60 * 2^-60 and products down to 2^-150, so that
    some errors and some products are subnormal. For "jax": only pairs whose
    Veltkamp partial products stay normal (|a*b| >= 2^-90, below 2^121),
    where the split is exact too."""
    n = 8192
    m = RNG.uniform(1.0, 2.0, size=(2, n)) * RNG.choice([-1.0, 1.0], size=(2, n))
    e = RNG.integers(-75, 64, size=(2, n))
    e[:, :256] = RNG.integers(57, 64, size=(2, 256))  # near 2^60 * 2^60
    e[:, 256:512] = RNG.integers(-64, -56, size=(2, 256))  # near 2^-60 * 2^-60
    a, b = (m * np.exp2(e)).astype(np.float32)
    if against == "jax":
        keep = (e.sum(axis=0) >= -90) & (e.sum(axis=0) <= 120)
        a, b = a[keep], b[keep]
    return a, b


@pytest.mark.parametrize("against", ["f64", "jax"])
def test_two_prod_error_is_exact(against):
    """ds.two_prod's error term is the exact a*b - p rounded once to f32:
    against numpy's f64 (a*b - p), subnormal products and errors included,
    and against the reference's Veltkamp split (`spf_tpu.ops.ds.two_prod`,
    op by op) where no partial product underflows."""
    a, b = _two_prod_operands(against)
    p, err = ds.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    if against == "f64":
        want_p = a * b
        want_err = (a.astype(np.float64) * b.astype(np.float64) - want_p.astype(np.float64)).astype(
            np.float32)
        tiny = np.finfo(np.float32).tiny
        assert (np.abs(want_err[want_err != 0]) < tiny).sum() > 100  # subnormal errors
        assert ((np.abs(want_p) < tiny) & (want_p != 0)).sum() > 10  # subnormal products
        np.testing.assert_array_equal(p.numpy().view(np.uint32), want_p.view(np.uint32))
        np.testing.assert_array_equal(err.numpy().view(np.uint32), want_err.view(np.uint32))
    else:
        with jax.disable_jit():
            jp, jerr = jds.two_prod(jnp.asarray(a), jnp.asarray(b))
        _eq_f32(p, jp)
        _eq_f32(err, jerr)


def test_ds_ops_bit_for_bit():
    a = _ds_operands(4096)
    b = _ds_operands(4096)
    ta = tuple(torch.from_numpy(c) for c in a)
    tb = tuple(torch.from_numpy(c) for c in b)
    ja = tuple(jnp.asarray(c) for c in a)
    jb = tuple(jnp.asarray(c) for c in b)
    with jax.disable_jit():
        cases = [
            (ds.two_sum(ta[0], tb[0]), jds.two_sum(ja[0], jb[0])),
            (ds.quick_two_sum(ta[0], ta[1]), jds.quick_two_sum(ja[0], ja[1])),
            (ds.two_prod(ta[0], tb[0]), jds.two_prod(ja[0], jb[0])),
            (ds.add(*ta, *tb), jds.add(*ja, *jb)),
            (ds.sub(*ta, *tb), jds.sub(*ja, *jb)),
            (ds.mul(*ta, *tb), jds.mul(*ja, *jb)),
        ]
        za = ta + tb
        zb = tb + ta
        jza = ja + jb
        jzb = jb + ja
        cases += [
            (ds.cadd(za, zb), jft._cadd(jza, jzb)),
            (ds.csub(za, zb), jft._csub(jza, jzb)),
            (ds.cmul(za, zb), jft._cmul(jza, jzb)),
        ]
        for got, want in cases:
            for g, w in zip(got, want):
                _eq_f32(g, w)
