"""The u64 API's ds32 backend (`spf_tpu_torch/ops/u64/fft_ds32.py`) and
the two `ops/ds.py` conversions it adds, against the JAX package's
`spf_tpu/ops/fft_ds32.py::DS32` and `spf_tpu/ops/ds.py`, on the CPU.

Bit for bit, every f32 plane and every int64: the reference runs op by
op (eagerly, outside any `jit`, where XLA:CPU cannot contract a multiply
and an add), and subnormals are flushed in PyTorch while comparing, as
XLA:CPU flushes them. The port's TwoProd is the fma form
(`ops/ds.py::two_prod`), the reference's the Veltkamp split: the tests
hold them to the same bits here rather than assume it. The port runs
one unbatched N = 64 shape and the shapes one batched CMux at k = 1,
l = 2 gives; the reference (`J_DS32`, the JAX package's `DS32` behind a
shim) sees each of them as rows padded to [ROWS, N] or [ROWS, N/2], so
that its eager operators compile for one shape (the transforms act on
the last axis and the rest is elementwise: a row's bits do not depend on
the others).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spf_tpu.ops import ds as j_ds
from spf_tpu.ops import fft_ops as j_fft_ops
from spf_tpu.ops.fft_ds32 import DS32 as JAX_DS32
from spf_tpu.ops.fft_ds32 import DS32Backend as JDS32Backend
from spf_tpu.ops.fft_ds32 import DsFreq as JDsFreq
from spf_tpu.params import GlweDef as JGlweDef
from spf_tpu.params import RadixDecomposition as JRadix
from spf_tpu_torch.ops import ds
from spf_tpu_torch.ops.torus import to_u64_np
from spf_tpu_torch.ops.u64 import encryption as enc
from spf_tpu_torch.ops.u64 import fft_ops
from spf_tpu_torch.ops.u64 import scheme_switch as ss
from spf_tpu_torch.ops.u64 import torus as t64
from spf_tpu_torch.ops.u64.fft import get_backend
from spf_tpu_torch.ops.u64.fft_ds32 import DS32, DsFreq
from spf_tpu_torch.params import GlweDef, LweDef, Params, RadixDecomposition
from spf_tpu_torch.runtime import Evaluation, generate_keys
from spf_tpu_torch.runtime.executor import CircuitExecutor
from spf_tpu_torch.runtime.fluent import FheCircuitCtx, UInt

torch.set_num_threads(1)

N = 64
GLWE = GlweDef(size=1, degree=N, std=1e-16)
RADIX = RadixDecomposition(count=2, radix_log=9)
J_GLWE = JGlweDef(size=1, degree=N, std=1e-16)
J_RADIX = JRadix(count=2, radix_log=9)
SS_RADIX = RadixDecomposition(count=6, radix_log=8)
J_SS_RADIX = JRadix(count=6, radix_log=8)


ROWS = 16


def _rows(x, last):
    """x [..., last] flattened and zero-padded to [ROWS, last] (in numpy:
    no JAX operator to compile)."""
    flat = np.asarray(x).reshape(-1, last)
    return jnp.asarray(np.pad(flat, ((0, ROWS - flat.shape[0]), (0, 0))))


def _cut(x, lead):
    """The first rows of x [ROWS, *] back to [*lead, *]."""
    return jnp.asarray(np.asarray(x)[:int(np.prod(lead))].reshape(*lead, x.shape[-1]))


class _RowsDS32(JDS32Backend):
    """The JAX package's DS32 with every transform and MAD run on [ROWS, *]
    rows, then cut back to the caller's shape."""

    def fwd_torus(self, x):
        return JDsFreq(*(_cut(c, x.shape[:-1])
                         for c in JAX_DS32.fwd_torus(_rows(x, x.shape[-1])).astuple()))

    def fwd_signed(self, x):
        return JDsFreq(*(_cut(c, x.shape[:-1])
                         for c in JAX_DS32.fwd_signed(_rows(x, x.shape[-1])).astuple()))

    def inv(self, f):
        rows = JDsFreq(*(_rows(c, f.shape[-1]) for c in f.astuple()))
        return _cut(JAX_DS32.inv(rows), f.shape[:-1])

    def cmadd(self, acc, a, b):
        lead = np.broadcast_shapes(acc.shape[:-1], a.shape[:-1], b.shape[:-1])
        k = acc.shape[-1]

        def rows(f):
            return JDsFreq(*(_rows(np.broadcast_to(c, (*lead, k)), k) for c in f.astuple()))

        out = JAX_DS32.cmadd(rows(acc), rows(a), rows(b))
        return JDsFreq(*(_cut(c, lead) for c in out.astuple()))


J_DS32 = _RowsDS32()


@pytest.fixture(autouse=True)
def _flush_denormals():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _u64(rng, shape):
    return rng.integers(0, 2**64, shape, dtype=np.uint64)


def _tt(a) -> torch.Tensor:
    return t64.u64(np.asarray(a).astype(np.uint64))


def _eq_freq(got: DsFreq, want):
    for i, (g, w) in enumerate(zip(got.astuple(), want.astuple())):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w, np.float32).view(np.uint32),
                                      err_msg=f"plane {i}")


def test_from_i64_and_to_u64_mod_q_bit_for_bit():
    """Random int64 and the edges (the clamp at 2^63 - 2^40, both ends of
    the range); ds values up to 2^85 in magnitude, halves, and the +2^63
    endpoint of the reduction. Shaped as the transforms' rows ([ROWS, N]
    and [ROWS, N/2]), whose operators the reference has compiled."""
    rng = np.random.default_rng(0)
    edges = np.array([0, 1, -1, 2**63 - 1, -(2**63), 2**63 - 2**40, 2**63 - 2**40 + 1,
                      2**40 - 1, -(2**40) + 1], dtype=np.int64)
    small = rng.integers(-(2**40), 2**40, 300).astype(np.int64)
    big = rng.integers(-(2**63), 2**63 - 1, ROWS * N - edges.size - small.size, dtype=np.int64)
    x = np.concatenate([big, edges, small]).reshape(ROWS, N)
    got = ds.from_i64(torch.from_numpy(x))
    want = j_ds.from_i64(jnp.asarray(x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w).view(np.uint32))

    ends = np.array([2.0**63, -(2.0**63), 2.0**64, 3 * 2.0**63, 2.0**85, 0.5, 1.5, -2.5],
                    np.float32)
    hi = np.concatenate([(rng.standard_normal(ROWS * N // 2 - ends.size)
                          * 2.0 ** rng.integers(0, 86, ROWS * N // 2 - ends.size)), ends])
    hi = hi.astype(np.float32)
    lo = (hi * rng.standard_normal(hi.size).astype(np.float32) * np.float32(2.0**-25))
    lo[-8:] = [0.5, -0.5, 1.5, 2.5, -1.5, 0.0, 0.5, 3.5]
    hi, lo = hi.reshape(ROWS, N // 2), lo.reshape(ROWS, N // 2)
    got = ds.to_u64_mod_q(torch.from_numpy(hi), torch.from_numpy(lo))
    want = j_ds.to_u64_mod_q(jnp.asarray(hi), jnp.asarray(lo))
    np.testing.assert_array_equal(to_u64_np(got), np.asarray(want))


@pytest.mark.parametrize("shape", [(N,), (2, 2, N)], ids=["N", "batched"])
def test_fwd_and_inv_bit_for_bit(shape):
    """fwd_torus on torus values, fwd_signed on gadget-sized digits, and
    the inverse of each spectrum (the forward transform's rounding error
    included) back to int64."""
    rng = np.random.default_rng(len(shape))
    x = _u64(rng, shape)
    got, want = DS32.fwd_torus(_tt(x)), J_DS32.fwd_torus(jnp.asarray(x))
    _eq_freq(got, want)
    np.testing.assert_array_equal(to_u64_np(DS32.inv(got)), np.asarray(J_DS32.inv(want)))
    d = rng.integers(-256, 256, shape).astype(np.int64)
    got, want = DS32.fwd_signed(torch.from_numpy(d)), J_DS32.fwd_signed(jnp.asarray(d))
    _eq_freq(got, want)
    np.testing.assert_array_equal(to_u64_np(DS32.inv(got)), np.asarray(J_DS32.inv(want)))


def test_cmadd_and_cmux_bit_for_bit(monkeypatch):
    """The frequency-domain MAD, then a CMux at k = 1, l = 2 with a batch
    of two selects (bits 0 and 1), the GGSW spectra from both backends
    equal, and the CMux decrypting to the selected input. The reference's
    gadget decomposition (integer) runs jitted: the same bits, one
    compile."""
    monkeypatch.setattr(j_fft_ops, "decompose", jax.jit(j_fft_ops.decompose, static_argnums=1))
    rng = np.random.default_rng(7)
    acc, key = _u64(rng, (2, N)), _u64(rng, (2, N))  # an accumulator, a key row
    d = rng.integers(-256, 256, (2, N)).astype(np.int64)  # gadget digits
    fa, fk = DS32.fwd_torus(_tt(acc)), DS32.fwd_torus(_tt(key))
    ja, jk = J_DS32.fwd_torus(jnp.asarray(acc)), J_DS32.fwd_torus(jnp.asarray(key))
    fd, jd = DS32.fwd_signed(torch.from_numpy(d)), J_DS32.fwd_signed(jnp.asarray(d))
    _eq_freq(DS32.cmadd(fa, fd, fk), J_DS32.cmadd(ja, jd, jk))

    gen = torch.Generator().manual_seed(7)
    sk = enc.generate_glwe_sk(gen, GLWE)
    ggsw = enc.encrypt_ggsw_scalar(gen, torch.tensor([0, 1]), sk, GLWE, RADIX)  # [2, 2, 2, 2, N]
    sel = DS32.fwd_torus(ggsw)
    j_sel = J_DS32.fwd_torus(jnp.asarray(to_u64_np(ggsw)))
    _eq_freq(sel, j_sel)
    m0 = t64.encode(torch.zeros(N, dtype=torch.int64), 1)
    m1 = t64.encode(torch.ones(N, dtype=torch.int64), 1)
    d0, d1 = enc.encrypt_glwe(gen, m0, sk, GLWE), enc.encrypt_glwe(gen, m1, sk, GLWE)
    got = fft_ops.cmux(d0, d1, sel, GLWE, RADIX, get_backend("ds32"))
    want = j_fft_ops.cmux(jnp.asarray(to_u64_np(d0)), jnp.asarray(to_u64_np(d1)), j_sel,
                          J_GLWE, J_RADIX, J_DS32)
    np.testing.assert_array_equal(to_u64_np(got), np.asarray(want))
    dec = t64.decode(enc.decrypt_glwe(got, sk, GLWE), 1)
    assert (dec[0] == 0).all() and (dec[1] == 1).all()


def test_scheme_switch_bit_for_bit(monkeypatch):
    """GLEV(m) -> GGSW(m) in the frequency domain (`fft_ops.scheme_switch_fft`
    with the backend's set_component and stack), bit for bit with the
    reference for m = 0 and 1 on one key; each GGSW then selects between
    trivial 0 and trivial 1 in a CMux, decoding to m (bench.py's check)."""
    monkeypatch.setattr(j_fft_ops, "decompose", jax.jit(j_fft_ops.decompose, static_argnums=1))
    gen = torch.Generator().manual_seed(11)
    sk = enc.generate_glwe_sk(gen, GLWE)
    ssk = ss.generate_scheme_switch_key(gen, sk, GLWE, SS_RADIX, DS32)  # [1, 1, 6, 2, N/2]
    j_ssk = JDsFreq(*(jnp.asarray(c.numpy()) for c in ssk.astuple()))
    zero = enc.trivial_glwe(t64.encode(torch.zeros(N, dtype=torch.int64), 1), GLWE)
    one = enc.trivial_glwe(t64.encode(torch.ones(N, dtype=torch.int64), 1), GLWE)
    for m in (0, 1):
        msg = torch.zeros(N, dtype=torch.int64)
        msg[0] = m
        glev = enc.encrypt_glev(gen, msg, sk, GLWE, RADIX)  # [2, 2, N]
        got = fft_ops.scheme_switch_fft(glev, ssk, GLWE, RADIX, SS_RADIX, DS32)
        want = j_fft_ops.scheme_switch_fft(jnp.asarray(to_u64_np(glev)), j_ssk, J_GLWE, J_RADIX,
                                           J_SS_RADIX, J_DS32)
        _eq_freq(got, want)
        out = fft_ops.cmux(zero, one, got, GLWE, RADIX, DS32)
        assert (t64.decode(enc.decrypt_glwe(out, sk, GLWE), 1) == m).all()


def test_u2_add_through_the_executor_on_ds32():
    """The u64 API on the ds32 backend end to end: keys made with
    `backend="ds32"`, an `Evaluation(be="ds32")` (whose constructor
    circuit-bootstraps GGSW(0) and GGSW(1): PBS, trace, scheme switch on
    `DsFreq`), and a u2 add through `CircuitExecutor`, decrypting right."""
    p = Params(l0_params=LweDef(dim=16, std=1e-16), l1_params=GLWE, cbs_radix=RADIX,
               pbs_radix=RadixDecomposition(count=2, radix_log=16),
               ks_radix=RadixDecomposition(count=9, radix_log=4),
               pfks_radix=RadixDecomposition(count=4, radix_log=11), ss_radix=SS_RADIX,
               tr_radix=RadixDecomposition(count=6, radix_log=7))
    sk, _, ck = generate_keys(torch.Generator().manual_seed(41), p, backend="ds32", device="cpu")
    assert isinstance(ck.bsk, DsFreq) and isinstance(ck.ssk, DsFreq)
    ev = Evaluation(ck, p, be="ds32", device="cpu")
    assert ev.be is DS32 and isinstance(ev.ggsw_one, DsFreq)
    ctx = FheCircuitCtx()
    a, b = UInt.input(ctx, 2), UInt.input(ctx, 2)
    out_keys = (a + b).output()
    cts = (ev.enc.encrypt_uint_bits(torch.Generator().manual_seed(1), 3, 2, sk)
           + ev.enc.encrypt_uint_bits(torch.Generator().manual_seed(2), 2, 2, sk))
    outputs = CircuitExecutor(ev).run(ctx.circuit, dict(zip(a.input_keys() + b.input_keys(), cts)))
    assert ev.enc.decrypt_uint_bits([outputs[k] for k in out_keys], sk) == 1  # 3 + 2 mod 4


def test_backend_interface():
    """`get_backend("ds32")` is the backend; zeros on a device, stack,
    indexing, set_component (in place) and `to` keep the four planes
    together; stack also takes int64 ciphertexts."""
    assert get_backend("ds32") is DS32 and get_backend(DS32) is DS32
    z = DS32.zeros((3, 2, 4), device="cpu")
    assert z.shape == (3, 2, 4) and z.device.type == "cpu"
    assert all(c.dtype == torch.float32 for c in z.astuple())
    v = DsFreq(*(torch.full((3, 4), float(i + 1)) for i in range(4)))
    s = DS32.zeros((3, 2, 4), device="cpu")
    assert DS32.set_component(s, 1, v) is None  # in place, as the c128 backend's
    assert all((c[:, 1] == i + 1).all() and (c[:, 0] == 0).all()
               for i, c in enumerate(s.astuple()))
    st = DS32.stack([s, z], axis=0)
    assert st.shape == (2, 3, 2, 4) and st[0, :, 1].shape == (3, 4)
    assert st.to("cpu").shape == st.shape
    lwe = torch.arange(6, dtype=torch.int64).reshape(2, 3)  # ciphertexts stay int64 tensors
    assert torch.equal(DS32.stack([lwe, lwe + 1], axis=0), torch.stack([lwe, lwe + 1]))
