"""The t-layout family of the port (`spf_tpu_torch/ops/fft_ds32_t.py`,
`ops/bootstrap_tpu.py`, the ds helpers it adds to `ops/ds.py`) against the
JAX package's (`spf_tpu/ops/fft_ds32_t.py`, `ops/bootstrap_tpu.py`,
`ops/ds.py`) on the CPU, then the t-layout PBS, bivariate PBS and CBS at
decode level against the port's u64 (reference-layout, c128) ones.

Bit for bit, every f32 plane and every int64, with subnormals flushed in
PyTorch while comparing, as XLA:CPU flushes them. The ds32 references run
op by op, outside any `jit` (where XLA:CPU could contract a multiply and
an add; `blind_rotate_t`'s `fori_loop` as a Python loop); the
integer-only ones (`monomial_mul_t`, `monomial_mul_static_t`, `pow_k_t`,
`sample_extract_t`) jitted, which keeps their bits. The reference's
transforms see every input as rows padded to [ROWS, N, LANES]
(`_canon_fwd` / `_canon_inv`: leading dims and lanes transform
independently), so each eager operator compiles for one shape an N.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spf_tpu.ops import bootstrap_tpu as j_bt
from spf_tpu.ops import ds as j_ds
from spf_tpu.ops import fft_ds32_t as j_ft
from spf_tpu.ops import torus as j_torus
from spf_tpu.params import GlweDef as JGlweDef
from spf_tpu.params import LweDef as JLweDef
from spf_tpu.params import RadixDecomposition as JRadix
from spf_tpu_torch import convert
from spf_tpu_torch.ops import bootstrap_tpu as bt
from spf_tpu_torch.ops import ds
from spf_tpu_torch.ops import encryption as penc
from spf_tpu_torch.ops import fft_ds32_t as ft
from spf_tpu_torch.ops import torus as ptorus
from spf_tpu_torch.ops.u64 import bootstrap as u64_bs
from spf_tpu_torch.ops.u64 import cbs as u64_cbs
from spf_tpu_torch.ops.u64 import encryption as enc
from spf_tpu_torch.ops.u64 import fft_ops
from spf_tpu_torch.ops.u64 import keyswitch as u64_ks
from spf_tpu_torch.ops.u64 import scheme_switch as u64_ss
from spf_tpu_torch.ops.u64 import torus as t64
from spf_tpu_torch.ops.u64.fft import C128
from spf_tpu_torch.params import GlweDef, LweDef, Params, RadixDecomposition

torch.set_num_threads(1)

ROWS, LANES = 8, 4
N = 64  # the ciphertext functions' degree (K = 32: a radix-2 big stage)
B = 4
GLWE = GlweDef(size=1, degree=N, std=1e-16)
J_GLWE = JGlweDef(size=1, degree=N, std=1e-16)
RADIX = RadixDecomposition(count=2, radix_log=16)
J_RADIX = JRadix(count=2, radix_log=16)
SS_RADIX = RadixDecomposition(count=3, radix_log=8)
J_SS_RADIX = JRadix(count=3, radix_log=8)

_REAL_FWD, _REAL_INV = j_ft.fwd_torus_t, j_ft.inv_t


def _rows(x):
    """x [..., n, b] (numpy) -> [ROWS, n, LANES] chunks, zero-padded."""
    n, b = x.shape[-2:]
    assert b <= LANES
    flat = x.reshape(-1, n, b)
    chunks = []
    for i in range(0, flat.shape[0], ROWS):
        c = flat[i:i + ROWS]
        chunks.append(np.pad(c, ((0, ROWS - c.shape[0]), (0, 0), (0, LANES - b))))
    return chunks


def _uncut(parts, lead, b):
    """Chunks [ROWS, n, LANES] back to [*lead, n, b]."""
    flat = np.concatenate(parts)[:int(np.prod(lead, dtype=np.int64))]
    return jnp.asarray(flat[..., :b].reshape(*lead, flat.shape[-2], b))


def _canon_fwd(x):
    x = np.asarray(x)
    outs = [_REAL_FWD(jnp.asarray(c)) for c in _rows(x)]
    return tuple(_uncut([np.asarray(o[c]) for o in outs], x.shape[:-2], x.shape[-1])
                 for c in range(4))


def _canon_inv(f):
    f = [np.asarray(c) for c in f]
    chunks = [_rows(c) for c in f]
    outs = [np.asarray(_REAL_INV(tuple(jnp.asarray(ch[i]) for ch in chunks)))
            for i in range(len(chunks[0]))]
    return _uncut(outs, f[0].shape[:-2], f[0].shape[-1])


@pytest.fixture
def canon(monkeypatch):
    """The reference's transforms on padded rows (its ciphertext functions
    call them through the module)."""
    monkeypatch.setattr(j_ft, "fwd_torus_t", _canon_fwd)
    monkeypatch.setattr(j_ft, "inv_t", _canon_inv)


@pytest.fixture(autouse=True)
def _flush_denormals():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _u64(rng, shape):
    return rng.integers(0, 2**64, shape, dtype=np.uint64)


def _tt(a) -> torch.Tensor:
    return t64.u64(np.asarray(a).astype(np.uint64))


def _eq_planes(got, want, what=""):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32),
                                      err_msg=f"{what} plane {i}")


def _eq_u64(got: torch.Tensor, want, what=""):
    np.testing.assert_array_equal(ptorus.to_u64_np(got), np.asarray(want).astype(np.uint64),
                                  err_msg=what)


def _spectra(rng, shape):
    """t-layout spectra of random torus coefficients [*shape, N] (no lane
    axis), by the port's transform (held to the reference's below)."""
    return bt.bsk_to_t(_tt(_u64(rng, (*shape, N))))


def _np_planes(f):
    return tuple(jnp.asarray(c.numpy()) for c in f)


# --- ds helpers -------------------------------------------------------------


def test_ds_helpers_bit_for_bit():
    """neg, mul_wsplit (b presplit by presplit_f32), presplit_f32 and
    mul_f32 against the reference's, on ds pairs of magnitudes 2^-40 to
    2^40 and the edges: zeros of both signs, ±1, powers of two, exact
    products, the split's own halves."""
    rng = np.random.default_rng(1)
    mags = np.exp2(rng.uniform(-40, 40, 250)) * rng.choice([-1.0, 1.0], 250)
    edges = np.array([0.0, -0.0, 1.0, -1.0, 2.0**20, -(2.0**-20), 3.0, 4097.0, 1 / 3, 2.0**40])
    a_hi, a_lo = ds.from_f64_array(np.concatenate([mags, edges]))
    b_hi, b_lo = ds.from_f64_array(np.concatenate([rng.permutation(mags), edges[::-1]]))
    b_hh, b_hl = ds.presplit_f32(b_hi)
    jh, jl = j_ds.presplit_f32(b_hi)
    np.testing.assert_array_equal(b_hh.view(np.uint32), jh.view(np.uint32))
    np.testing.assert_array_equal(b_hl.view(np.uint32), jl.view(np.uint32))
    assert np.array_equal(b_hh.astype(np.float64) + b_hl, b_hi.astype(np.float64))

    t = [torch.from_numpy(x) for x in (a_hi, a_lo, b_hi, b_lo, b_hh, b_hl)]
    j = [jnp.asarray(x) for x in (a_hi, a_lo, b_hi, b_lo, b_hh, b_hl)]
    _eq_planes(ds.neg(t[0], t[1]), j_ds.neg(j[0], j[1]), "neg")
    _eq_planes(ds.mul_wsplit(*t), j_ds.mul_wsplit(*j), "mul_wsplit")
    _eq_planes(ds.mul_f32(t[0], t[1], t[2]), j_ds.mul_f32(j[0], j[1], j[2]), "mul_f32")
    # the presplit product is the runtime-split one
    _eq_planes(ds.mul_wsplit(*t), ds.mul(*t[:4]), "mul_wsplit vs mul")
    # complex operands: the imaginary parts are the real parts reversed
    a4 = (a_hi, a_lo, a_hi[::-1].copy(), a_lo[::-1].copy())
    b8 = (b_hi, b_lo, b_hi[::-1].copy(), b_lo[::-1].copy(),
          b_hh, b_hl, b_hh[::-1].copy(), b_hl[::-1].copy())
    _eq_planes(ft._cmul_wsplit(tuple(map(torch.from_numpy, a4)), tuple(map(torch.from_numpy, b8))),
               j_ft._cmul_wsplit(tuple(map(jnp.asarray, a4)), tuple(map(jnp.asarray, b8))),
               "_cmul_wsplit")


# --- tables and transforms --------------------------------------------------


@pytest.mark.parametrize("k", [1024, 2048])
def test_tables_and_bit_images(k):
    """The stage tables, the permutation, the DIF frequency order and its
    bit images (numpy only)."""
    for inverse in (False, True):
        big, small, br = ft._tables(k, inverse)
        jbig, jsmall, jbr = j_ft._tables(k, inverse)
        assert [r for r, _ in big] == [r for r, _ in jbig]
        for (_, tws), (_, jtws) in zip(big, jbig):
            for w, jw in zip(tws, jtws, strict=True):
                _eq_planes(w, jw, f"big K={k}")
        assert len(small) == len(jsmall)
        for s, js in zip(small, jsmall):
            assert np.array_equal(np.asarray(s, np.float32).view(np.uint32),
                                  np.asarray(js, np.float32).view(np.uint32))
        assert br.dtype == jbr.dtype and np.array_equal(br, jbr)
    assert np.array_equal(ft.dif_freq_order(k), j_ft.dif_freq_order(k))
    assert ft.dif_bit_images(k) == j_ft.dif_bit_images(k)


@pytest.mark.parametrize("n", [64, 128, 256])  # K = 32, 64, 128: radix 2, 4, 8
def test_transforms_bit_for_bit(n):
    """fwd_torus_t and inv_t on leading dims [2, 4] (fwd_signed_t, its
    one-line wrapper, at N = 64), then the cores on the spectra:
    _fft_core_t without the gather, the concat-free forward core,
    _ifft_core_t_dit and the concat-free inverse core. The reference sees
    [8, N, 4] rows."""
    rng = np.random.default_rng(n)
    x = _u64(rng, (2, 4, n, LANES))
    got = ft.fwd_torus_t(_tt(x))
    want = _REAL_FWD(jnp.asarray(x.reshape(ROWS, n, LANES)))
    _eq_planes(tuple(c.reshape(ROWS, n // 2, LANES) for c in got), want, "fwd_torus_t")
    if n == 64:
        signed = rng.integers(-(2**20), 2**20, (ROWS, n, LANES)).astype(np.int64)
        _eq_planes(ft.fwd_signed_t(torch.from_numpy(signed)),
                   j_ft.fwd_signed_t(jnp.asarray(signed)), "fwd_signed_t")
    _eq_u64(ft.inv_t(got).reshape(ROWS, n, LANES), _REAL_INV(want), "inv_t")

    comps = tuple(torch.from_numpy(np.array(c)) for c in want)
    _eq_planes(ft._fft_core_t(comps, False, take_out=False),
               j_ft._fft_core_t(want, False, take_out=False), "core without the gather")
    _eq_planes(ft._fft_core_t_list(comps), j_ft._fft_core_t_list(want), "fwd list core")
    dit = ft._ifft_core_t_dit(comps)
    _eq_planes(dit, j_ft._ifft_core_t_dit(want), "dit core")
    _eq_planes(ft._ifft_core_t_list(comps), j_ft._ifft_core_t_list(want), "inverse list core")
    # the DIT core inverts the gather-free forward core up to K
    scrambled = ft._fft_core_t(ft._ifft_core_t_dit(ft._fft_core_t(comps, False, False)),
                               False, False)
    assert scrambled[0].shape == comps[0].shape


def test_convert_carries_t_layout_state(canon):
    """convert.t_layout_keys / freq_t take the JAX package's coefficient
    keys and t-layout spectra to the port's, the same bits."""
    rng = np.random.default_rng(4)
    bsk = _u64(rng, (2, 2, 2, 2, N))
    ak = _u64(rng, (GLWE.log_degree, 1, 2, 2, N))
    ssk = _u64(rng, (1, 1, 3, 2, N))
    got = convert.t_layout_keys(bsk, ak, ssk, device="cpu")
    want_bsk = j_bt.bsk_to_t(jnp.asarray(bsk))
    _eq_planes(got[0], want_bsk, "bsk_to_t")
    _eq_planes(convert.t_layout_keys(convert.u64_to_limbs(bsk), device="cpu"), want_bsk,
               "bsk_to_t (limbs)")
    j_ak, j_ssk = j_bt.keys_to_t(jnp.asarray(ak), jnp.asarray(ssk))
    _eq_planes(got[1], j_ak, "keys_to_t ak")
    _eq_planes(got[2], j_ssk, "keys_to_t ssk")
    _eq_planes(convert.freq_t(want_bsk, device="cpu"), want_bsk, "freq_t")


# --- integer functions ------------------------------------------------------


def test_integer_functions_bit_for_bit():
    """monomial_mul_t at every t edge (0, 1, N - 1, N, 2N - 1, random),
    monomial_mul_static_t (negative, beyond 2N), pow_k_t for every trace
    exponent and sample_extract_t at h = 0, 5, N - 1, against the
    reference's jitted."""
    rng = np.random.default_rng(2)
    a = _u64(rng, (2, N, 8))
    t = np.array([0, 1, N - 1, N, 2 * N - 1, 77, 5, 100], dtype=np.uint64)
    _eq_u64(bt.monomial_mul_t(_tt(a), _tt(t)),
            jax.jit(j_bt.monomial_mul_t)(jnp.asarray(a), jnp.asarray(t)), "monomial_mul_t")
    static = jax.jit(j_bt.monomial_mul_static_t, static_argnums=1)
    for s in (0, 3, N, N + 7, 2 * N - 1, -5, 3 * N + 1):
        _eq_u64(bt.monomial_mul_static_t(_tt(a), s), static(jnp.asarray(a), s), f"static {s}")
    pow_k = jax.jit(j_bt.pow_k_t, static_argnums=1)
    for i in range(1, GLWE.log_degree + 1):
        kx = N // (1 << (i - 1)) + 1
        _eq_u64(bt.pow_k_t(_tt(a), kx), pow_k(jnp.asarray(a), kx), f"pow_k {kx}")
    extract = jax.jit(j_bt.sample_extract_t, static_argnums=(1, 2))
    for h in (0, 5, N - 1):
        _eq_u64(bt.sample_extract_t(_tt(a), h, GLWE), extract(jnp.asarray(a), h, J_GLWE),
                f"sample_extract {h}")
    x = _tt(a)
    assert torch.equal(bt.from_t_layout(bt.to_t_layout(x)), x)
    assert tuple(bt.to_t_layout(x).shape) == (N, 8, 2)


def test_shr_round_at_the_cbs_shift():
    """`ops.torus.shr_round`, which circuit_bootstrap_t uses, against the
    JAX package's `torus.shr_round` at log2 N, edges included."""
    rng = np.random.default_rng(3)
    x = np.concatenate([_u64(rng, 250), np.array([0, 1, 2**63, 2**64 - 1, 2**5, 2**5 - 1],
                                                  dtype=np.uint64)])
    for shift in (GLWE.log_degree, 11):
        _eq_u64(ptorus.shr_round(_tt(x), shift), j_torus.shr_round(jnp.asarray(x), shift),
                f"shr_round {shift}")


# --- ciphertext functions on the ds32 transforms ---------------------------


def test_cmux_keyswitch_trace_scheme_switch_bit_for_bit(canon):
    """cmux_t (a shared GGSW row and one GGSW a lane), keyswitch_glwe_t,
    trace_t and scheme_switch_t at N = 64 on random ciphertexts and
    spectra of random keys, against the reference run op by op."""
    rng = np.random.default_rng(5)
    d0, d1 = _u64(rng, (2, N, B)), _u64(rng, (2, N, B))
    row = _spectra(rng, (2, 2, 2))  # [k+1, l, k+1, K]
    got = bt.cmux_t(_tt(d0), _tt(d1), row, GLWE, RADIX)
    want = j_bt.cmux_t(jnp.asarray(d0), jnp.asarray(d1), _np_planes(row), J_GLWE, J_RADIX)
    _eq_u64(got, want, "cmux_t")
    lanes = tuple(c.reshape(2, 2, 2, N // 2, 1).expand(-1, -1, -1, -1, B).contiguous()
                  for c in row)  # one GGSW a lane, here all the same
    _eq_u64(bt.cmux_t(_tt(d0), _tt(d1), lanes, GLWE, RADIX), want, "cmux_t, batched row")
    # cmadd_t at the CMux's shapes and magnitudes: acc [k+1, K, B], a digit
    # spectrum [1, K, B] (|digit| < 2^15), a key row [k+1, K, 1]
    acc = ft.fwd_signed_t(torch.from_numpy(rng.integers(-(2**40), 2**40, (2, N, B))))
    dig = ft.fwd_signed_t(torch.from_numpy(rng.integers(-(2**15), 2**15, (1, N, B))))
    g00 = tuple(c[0, 0, :, :, None] for c in row)
    _eq_planes(ft.cmadd_t(acc, dig, g00),
               j_ft.cmadd_t(_np_planes(acc), _np_planes(dig), _np_planes(g00)), "cmadd_t")

    ksk = _spectra(rng, (1, 2, 2))  # [k, l, k+1, K]
    _eq_u64(bt.keyswitch_glwe_t(_tt(d0), ksk, GLWE, RADIX),
            j_bt.keyswitch_glwe_t(jnp.asarray(d0), _np_planes(ksk), J_GLWE, J_RADIX),
            "keyswitch_glwe_t")
    ak = _spectra(rng, (GLWE.log_degree, 1, 2, 2))
    _eq_u64(bt.trace_t(_tt(d1), ak, GLWE, RADIX),
            j_bt.trace_t(jnp.asarray(d1), _np_planes(ak), J_GLWE, J_RADIX), "trace_t")
    glev = _u64(rng, (RADIX.count, 2, N, B))
    ssk = _spectra(rng, (1, 1, SS_RADIX.count, 2))
    _eq_planes(bt.scheme_switch_t(_tt(glev), ssk, GLWE, RADIX, SS_RADIX),
               j_bt.scheme_switch_t(jnp.asarray(glev), _np_planes(ssk), J_GLWE, J_RADIX,
                                    J_SS_RADIX),
               "scheme_switch_t")


def _python_fori_loop(lower, upper, body, init):
    val = init
    for i in range(lower, upper):
        val = body(i, val)
    return val


def test_blind_rotate_bit_for_bit(canon, monkeypatch):
    """blind_rotate_t at n0 = 4 against the reference's with its fori_loop
    run as a Python loop (as `jax.disable_jit()` runs it: every operator
    eager, none compiled together and contracted by XLA:CPU; eager, the
    steps share the CMux test's compiled operators), phases at their
    edges."""
    rng = np.random.default_rng(6)
    n0 = 4
    lwe = LweDef(dim=n0, std=1e-16)
    bsk = _spectra(rng, (n0, 2, 2, 2))
    lut = _u64(rng, (2, N, 1))
    ct = rng.integers(0, 2 * N, (n0 + 1, B)).astype(np.uint64)
    ct[:, 0] = [0, 1, N - 1, N, 2 * N - 1]
    got = bt.blind_rotate_t(_tt(lut), _tt(ct), bsk, lwe, GLWE, RADIX)
    monkeypatch.setattr(jax.lax, "fori_loop", _python_fori_loop)
    want = j_bt.blind_rotate_t(jnp.asarray(lut), jnp.asarray(ct), _np_planes(bsk),
                               JLweDef(dim=n0, std=1e-16), J_GLWE, J_RADIX)
    _eq_u64(got, want, "blind_rotate_t")


# --- decode level, in torch alone -------------------------------------------

DEC_LWE = LweDef(dim=16, std=1e-16)
DEC_GLWE = GlweDef(size=1, degree=128, std=1e-16)
DEC_PARAMS = Params(
    l0_params=DEC_LWE,
    l1_params=DEC_GLWE,
    cbs_radix=RadixDecomposition(count=2, radix_log=9),
    pbs_radix=RadixDecomposition(count=2, radix_log=16),
    ks_radix=RadixDecomposition(count=9, radix_log=4),
    pfks_radix=RadixDecomposition(count=4, radix_log=11),
    ss_radix=RadixDecomposition(count=6, radix_log=8),
    tr_radix=RadixDecomposition(count=6, radix_log=7),
)


@pytest.fixture(scope="module")
def dec_keys():
    gen = torch.Generator().manual_seed(14)
    rng = np.random.default_rng(14)
    p = DEC_PARAMS
    lwe_sk = rng.integers(0, 2, p.l0_params.dim).astype(np.int64)
    glwe_sk = penc.generate_glwe_sk(p.l1_params, gen)
    bsk = penc.generate_bsk(lwe_sk, glwe_sk, p.l1_params, p.pbs_radix, gen)
    ak = u64_ks.generate_automorphism_keys(gen, glwe_sk, p.l1_params, p.tr_radix, be=None)
    ssk = u64_ss.generate_scheme_switch_key(gen, glwe_sk, p.l1_params, p.ss_radix, be=None)
    return rng, lwe_sk, glwe_sk, bsk, ak, ssk


def _decode_l1(out_t, glwe_sk, bits):
    """t-layout (or batch-first) L1 LWEs -> decoded messages."""
    sk_flat = enc.glwe_sk_to_lwe_sk(glwe_sk)
    return t64.decode(enc.decrypt_lwe(out_t, sk_flat, DEC_GLWE.as_lwe_def()), bits)


def test_pbs_and_bivariate_decode(dec_keys):
    """programmable_bootstrap_t of the 8 messages of 3 bits under (x + 1)
    % 8 (bench.py --backend ds32's LUT) and the bivariate PBS of 16 pairs
    under (l + r) % 4 (packed l * 4 + r) decode right and equal the port's
    u64 c128 PBS on the same ciphertexts."""
    rng, lwe_sk, glwe_sk, bsk, _, _ = dec_keys
    p = DEC_PARAMS
    bsk_t = bt.bsk_to_t(bsk)
    bsk_c = C128.fwd_torus(bsk)
    msgs = np.arange(8, dtype=np.uint64)
    cts = _tt(penc.encrypt_lwe_np(rng, msgs << np.uint64(60), lwe_sk, p.l0_params))
    lut = u64_bs.generate_lut([lambda x: (x + 1) % 8], p.l1_params, 3, device="cpu")
    out_t = bt.from_t_layout(bt.programmable_bootstrap_t(bt.to_t_layout(cts), lut, bsk_t,
                                                         p.l0_params, p.l1_params, p.pbs_radix))
    ref = u64_bs.programmable_bootstrap_univariate(cts, lut, bsk_c, p.l0_params, p.l1_params,
                                                   p.pbs_radix)
    dec = _decode_l1(out_t, glwe_sk, 3)
    assert dec.tolist() == ((msgs + 1) % 8).tolist()
    assert torch.equal(dec, _decode_l1(ref, glwe_sk, 3))

    left, right = np.arange(16) % 4, np.arange(16) // 4
    ct_l, ct_r = (_tt(penc.encrypt_lwe_np(rng, m.astype(np.uint64) << np.uint64(59), lwe_sk,
                                          p.l0_params)) for m in (left, right))
    lut2 = u64_bs.generate_bivariate_lut(lambda a, b: (a + b) % 4, p.l1_params, 2,
                                         device="cpu")
    packed = (ct_l << 2) + ct_r
    out2 = bt.from_t_layout(bt.programmable_bootstrap_t(
        bt.to_t_layout(packed), lut2, bsk_t, p.l0_params, p.l1_params, p.pbs_radix))
    ref2 = u64_bs.programmable_bootstrap_bivariate(ct_l, ct_r, lut2, bsk_c, p.l0_params,
                                                   p.l1_params, p.pbs_radix, 2)
    dec2 = _decode_l1(out2, glwe_sk, 4)
    assert dec2.tolist() == ((left + right) % 4).tolist()
    assert torch.equal(dec2, _decode_l1(ref2, glwe_sk, 4))


def test_circuit_bootstrap_decode(dec_keys):
    """circuit_bootstrap_t of the bits 0, 1, 1, 0: every lane's GGSW
    selects its bit through cmux_t at every coefficient, as the port's u64
    c128 CBS's GGSW does through the u64 CMux."""
    rng, lwe_sk, glwe_sk, bsk, ak, ssk = dec_keys
    p = DEC_PARAMS
    glwe = p.l1_params
    bits = np.array([0, 1, 1, 0], dtype=np.uint64)
    cts = _tt(penc.encrypt_lwe_np(rng, bits << np.uint64(63), lwe_sk, p.l0_params))
    ak_t, ssk_t = bt.keys_to_t(ak, ssk)
    ggsw_t = bt.circuit_bootstrap_t(bt.to_t_layout(cts), bt.bsk_to_t(bsk), ak_t, ssk_t, p)
    assert tuple(ggsw_t[0].shape) == (2, p.cbs_radix.count, 2, glwe.degree // 2, 4)
    m0 = torch.zeros((2, glwe.degree, 4), dtype=torch.int64)
    m1 = m0.clone()
    m1[-1] = t64.encode(1, 1)
    out = bt.from_t_layout(bt.cmux_t(m0, m1, ggsw_t, glwe, p.cbs_radix))
    got = t64.decode(enc.decrypt_glwe(out, glwe_sk, glwe), 1)
    assert got.tolist() == [[int(b)] * glwe.degree for b in bits]

    ggsw_c = u64_cbs.circuit_bootstrap(cts, C128.fwd_torus(bsk), C128.fwd_torus(ak),
                                       C128.fwd_torus(ssk), p)
    ref = fft_ops.cmux(bt.from_t_layout(m0), bt.from_t_layout(m1), ggsw_c, glwe, p.cbs_radix,
                       C128)
    assert torch.equal(t64.decode(enc.decrypt_glwe(ref, glwe_sk, glwe), 1), got)
