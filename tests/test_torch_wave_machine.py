"""The port's executors (`ops/mux_eval_u32.py`, `runtime/executor_u32.py`,
`runtime/wave_machine.py`) against the JAX package, at the parameters of
`tests/test_wave_machine.py` (k = 1, N = 64, n0 = 32).

- Bit for bit, with the JAX functions run eagerly (no `jit`, no JAX
  executor) and the bit-reversed FFT twins (`fft_pallas.fwd_ds_ref`,
  `inv_ds_ref`) in place of their FFT, as `tests/test_torch_cbs.py` does:
  `evaluate_mux_circuit` on a 2-bit adder over numpy GGSWs, and each wave
  function (CMux and external product under a batched row, a stacked CMux
  run, add, not, mul_xn, dynamic extract) on random slot buffers, with
  padded lanes that must write no live slot.
- Decrypt level: the flows of `tests/test_wave_machine.py` with the port's
  own keys on the CPU, through the `WaveMachine` and the per-wave
  `U32CircuitExecutor`, whose outputs must be the same bits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spf_tpu.circuits import integer as j_integer
from spf_tpu.ops import bootstrap_u32 as bu
from spf_tpu.ops import fft_pallas as fp
from spf_tpu.ops import limb32 as lb
from spf_tpu.ops import mux_eval_u32 as j_mux_eval
from spf_tpu.runtime import wave_machine as j_wm
from spf_tpu_torch import convert
from spf_tpu_torch.circuits import integer
from spf_tpu_torch.ops import bootstrap, encryption, torus
from spf_tpu_torch.ops.cbs import circuit_bootstrap
from spf_tpu_torch.ops import mux_eval_u32 as mux_eval
from spf_tpu_torch.params import GlweDef, LweDef, Params, RadixDecomposition
from spf_tpu_torch.runtime import wave_machine as wm
from spf_tpu_torch.runtime.executor_u32 import U32CircuitExecutor, U32ComputeKey
from spf_tpu_torch.runtime.fhe_circuit import CircuitError, CtType, FheCircuit, FheEdge, FheOp
from spf_tpu_torch.runtime.fluent import FheCircuitCtx, UInt
from spf_tpu_torch.utils import host_crypto as hc

torch.set_num_threads(1)

LWE = LweDef(dim=32, std=1e-16)
GLWE = GlweDef(size=1, degree=64, std=1e-16)
P = Params(
    l0_params=LWE,
    l1_params=GLWE,
    cbs_radix=RadixDecomposition(count=2, radix_log=9),
    pbs_radix=RadixDecomposition(count=2, radix_log=16),
    ks_radix=RadixDecomposition(count=9, radix_log=4),
    pfks_radix=RadixDecomposition(count=4, radix_log=11),
    ss_radix=RadixDecomposition(count=6, radix_log=8),
    tr_radix=RadixDecomposition(count=6, radix_log=7),
)
N, K = GLWE.degree, GLWE.degree // 2
P_CANON = 4  # polynomials per twin FFT call (l * (k+1)), so that every call shares one shape
LANES_CANON = 16  # lanes of every twin call below (each lane is computed alone)


def _jax_params():
    from spf_tpu import params as jp

    def back(obj):
        cls = getattr(jp, type(obj).__name__)
        return cls(**{f.name: back(getattr(obj, f.name)) if dataclasses.is_dataclass(
            getattr(obj, f.name)) else getattr(obj, f.name) for f in dataclasses.fields(obj)})

    return back(P)


JP = _jax_params()
assert convert.param(JP) == P


# --- bit for bit against the JAX functions, run eagerly -----------------


def _lanes(fn):
    """fn on its arguments' lanes (last axis) padded with zeros to
    LANES_CANON, the result cut back: every lane is computed alone, so the
    bits of the real lanes do not change, and each eager JAX operator
    compiles once for all the circuits' widths instead of once a width (the
    padding and the cut are numpy's, so they compile nothing)."""
    def pad(x):
        if isinstance(x, tuple):
            return tuple(pad(c) for c in x)
        if not hasattr(x, "ndim") or x.ndim < 2:
            return x
        return jnp.asarray(np.pad(np.asarray(x), [(0, 0)] * (x.ndim - 1)
                                  + [(0, LANES_CANON - x.shape[-1])]))

    def run(*args):
        w = next(a for a in jax.tree_util.tree_leaves(args) if hasattr(a, "ndim")).shape[-1]
        if w > LANES_CANON:
            return fn(*args)
        return jax.tree_util.tree_map(lambda c: jnp.asarray(np.asarray(c)[..., :w]),
                                      fn(*(pad(a) for a in args)))

    return run


def _canon_fwd(hi, lo):
    lead = hi.shape[:-2]
    p = int(np.prod(lead)) if lead else 1
    pad = ((0, P_CANON - p), (0, 0), (0, 0))
    f = fp.fwd_ds_ref(*(jnp.pad(x.reshape(p, *x.shape[-2:]), pad) for x in (hi, lo)))
    return tuple(c[:p].reshape(*lead, *c.shape[-2:]) for c in f)


def _python_scan(f, init, xs):
    carry = init
    for i in range(jax.tree_util.tree_leaves(xs)[0].shape[0]):
        carry, _ = f(carry, jax.tree_util.tree_map(lambda x: x[i], xs))
    return carry, None


@pytest.fixture
def twins(monkeypatch):
    """The JAX functions with the bit-reversed FFT twins in place of their
    backend's FFT, `scan` as a Python loop, and subnormals flushed in
    PyTorch as XLA:CPU flushes them."""
    def fwd_signed(digits, use_pallas=None):
        d = digits.astype(jnp.float32)
        return _canon_fwd(d, jnp.zeros_like(d))

    def inv_limb(f, use_pallas=None):
        return lb.from_ds(*fp.inv_ds_ref(f))

    monkeypatch.setattr(bu, "fwd_signed", _lanes(fwd_signed))
    monkeypatch.setattr(bu, "inv_limb", _lanes(inv_limb))
    monkeypatch.setattr(bu, "freq_mad", _lanes(bu.freq_mad))
    monkeypatch.setattr(lb, "decompose", _lanes(lb.decompose))
    monkeypatch.setattr(lb, "add", _lanes(lb.add))
    monkeypatch.setattr(lb, "sub", _lanes(lb.sub))
    monkeypatch.setattr(j_wm, "inv_limb", _lanes(inv_limb))
    monkeypatch.setattr(jax.lax, "scan", _python_scan)
    torch.set_flush_denormal(True)
    with jax.disable_jit():
        yield
    torch.set_flush_denormal(False)


def _spectra(rng, *shape):
    """Random ds spectra, 4 f32 planes (hi, hi * 2^-25-ish lo pairs)."""
    out = []
    for _ in range(2):
        hi = (rng.standard_normal(shape) * 2.0**40).astype(np.float32)
        out += [hi, (hi * rng.standard_normal(shape) * 2.0**-25).astype(np.float32)]
    return out


def test_evaluate_mux_circuit_bit_for_bit(twins):
    """A 2-bit adder, 2 instances, over numpy GGSWs of random bits: the same
    bits as `evaluate_mux_circuit_u32` (per_level_jit=False, no refresh),
    with and without the port's per-level padding, decrypting to a + b."""
    rng = np.random.default_rng(31)
    n_bits, inst = 2, 2
    sk = rng.integers(0, 2, (1, N)).astype(np.uint64)
    vals = rng.integers(0, 4, (2, inst))
    bits = [(int(vals[i // n_bits, j]) >> (i % n_bits)) & 1
            for i in range(2 * n_bits) for j in range(inst)]
    ggsw = np.stack([hc.encrypt_ggsw_scalar_np(rng, b, sk, GLWE, P.cbs_radix) for b in bits])
    sel = tuple(c.movedim(0, -1).contiguous()
                for c in bootstrap.bsk_to_freq(torus.from_u64_np(ggsw)))
    circuit = integer.ripple_carry_adder(n_bits)
    got = mux_eval.evaluate_mux_circuit(circuit, sel, GLWE, P.cbs_radix, inst)
    padded = mux_eval.evaluate_mux_circuit(circuit, sel, GLWE, P.cbs_radix, inst,
                                           per_level_jit=True)
    want = j_mux_eval.evaluate_mux_circuit_u32(
        j_integer.ripple_carry_adder(n_bits), tuple(jnp.asarray(c.numpy()) for c in sel),
        JP.l1_params, JP.cbs_radix, inst, use_pallas=False)
    sums = [0] * inst
    for i, (g, p, w) in enumerate(zip(got, padded, want)):
        np.testing.assert_array_equal(torus.to_u64_np(g), lb.to_u64_np(w))
        np.testing.assert_array_equal(torus.to_u64_np(p), lb.to_u64_np(w))
        for j in range(inst):
            sums[j] |= hc.decrypt_glwe_bit_np(torus.to_u64_np(g[..., j]), sk, GLWE) << i
    assert sums == [int(vals[0, j] + vals[1, j]) for j in range(inst)]


S, S_GGSW, W = 8, 4, 8  # live GLWE / LWE slots, GGSW slots, lanes of a wave


def _wave(group):
    """The index arrays of one wave of `group`: 3 gates on W lanes (the
    padded lanes gather slot 0 and scatter to slot S, past the live ones),
    or for cmux_scan two stacked CMux waves, the second reading the first's
    outputs."""
    def idx(**roles):
        out = {}
        for k, v in roles.items():
            out[k] = np.zeros(W, np.int32)
            out[k][:3] = v
        out["out"][3:] = S
        return out

    cmux_a = idx(lo=[5, 0, 5], hi=[2, 7, 1], sel=[3, 0, 2], out=[6, 1, 4])
    if group == "cmux":
        return cmux_a
    if group == "cmux_scan":
        cmux_b = idx(lo=[6, 1, 3], hi=[4, 6, 7], sel=[1, 1, 0], out=[0, 5, 2])
        return {k: np.stack([cmux_a[k], cmux_b[k]]) for k in cmux_a}
    if group == "extprod":
        return idx(lo=[5, 0, 5], sel=[3, 0, 2], out=[6, 1, 4])
    if group == "add":
        return idx(lo=[5, 0, 5], hi=[2, 7, 1], out=[6, 1, 4])
    ix = idx(**{"in": [5, 0, 2], "out": [6, 1, 2]})
    if group == "mulxn":
        ix["t"] = np.array([3, 70, 2 * N - 1, 0, 0, 0, 0, 0], np.uint32)
    if group == "extract":
        ix["h"] = np.array([0, 17, N - 1, 0, 0, 0, 0, 0], np.int32)
    return ix


@pytest.mark.parametrize("group", ["cmux", "cmux_scan", "extprod", "add", "not", "mulxn",
                                   "extract"])
def test_wave_bit_for_bit(twins, group):
    """Each wave function on random buffers: every live slot of the result
    equals the JAX closure's (`WaveMachine._kernel`, run eagerly), so the
    padded lanes wrote none; the port's scratch slot takes them."""
    rng = np.random.default_rng(40 + len(group))
    glwe = rng.integers(0, 1 << 64, (S, 2, N), dtype=np.uint64)
    lwe1 = rng.integers(0, 1 << 64, (S, N + 1), dtype=np.uint64)
    ggsw = _spectra(rng, S_GGSW, 2, P.cbs_radix.count, 2, K)
    ix = _wave(group)

    def slots_last(x):  # [S, ...] u64 -> int64 [..., S + 1], scratch slot zero
        t = torus.from_u64_np(np.moveaxis(x, 0, -1))
        return torch.cat([t, torch.zeros_like(t[..., :1])], dim=-1)

    bufs = {"glwe": slots_last(glwe), "lwe1": slots_last(lwe1),
            "ggsw": tuple(torch.from_numpy(np.concatenate([c, np.zeros_like(c[:1])])) for c in ggsw)}
    wm.WAVES[group](bufs, wm.device_indices(ix, "cpu"), None, P)

    jw = j_wm.WaveMachine(None, JP, use_pallas=False)
    f = jw._kernel((group,))
    jg, jl1 = lb.from_u64_np(glwe), lb.from_u64_np(lwe1)
    jggsw = tuple(jnp.asarray(c) for c in ggsw)
    a = {k: jnp.asarray(v) for k, v in ix.items()}
    if group in ("cmux", "cmux_scan"):
        out, buf = f(jg, jggsw, a["lo"], a["hi"], a["sel"], a["out"]), "glwe"
    elif group == "extprod":
        out, buf = f(jg, jggsw, a["lo"], a["sel"], a["out"]), "glwe"
    elif group == "add":
        out, buf = f(jg, a["lo"], a["hi"], a["out"]), "glwe"
    elif group == "not":
        out, buf = f(jg, a["in"], a["out"]), "glwe"
    elif group == "mulxn":
        out, buf = f(jg, a["in"], a["t"], a["out"]), "glwe"
    else:
        out, buf = f(jl1, jg, a["in"], a["h"], a["out"]), "lwe1"
    want = np.moveaxis(lb.to_u64_np(out), 0, -1)
    np.testing.assert_array_equal(torus.to_u64_np(bufs[buf])[..., :S], want)
    unchanged = glwe if buf == "lwe1" else lwe1
    other = "glwe" if buf == "lwe1" else "lwe1"
    np.testing.assert_array_equal(torus.to_u64_np(bufs[other])[..., :S],
                                  np.moveaxis(unchanged, 0, -1))


# --- the flows of tests/test_wave_machine.py, decrypt level -------------


@pytest.fixture(scope="module")
def material():
    """The port's keys (CPU), made from a torch generator: the single-bit
    bootstrap key at pbs_radix, the automorphism, scheme-switch and LWE
    keyswitch keys, and the GGSW constants at cbs_radix."""
    gen = torch.Generator().manual_seed(977)
    lwe_sk = encryption.generate_lwe_sk(LWE, gen)
    glwe_sk = encryption.generate_glwe_sk(GLWE, gen)
    bsk = encryption.generate_bsk(lwe_sk, glwe_sk, GLWE, P.pbs_radix, gen)
    ak = encryption.generate_automorphism_keys(glwe_sk, GLWE, P.tr_radix, gen)
    ssk = encryption.generate_scheme_switch_key(glwe_sk, GLWE, P.ss_radix, gen)
    ksk = encryption.generate_lwe_keyswitch_key(glwe_sk.reshape(-1), lwe_sk, LWE, P.ks_radix, gen)
    g01 = encryption.encrypt_ggsw_scalar(torch.tensor([0, 1]), glwe_sk, GLWE, P.cbs_radix, gen)
    key = U32ComputeKey.from_coeff(bsk, ak, ssk, ksk, g01[0], g01[1], device="cpu")
    return dict(sk=glwe_sk.numpy().astype(np.uint64), lwe_sk=lwe_sk.numpy().astype(np.uint64),
                key=key, wm=wm.WaveMachine(key, P), rng=np.random.default_rng(5))


def _run(ex, m, build, vals, n):
    ctx = FheCircuitCtx()
    ops = [UInt.input(ctx, n) for _ in vals]
    out_keys = build(*ops).output()
    inputs = {}
    for op, v in zip(ops, vals):
        inputs.update(zip(op.input_keys(), hc.encrypt_uint_bits_np(m["rng"], v, n, m["sk"], GLWE)))
    res = ex.run(ctx.circuit, inputs)
    return hc.decrypt_uint_bits_np([res[k] for k in out_keys], m["sk"], GLWE), ctx, inputs, res


def test_evaluate_mux_circuit_refreshed(material):
    """`evaluate_mux_circuit` over CBS-made selects of L0 bits, with every
    wire recrypted at a fresh-path of 2 (`RefreshKeys`): decrypts to a + b."""
    m = material
    key, inst = m["key"], 2
    vals = [(3, 2), (1, 1)]  # (a, b) of each instance
    bits = np.array([(vals[j][i // 2] >> (i % 2)) & 1 for i in range(4) for j in range(inst)],
                    np.uint64)
    l0 = encryption.encrypt_lwe_np(m["rng"], bits << np.uint64(63), m["lwe_sk"], LWE)
    sel = circuit_bootstrap(torus.from_u64_np(l0.T.copy()), key.bsk_freq, key.ak_freq,
                            key.ssk_freq, P)
    rk = mux_eval.RefreshKeys(key.bsk_freq, key.ak_freq, key.ssk_freq, key.ksk_planes, P,
                              refresh_every=2)
    outs = mux_eval.evaluate_mux_circuit(integer.ripple_carry_adder(2), sel, GLWE, P.cbs_radix,
                                         inst, refresh=rk)
    for j in range(inst):
        got = sum(hc.decrypt_glwe_bit_np(torus.to_u64_np(o[..., j]), m["sk"], GLWE) << i
                  for i, o in enumerate(outs))
        assert got == sum(vals[j])


def test_u2_add(material):
    m = material
    m["wm"].wave_log.clear()
    assert _run(m["wm"], m, lambda a, b: a + b, (1, 2), 2)[0] == 3
    stats = m["wm"].wave_stats()
    # the 4 input conversions contract into one convert wave
    assert stats["convert"] == {"waves": 1, "gates": 4, "mean_batch": 4.0, "max_batch": 4}


def test_u4_mul_matches_per_wave(material):
    """The full 8-bit product; the per-wave executor gives the same bits."""
    m = material
    got, ctx, inputs, res = _run(m["wm"], m, lambda a, b: a * b, (5, 6), 4)
    assert got == 30
    ref = U32CircuitExecutor(m["key"], P, whole_circuit=False).run(ctx.circuit, inputs)
    assert set(ref) == set(res)
    for k in res:
        np.testing.assert_array_equal(ref[k], res[k])


def test_xor_and_eq(material):
    m = material
    assert _run(m["wm"], m, lambda a, b: a ^ b, (3, 1), 2)[0] == 2
    assert _run(m["wm"], m, lambda a, b: a.eq(b), (2, 2), 2)[0] == 1


def test_deep_refresh_circuit(material):
    """refresh_every = 2 on a 4-bit adder: the recryption chains run as
    refresh waves (extract -> keyswitch -> CBS -> external product of
    ONE), and the per-wave executor gives the same bits."""
    m = material
    ctx = FheCircuitCtx()
    a, b = UInt.input(ctx, 4), UInt.input(ctx, 4)
    sels = [ctx.circuit.insert_ciphertext_conversion(nd, CtType.GLWE1, CtType.GGSW1)
            for nd in a.bits + b.bits]
    outs = ctx.circuit.insert_mux_circuit(integer.ripple_carry_adder(4, emit_carry=False), sels,
                                          refresh_every=2)
    keys = []
    for j, o in enumerate(outs):
        on = ctx.circuit.add_node(FheOp.OUTPUT_GLWE1, f"out{j}")
        ctx.circuit.add_edge(o, on, FheEdge.UNARY)
        keys.append(f"out{j}")
    cts = (hc.encrypt_uint_bits_np(m["rng"], 9, 4, m["sk"], GLWE)
           + hc.encrypt_uint_bits_np(m["rng"], 5, 4, m["sk"], GLWE))
    inputs = dict(zip(a.input_keys() + b.input_keys(), cts))
    m["wm"].wave_log.clear()
    res = m["wm"].run(ctx.circuit, inputs)
    assert hc.decrypt_uint_bits_np([res[k] for k in keys], m["sk"], GLWE) == (9 + 5) % 16
    assert m["wm"].wave_stats()["refresh"]["gates"] > 0
    ref = U32CircuitExecutor(m["key"], P).run(ctx.circuit, inputs)
    for k in keys:
        np.testing.assert_array_equal(ref[k], res[k])


def test_packed_add(material):
    """Packed inputs (dynamic-index extraction), a packed output (mul_xn
    and add waves)."""
    m = material
    n, a_val, b_val = 4, 11, 7
    ctx = FheCircuitCtx()
    s = UInt.packed_input(ctx, n) + UInt.packed_input(ctx, n)
    out_key = s.pack_output()

    def pack_ct(value):
        msg = np.zeros(N, np.uint64)
        msg[:n] = [((value >> i) & 1) << 63 for i in range(n)]
        return hc.encrypt_glwe_np(m["rng"], msg, m["sk"], GLWE)

    res = m["wm"].run(ctx.circuit, {"in0": pack_ct(a_val), "in1": pack_ct(b_val)})
    phase = hc.decrypt_glwe_np(res[out_key], m["sk"], GLWE)
    bits = ((phase >> np.uint64(63)) + ((phase >> np.uint64(62)) & np.uint64(1))) & np.uint64(1)
    assert sum(int(bits[i]) << i for i in range(n)) == (a_val + b_val) % (1 << n)


def test_not_gate_and_ggsw_constants(material):
    """NOT, and CMuxes under the key's GGSW(1) and GGSW(0) constants."""
    m = material
    g = FheCircuit()
    x = g.add_node(FheOp.INPUT_GLWE1, "x")
    nt = g.add_node(FheOp.NOT)
    g.add_edge(x, nt, FheEdge.UNARY)
    for name, const in (("y", None), ("hi", FheOp.ONE_GGSW1), ("lo", FheOp.ZERO_GGSW1)):
        src = nt
        if const is not None:
            src = g.add_node(FheOp.CMUX)
            g.add_edge(g.add_node(const), src, FheEdge.SEL)
            g.add_edge(x, src, FheEdge.LOW)
            g.add_edge(nt, src, FheEdge.HIGH)
        o = g.add_node(FheOp.OUTPUT_GLWE1, name)
        g.add_edge(src, o, FheEdge.UNARY)
    for bit in (0, 1):
        ct = hc.encrypt_glwe_bit_np(m["rng"], bit, m["sk"], GLWE)
        res = m["wm"].run(g, {"x": ct})
        got = {k: hc.decrypt_glwe_bit_np(v, m["sk"], GLWE) for k, v in res.items()}
        assert got == {"y": 1 - bit, "hi": 1 - bit, "lo": bit}
        ref = U32CircuitExecutor(m["key"], P).run(g, {"x": ct})
        for k in res:
            np.testing.assert_array_equal(ref[k], res[k])


def test_schedule_cached_and_glev_rejected(material):
    """The schedule is built once per circuit structure; GLEV ops raise."""
    m = material
    ctx = FheCircuitCtx()
    a, b = UInt.input(ctx, 3), UInt.input(ctx, 3)
    (a + b).output()
    n_before = len(m["wm"]._schedules)
    inputs = dict(zip(a.input_keys() + b.input_keys(),
                      hc.encrypt_uint_bits_np(m["rng"], 3, 3, m["sk"], GLWE)
                      + hc.encrypt_uint_bits_np(m["rng"], 6, 3, m["sk"], GLWE)))
    assert m["wm"].schedule(ctx.circuit) is m["wm"].schedule(ctx.circuit)
    m["wm"].run(ctx.circuit, inputs)
    assert len(m["wm"]._schedules) == n_before + 1
    g = FheCircuit()
    z = g.add_node(FheOp.ZERO_GLEV1)
    o = g.add_node(FheOp.OUTPUT_GLEV1, "y")
    g.add_edge(z, o, FheEdge.UNARY)
    with pytest.raises(CircuitError):
        m["wm"].run(g, {})
