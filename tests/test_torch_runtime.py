"""The u64 API of the port (`spf_tpu_torch/runtime/{keys,encryption,
evaluation,executor}.py`, the `params` sets, `convert`'s key conversion,
and the encrypted CPU's default executor) on the CPU, at the parameters of
`tests/test_torch_wave_machine.py` (k = 1, N = 64, n0 = 32).

- The slice against the JAX package: a 2-bit add through both packages'
  `CircuitExecutor` on the same keys (the port's, carried to JAX as numpy)
  and the same input ciphertexts: the same groups dispatched, equal
  decryptions, and output phases within PHASE_TOL. Their raw bits part at
  the first gadget digit whose rounding the FFTs' last ulps decide (see
  `tests/test_torch_u64.py`, which holds each step within 2^32).
- The port alone, decrypting: the flows of `tests/test_runtime.py` and
  `tests/test_e2e_int.py` (GLEV mode, the GLEV -> GGSW round trip, packed
  public encryption), host numpy handles, and `FheComputer(ev)` with no
  executor running hand-assembled programs on the u64 `CircuitExecutor`,
  their returns read by `decrypt_return`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spf_tpu import params as jparams
from spf_tpu.ops import cbs as j_cbs_ops
from spf_tpu.runtime import keys as j_keys
from spf_tpu.runtime.evaluation import Evaluation as JEvaluation
from spf_tpu.runtime.executor import CircuitExecutor as JCircuitExecutor
from spf_tpu.runtime.fluent import FheCircuitCtx as JCtx
from spf_tpu.runtime.fluent import UInt as JUInt
from spf_tpu_torch import convert, params
from spf_tpu_torch.cpu import ArgsBuilder, FheComputer, Memory, run_program
from spf_tpu_torch.cpu.args import decrypt_return
from spf_tpu_torch.cpu.isa import RP, SP, Asm
from spf_tpu_torch.ops import torus as port_torus
from spf_tpu_torch.ops.u64 import bootstrap as u64_bs
from spf_tpu_torch.ops.u64 import cbs as u64_cbs
from spf_tpu_torch.ops.u64 import encryption as enc
from spf_tpu_torch.params import GlweDef, LweDef, Params, RadixDecomposition
from spf_tpu_torch.runtime import ComputeKey, Encryption, Evaluation, generate_keys
from spf_tpu_torch.runtime.executor import CircuitExecutor
from spf_tpu_torch.runtime.fhe_circuit import CtType, FheCircuit, FheEdge, FheOp
from spf_tpu_torch.runtime.fluent import FheCircuitCtx, UInt
from spf_tpu_torch.utils import host_crypto as hc
from spf_tpu_torch.utils.profiling import WaveProfiler

torch.set_num_threads(1)

PHASE_TOL = 2.0**52  # 10 bits below the 2^62 decision boundary of a bit
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
GLWE = P.l1_params
N = GLWE.degree


def jp(obj):
    """A port parameter dataclass -> the JAX package's."""
    cls = getattr(jparams, type(obj).__name__)
    return cls(**{f.name: jp(getattr(obj, f.name)) if dataclasses.is_dataclass(
        getattr(obj, f.name)) else getattr(obj, f.name) for f in dataclasses.fields(obj)})


@pytest.fixture(scope="module")
def material():
    sk, pk, ck = generate_keys(torch.Generator().manual_seed(41), P, device="cpu")
    ev = Evaluation(ck, P, device="cpu")
    return sk, pk, ck, ev, CircuitExecutor(ev)


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


# --- params, keys, devices ----------------------------------------------------------


@pytest.mark.parametrize("name", [
    "LWE_637_128", "LWE_512_128", "GLWE_1_512_128", "GLWE_5_256_128", "GLWE_1_1024_128",
    "GLWE_1_2048_128", "DEFAULT_128", "TEST_RADIX", "TEST_GLWE_DEF_1", "TEST_RLWE_DEF",
    "TEST_GLWE_DEF_2", "TEST_LWE_DEF_1", "TEST_LWE_DEF_2", "TEST_LWE_DEF_3", "TEST_PARAMS"])
def test_params_field_for_field(name):
    assert convert.param(getattr(jparams, name)) == getattr(params, name)


def test_noise_exponent_at_depth():
    for depth in (0, 1, 64, 510, 1024, 1e6):
        assert params.noise_exponent_at_depth(depth) == jparams.noise_exponent_at_depth(depth)


def test_generate_keys_shapes(material):
    sk, pk, ck, _, _ = material
    k, n0 = GLWE.size, P.l0_params.dim
    assert sk.lwe_0.shape == (n0,) and sk.glwe_1.shape == (k, N) and sk.lwe_1.shape == (k * N,)
    assert set(sk.lwe_0.tolist()) <= {0, 1} and set(sk.glwe_1.flatten().tolist()) == {0, 1}
    assert pk.rlwe_1.shape == (2, N)
    assert ck.bsk.shape == (n0, k + 1, P.pbs_radix.count, k + 1, N // 2)
    assert ck.ksk.shape == (k * N, P.ks_radix.count, n0 + 1)
    assert ck.auto_keys.shape == (GLWE.log_degree, k, P.tr_radix.count, k + 1, N // 2)
    assert ck.ssk.shape == (k, k, P.ss_radix.count, k + 1, N // 2)
    assert ck.bsk.dtype == ck.auto_keys.dtype == ck.ssk.dtype == torch.complex128
    assert ck.ksk.dtype == torch.int64 and ck.device == torch.device("cpu")
    p2 = dataclasses.replace(P, l1_params=GlweDef(size=2, degree=64, std=1e-16))
    sk2, pk2, ck2 = generate_keys(3, p2, device="cpu")  # an int seed; k = 2: no public key
    assert pk2 is None and ck2.ssk.shape == (2, 2, P.ss_radix.count, 3, N // 2)


def test_entry_points_need_a_card(material, monkeypatch):
    """Without a card the u64 entry points raise unless device="cpu"; no
    fallback hides the device."""
    _, _, ck, _, _ = material
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: generate_keys(0, P), lambda: Encryption(P),
               lambda: Evaluation(ck, P, precompute_constants=False),
               lambda: convert.compute_key(ck)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    assert Encryption(P, device="cpu").device == torch.device("cpu")
    # the ops that make a tensor from no tensor input place it on the card,
    # those given one follow its device
    msg = np.zeros(N, dtype=np.uint64)
    for fn in (lambda: enc.trivial_lwe(1, P.l0_params),
               lambda: enc.trivial_glwe(msg, GLWE),
               lambda: enc.trivial_glev(msg, GLWE, P.cbs_radix),
               lambda: enc.trivial_ggsw(msg, GLWE, P.cbs_radix),
               lambda: u64_bs.generate_lut([lambda x: x], GLWE, 1),
               lambda: u64_bs.generate_bivariate_lut(lambda x, y: x, GLWE, 1),
               lambda: u64_cbs.multifunctional_cbs_lut(GLWE, P.cbs_radix)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    on_cpu = torch.zeros(N, dtype=torch.int64)
    for fn in (enc.trivial_glwe, enc.trivial_glev, enc.trivial_ggsw):
        args = (GLWE,) if fn is enc.trivial_glwe else (GLWE, P.cbs_radix)
        assert fn(on_cpu, *args).device == fn(msg, *args, device="cpu").device == on_cpu.device


def test_convert_round_trip(material):
    """The JAX package's key objects -> the port's -> numpy: the same bits
    and spectra as the keys they were made from."""
    sk, pk, ck, _, _ = material
    arrays = {**convert.key_arrays(sk), **convert.key_arrays(pk), **convert.key_arrays(ck)}
    assert set(arrays) == {"lwe_0", "glwe_1", "rlwe_1", "bsk", "ksk", "auto_keys", "ssk"}
    jsk = j_keys.SecretKey(lwe_0=jnp.asarray(arrays["lwe_0"]), glwe_1=jnp.asarray(arrays["glwe_1"]))
    jpk = j_keys.PublicKey(rlwe_1=jnp.asarray(arrays["rlwe_1"]))
    jck = j_keys.ComputeKey(**{f: jnp.asarray(arrays[f]) for f in ("bsk", "ksk", "auto_keys",
                                                                    "ssk")})
    assert jck.ksk.dtype == jnp.uint64 and jck.bsk.dtype == jnp.complex128
    back = {**convert.key_arrays(convert.secret_key(jsk, "cpu")),
            **convert.key_arrays(convert.public_key(jpk, "cpu")),
            **convert.key_arrays(convert.compute_key(jck, "cpu"))}
    for name, a in arrays.items():
        assert back[name].dtype == a.dtype and np.array_equal(back[name], a), name
    ck2 = convert.compute_key(jck, "cpu")
    assert torch.equal(ck2.ksk_planes, ck.ksk_planes) and torch.equal(ck2.bsk, ck.bsk)
    assert torch.equal(convert.secret_key(jsk, "cpu").glwe_1, sk.glwe_1)


# --- the slice against the JAX package -------------------------------------------------


def _add_graph(ctx_cls, uint_cls, n):
    ctx = ctx_cls()
    a, b = uint_cls.input(ctx, n), uint_cls.input(ctx, n)
    return ctx, a.input_keys() + b.input_keys(), (a + b).output()


def test_add_through_both_executors(material, monkeypatch):
    sk, _, ck, ev, _ = material
    arrays = {**convert.key_arrays(sk), **convert.key_arrays(ck)}
    jck = j_keys.ComputeKey(**{f: jnp.asarray(arrays[f]) for f in ("bsk", "ksk", "auto_keys",
                                                                    "ssk")})
    jpar = jp(P)
    jev = JEvaluation(jck, jpar, precompute_constants=False)
    # JAX's CBS as written, its fori_loop a Python loop over the jitted body
    # (compiling the loop takes minutes here); the other ops stay jitted
    jev._jit_cache["circuit_bootstrap"] = lambda c: j_cbs_ops.circuit_bootstrap(
        c, jck.bsk, jck.auto_keys, jck.ssk, jpar)

    def fori_loop(lower, upper, body, init):
        step, carry = jax.jit(body), init
        for i in range(lower, upper):
            carry = step(i, carry)
        return carry

    monkeypatch.setattr(jax.lax, "fori_loop", fori_loop)
    a_val, b_val, n = 3, 2, 2
    cts = ev.enc.encrypt_uint_bits(gen(1), a_val, n, sk) + ev.enc.encrypt_uint_bits(
        gen(2), b_val, n, sk)
    ctx, in_keys, out_keys = _add_graph(FheCircuitCtx, UInt, n)
    jctx, j_in_keys, j_out_keys = _add_graph(JCtx, JUInt, n)
    ex = CircuitExecutor(ev, debug=True)
    jex = JCircuitExecutor(jev, debug=True)
    outs = ex.run(ctx.circuit, dict(zip(in_keys, cts)))
    jouts = jex.run(jctx.circuit, {k: jnp.asarray(port_torus.to_u64_np(c))
                                   for k, c in zip(j_in_keys, cts)})
    assert ex.debug_log == jex.debug_log
    got = ev.enc.decrypt_uint_bits([outs[k] for k in out_keys], sk)
    jgot = ev.enc.decrypt_uint_bits([np.asarray(jouts[k]) for k in j_out_keys], sk)
    assert got == jgot == (a_val + b_val) % (1 << n)
    worst = 0.0
    for k, jk in zip(out_keys, j_out_keys):
        d = enc.decrypt_glwe(outs[k], sk.glwe_1, GLWE) - enc.decrypt_glwe(
            np.asarray(jouts[jk]), sk.glwe_1, GLWE)
        worst = max(worst, float(d.to(torch.float64).abs().max()))
    print(f"\n2-bit add: output phases differ by at most 2^{np.log2(worst + 1):.2f}")
    assert worst <= PHASE_TOL


# --- the port alone, decrypting --------------------------------------------------------


def run_binary(material, build, a_val, b_val, n, mode="glwe"):
    sk, _, _, ev, ex = material
    ctx = FheCircuitCtx()
    a, b = UInt.input(ctx, n, mode=mode), UInt.input(ctx, n, mode=mode)
    out_keys = build(a, b).output()
    cts = ev.enc.encrypt_uint_bits(gen(a_val), a_val, n, sk) + ev.enc.encrypt_uint_bits(
        gen(100 + b_val), b_val, n, sk)
    outputs = ex.run(ctx.circuit, dict(zip(a.input_keys() + b.input_keys(), cts)))
    return ev.enc.decrypt_uint_bits([outputs[k] for k in out_keys], sk)


@pytest.mark.parametrize("case", [
    ("add", lambda a, b: a + b, 9, 7, 0), ("sub", lambda a, b: a - b, 5, 10, 11),
    ("mul", lambda a, b: a * b, 13, 11, 143), ("gt", lambda a, b: a.gt(b), 12, 3, 1),
    ("eq", lambda a, b: a.eq(b), 6, 6, 1), ("xor", lambda a, b: a ^ b, 0b1100, 0b1010, 0b0110),
    ("select", lambda a, b: a.select(a.gt(b), b), 7, 2, 7)], ids=lambda c: c[0])
def test_u4_ops(material, case):
    _, build, a_val, b_val, want = case
    assert run_binary(material, build, a_val, b_val, 4) == want


@pytest.mark.parametrize("case", [("add", lambda a, b: a + b, 10, 5, 15),
                                  ("eq", lambda a, b: a.eq(b), 9, 9, 1)], ids=lambda c: c[0])
def test_u4_glev_mode(material, case):
    """GLEV CMux trees and the scheme-switch output conversion."""
    _, build, a_val, b_val, want = case
    assert run_binary(material, build, a_val, b_val, 4, mode="glev") == want


def test_glev_ggsw_conversion_roundtrip(material):
    sk, _, _, ev, ex = material
    for bit in (0, 1):
        g = FheCircuit()
        inp = g.add_node(FheOp.INPUT_GLWE1, "b")
        glev = g.insert_ciphertext_conversion(inp, CtType.GLWE1, CtType.GLEV1)
        ggsw = g.insert_ciphertext_conversion(glev, CtType.GLEV1, CtType.GGSW1)
        zero, one, m = (g.add_node(FheOp.ZERO_GLWE1), g.add_node(FheOp.ONE_GLWE1),
                        g.add_node(FheOp.CMUX))
        g.add_edge(ggsw, m, FheEdge.SEL)
        g.add_edge(zero, m, FheEdge.LOW)
        g.add_edge(one, m, FheEdge.HIGH)
        o = g.add_node(FheOp.OUTPUT_GLWE1, "out")
        g.add_edge(m, o, FheEdge.UNARY)
        ct = ev.enc.encrypt_uint_bits(gen(5 + bit), bit, 1, sk)
        assert ev.enc.decrypt_uint_bits([ex.run(g, {"b": ct[0]})["out"]], sk) == bit


def test_packed_input_roundtrip(material):
    sk, pk, _, ev, ex = material
    n = 4
    ctx = FheCircuitCtx()
    a, b = UInt.packed_input(ctx, n), UInt.packed_input(ctx, n)
    out_key = (a + b).pack_output()
    ct_a = ev.enc.encrypt_packed_uint(gen(30), 12, n, pk)
    ct_b = ev.enc.encrypt_packed_uint(gen(31), 3, n, pk)
    assert ev.enc.decrypt_packed_uint(ct_a, n, sk) == 12
    outputs = ex.run(ctx.circuit, {"in0": ct_a, "in1": ct_b})
    assert ev.enc.decrypt_packed_uint(outputs[out_key], n, sk) == 15


def test_evaluation_ops(material):
    """Keyless NOT / XOR, the precomputed GGSW(0) / GGSW(1), and the full
    conversion ring GLWE -> LWE1 -> LWE0 -> GGSW -> CMux."""
    sk, _, _, ev, _ = material
    rng_ = np.random.default_rng(3)
    m1, m2 = rng_.integers(0, 2, N), rng_.integers(0, 2, N)
    c1 = ev.enc.encrypt_glwe_l1(gen(10), torch.from_numpy(m1), sk)
    c2 = ev.enc.encrypt_glwe_l1(gen(11), torch.from_numpy(m2), sk)
    assert ev.enc.decrypt_glwe_l1(ev.xor(c1, c2), sk).tolist() == (m1 ^ m2).tolist()
    dec_not = ev.enc.decrypt_glwe_l1(ev.not_(c1), sk)
    assert int(dec_not[0]) == 1 - int(m1[0]) and dec_not[1:].tolist() == m1[1:].tolist()
    zeros = ev.enc.encrypt_glwe_l1(gen(20), torch.zeros(N, dtype=torch.int64), sk)
    ones = ev.enc.encrypt_glwe_l1(gen(21), torch.ones(N, dtype=torch.int64), sk)
    for const, bit in ((ev.ggsw_zero, 0), (ev.ggsw_one, 1)):
        assert set(ev.enc.decrypt_glwe_l1(ev.cmux(const, zeros, ones), sk).tolist()) == {bit}
    for bit in (0, 1):
        glwe = ev.enc.encrypt_uint_bits(gen(42 + bit), bit, 1, sk)[0]
        lwe1 = ev.sample_extract(glwe, 0)
        assert int(ev.enc.decrypt_lwe_l1(lwe1, sk)) == bit
        lwe0 = ev.keyswitch_lwe_l1_to_l0(lwe1)
        assert int(ev.enc.decrypt_lwe_l0(lwe0, sk)) == bit
        out = ev.cmux(ev.circuit_bootstrap(lwe0), zeros, ones)
        assert set(ev.enc.decrypt_glwe_l1(out, sk).tolist()) == {bit}
        assert int(ev.enc.decrypt_lwe_l0(ev.enc.encrypt_lwe_l0(gen(bit), bit, sk), sk)) == bit
        ggsw = ev.enc.encrypt_ggsw_l1(gen(50 + bit), bit, sk)
        assert set(ev.enc.decrypt_glwe_l1(ev.multiply_glwe_ggsw(ones, ggsw), sk).tolist()) == {bit}


def test_executor_host_handles_and_compile(material):
    """Host numpy u64 handles go in as they are; `compile` runs the same
    circuit; a profiler records every dispatched group."""
    sk, _, _, ev, _ = material
    glwe_sk = port_torus.to_u64_np(sk.glwe_1)
    rng_ = np.random.default_rng(8)
    ctx, in_keys, out_keys = _add_graph(FheCircuitCtx, UInt, 3)
    cts = hc.encrypt_uint_bits_np(rng_, 5, 3, glwe_sk, GLWE) + hc.encrypt_uint_bits_np(
        rng_, 6, 3, glwe_sk, GLWE)
    ex = CircuitExecutor(ev, debug=True)
    ex.profiler = WaveProfiler()
    outs = ex.run(ctx.circuit, dict(zip(in_keys, cts)))
    assert ev.enc.decrypt_uint_bits([outs[k] for k in out_keys], sk) == 3
    assert hc.decrypt_uint_bits_np([port_torus.to_u64_np(outs[k]) for k in out_keys],
                                   glwe_sk, GLWE) == 3
    assert len(ex.profiler.records) == len(ex.debug_log) > 0
    fn = ex.compile(ctx.circuit)
    assert fn is ex.compile(ctx.circuit)
    again = fn(dict(zip(in_keys, cts)))
    assert ev.enc.decrypt_uint_bits([again[k] for k in out_keys], sk) == 3


def _program(asm_build, *arg_cts, ret_bytes=1):
    mem = Memory()
    entry = mem.allocate_program(asm_build(Asm()).instrs)
    call = ArgsBuilder()
    for c in arg_cts:
        call = call.arg_encrypted(c)
    return mem, entry, call.return_value(8 * ret_bytes).build()


def test_fhe_computer_default_executor(material):
    """`FheComputer(ev)` with no executor runs the u64 `CircuitExecutor`:
    an add, a select on a plaintext bit (the GGSW constants), and a Dbg
    handler that flushes mid-program, each return read by `decrypt_return`."""
    sk, _, _, ev, _ = material

    def load2(a):
        return a.load(1, SP, 8, offset=0).load(2, SP, 8, offset=1)

    x, y = ev.enc.encrypt_uint_bits(gen(60), 42, 8, sk), ev.enc.encrypt_uint_bits(gen(61), 54,
                                                                                     8, sk)
    mem, entry, call = _program(lambda a: load2(a).add(3, 1, 2).store(RP, 3, 8).ret(), x, y)
    proc = FheComputer(ev)
    assert isinstance(proc.ex, CircuitExecutor) and proc.ex.ev is ev
    rp = proc.run_program(entry, mem, call)
    assert decrypt_return(mem, rp, 1, ev.enc, sk) == 96 and proc.flush_count == 1

    mem, entry, call = _program(lambda a: a.load(1, SP, 8, offset=0).loadi(2, 3, 8).mul(3, 1, 2)
                                .store(RP, 3, 8).ret(), ev.enc.encrypt_uint_bits(gen(62), 21, 8,
                                                                                 sk))
    mem.function_entries["times3"] = entry  # through the one-call runner, as a user would
    mem2, rp, _ = run_program(ev, mem, "times3", call)
    assert decrypt_return(mem2, rp, 1, ev.enc, sk) == 63

    seen = []
    mem, entry, call = _program(lambda a: load2(a).add(3, 1, 2).dbg(3, 7).xor(4, 3, 1)
                                .store(RP, 4, 8).ret(), x, y)
    proc = FheComputer(ev)
    proc.debug_handlers[7] = lambda v: seen.append(ev.enc.decrypt_uint_bits(list(v.bits), sk))
    rp = proc.run_program(entry, mem, call)
    assert seen == [96] and proc.flush_count == 2
    assert decrypt_return(mem, rp, 1, ev.enc, sk) == 96 ^ 42


def test_compute_key_planes_follow_the_key(material):
    _, _, ck, _, _ = material
    copy = ComputeKey(bsk=ck.bsk, ksk=ck.ksk, auto_keys=ck.auto_keys, ssk=ck.ssk)
    assert torch.equal(copy.ksk_planes, ck.ksk_planes)
    assert copy.ksk_planes.shape == (4, ck.ksk.shape[0] * ck.ksk.shape[1], ck.ksk.shape[2])
