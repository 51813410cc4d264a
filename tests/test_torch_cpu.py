"""The port's encrypted CPU (`spf_tpu_torch/cpu/`) against the JAX
package's (`spf_tpu/cpu/`).

- ISA: every `Asm` method's instruction encodes to the same 64-bit word
  in both packages and decodes back equal.
- Graph parity: both `FheComputer`s run the programs of
  `tests/test_cpu.py` (bench.py --program mul32 among them), a program of
  every encrypted instruction, and two programs that flush more than once
  (a `Dbg` handler on an encrypted register; a lowered node budget). Each
  gets its own `U32HostEvaluation` at DEFAULT_128 and a recording executor
  that keeps each flush's circuit and answers with zero GLWE arrays, so no
  crypto runs. The circuits are the same node for node and edge for edge,
  with the same input keys and values, and so are gas, flushes, the return
  pointer, registers and memory. The faults raise the same class at the
  same instruction. mul32's wave schedule is the reference's, and its
  statistics are those `chip_smoke.py` holds the card's run against.
- Decryption: the encrypted programs on the port's `WaveMachine` on the
  CPU at the parameters of `tests/test_torch_wave_machine.py` (k = 1,
  N = 64, n0 = 32), across one and several flushes.
- The ELF32 loader: a small ELF built here maps the same bytes and entries
  in both packages; both reject a bad magic, class and ABI version.

No JAX function runs here: the JAX CPU, its circuits and its scheduler
are host Python.
"""

import dataclasses
import inspect
import struct
import types

import numpy as np
import pytest
import torch

import chip_smoke
from spf_tpu import params as j_params
from spf_tpu.cpu import args as j_args
from spf_tpu.cpu import isa as j_isa
from spf_tpu.cpu import memory as j_memory
from spf_tpu.cpu import processor as j_processor
from spf_tpu.runtime import executor_u32 as j_executor
from spf_tpu.runtime import wave_machine as j_wm
from spf_tpu.utils.profiling import metrics as j_metrics
from spf_tpu_torch import params
from spf_tpu_torch.cpu import args, isa, memory, processor, run_program
from spf_tpu_torch.ops import encryption
from spf_tpu_torch.params import GlweDef, LweDef, Params, RadixDecomposition
from spf_tpu_torch.runtime import wave_machine as wm
from spf_tpu_torch.runtime.executor_u32 import U32ComputeKey, U32HostEvaluation, wave_stats
from spf_tpu_torch.runtime.fhe_circuit import FheCircuit, FheEdge, FheOp
from spf_tpu_torch.utils import host_crypto as hc
from spf_tpu_torch.utils.profiling import metrics

torch.set_num_threads(1)

PORT = dict(isa=isa, memory=memory, args=args, processor=processor, metrics=metrics,
            ev=lambda: U32HostEvaluation(params.DEFAULT_128), glwe=params.DEFAULT_128.l1_params)
REF = dict(isa=j_isa, memory=j_memory, args=j_args, processor=j_processor, metrics=j_metrics,
           ev=lambda: j_executor.U32HostEvaluation(j_params.DEFAULT_128),
           glwe=j_params.DEFAULT_128.l1_params)

# --- (a) the ISA -------------------------------------------------------------

# one call of every Asm method, with operands that fill its fields
ASM_CALLS = [
    ("load", (4, 3, 16, -8)), ("store", (3, 4, 128, 12)), ("loadi", (3, -0x21524111, 32)),
    ("trunc", (5, 6, 7)), ("zext", (5, 6, 64)), ("sext", (11, 3, 128)), ("move", (63, 0)),
    ("not_", (1, 2)), ("and_", (1, 2, 3)), ("or_", (4, 5, 6)), ("xor", (7, 8, 9)),
    ("add", (5, 3, 4)), ("addc", (5, 6, 3, 4, 7)), ("sub", (10, 11, 12)),
    ("subb", (5, 6, 3, 4, 7)), ("neg", (13, 14)), ("mul", (15, 16, 17)),
    ("rotl", (1, 2, 3)), ("rotr", (4, 5, 6)), ("shl", (7, 8, 9)), ("shr", (10, 11, 12)),
    ("shra", (13, 14, 15)), ("cmp_eq", (1, 2, 3)), ("cmp_gt", (4, 5, 6)),
    ("cmp_gt_s", (8, 3, 4)), ("cmp_ge", (1, 2, 3)), ("cmp_ge_s", (4, 5, 6)),
    ("cmp_lt", (7, 8, 9)), ("cmp_lt_s", (10, 11, 12)), ("cmp_le", (13, 14, 15)),
    ("cmp_le_s", (16, 17, 18)), ("branch_nonzero", (8, -16)), ("branch_zero", (9, 1 << 30)),
    ("branch", (-(1 << 31),)), ("ret", ()), ("cmux", (9, 8, 3, 4)), ("dbg", (3, 0x7FFFFFFF)),
]


def test_every_asm_method_is_called():
    names = {n for n, _ in inspect.getmembers(isa.Asm, inspect.isfunction) if not n.startswith("_")}
    assert names == {n for n, _ in ASM_CALLS}
    assert isa.ISA == j_isa.ISA and (isa.RP, isa.SP, isa.INSTRUCTION_SIZE) == (
        j_isa.RP, j_isa.SP, j_isa.INSTRUCTION_SIZE)


@pytest.mark.parametrize("method, operands", ASM_CALLS, ids=[n for n, _ in ASM_CALLS])
def test_isa_word_for_word(method, operands):
    instr = getattr(isa.Asm(), method)(*operands).instrs[0]
    ref = getattr(j_isa.Asm(), method)(*operands).instrs[0]
    word = isa.encode(instr)
    assert 0 <= word < 1 << 64 and word == j_isa.encode(ref)
    back, ref_back = isa.decode(word), j_isa.decode(word)
    assert (back.name, back.operands) == (ref_back.name, ref_back.operands)
    assert (back.name, back.operands) == (instr.name, instr.operands)


# --- (b) graph parity ----------------------------------------------------------

SP, RP = isa.SP, isa.RP


@dataclasses.dataclass
class Program:
    """A hand-assembled program (`build(Asm) -> Asm`), its arguments, each
    ("enc", value, width), ("pt", value, width) or ("struct", [(value,
    width), ...]), its return (width, encrypted) and the value it returns;
    the node budget to set on the processor, the value the Dbg handler 7
    sees, and the flushes the run makes."""

    build: object
    args: list
    ret: tuple
    value: int | None
    budget: int | None = None
    dbg: int | None = None
    flushes: int = 1


def _every_op(a):
    """Each encrypted instruction of the processor at 8 bits."""
    a = (a.load(1, SP, 8, offset=0).load(2, SP, 8, offset=1).loadi(3, 3, 8).loadi(11, 1, 1)
         .sub(4, 1, 2).and_(5, 1, 2).or_(6, 1, 3).neg(7, 1).not_(8, 2)
         .addc(9, 30, 1, 2, 11).subb(12, 31, 1, 3, 11).cmp_eq(14, 1, 2).cmp_ge_s(15, 1, 3)
         .cmp_lt(16, 1, 2).cmp_le_s(17, 2, 1).shl(18, 1, 3).shra(19, 1, 2).rotl(20, 2, 3)
         .rotr(21, 1, 2).shr(22, 2, 3).trunc(23, 1, 4).zext(24, 23, 8).sext(25, 23, 8)
         .cmux(26, 14, 1, 3).move(27, 26).xor(28, 24, 25))
    for i, r in enumerate((4, 5, 6, 7, 8, 9, 12, 18, 19, 20, 21, 22, 26, 27, 28)):
        a = a.store(RP, r, 8, offset=i)
    for i, r in enumerate((30, 31, 14, 15, 16, 17)):
        a = a.store(RP, r, 1, offset=15 + i)  # a 1-bit store writes one zero-extended byte
    return a.ret()


def _load2(a):
    return a.load(1, SP, 8, offset=0).load(2, SP, 8, offset=1)


PROGRAMS = {
    "loop_sum": Program(
        lambda a: a.loadi(1, 1, 32).loadi(2, 0, 32).loadi(3, 11, 32).loadi(4, 1, 32)
        .add(2, 2, 1).add(1, 1, 4).cmp_lt(5, 1, 3).branch_nonzero(5, -24).store(10, 2, 32).ret(),
        [], (32, False), 55, flushes=0),
    "arithmetic_ops": Program(
        lambda a: a.loadi(1, 200, 8).loadi(2, 100, 8).add(3, 1, 2).mul(4, 1, 2).sub(5, 1, 2)
        .xor(6, 1, 2).shra(7, 1, 2).store(10, 3, 8, offset=0).store(10, 4, 8, offset=1)
        .store(10, 5, 8, offset=2).store(10, 6, 8, offset=3).ret(),
        [], (32, False), 44 | 32 << 8 | 100 << 16 | 172 << 24, flushes=0),
    "encrypted_add": Program(lambda a: _load2(a).add(3, 1, 2).store(RP, 3, 8).ret(),
                             [("enc", 42, 8), ("enc", 54, 8)], (8, True), 96),
    # tests/test_cpu.py's mul32 gradeschool program is bench.py --program mul32
    "mul32": Program(
        lambda a: a.load(1, SP, 32, offset=0).load(2, SP, 32, offset=4).mul(3, 1, 2)
        .store(RP, 3, 32).ret(),
        [("enc", 51977, 32), ("enc", 40961, 32)], (32, True), 2129029897),
    "cmux_and_compare": Program(
        lambda a: _load2(a).cmp_gt(3, 1, 2).cmux(4, 3, 1, 2).store(RP, 4, 8).ret(),
        [("enc", 57, 8), ("enc", 201, 8)], (8, True), 201),
    "mixed_plain_encrypted": Program(
        lambda a: a.load(1, SP, 8, offset=0).loadi(2, 3, 8).mul(3, 1, 2).store(RP, 3, 8).ret(),
        [("enc", 21, 8)], (8, True), 63),
    "struct_argument": Program(lambda a: _load2(a).add(3, 1, 2).store(RP, 3, 8).ret(),
                               [("struct", [(19, 8), (23, 8)])], (8, False), 42, flushes=0),
    "every_encrypted_op": Program(_every_op, [("enc", 0xB5, 8), ("enc", 0x3C, 8)], (8 * 21, True),
                                  None),
    # a Dbg handler on an unresolved register flushes mid-program
    "dbg_two_flushes": Program(
        lambda a: _load2(a).add(3, 1, 2).dbg(3, 7).xor(4, 3, 1).store(RP, 4, 8).ret(),
        [("enc", 42, 8), ("enc", 54, 8)], (8, True), 96 ^ 42, dbg=96, flushes=2),
    # a pending graph above the node budget flushes after the add and the
    # sub; the CMux's graph stays below it until the end
    "budget_flushes": Program(
        lambda a: _load2(a).add(3, 1, 2).sub(4, 3, 2).cmux(5, 4, 3, 1).store(RP, 5, 8).ret(),
        [("enc", 43, 8), ("enc", 54, 8)], (8, True), 97, budget=40, flushes=3),
}
FAULTS = {
    # (program, args, gas limit, the fault's class name)
    "encrypted_branch_condition": (lambda a: a.load(1, SP, 8, offset=0).branch_nonzero(1, 8).ret(),
                                   [("enc", 1, 8)], None, "BranchConditionNotPlaintext"),
    "out_of_gas": (lambda a: a.loadi(1, 0, 32).branch(0).ret(), [], 1000, "OutOfGas"),
    "unaligned_access": (lambda a: a.loadi(1, 3, 32).load(2, 1, 32).ret(), [], None,
                         "UnalignedAccess"),
}


class Recorder:
    """A circuit executor that records each flush's circuit and inputs and
    answers every output with its own zero GLWE array: no crypto runs, and
    each output is a distinct handle as an executor's would be."""

    def __init__(self, glwe):
        self.shape = (glwe.size + 1, glwe.degree)
        self.flushes = []
        self.outputs = {}  # id(array) -> "flush:key"

    def run(self, circuit, inputs):
        self.flushes.append(dict(
            nodes=[(n.op.value, n.param) for n in circuit.nodes],
            edges=[(s, d, r.value) for s, d, r in circuit.edges],
            inputs=dict(inputs), circuit=circuit))
        out = {}
        for n in circuit.nodes:
            if n.op.name == "OUTPUT_GLWE1":
                out[n.param] = np.zeros(self.shape, np.uint64)
                self.outputs[id(out[n.param])] = f"{len(self.flushes)}:{n.param}"
        return out


def _handles(arg_list):
    """Random u64 GLWE arrays standing in for each encrypted argument's
    bits (no crypto runs), and a label for each by argument and bit."""
    glwe = params.DEFAULT_128.l1_params
    rng = np.random.default_rng(7)
    bits, labels = {}, {}
    for i, a in enumerate(arg_list):
        if a[0] == "enc":
            bits[i] = [rng.integers(0, 1 << 64, (glwe.size + 1, glwe.degree), np.uint64,
                                    endpoint=False) for _ in range(a[2])]
            labels.update({id(c): f"arg{i}.{j}" for j, c in enumerate(bits[i])})
    return bits, labels


def _call_data(pkg, arg_list, ret, bits):
    b = pkg["args"].ArgsBuilder()
    for i, a in enumerate(arg_list):
        if a[0] == "enc":
            b = b.arg_encrypted(bits[i])
        elif a[0] == "pt":
            b = b.arg(a[1], a[2])
        else:
            b = b.arg_struct(a[1])
    if ret is None:
        return b.no_return_value().build()
    return b.return_value(*ret).build()


def _token(proc, rec, labels, bit):
    """A package-free name of a GLWE bit handle."""
    if bit is proc._triv_bits[0] or bit is proc._triv_bits[1]:
        return int(bit is proc._triv_bits[1])
    if id(bit) in labels:
        return labels[id(bit)]
    return rec.outputs[id(bit)]


def _state(pkg, proc, rec, mem, labels):
    pt, ct = pkg["processor"].PtVal, pkg["processor"].CtVal
    regs = []
    for r in proc.registers:
        if isinstance(r, pt):
            regs.append(("pt", r.val, r.width))
        else:
            assert isinstance(r, ct)
            regs.append(("ct", r.width, [_token(proc, rec, labels, b) for b in r.bits]))
    enc = pkg["memory"].EncByte
    pages = {pid: [("enc", [_token(proc, rec, labels, b) for b in x.bits]) if isinstance(x, enc)
                   else x for x in page] for pid, page in mem.pages.items()}
    return regs, pages


def _run(pkg, name, bits, labels):
    prog = PROGRAMS[name]
    rec = Recorder(pkg["glwe"])
    mem = pkg["memory"].Memory()
    entry = mem.allocate_program(prog.build(pkg["isa"].Asm()).instrs)
    proc = pkg["processor"].FheComputer(pkg["ev"](), executor=rec)
    if prog.budget is not None:
        proc.FLUSH_NODE_BUDGET = prog.budget
    seen = []
    proc.debug_handlers[7] = lambda v: seen.append(
        [_token(proc, rec, labels, b) for b in v.bits])
    before = pkg["metrics"].snapshot()
    rp = proc.run_program(entry, mem, _call_data(pkg, prog.args, prog.ret, bits))
    after = pkg["metrics"].snapshot()
    counts = {k: after.get(k, 0) - before.get(k, 0) for k in ("cpu.instructions", "cpu.flushes")}
    return dict(rec=rec, proc=proc, mem=mem, rp=rp, counts=counts, seen=seen,
                state=_state(pkg, proc, rec, mem, labels))


_RUNS = {}


def _both(name):
    """The program run by both packages on the same argument handles,
    memoised: mul32's graph takes about a second a package to build."""
    if name not in _RUNS:
        bits, labels = _handles(PROGRAMS[name].args)
        _RUNS[name] = (_run(PORT, name, bits, labels), _run(REF, name, bits, labels))
    return _RUNS[name]


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_program_graph_parity(name):
    """The same circuits (nodes, params, edges; input keys and the very
    input arrays) at every flush, and the same gas, flush count, counters,
    return pointer, registers and memory."""
    got, want = _both(name)
    prog = PROGRAMS[name]
    assert len(got["rec"].flushes) == len(want["rec"].flushes) == got["proc"].flush_count
    assert got["proc"].flush_count == prog.flushes
    for g, w in zip(got["rec"].flushes, want["rec"].flushes):
        assert g["nodes"] == w["nodes"]
        assert g["edges"] == w["edges"]
        assert list(g["inputs"]) == list(w["inputs"])
        assert all(g["inputs"][k] is w["inputs"][k] or np.array_equal(g["inputs"][k],
                                                                     w["inputs"][k])
                   for k in g["inputs"])
    for key in ("rp", "counts", "seen", "state"):
        assert got[key] == want[key], key
    gp, wp = got["proc"], want["proc"]
    assert (gp.gas_used, gp.flush_count) == (wp.gas_used, wp.flush_count)
    if not prog.ret[1]:
        n = prog.ret[0] // 8
        assert args.decode_plaintext_return(got["mem"], got["rp"], n) == prog.value
    assert len(got["seen"]) == (prog.dbg is not None)


def test_mul32_is_bench_program():
    """bench.py --program mul32: 500003 gas, one flush, and the 128 input
    conversions of its gradeschool product (64 GLWE inputs, 64 lazy bits of
    the 16-bit sub-products)."""
    got, _ = _both("mul32")
    (flush,) = got["rec"].flushes
    ops = [op for op, _ in flush["nodes"]]
    assert got["proc"].gas_used == 500_003 and got["proc"].flush_count == 1
    assert ops.count("input_glwe1") == 64
    assert len(flush["nodes"]) == 51_075


def test_mul32_schedule_equals_reference():
    """The port's wave schedule of the port's mul32 graph is the JAX
    scheduler's of the JAX graph, and its statistics are the ones
    `chip_smoke.py` holds the card's run against."""
    got, want = _both("mul32")
    s = wm.build_schedule(got["rec"].flushes[0]["circuit"])
    js = j_wm.build_schedule(want["rec"].flushes[0]["circuit"])
    assert s.wave_log == js.wave_log and s.slot_counts == js.slot_counts
    assert [(w.group, w.width, w.gates) for w in s.waves] == [
        (w.group, w.width, w.gates) for w in js.waves]
    want_stats = j_wm.WaveMachine.wave_stats(types.SimpleNamespace(wave_log=js.wave_log))
    assert wave_stats(s.wave_log) == want_stats == chip_smoke.MUL32_WAVE_STATS


@pytest.mark.parametrize("name", list(FAULTS))
def test_faults_raise_alike(name):
    build, arg_list, gas_limit, fault = FAULTS[name]
    bits, _ = _handles(arg_list)
    seen = []
    for pkg in (PORT, REF):
        mem = pkg["memory"].Memory()
        entry = mem.allocate_program(build(pkg["isa"].Asm()).instrs)
        proc = pkg["processor"].FheComputer(pkg["ev"](), executor=Recorder(pkg["glwe"]))
        call = _call_data(pkg, arg_list, None, bits) if arg_list else None
        before = pkg["metrics"].snapshot().get("cpu.instructions", 0)
        with pytest.raises(Exception) as err:
            proc.run_program(entry, mem, call, gas_limit=gas_limit)
        done = pkg["metrics"].snapshot().get("cpu.instructions", 0) - before
        seen.append((type(err.value).__name__, str(err.value), done, proc.gas_used))
    assert seen[0] == seen[1] and seen[0][0] == fault


def test_no_executor_raises():
    with pytest.raises(processor.CpuError, match="WaveMachine"):
        processor.FheComputer(PORT["ev"]())


# --- (c) decryption on the port's wave machine (CPU) ------------------------

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


@pytest.fixture(scope="module")
def machine():
    """`tests/test_torch_wave_machine.py`'s keys (CPU) and a WaveMachine on them."""
    gen = torch.Generator().manual_seed(977)
    lwe_sk = encryption.generate_lwe_sk(LWE, gen)
    glwe_sk = encryption.generate_glwe_sk(GLWE, gen)
    bsk = encryption.generate_bsk(lwe_sk, glwe_sk, GLWE, P.pbs_radix, gen)
    ak = encryption.generate_automorphism_keys(glwe_sk, GLWE, P.tr_radix, gen)
    ssk = encryption.generate_scheme_switch_key(glwe_sk, GLWE, P.ss_radix, gen)
    ksk = encryption.generate_lwe_keyswitch_key(glwe_sk.reshape(-1), lwe_sk, LWE, P.ks_radix, gen)
    g01 = encryption.encrypt_ggsw_scalar(torch.tensor([0, 1]), glwe_sk, GLWE, P.cbs_radix, gen)
    key = U32ComputeKey.from_coeff(bsk, ak, ssk, ksk, g01[0], g01[1], device="cpu")
    return dict(sk=glwe_sk.numpy().astype(np.uint64), wm=wm.WaveMachine(key, P),
                rng=np.random.default_rng(11))


def test_trivial_one_is_the_wave_machines_slot_one(machine):
    """`U32HostEvaluation`'s trivial bits are the bit patterns of the wave
    machine's constant slots (0 and 1), so a folded constant and a resolved
    trivial bit are the same ciphertext."""
    g = FheCircuit()
    for name, op in (("one", FheOp.ONE_GLWE1), ("zero", FheOp.ZERO_GLWE1)):
        o = g.add_node(FheOp.OUTPUT_GLWE1, name)
        g.add_edge(g.add_node(op), o, FheEdge.UNARY)
    out = machine["wm"].run(g, {})
    enc = U32HostEvaluation(P).enc
    np.testing.assert_array_equal(out["one"], enc.trivial_glwe_l1_one())
    np.testing.assert_array_equal(out["zero"], enc.trivial_glwe_l1_zero())
    assert int(enc.trivial_glwe_l1_one()[-1, 0]) == 1 << 63


@pytest.mark.parametrize("name", ["encrypted_add", "cmux_and_compare", "mixed_plain_encrypted",
                                  "dbg_two_flushes", "budget_flushes"])
def test_program_decrypts_on_wave_machine(machine, name):
    prog, m = PROGRAMS[name], machine
    sk = m["sk"]
    mem = memory.Memory()
    entry = mem.allocate_program(prog.build(isa.Asm()).instrs)
    b = args.ArgsBuilder()
    for _, v, w in prog.args:
        b = b.arg_encrypted(hc.encrypt_uint_bits_np(m["rng"], v, w, sk, GLWE))
    call = b.return_value(*prog.ret).build()
    seen = []
    if prog.budget is None and prog.dbg is None:
        # through the one-call runner, as a user would
        mem.function_entries[name] = entry
        mem, rp, proc = run_program(U32HostEvaluation(P), mem, name, call, executor=m["wm"])
    else:
        proc = processor.FheComputer(U32HostEvaluation(P), executor=m["wm"])
        if prog.budget is not None:
            proc.FLUSH_NODE_BUDGET = prog.budget
        proc.debug_handlers[7] = lambda v: seen.append(
            hc.decrypt_uint_bits_np(list(v.bits), sk, GLWE))
        rp = proc.run_program(entry, mem, call)
    got = 0
    for i in range(prog.ret[0] // 8):
        byte = mem.load_byte(rp + i)
        assert isinstance(byte, memory.EncByte)
        got |= hc.decrypt_uint_bits_np(list(byte.bits), sk, GLWE) << (8 * i)
    assert got == prog.value
    assert proc.flush_count == prog.flushes
    assert seen == ([prog.dbg] if prog.dbg is not None else [])


# --- (d) the ELF32 loader --------------------------------------------------------

VADDR = 0x10000


def _elf(magic=b"\x7fELF", ei_class=1, abi=memory.SUPPORTED_ABI_VERSION):
    """An ELF32 little-endian file: one PT_LOAD segment (the encrypted-add
    program, memsz past filesz), a symtab with one FUNC and one OBJECT
    symbol, its strtab."""
    code = b"".join(isa.encode(i).to_bytes(8, "little") for i in PROGRAMS["encrypted_add"].build(
        isa.Asm()).instrs)
    strtab = b"\x00add\x00table\x00"
    symtab = (bytes(16) + struct.pack("<IIIBBH", 1, VADDR, len(code), 0x12, 0, 1)
              + struct.pack("<IIIBBH", 5, VADDR + 0x2000, 4, 0x11, 0, 1))
    ph_off, code_off = 52, 52 + 32
    str_off = code_off + len(code)
    sym_off = str_off + len(strtab)
    sh_off = sym_off + len(symtab)
    ident = magic + bytes([ei_class, 1, 1, 0, abi]) + bytes(7)
    header = ident + struct.pack("<HHIIIIIHHHHHH", 2, memory.PARASOL_MACHINE, 1, VADDR, ph_off,
                                 sh_off, 0, 52, 32, 1, 40, 3, 0)
    phdr = struct.pack("<IIIIIIII", 1, code_off, VADDR, VADDR, len(code), 0x3000, 5, 0x1000)
    shdrs = (bytes(40)
             + struct.pack("<IIIIIIIIII", 0, 2, 0, 0, sym_off, len(symtab), 2, 1, 4, 16)
             + struct.pack("<IIIIIIIIII", 0, 3, 0, 0, str_off, len(strtab), 0, 0, 1, 0))
    return header + phdr + code + strtab + symtab + shdrs, code


def test_elf_loads_alike():
    data, code = _elf()
    got, want = memory.Memory.new_from_elf(data), j_memory.Memory.new_from_elf(data)
    assert got.function_entries == want.function_entries == {"add": VADDR}
    assert got.pages == want.pages and got._brk == want._brk == VADDR + 0x3000
    assert bytes(got.load_bytes(VADDR, len(code), align_check=False)) == code
    word = got.try_load_plaintext_dword(got.get_function_entry("add"))
    assert isa.decode(word).name == "Load"


@pytest.mark.parametrize("bad", [dict(magic=b"\x7fELG"), dict(ei_class=2), dict(abi=2)],
                         ids=["magic", "class", "abi_version"])
def test_elf_rejects_alike(bad):
    data, _ = _elf(**bad)
    with pytest.raises(memory.MemoryError_) as got:
        memory.Memory.new_from_elf(data)
    with pytest.raises(j_memory.MemoryError_) as want:
        j_memory.Memory.new_from_elf(data)
    assert str(got.value) == str(want.value)
