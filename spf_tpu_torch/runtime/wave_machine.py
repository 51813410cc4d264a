"""Wave-machine executor: index-driven FheCircuit execution from slot
buffers.

Port of `spf_tpu/runtime/wave_machine.py` on int64 wires:

1. **Slot buffers.** All live wires of a kind (glwe / lwe1 / lwe0 / ggsw)
   live in ONE device tensor per kind, S slots from linear-scan slot
   allocation (S a power of two), plus one scratch slot at index S that
   no wave reads: padded lanes write there (the reference's out-of-bounds
   scatter with `mode="drop"`). Gates address operands by slot index; a
   wave gathers its operands, computes and scatters its results.
2. **Greedy op-batched scheduling** (`build_schedule`, a copy of the
   reference's): every non-CBS op runs as soon as it is ready, and
   CIRCUIT_BOOTSTRAP gates wait until nothing else can proceed, so CBS
   waves batch every conversion that accumulated; extract -> keyswitch ->
   CBS chains contract into one "convert" wave, and with the external
   product of the ONE constant after them into one "refresh" wave.
3. **Runs of CMux waves.** Runs of 8 equal-width CMux waves are stacked
   (`cmux_scan`); the reference runs each as one `lax.scan`, here a loop
   over the stacked waves in order, each reading what the one before it
   wrote.
4. **Spans and counters.** A run is one `wm.run` span; each stretch of
   consecutive waves of one kind is one span (`wm.cmux`: single and
   stacked CMux waves; `wm.convert`, `wm.refresh`, `wm.cbs`; `wm.other`:
   external products, adds, NOTs, monomial products, extractions and
   keyswitches), opened once a stretch and not once a wave. Each run adds
   the schedule's counts to the `wm.*` counters (`schedule_counts`),
   read from the schedule on the host, never from the device.
5. **Replayed stretches on a card.** The first run of a schedule on a
   CUDA device runs eagerly: it loads every kernel and fills every cache
   the waves read. The second captures each stretch into a CUDA graph
   over buffers kept with the schedule (one memory pool for all of them,
   replayed in the order they were captured), and that run and every later
   one zeroes the buffers, scatters the inputs, replays the stretches
   (each in its span, so a span clock times its graph) and gathers the
   outputs. A run then costs the host one launch a stretch in place of a
   few hundred thousand operators, the same kernels on the same operands
   (a circuit run once keeps the eager path). Host-side counters inside
   the waves (`cbs.*`, the kernels' launch counts) and the `cbs.*` spans
   count the capture, not the replays.

Layouts. GLWE and LWE buffers are batch-last, int64 [k+1, N, S+1] and
[n+1, S+1]: the port's ops take [k+1, N, B], so a gather along the last
axis (`index_select`) yields an operand as it is consumed and a scatter
(`index_copy_`) writes a result as it is produced, one pass each; a
slot-major buffer would add a transpose to each. The GGSW buffer is
slot-major, 4 f32 planes [S+1, k+1, l_cbs, k+1, K]: a CMux or external
product reads each lane's row in place through the kernel of
`freq_mad_batched`, so no row is ever gathered (a 256-lane wave's rows
would be 67 MB at DEFAULT_128); a CBS wave's output, [k+1, l, k+1, K, W],
is moved to slot-major as it is scattered. Slot 1 of the GLWE buffer is
the trivial ONE (slot 0 the zero), slots 0 and 1 of the GGSW buffer the
key's GGSW(0) and GGSW(1) where a circuit uses them.

Correctness is the per-wave executor's (`executor_u32`): the same ops on
the same operands; only operand routing differs. (≙ reference scheduler
`circuit_processor/mod.rs:62-656`.)
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc

import numpy as np
import torch

from ..ops import torus
from ..ops.bootstrap import cmux, external_product, inv_limb, sample_extract
from ..ops.cbs import circuit_bootstrap
from ..ops.keyswitch import keyswitch_lwe
from ..ops.mux_eval_u32 import trivial_bit_glwe
from ..params import GlweDef, Params
from ..utils.profiling import metrics, span
from .executor_u32 import U32ComputeKey, not_glwe, wave_stats
from .fhe_circuit import CircuitError, FheCircuit, FheEdge, FheOp

# wire kinds (buffer families)
_GLWE, _LWE1, _LWE0, _GGSW = "glwe", "lwe1", "lwe0", "ggsw"

_KIND_OF_OP = {
    FheOp.INPUT_GLWE1: _GLWE,
    FheOp.INPUT_LWE1: _LWE1,
    FheOp.INPUT_LWE0: _LWE0,
    FheOp.ZERO_GLWE1: _GLWE,
    FheOp.ONE_GLWE1: _GLWE,
    FheOp.ZERO_GGSW1: _GGSW,
    FheOp.ONE_GGSW1: _GGSW,
    FheOp.NOT: _GLWE,
    FheOp.GLWE_ADD: _GLWE,
    FheOp.CMUX: _GLWE,
    FheOp.MULTIPLY_GGSW_GLWE: _GLWE,
    FheOp.MUL_XN: _GLWE,
    FheOp.SAMPLE_EXTRACT: _LWE1,
    FheOp.KEYSWITCH_L1_L0: _LWE0,
    FheOp.CIRCUIT_BOOTSTRAP: _GGSW,
}

# compute-op wave groups; canonical lane widths per group (ascending;
# waves chunk at the last entry), the reference's: the TPU kept its set of
# compiled executables tiny with them, and the port keeps them so that its
# schedules equal the reference's. "convert" (extract->ks->cbs) and
# "refresh" (convert->extprod(ONE)) are synthetic fused chains produced by
# the scheduler's contraction pass; they keep conversion traffic from
# splitting runs of CMux waves.
_WIDTHS = {
    "cmux": (64, 256),
    "extprod": (64, 256),
    "cbs": (32, 256),
    "convert": (32, 256),
    "refresh": (32, 256),
    "extract": (256,),
    "ks": (256,),
    "add": (256,),
    "not": (256,),
    "mulxn": (256,),
}

_GROUP_OF_OP = {
    FheOp.CMUX: "cmux",
    FheOp.MULTIPLY_GGSW_GLWE: "extprod",
    FheOp.CIRCUIT_BOOTSTRAP: "cbs",
    FheOp.SAMPLE_EXTRACT: "extract",
    FheOp.KEYSWITCH_L1_L0: "ks",
    FheOp.GLWE_ADD: "add",
    FheOp.NOT: "not",
    FheOp.MUL_XN: "mulxn",
}

# groups deferred until nothing else is ready (maximizes their batch);
# all three contain a full circuit bootstrap
_DEFERRED = ("cbs", "convert", "refresh")

# output buffer kind per wave group
_OUT_KIND = {
    "cmux": _GLWE, "extprod": _GLWE, "add": _GLWE, "not": _GLWE,
    "mulxn": _GLWE, "extract": _LWE1, "ks": _LWE0, "cbs": _GGSW,
    "convert": _GGSW, "refresh": _GLWE,
}

# chunk length of runs of equal-width cmux waves (one `lax.scan` each on
# the TPU, one loop here)
_SCAN_R = 8


def _canon_w(group: str, g: int) -> int:
    for w in _WIDTHS[group]:
        if g <= w:
            return w
    return _WIDTHS[group][-1]


@dataclasses.dataclass
class Wave:
    group: str
    width: int  # padded lane width
    gates: int  # real gate count
    # per-role int32 operand index arrays [width] (padded entries:
    # gather index 0 / scatter index S, the scratch slot past the live ones)
    idx: dict


@dataclasses.dataclass
class Schedule:
    waves: list  # list[Wave] after scan-chunking; scan entries are
    # ("scan", group, width, stacked idx dict of [R, width])
    slot_counts: dict  # kind -> S (pow2)
    inputs: dict  # kind -> (names list, np slot idx [padded pow2])
    outputs: list  # (param, kind, slot)
    wave_log: list  # (group, gates) for observability
    uses_ggsw_consts: bool = False  # ZERO_GGSW1/ONE_GGSW1 present


@contextlib.contextmanager
def _gc_paused():
    """The cyclic garbage collector off within the block: code that keeps
    every small object it allocates until it returns would make each
    collection walk its whole growing heap again (a third of the schedule
    build of 5 x 10^5 nodes)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def build_schedule(circuit: FheCircuit, collect_outputs: bool = True) -> Schedule:
    """Compile an FheCircuit into a wave schedule (host-only; cached by
    circuit structure in `WaveMachine`). A copy of the reference's
    `build_schedule`: the same waves, groups, widths, index arrays and
    slot counts."""
    with _gc_paused():
        return _build_schedule(circuit)


def _build_schedule(circuit: FheCircuit) -> Schedule:
    circuit.validate()
    n = len(circuit.nodes)
    ops: list = [nd.op for nd in circuit.nodes]
    params_l: list = [nd.param for nd in circuit.nodes]
    edges: list = list(circuit.edges)

    # --- conversion-chain contraction (peephole) ---
    # extract(h=0) -> keyswitch -> cbs, each intermediate single-use,
    # collapses to one synthetic "convert" node (glwe -> ggsw); if the
    # cbs feeds exactly one extprod whose GLWE operand is the ONE
    # constant (the mid-tree recryption pattern emitted by
    # `fhe_circuit.insert_mux_circuit`), the whole chain collapses to
    # "refresh" (glwe -> glwe).
    epreds: dict[int, list] = {}
    esuccs: dict[int, list] = {}
    ncons = [0] * n
    for ei, (s, d, r) in enumerate(edges):
        epreds.setdefault(d, []).append((ei, s, r))
        esuccs.setdefault(s, []).append((ei, d, r))
        ncons[s] += 1
    dead_edges: set[int] = set()
    new_edges: list = []
    for c in range(n):
        if ops[c] is not FheOp.CIRCUIT_BOOTSTRAP:
            continue
        pc = epreds.get(c, [])
        if len(pc) != 1:
            continue
        ei_ks, ksn, _ = pc[0]
        if ops[ksn] is not FheOp.KEYSWITCH_L1_L0 or ncons[ksn] != 1:
            continue
        pk = epreds.get(ksn, [])
        if len(pk) != 1:
            continue
        ei_ex, exn, _ = pk[0]
        if (
            ops[exn] is not FheOp.SAMPLE_EXTRACT
            or ncons[exn] != 1
            or (params_l[exn] or 0) != 0
        ):
            continue
        pe = epreds.get(exn, [])
        if len(pe) != 1:
            continue
        ei_src, srcn, _ = pe[0]
        ops[ksn] = ops[exn] = None
        dead_edges.update((ei_ks, ei_ex, ei_src))
        target, top = c, "convert"
        cons_c = esuccs.get(c, [])
        if len(cons_c) == 1:
            ei_ce, e, r_ce = cons_c[0]
            if ops[e] is FheOp.MULTIPLY_GGSW_GLWE and r_ce == FheEdge.GGSW:
                pe2 = epreds.get(e, [])
                glwe_in = [x for x in pe2 if x[2] == FheEdge.GLWE]
                if (
                    len(pe2) == 2
                    and glwe_in
                    and ops[glwe_in[0][1]] is FheOp.ONE_GLWE1
                ):
                    ops[c] = None
                    dead_edges.update((ei_ce, glwe_in[0][0]))
                    target, top = e, "refresh"
        ops[target] = top
        new_edges.append((srcn, target, FheEdge.UNARY))
    if dead_edges or new_edges:
        edges = [
            e for ei, e in enumerate(edges) if ei not in dead_edges
        ] + new_edges

    preds: dict[int, list] = {}
    rc = [0] * n
    succs: dict[int, list[int]] = {}
    indeg = [0] * n
    for s, d, r in edges:
        preds.setdefault(d, []).append((s, r))
        succs.setdefault(s, []).append(d)
        rc[s] += 1
        indeg[d] += 1

    # alias resolution (RETIRE/NOP forward their single input)
    alias: dict[int, int] = {}

    def resolve(i: int) -> int:
        while i in alias:
            i = alias[i]
        return i

    # slot allocation state
    slot: dict[int, int] = {}
    peak = {k: 0 for k in (_GLWE, _LWE1, _LWE0, _GGSW)}
    nslots = {k: 0 for k in (_GLWE, _LWE1, _LWE0, _GGSW)}
    free: dict[str, list[int]] = {k: [] for k in (_GLWE, _LWE1, _LWE0, _GGSW)}
    # reserve const slots 0/1 for glwe + ggsw (zero/one), never freed
    for k in (_GLWE, _GGSW):
        nslots[k] = peak[k] = 2

    def alloc(kind: str) -> int:
        if free[kind]:
            return free[kind].pop()
        s = nslots[kind]
        nslots[kind] += 1
        peak[kind] = max(peak[kind], nslots[kind])
        return s

    def release(node: int):
        """Drop one reference to `node`'s value; free its slot at 0."""
        node = resolve(node)
        rc[node] -= 1
        if rc[node] == 0 and node in slot and not protected[node]:
            free[_kind_of[node]].append(slot[node])

    # node kind + const/INPUT classification
    _kind_of: dict[int, str] = {}
    protected = [False] * n  # const slots / outputs never freed
    in_names: dict[str, list] = {k: [] for k in (_GLWE, _LWE1, _LWE0)}
    in_slots: dict[str, list] = {k: [] for k in (_GLWE, _LWE1, _LWE0)}
    outputs: list = []
    ready_init: list[int] = []

    n_dead = 0
    for i in range(n):
        op = ops[i]
        if op is None:  # contracted away
            n_dead += 1
            continue
        if isinstance(op, str):  # synthetic convert/refresh
            continue
        if op in (
            FheOp.INPUT_GGSW1, FheOp.INPUT_GLEV1, FheOp.GLEV_CMUX,
            FheOp.SCHEME_SWITCH, FheOp.ZERO_GLEV1, FheOp.ONE_GLEV1,
            FheOp.ZERO_LWE0, FheOp.ONE_LWE0, FheOp.OUTPUT_GGSW1,
            FheOp.OUTPUT_GLEV1,
        ):
            raise CircuitError(
                f"{op} not supported on the u32 wave machine (GLEV-mode"
                " ops run on the u64 CircuitExecutor)"
            )
        kind = _KIND_OF_OP.get(op)
        if kind is not None:
            _kind_of[i] = kind
        if op in (FheOp.ZERO_GLWE1, FheOp.ZERO_GGSW1):
            slot[i] = 0
            protected[i] = True
            ready_init.append(i)
        elif op in (FheOp.ONE_GLWE1, FheOp.ONE_GGSW1):
            slot[i] = 1
            protected[i] = True
            ready_init.append(i)
        elif op.value.startswith("input_"):
            s = alloc(kind)
            slot[i] = s
            protected[i] = True  # inputs are cheap to keep; never reuse
            in_names[kind].append(params_l[i])
            in_slots[kind].append(s)
            ready_init.append(i)
        elif op in (FheOp.RETIRE, FheOp.NOP) and i not in preds:
            ready_init.append(i)  # input-less retire/nop: no-op

    # scheduling: completed set -> ready groups -> emit waves
    done = [False] * n
    ready: dict[str, list[int]] = {g: [] for g in _WIDTHS}
    waves: list[Wave] = []
    wave_log: list = []
    n_done = 0

    def complete(i: int):
        nonlocal n_done
        stack = [i]
        while stack:
            cur = stack.pop()
            if done[cur]:
                continue
            done[cur] = True
            n_done += 1
            for nxt in succs.get(cur, []):
                indeg[nxt] -= 1
                if indeg[nxt] == 0:
                    opn = ops[nxt]
                    if opn in (FheOp.RETIRE, FheOp.NOP):
                        ins = preds.get(nxt, [])
                        if ins:
                            src = resolve(ins[0][0])
                            alias[nxt] = src
                            # transfer the alias's consumers onto the
                            # source (and consume the alias's own input
                            # edge): release() resolves through the
                            # alias, so rc must live on the source
                            rc[src] += rc[nxt] - 1
                        stack.append(nxt)
                    elif isinstance(opn, str):  # convert / refresh
                        ready[opn].append(nxt)
                    elif opn.value.startswith("output_"):
                        src = resolve(preds[nxt][0][0])
                        protected[src] = True
                        outputs.append(
                            (params_l[nxt], _kind_of[src], slot[src])
                        )
                        stack.append(nxt)
                    else:
                        ready[_GROUP_OF_OP[opn]].append(nxt)

    def emit(group: str, nids: list[int]):
        """One wave of `group` over `nids` (width already <= cap)."""
        g = len(nids)
        wp = _canon_w(group, g)
        idx: dict[str, np.ndarray] = {}
        roles = {
            "cmux": ((FheEdge.LOW, "lo"), (FheEdge.HIGH, "hi"),
                     (FheEdge.SEL, "sel")),
            "extprod": ((FheEdge.GLWE, "lo"), (FheEdge.GGSW, "sel")),
            "add": ((FheEdge.LEFT, "lo"), (FheEdge.RIGHT, "hi")),
            "cbs": ((FheEdge.UNARY, "in"),),
            "ks": ((FheEdge.UNARY, "in"),),
            "extract": ((FheEdge.UNARY, "in"),),
            "not": ((FheEdge.UNARY, "in"),),
            "mulxn": ((FheEdge.UNARY, "in"),),
            "convert": ((FheEdge.UNARY, "in"),),
            "refresh": ((FheEdge.UNARY, "in"),),
        }[group]
        for role, key in roles:
            arr = np.zeros((wp,), dtype=np.int32)
            for j, nid in enumerate(nids):
                src = resolve(_role(preds[nid], role))
                arr[j] = slot[src]
            idx[key] = arr
        if group == "extract":
            idx["h"] = np.asarray(
                [params_l[nid] or 0 for nid in nids]
                + [0] * (wp - g), dtype=np.int32,
            )
        if group == "mulxn":
            idx["t"] = np.asarray(
                [params_l[nid] or 0 for nid in nids]
                + [0] * (wp - g), dtype=np.uint32,
            )
        # consume input refs (may free slots), then allocate outputs
        for nid in nids:
            for src, _ in preds[nid]:
                release(src)
        okind = _OUT_KIND[group]
        out = np.full((wp,), -1, dtype=np.int32)
        for j, nid in enumerate(nids):
            s = alloc(okind)
            slot[nid] = s
            _kind_of[nid] = okind
            out[j] = s
        idx["out"] = out
        waves.append(Wave(group, wp, g, idx))
        wave_log.append((group, g))
        for nid in nids:
            complete(nid)

    for i in ready_init:
        complete(i)
    # priority order: cmux first and RESTART after each emission, so
    # consecutive cmux waves form long runs (scan fusion needs
    # consecutive equal-width waves); CBS-class groups are deferred
    # until nothing else is ready, maximizing their batch. EXCEPT:
    # when the cmux frontier is NARROW and plenty of conversions are
    # pending, run the conversions first — their completion unlocks
    # whole subtrees at once, merging the narrow post-refresh frontiers
    # into wider waves (mul-class circuits fragment into per-tree
    # frontiers across refresh boundaries otherwise).
    _PRIORITY = [g for g in _WIDTHS if g not in _DEFERRED]

    def emit_deferred() -> bool:
        pending = [g for g in _DEFERRED if ready[g]]
        if not pending:
            return False
        group = max(pending, key=lambda g: len(ready[g]))
        nids, ready[group] = ready[group], []
        cap = _WIDTHS[group][-1]
        for c in range(0, len(nids), cap):
            emit(group, nids[c : c + cap])
        return True

    while True:
        if (
            0 < len(ready["cmux"]) < 64
            and sum(len(ready[g]) for g in _DEFERRED) >= 32
        ):
            emit_deferred()
            continue
        for group in _PRIORITY:
            if ready[group]:
                nids, ready[group] = ready[group], []
                cap = _WIDTHS[group][-1]
                for c in range(0, len(nids), cap):
                    emit(group, nids[c : c + cap])
                break
        else:
            if not emit_deferred():
                break

    if n_done != n - n_dead:
        raise CircuitError(
            f"circuit contains a cycle or unreachable nodes "
            f"({n - n_dead - n_done} unscheduled)"
        )

    slot_counts = {
        k: 1 << max(0, (peak[k] - 1)).bit_length() if peak[k] else 0
        for k in peak
    }
    # padded scatter indices = S (the scratch slot)
    for w in waves:
        w.idx["out"][w.idx["out"] < 0] = slot_counts[_OUT_KIND[w.group]]

    # chunk runs of equal-width cmux waves
    fused: list = []
    i = 0
    while i < len(waves):
        w = waves[i]
        if w.group == "cmux":
            run = [w]
            while (
                len(run) < _SCAN_R
                and i + len(run) < len(waves)
                and waves[i + len(run)].group == "cmux"
                and waves[i + len(run)].width == w.width
            ):
                run.append(waves[i + len(run)])
            if len(run) == _SCAN_R:
                stacked = {
                    k: np.stack([r.idx[k] for r in run])
                    for k in ("lo", "hi", "sel", "out")
                }
                fused.append(
                    Wave("cmux_scan", w.width,
                         sum(r.gates for r in run), stacked)
                )
                i += len(run)
                continue
        fused.append(w)
        i += 1

    ins = {}
    for kind in in_names:
        names = in_names[kind]
        if not names:
            continue
        npad = 1 << max(0, (len(names) - 1).bit_length())
        sl = np.full((npad,), slot_counts[kind], dtype=np.int32)
        sl[: len(names)] = in_slots[kind]
        ins[kind] = (names, sl)

    uses_ggsw_consts = any(
        n.op in (FheOp.ZERO_GGSW1, FheOp.ONE_GGSW1) for n in circuit.nodes
    )
    return Schedule(
        fused, slot_counts, ins, outputs, wave_log, uses_ggsw_consts
    )


def _role(ins, role):
    for src, r in ins:
        if r == role:
            return src
    raise CircuitError(f"missing {role} input")


def sample_extract_dyn(x: torch.Tensor, h: torch.Tensor, glwe: GlweDef) -> torch.Tensor:
    """Batched sample extract with a coefficient index per lane: GLWE
    int64 [k+1, N, W], h int64 [W] in [0, N) -> LWE int64 [k*N+1, W]
    (≙ `wave_machine.sample_extract_dyn_u32`, the dynamic-h form of
    `bootstrap.sample_extract`, so one call serves every extraction index)."""
    n = glwe.degree
    j = torch.arange(n, device=x.device)[:, None]  # [N, 1]
    idx = torch.remainder(h[None, :] - j, n)  # [N, W]
    neg = j > h[None, :]  # [N, W]
    a = x[:-1]  # [k, N, W]
    ga = torch.gather(a, 1, idx[None].expand(a.shape))
    ga = torch.where(neg, -ga, ga)
    b = torch.gather(x[-1], 0, h[None, :])  # [1, W]
    return torch.cat([ga.reshape(glwe.size * n, -1), b], dim=0)


# the wave groups: each gathers its operands from the buffers, computes with
# the port's ops and scatters its results into its output buffer (in place)


def _cbs_out(ggsw, out, buf):
    """Scatter CBS outputs, 4 planes [k+1, l, k+1, K, W], into the
    slot-major GGSW buffer."""
    for b, o in zip(buf, ggsw):
        b.index_copy_(0, out, o.movedim(-1, 0))


def _convert_in(x, key: U32ComputeKey, p: Params):
    """extract(0) -> LWE keyswitch -> CBS of GLWE bits [k+1, N, W]."""
    glwe = p.l1_params
    l1 = sample_extract(x, 0, glwe)
    l0 = keyswitch_lwe(l1, key.ksk_planes, glwe.as_lwe_def(), p.l0_params, p.ks_radix)
    return circuit_bootstrap(l0, key.bsk_freq, key.ak_freq, key.ssk_freq, p)


def cmux_wave(bufs, ix, key, p):
    g = bufs[_GLWE]
    d0, d1 = g.index_select(-1, ix["lo"]), g.index_select(-1, ix["hi"])
    g.index_copy_(-1, ix["out"], cmux(d0, d1, bufs[_GGSW], p.cbs_radix, ix["sel"], slot_axis=0))


def cmux_scan_wave(bufs, ix, key, p):
    for r in range(ix["out"].shape[0]):
        cmux_wave(bufs, {k: v[r] for k, v in ix.items()}, key, p)


def extprod_wave(bufs, ix, key, p):
    g = bufs[_GLWE]
    x = g.index_select(-1, ix["lo"])
    g.index_copy_(-1, ix["out"], inv_limb(external_product(x, bufs[_GGSW], p.cbs_radix, ix["sel"],
                                                           slot_axis=0)))


def add_wave(bufs, ix, key, p):
    g = bufs[_GLWE]
    g.index_copy_(-1, ix["out"], torus.add(g.index_select(-1, ix["lo"]),
                                           g.index_select(-1, ix["hi"])))


def not_wave(bufs, ix, key, p):
    g = bufs[_GLWE]
    g.index_copy_(-1, ix["out"], not_glwe(g.index_select(-1, ix["in"])))


def mulxn_wave(bufs, ix, key, p):
    g = bufs[_GLWE]
    g.index_copy_(-1, ix["out"], torus.monomial_mul(g.index_select(-1, ix["in"]), ix["t"]))


def extract_wave(bufs, ix, key, p):
    x = bufs[_GLWE].index_select(-1, ix["in"])
    bufs[_LWE1].index_copy_(-1, ix["out"], sample_extract_dyn(x, ix["h"], p.l1_params))


def ks_wave(bufs, ix, key, p):
    x = bufs[_LWE1].index_select(-1, ix["in"])
    out = keyswitch_lwe(x, key.ksk_planes, p.l1_params.as_lwe_def(), p.l0_params, p.ks_radix)
    bufs[_LWE0].index_copy_(-1, ix["out"], out)


def cbs_wave(bufs, ix, key, p):
    x = bufs[_LWE0].index_select(-1, ix["in"])
    _cbs_out(circuit_bootstrap(x, key.bsk_freq, key.ak_freq, key.ssk_freq, p), ix["out"],
             bufs[_GGSW])


def convert_wave(bufs, ix, key, p):
    x = bufs[_GLWE].index_select(-1, ix["in"])
    _cbs_out(_convert_in(x, key, p), ix["out"], bufs[_GGSW])


def refresh_wave(bufs, ix, key, p):
    """Wire recryption: extract -> keyswitch -> CBS -> external product of
    the trivial ONE with each lane's fresh GGSW (the mid-tree refresh)."""
    g = bufs[_GLWE]
    x = g.index_select(-1, ix["in"])
    one = trivial_bit_glwe(1, p.l1_params, x.shape[-1], x.device)
    g.index_copy_(-1, ix["out"], inv_limb(external_product(one, _convert_in(x, key, p),
                                                           p.cbs_radix)))


WAVES = {
    "cmux": cmux_wave, "cmux_scan": cmux_scan_wave, "extprod": extprod_wave, "add": add_wave,
    "not": not_wave, "mulxn": mulxn_wave, "extract": extract_wave, "ks": ks_wave,
    "cbs": cbs_wave, "convert": convert_wave, "refresh": refresh_wave,
}


# the span of each wave group's stretches (every other group: "wm.other")
_SPAN_OF_GROUP = {"cmux": "wm.cmux", "cmux_scan": "wm.cmux", "convert": "wm.convert",
                  "refresh": "wm.refresh", "cbs": "wm.cbs"}


def schedule_counts(sched: Schedule) -> dict:
    """What one run of `sched` adds to the `wm.*` counters: `wm.calls` 1;
    `wm.waves`, a stacked CMux run counted as its stacked waves;
    `wm.lanes`, their padded widths; `wm.gates`, their real gates;
    `wm.cbs_gates`, the real gates of the waves that run a circuit
    bootstrap (convert, refresh, cbs)."""
    waves = lanes = gates = cbs_gates = 0
    for w in sched.waves:
        r = w.idx["out"].shape[0] if w.group == "cmux_scan" else 1
        waves += r
        lanes += r * w.width
        gates += w.gates
        if w.group in _DEFERRED:
            cbs_gates += w.gates
    return {"wm.calls": 1, "wm.waves": waves, "wm.lanes": lanes, "wm.gates": gates,
            "wm.cbs_gates": cbs_gates}


def span_runs(sched: Schedule, waves: list) -> list:
    """The schedule's waves, each with its device index arrays `waves`, cut
    into stretches of one span: [(span name, [(wave function, indices)])]."""
    runs: list = []
    for w, ix in zip(sched.waves, waves):
        name = _SPAN_OF_GROUP.get(w.group, "wm.other")
        if not runs or runs[-1][0] != name:
            runs.append((name, []))
        runs[-1][1].append((WAVES[w.group], ix))
    return runs


@dataclasses.dataclass
class Compiled:
    """A schedule as `WaveMachine.run` uses it: its index arrays on the
    device, cut into span stretches, and the counts a run adds; on a card,
    after its first run, its buffers and one CUDA graph a stretch."""
    schedule: Schedule
    runs: list
    counts: dict
    ran: bool = False  # an eager run has loaded every kernel and cache
    bufs: dict | None = None
    graphs: list | None = None


def device_indices(idx: dict, device) -> dict:
    """A wave's index arrays on the device: int64 (gathers, scatters,
    extraction indices, monomial powers), the CMux selects int32 (the slot
    indices of `freq_mad_batched`)."""
    return {k: torch.from_numpy(np.asarray(v).astype(np.int32 if k == "sel" else np.int64)).to(device)
            for k, v in idx.items()}


class WaveMachine:
    """Executes wave schedules against slot buffers on the key's device.

    Drop-in `run(circuit, inputs) -> outputs` backend for
    `U32CircuitExecutor` / `FheComputer` (inputs and outputs: host numpy
    u64 arrays, GLWE [k+1, N] / LWE [n+1]). The reference's `use_pallas`
    picks between its two FFT orders; the port has one (the key's spectra
    and every wave's come from the same FFT), so it has no such switch."""

    def __init__(self, key: U32ComputeKey, params: Params):
        self.key = key
        self.params = params
        self.device = key.device
        self._schedules: dict = {}
        self.wave_log: list = []

    # -- public API ----------------------------------------------------

    def run(self, circuit: FheCircuit, inputs: dict) -> dict:
        c = self._compiled(circuit)
        self.wave_log.extend(c.schedule.wave_log)
        for name, n in c.counts.items():
            metrics.inc(name, n)
        with span("wm.run"):
            if c.graphs is None and c.ran and self.device.type == "cuda":
                self._capture(c)
            if c.graphs is None:
                bufs = self._new_buffers(c.schedule)
                self._scatter_inputs(c.schedule, bufs, inputs)
                for name, waves in c.runs:
                    with span(name):
                        for fn, ix in waves:
                            fn(bufs, ix, self.key, self.params)
                c.ran = True
            else:
                bufs = c.bufs
                self._reset_buffers(c.schedule, bufs)
                self._scatter_inputs(c.schedule, bufs, inputs)
                for (name, _), graph in zip(c.runs, c.graphs):
                    with span(name):
                        graph.replay()
            return self._gather_outputs(c.schedule, bufs)

    def wave_stats(self) -> dict:
        return wave_stats(self.wave_log)

    def schedule(self, circuit: FheCircuit) -> Schedule:
        """The schedule `run` uses for `circuit` (built once per circuit
        structure)."""
        return self._compiled(circuit).schedule

    # -- schedule cache -------------------------------------------------

    def _compiled(self, circuit: FheCircuit) -> Compiled:
        """The circuit's schedule with its index arrays on the device, built
        and uploaded once per circuit structure, found by the circuit's
        memoised `structure_key` (no walk over the graph on a later run)."""
        ck = circuit.structure_key()
        c = self._schedules.get(ck)
        if c is None:
            sched = build_schedule(circuit)
            waves = [device_indices(w.idx, self.device) for w in sched.waves]
            c = Compiled(sched, span_runs(sched, waves), schedule_counts(sched))
            self._schedules[ck] = c
            metrics.inc("wavemachine.schedules")
        return c

    def _capture(self, c: Compiled) -> None:
        """Capture each stretch of `c`'s waves into a CUDA graph over
        buffers of its own, all in one memory pool: every value that
        crosses stretches lives in the buffers, so a stretch's temporaries
        are free again when the next one is captured, and the graphs
        replay in their capture order."""
        bufs = self._new_buffers(c.schedule)
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        graphs = []
        with torch.cuda.stream(stream):
            for _, waves in c.runs:
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=pool)
                try:
                    for fn, ix in waves:
                        fn(bufs, ix, self.key, self.params)
                finally:
                    graph.capture_end()
                graphs.append(graph)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        c.bufs, c.graphs = bufs, graphs

    # -- buffers ---------------------------------------------------------

    def shapes(self) -> dict:
        """The shape of one wire of each kind (its slot axis left out)."""
        p = self.params
        glwe = p.l1_params
        kp1, n = glwe.size + 1, glwe.degree
        return {
            _GLWE: (kp1, n),
            _LWE1: (glwe.size * n + 1,),
            _LWE0: (p.l0_params.dim + 1,),
            _GGSW: (kp1, p.cbs_radix.count, kp1, n // 2),
        }

    def _new_buffers(self, sched: Schedule) -> dict:
        """Buffers of S + 1 slots a kind (None for an unused kind), zeroed
        but for the constants in slots 0 and 1."""
        shapes = self.shapes()
        bufs = {}
        for kind, s in sched.slot_counts.items():
            if s == 0:
                bufs[kind] = None
            elif kind == _GGSW:
                bufs[kind] = tuple(torch.zeros((s + 1, *shapes[kind]), dtype=torch.float32,
                                               device=self.device) for _ in range(4))
            else:
                bufs[kind] = torch.zeros((*shapes[kind], s + 1), dtype=torch.int64,
                                         device=self.device)
        self._set_constants(sched, bufs)
        return bufs

    def _reset_buffers(self, sched: Schedule, bufs: dict) -> None:
        """Zero kept buffers and set their constants again, as
        `_new_buffers` leaves them."""
        for b in bufs.values():
            if b is not None:
                for plane in b if isinstance(b, tuple) else (b,):
                    plane.zero_()
        self._set_constants(sched, bufs)

    def _set_constants(self, sched: Schedule, bufs: dict) -> None:
        """The trivial ONE in GLWE slot 1 (slot 0 the zero); the key's
        GGSW(0) and GGSW(1) in GGSW slots 0 and 1 where the circuit uses
        them."""
        if bufs.get(_GLWE) is not None:
            bufs[_GLWE][-1, 0, 1] = torus.encode_const(1, 1)
        if bufs.get(_GGSW) is not None and sched.uses_ggsw_consts:
            if self.key.ggsw_zero_freq is None:
                raise CircuitError("circuit uses GGSW constants but the compute key"
                                   " has no ggsw_zero/one_freq")
            for b, z, o in zip(bufs[_GGSW], self.key.ggsw_zero_freq, self.key.ggsw_one_freq):
                b[0], b[1] = z, o

    def _scatter_inputs(self, sched: Schedule, bufs: dict, inputs: dict) -> None:
        """The inputs into their slots: those of a kind stacked on the host
        and shipped at once."""
        for kind, (names, sl) in sched.inputs.items():
            x = np.stack([np.asarray(inputs[nm], dtype=np.uint64) for nm in names], axis=-1)
            slots = torch.from_numpy(sl[:len(names)].astype(np.int64)).to(self.device)
            bufs[kind].index_copy_(-1, slots, torus.from_u64_np(x, self.device))

    def _gather_outputs(self, sched: Schedule, bufs: dict) -> dict:
        by_kind: dict[str, list] = {}
        for param, kind, sl in sched.outputs:
            by_kind.setdefault(kind, []).append((param, sl))
        out = {}
        for kind, items in by_kind.items():
            sl = torch.tensor([s for _, s in items], dtype=torch.int64, device=self.device)
            got = torus.to_u64_np(bufs[kind].index_select(-1, sl))
            for j, (param, _) in enumerate(items):
                out[param] = np.ascontiguousarray(got[..., j])
        return out
