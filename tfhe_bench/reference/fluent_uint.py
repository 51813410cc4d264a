"""Plain evaluators of an `FheCircuit` of encrypted integer bits, and the
exact products that the multiply cell computes.

Written from the graph's semantics and the scheme, not from the program,
and importing nothing of it: the graph is read as data (each node's op
name and param, each edge's source, destination and role name), and
every ciphertext operation is `reference/cycle.py`'s or `reference/pbs.py`'s.

- `product(a, b)`: the exact 64-bit products of 32-bit operands, u64.
- `graph_data(circuit)`: the graph as data, in a topological order, with
  each node's level (one more than its deepest input's; sources 0).
- `eval_bits(graph, inputs)`: the plaintext bit of every wire. A GLWE
  wire carries its bit at coefficient 0; conversions (extraction at
  coefficient 0, keyswitch, circuit bootstrap) keep it; CMux selects
  (`hi` where the select is 1); the external product multiplies; NOT
  flips; ADD adds mod 2 (bits encoded at q/2).
- `eval_encrypted(graph, inputs, keys, params, dtype)`: the same graph on
  ciphertexts, gate by gate, the gates of one topological level batched
  by op: circuit bootstrap (`cycle.glev`, then `cycle.scheme_switch`),
  CMux and external product (the gadget product of `cycle._product`
  under each gate's own GGSW), sample extraction, the L1 -> L0 keyswitch
  (`cycle.lwe_keyswitch`), NOT, ADD and monomial products in exact
  integer arithmetic. float64 is the plain reference, float32 the
  control, as in `reference/cycle.py`. It keeps no slots, waves or
  schedule of its own beyond the levels.

Departures from upstream (parasol_runtime's `FheCircuit` and its
circuit processor), each with the same decryption:

- gates run level by level, where upstream runs each node as a task as
  soon as its inputs are ready;
- the circuit bootstrap is `reference/cycle.py`'s (this repository's
  g = 2 multi-bit rotation, each level adding only its own offset);
- GGSWs are kept in the coefficient domain (rounded to integers) and
  each product takes their spectra, where upstream keeps them as
  spectra;
- `eval_bits` models a GLWE wire by its coefficient 0 only, so it
  refuses a sample extraction at another coefficient and a monomial
  product by X^t, t != 0 (packed integers); `eval_encrypted` runs both;
- the GLEV ops (GLEV CMux, scheme switch of a GLEV) are refused by
  `eval_encrypted`, as by the program's u32 wave machine.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from tfhe_bench.reference import cycle, pbs

_U64 = np.uint64
_HALF = -(1 << 63)  # q/2 as int64: the encoding of bit 1
# ops that pass their one input's bit on unchanged
_IDENTITY = ("keyswitch", "cbs", "scheme_switch", "retire", "nop")
_CONST = {"zero_lwe0": 0, "one_lwe0": 1, "zero_glwe1": 0, "one_glwe1": 1, "zero_ggsw1": 0,
          "one_ggsw1": 1, "zero_glev1": 0, "one_glev1": 1}


def product(a, b) -> np.ndarray:
    """The exact products of unsigned operands below 2^32, u64 (a 64-bit
    product of two 32-bit operands never wraps)."""
    a, b = np.asarray(a), np.asarray(b)
    if (a < 0).any() or (b < 0).any() or (a >> 32).any() or (b >> 32).any():
        raise ValueError("operands must lie in [0, 2^32)")
    return a.astype(_U64) * b.astype(_U64)


@dataclasses.dataclass
class Graph:
    """An FheCircuit as data: `ops` [op name], `params` [param], `preds`
    [{role name: source node}], `order` a topological order, `level`
    [level]."""
    ops: list
    params: list
    preds: list
    order: list
    level: list


def graph_data(circuit) -> Graph:
    """Read a graph off any object with `nodes` (each with `.op.value` and
    `.param`) and `edges` ((source, destination, role with `.value`)).
    Raises on a cycle."""
    n = len(circuit.nodes)
    ops = [nd.op.value for nd in circuit.nodes]
    params = [nd.param for nd in circuit.nodes]
    preds: list = [{} for _ in range(n)]
    succs: list = [[] for _ in range(n)]
    indeg = [0] * n
    for s, d, r in circuit.edges:
        preds[d][r.value] = s
        succs[s].append(d)
        indeg[d] += 1
    level = [0] * n
    queue = deque(i for i in range(n) if indeg[i] == 0)
    order = []
    while queue:
        cur = queue.popleft()
        order.append(cur)
        for nxt in succs[cur]:
            level[nxt] = max(level[nxt], level[cur] + 1)
            indeg[nxt] -= 1
            if indeg[nxt] == 0:
                queue.append(nxt)
    if len(order) != n:
        raise ValueError("the graph has a cycle")
    return Graph(ops, params, preds, order, level)


def _as_graph(graph) -> Graph:
    return graph if isinstance(graph, Graph) else graph_data(graph)


def eval_bits(graph, inputs: dict, lanes: int = 1) -> dict:
    """The plaintext bit of every output: `inputs` input key -> bit, or
    with `lanes` > 1 a mask of `lanes` independent bits (bit c for case
    c). Returns output key -> bit (or mask)."""
    g = _as_graph(graph)
    mask = (1 << lanes) - 1
    val = [0] * len(g.ops)
    out = {}
    for i in g.order:
        op, ins = g.ops[i], g.preds[i]
        if op.startswith("input_"):
            v = inputs[g.params[i]] & mask
        elif op in _CONST:
            v = mask if _CONST[op] else 0
        elif op in ("cmux", "glev_cmux"):
            lo, hi = val[ins["low"]], val[ins["high"]]
            v = lo ^ (val[ins["sel"]] & (lo ^ hi))
        elif op == "multiply_ggsw_glwe":
            v = val[ins["ggsw"]] & val[ins["glwe"]]
        elif op == "not":
            v = mask ^ val[ins["unary"]]
        elif op == "glwe_add":
            v = val[ins["left"]] ^ val[ins["right"]]
        elif op in ("sample_extract", "mul_xn"):
            if g.params[i] or 0:
                raise ValueError(f"node {i}: {op} {g.params[i]} moves a bit off coefficient 0")
            v = val[ins["unary"]]
        elif op in _IDENTITY:
            v = val[ins["unary"]] if ins else 0
        elif op.startswith("output_"):
            v = val[ins["unary"]]
            out[g.params[i]] = v
        else:
            raise ValueError(f"node {i}: unknown op {op!r}")
        val[i] = v
    return out


# -- on ciphertexts ----------------------------------------------------------


def _radix(params: dict, name: str) -> tuple:
    count, log_b = params[name]
    return int(count), int(log_b)


def trivial_glwe(bit: int, kp1: int, n: int, device) -> torch.Tensor:
    """A noiseless GLWE of a bit at coefficient 0: int64 [k+1, N]."""
    out = torch.zeros((kp1, n), dtype=torch.int64, device=device)
    out[-1, 0] = _HALF if bit else 0
    return out


def trivial_ggsw(bit: int, kp1: int, count: int, log_b: int, n: int, device) -> torch.Tensor:
    """A noiseless GGSW of a bit, int64 [k+1, l, k+1, N]: row j, level i
    holds bit * q/B^(i+1) in mask j (phase -bit * s_j * q/B^(i+1)), row k
    in the body's coefficient 0."""
    out = torch.zeros((kp1, count, kp1, n), dtype=torch.int64, device=device)
    if bit:
        for i in range(count):
            for j in range(kp1):
                out[j, i, j, 0] = 1 << (64 - log_b * (i + 1))
    return out


def _extract(x: torch.Tensor, h: list) -> torch.Tensor:
    """GLWE int64 [B, k+1, N] -> the LWE of coefficient h[b] of each,
    int64 [k*N+1, B] under the flattened key."""
    shifted = torch.stack([cycle._negacyclic_shift(x[b], -int(e)) if e else x[b]
                           for b, e in enumerate(h)])
    return pbs.sample_extract(shifted)


def _chunks(nodes: list, size: int):
    for c0 in range(0, len(nodes), size):
        yield nodes[c0:c0 + size]


def eval_encrypted(graph, inputs: dict, keys: dict, params: dict,
                   dtype: torch.dtype = torch.float64, chunk: int = 128,
                   cbs_chunk: int = 64) -> dict:
    """Run the graph on ciphertexts: `inputs` input key -> u64 or int64
    array (a GLWE [k+1, N], an LWE [n+1]); `keys` the benchmark's
    coefficient-domain keys (`frozen/keygen.py`: `bsk` [n_groups, 2^g-1,
    k+1, l, k+1, N] at `cbs_pbs_radix`, `ak` [log2 N, k, l_tr, k+1, N],
    `ssk` [k, k, l_ss, k+1, N], `ksk` [k*N, l_ks, n0+1]), on the device
    they lie on; `params` the configuration's (`cbs_radix`,
    `cbs_pbs_radix`, `tr_radix`, `ss_radix`, `ks_radix` as [count, log B],
    `group_cbs`). Products run in the complex type of `dtype`, `chunk`
    gates (`cbs_chunk` bootstraps) at a time. Returns output key -> u64
    array."""
    g = _as_graph(graph)
    bsk, ak, ssk, ksk = keys["bsk"], keys["ak"], keys["ssk"], keys["ksk"]
    dev = ak.device
    kp1, n = ak.shape[-2:]
    c_count, c_log = _radix(params, "cbs_radix")
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    fft = pbs._Fft(n, cdtype, dev)
    ssk_f = cycle._key_spectra(ssk, fft)
    uses = [0] * len(g.ops)
    for ins in g.preds:
        for s in ins.values():
            uses[s] += 1
    val: dict = {}
    spectra: dict = {}  # GGSW node -> its pieces' spectra [4, k+1, l, k+1, N]
    out = {}

    def take(i):
        """Node i's value, dropped once its last consumer has it."""
        v = val[i]
        uses[i] -= 1
        if uses[i] == 0:
            del val[i]
            spectra.pop(i, None)
        return v

    def ggsw_f(i):
        if i not in spectra:
            spectra[i] = cycle._key_spectra(val[i], fft)
        return spectra[i]

    def external_product(ggsw_nodes, glwe):
        """Each GLWE [B, k+1, N] (its gadget digits) times its gate's GGSW."""
        digits = pbs.decompose(glwe, c_count, c_log)  # [l, B, k+1, N]
        keys_f = torch.stack([ggsw_f(s) for s in ggsw_nodes], dim=1)
        return cycle._product(digits, keys_f, fft, per_lane=True)

    by_level: dict = {}
    for i in g.order:
        by_level.setdefault(g.level[i], {}).setdefault(g.ops[i], []).append(i)
    for lv in sorted(by_level):
        for op, nodes in by_level[lv].items():
            ins = [g.preds[i] for i in nodes]
            if op.startswith("input_"):
                for i in nodes:
                    x = np.asarray(inputs[g.params[i]], dtype=_U64).view(np.int64)
                    val[i] = torch.from_numpy(x.copy()).to(dev)
            elif op in ("zero_glwe1", "one_glwe1"):
                for i in nodes:
                    val[i] = trivial_glwe(_CONST[op], kp1, n, dev)
            elif op in ("zero_ggsw1", "one_ggsw1"):
                for i in nodes:
                    val[i] = trivial_ggsw(_CONST[op], kp1, c_count, c_log, n, dev)
            elif op in ("zero_lwe0", "one_lwe0"):
                for i in nodes:
                    val[i] = torch.zeros(ksk.shape[-1], dtype=torch.int64, device=dev)
                    val[i][-1] = _HALF if _CONST[op] else 0
            elif op in ("cmux", "multiply_ggsw_glwe"):
                for part in _chunks(list(zip(nodes, ins)), chunk):
                    sel = [p["sel" if op == "cmux" else "ggsw"] for _, p in part]
                    if op == "cmux":
                        d0 = torch.stack([take(p["low"]) for _, p in part])
                        d1 = torch.stack([take(p["high"]) for _, p in part])
                        res = d0 + external_product(sel, d1 - d0)
                    else:
                        res = external_product(sel, torch.stack([take(p["glwe"]) for _, p in part]))
                    for s in sel:
                        take(s)
                    for b, (i, _) in enumerate(part):
                        val[i] = res[b]
            elif op == "cbs":
                for part in _chunks(list(zip(nodes, ins)), cbs_chunk):
                    ct = torch.stack([take(p["unary"]) for _, p in part], dim=1)  # [n0+1, B]
                    levels = cycle.glev(ct, bsk, ak, params, fft)
                    ggsw = cycle.scheme_switch(levels, ssk_f, *_radix(params, "ss_radix"), fft)
                    for b, (i, _) in enumerate(part):
                        val[i] = ggsw[b]
            elif op == "sample_extract":
                x = torch.stack([take(p["unary"]) for p in ins])
                res = _extract(x, [g.params[i] or 0 for i in nodes])
                for b, i in enumerate(nodes):
                    val[i] = res[:, b]
            elif op == "keyswitch":
                l1 = torch.stack([take(p["unary"]) for p in ins], dim=1)
                res = cycle.lwe_keyswitch(l1, ksk, *_radix(params, "ks_radix"))
                for b, i in enumerate(nodes):
                    val[i] = res[:, b]
            elif op == "not":
                for i, p in zip(nodes, ins):
                    v = -take(p["unary"])
                    v[-1, 0] += _HALF
                    val[i] = v
            elif op == "glwe_add":
                for i, p in zip(nodes, ins):
                    val[i] = take(p["left"]) + take(p["right"])
            elif op == "mul_xn":
                for i, p in zip(nodes, ins):
                    val[i] = cycle._negacyclic_shift(take(p["unary"]), int(g.params[i] or 0))
            elif op in ("retire", "nop"):
                for i, p in zip(nodes, ins):
                    if p:
                        val[i] = take(p["unary"])
            elif op.startswith("output_"):
                for i, p in zip(nodes, ins):
                    out[g.params[i]] = take(p["unary"]).cpu().numpy().view(_U64)
            else:
                raise ValueError(f"{op!r} is not evaluated on ciphertexts here")
    return out
