"""Levelized MuxCircuit evaluation over encrypted wires.

Port of `spf_tpu/ops/mux_eval_u32.py` on int64 wires. It runs a boolean
mux DAG (`circuits/mux.py`) over encrypted wires: selects are GGSW
spectra straight out of `cbs.circuit_bootstrap`, wires are GLWE
ciphertexts int64 [k+1, N, lanes], and every level's gates run as one
batched CMux with the gate and instance axes packed onto the lane axis
(≙ the reference evaluates the same DAG gate at a time on rayon threads,
`parasol_runtime/src/circuit_processor/mod.rs`).

Several independent *instances* of the same circuit evaluate in one pass:
wires carry an instance axis I on the lanes, so a level of G gates runs a
CMux of G*I lanes. Each lane's select is read in place from the CBS
output (`freq_mad_batched` under the lane's input index), with no gather
of GGSW rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..circuits.mux import MuxCircuit
from ..params import GlweDef, Params, RadixDecomposition
from . import torus
from .bootstrap import cmux, sample_extract
from .cbs import circuit_bootstrap
from .keyswitch import keyswitch_lwe

# Fresh-path bound before a wire is recrypted (see RefreshKeys), calibrated
# against DEFAULT_128's 4x8 `cbs_pbs_radix` (`fhe_circuit.DEFAULT_MUX_REFRESH_DEPTH`).
DEFAULT_REFRESH_DEPTH = 64


@dataclasses.dataclass
class RefreshKeys:
    """Key material for mid-tree wire recryption: a wire whose CMux
    fresh-path reaches `refresh_every` is re-encrypted via extract ->
    keyswitch -> CBS -> external product with ONE, which resets its noise
    to a fresh CBS's. Without it, depth-510 trees (the 16x16 multiplier)
    exceed the noise budget. Spectra as 4-plane tuples, the keyswitch key
    as byte planes (`keyswitch.ksk_to_byte_planes`)."""

    bsk_freq: tuple
    ak_freq: tuple
    ssk_freq: tuple
    ksk_planes: torch.Tensor
    params: Params
    refresh_every: int = DEFAULT_REFRESH_DEPTH


def levelize(circuit: MuxCircuit) -> list:
    """Group mux node ids by longest-path depth (constants at level -1)."""
    depth: dict[int, int] = {}
    levels: list[list[int]] = []
    for i, node in enumerate(circuit.nodes):
        if node[0] != "mux":
            depth[i] = -1
            continue
        _, _, lo, hi = node
        d = max(depth[lo], depth[hi]) + 1
        depth[i] = d
        while len(levels) <= d:
            levels.append([])
        levels[d].append(i)
    return levels


def trivial_bit_glwe(bit: int, glwe: GlweDef, instances: int, device) -> torch.Tensor:
    """Trivial GLWE of a binary message (1-bit encoding), int64 [k+1, N, I]."""
    out = torch.zeros((glwe.size + 1, glwe.degree, instances), dtype=torch.int64, device=device)
    if bit:
        out[-1, 0] = torus.encode_const(1, 1)
    return out


def refresh_wires(w: torch.Tensor, rk: RefreshKeys) -> torch.Tensor:
    """Recrypt GLWE bit wires int64 [k+1, N, W]: sample extract, L1 -> L0
    keyswitch, CBS, then the CMux of (0, 1) under the fresh GGSWs."""
    p = rk.params
    glwe = p.l1_params
    l1 = sample_extract(w, 0, glwe)
    l0 = keyswitch_lwe(l1, rk.ksk_planes, glwe.as_lwe_def(), p.l0_params, p.ks_radix)
    g = circuit_bootstrap(l0, rk.bsk_freq, rk.ak_freq, rk.ssk_freq, p)
    width = w.shape[-1]
    return cmux(trivial_bit_glwe(0, glwe, width, w.device), trivial_bit_glwe(1, glwe, width, w.device),
                g, p.cbs_radix)


def refresh_levels(circuit: MuxCircuit, refresh_every: int) -> dict:
    """Static refresh plan: node id -> True for mux nodes whose CMux
    fresh-path reaches `refresh_every` (those wires are recrypted right
    after their level executes; their fresh-path resets to 1)."""
    fp: dict[int, int] = {}
    plan: dict[int, bool] = {}
    for i, node in enumerate(circuit.nodes):
        if node[0] != "mux":
            fp[i] = 0
            continue
        _, _, lo, hi = node
        f = max(fp[lo], fp[hi]) + 1
        if refresh_every and f >= refresh_every:
            plan[i] = True
            f = 1
        fp[i] = f
    return plan


def pad_lanes(x: torch.Tensor, width: int, edge: bool) -> torch.Tensor:
    """Pad the lane (last) axis to `width`: zeros, or the last lane repeated."""
    w = x.shape[-1]
    if w == width:
        return x
    fill = x[..., -1:].expand(*x.shape[:-1], width - w) if edge else x.new_zeros(
        (*x.shape[:-1], width - w))
    return torch.cat([x, fill], dim=-1)


def evaluate_mux_circuit(
    circuit: MuxCircuit,
    sel_ggsw_freq,
    glwe: GlweDef,
    cbs_radix: RadixDecomposition,
    instances: int,
    per_level_jit: bool = False,
    refresh: RefreshKeys | None = None,
):
    """Evaluate `circuit` over encrypted selects (≙
    `mux_eval_u32.evaluate_mux_circuit_u32`).

    sel_ggsw_freq: GGSW spectra, 4 planes [k+1, l, k+1, K, num_inputs * I]
    from `cbs.circuit_bootstrap`, ordered input-major (input i's I
    instances at i*I..(i+1)*I). Returns the output wires, each a GLWE
    int64 [k+1, N, I].

    `per_level_jit=True` pads each level's lanes to the next power of two,
    as the reference does to share one executable across levels; PyTorch
    runs eagerly, so this is the same per-level loop on padded lanes (the
    padded lanes' outputs are dropped, the others' bits are unchanged).

    `refresh` bounds tree noise for deep circuits: wires whose fresh-path
    reaches `refresh.refresh_every` are recrypted through the conversion
    cycle, batched per level (lanes padded to a power of two with the last
    wire repeated, as in the reference).
    """
    ii = instances
    device = sel_ggsw_freq[0].device
    vals: dict[int, torch.Tensor] = {}
    zero = trivial_bit_glwe(0, glwe, ii, device)
    one = trivial_bit_glwe(1, glwe, ii, device)
    for i, node in enumerate(circuit.nodes):
        if node[0] == "zero":
            vals[i] = zero
        elif node[0] == "one":
            vals[i] = one
    plan = refresh_levels(circuit, refresh.refresh_every) if refresh else {}

    for level in levelize(circuit):
        lo = torch.cat([vals[circuit.nodes[n][2]] for n in level], dim=-1)
        hi = torch.cat([vals[circuit.nodes[n][3]] for n in level], dim=-1)
        sel_idx = np.concatenate([circuit.nodes[n][1] * ii + np.arange(ii) for n in level])
        slots = torch.from_numpy(sel_idx.astype(np.int32)).to(device)
        w = lo.shape[-1]
        if per_level_jit:
            wp = 1 << (w - 1).bit_length()
            lo, hi = pad_lanes(lo, wp, False), pad_lanes(hi, wp, False)
            slots = pad_lanes(slots, wp, False)  # slot 0: any GGSW; the lanes are dropped
        out = cmux(lo, hi, sel_ggsw_freq, cbs_radix, slots)[..., :w]
        for j, n in enumerate(level):
            vals[n] = out[..., j * ii:(j + 1) * ii]
        to_refresh = [n for n in level if plan.get(n)]
        if to_refresh:
            rw = torch.cat([vals[n] for n in to_refresh], dim=-1)
            w = rw.shape[-1]
            fresh = refresh_wires(pad_lanes(rw, 1 << (w - 1).bit_length(), True), refresh)
            for j, n in enumerate(to_refresh):
                vals[n] = fresh[..., j * ii:(j + 1) * ii]
    return [vals[o] for o in circuit.outputs]
