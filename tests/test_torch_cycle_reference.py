"""The port's conversion cycle (`ops/cbs.py::ConversionCycle`) against the
benchmark's plain reference (`tfhe_bench/reference/cycle.py`, float64), on
the same coefficient-domain keys, at N = 64, n0 = 8 with DEFAULT_128's
radices, negligible noise and a g = 2 key; and the cycle's spans and
counters under `torch.profiler` on the CPU.

Keys and bits come from seeded generators through the benchmark's keygen
(`tfhe_bench/frozen/keygen.py`), as the cell makes them at full size.
"""

import dataclasses

import numpy as np
import pytest
import torch

from spf_tpu_torch.ops import cbs, multibit
from spf_tpu_torch.ops.bootstrap import inv_limb, spectra
from spf_tpu_torch.params import DEFAULT_128, GlweDef, LweDef
from spf_tpu_torch.utils.profiling import metrics
from tfhe_bench import trace
from tfhe_bench.frozen import keygen
from tfhe_bench.reference import cycle as ref, plain
from tfhe_bench.systems.multibit_pbs import glwe_def, lwe_def, radix_def

torch.set_num_threads(1)

N, N0, B, GROUP = 64, 8, 8, 2
PARAMS = dataclasses.replace(DEFAULT_128, l0_params=LweDef(N0, 1e-16),
                             l1_params=GlweDef(1, N, 1e-16))


def _pair(r):
    return [r.count, r.radix_log]


# the reference's view of the same parameters (the benchmark configuration's keys)
REF_PARAMS = {"cbs_radix": _pair(PARAMS.cbs_radix), "cbs_pbs_radix": _pair(PARAMS.cbs_pbs_radix),
              "tr_radix": _pair(PARAMS.tr_radix), "ss_radix": _pair(PARAMS.ss_radix),
              "ks_radix": _pair(PARAMS.ks_radix), "group_cbs": GROUP}

# Tolerances of the comparison, as log2 of the largest wrapped difference
# of two phases (q = 2^64; a bit decodes wrong 2^62 away):
# - GLEV, GGSW and L1 phases: the port rounds every product in ds32 (about
#   48 significant bits) where the reference's are exact. Over six seeds
#   the gaps read 2^34.1-2^35.6 (GLEV), 2^35.0-2^36.1 (GGSW rows, brought
#   back from the port's spectra by its inverse FFT) and 2^37.9-2^38.6
#   (L1); the bounds leave 2^6 above them. A float32 reference reads
#   2^59.7 (GLEV), 2^61.0 (GGSW) and 2^62.6 (L1) or more. The gaps grow
#   with N: the benchmark's card test holds the cell's size to its own.
# - L0 phases: each lane's L0 phase lies within its keyswitch's digit
#   rounding of bit * 2^63 (ks_radix 6 x 2 keeps 12 bits, so each of the
#   k*N = 64 L1 mask values rounds by at most 2^51: at most 2^57 in all),
#   and one rounding is an unrelated function of its L1 mask: two cycles of
#   one bit lie within 2^58 of each other.
GLEV_GAP_LOG2 = 42
GGSW_GAP_LOG2 = 43
L1_GAP_LOG2 = 46
L0_GAP_LOG2 = 58


@pytest.fixture(scope="module")
def setting():
    return make_setting(20261018)


def make_setting(seed: int) -> dict:
    """Keys, bits, their encryptions and the port's cycle, from one seed."""
    gen = torch.Generator().manual_seed(seed)
    lwe, glwe = lwe_def(N0, 1e-16), glwe_def(1, N, 1e-16)
    lwe_sk = keygen.generate_lwe_sk(lwe, gen)
    glwe_sk = keygen.generate_glwe_sk(glwe, gen)
    keys = dict(
        bsk=keygen.generate_multibit_bsk(lwe_sk, glwe_sk, glwe, radix_def(REF_PARAMS["cbs_pbs_radix"]),
                                         GROUP, gen),
        ak=keygen.generate_automorphism_keys(glwe_sk, glwe, radix_def(REF_PARAMS["tr_radix"]), gen),
        ssk=keygen.generate_scheme_switch_key(glwe_sk, glwe, radix_def(REF_PARAMS["ss_radix"]), gen),
        ksk=keygen.generate_lwe_keyswitch_key(glwe_sk.reshape(-1), lwe_sk, lwe,
                                              radix_def(REF_PARAMS["ks_radix"]), gen))
    bits = np.random.default_rng(seed).integers(0, 2, B)
    ct = keygen.encrypt_lwe(torch.from_numpy(bits) << 63, lwe_sk, lwe, gen).T.contiguous()
    cycle = cbs.ConversionCycle(*keys.values(), PARAMS, device="cpu")
    return dict(keys=keys, bits=bits, ct=ct, cycle=cycle, lwe_sk=lwe_sk.numpy(),
                glwe_sk=glwe_sk)


def _port_stages(s):
    """The port's cycle, stage by stage as `forward` runs it: (GLEV [l, k+1,
    N, B], GGSW int64 [B, k+1, l, k+1, N] brought back from its spectra,
    L1 LWE [k*N+1, B], L0 LWE [n0+1, B])."""
    cyc = s["cycle"]
    acc = cbs.cbs_blind_rotate(s["ct"], spectra(cyc, "bsk"), PARAMS)
    glev = cbs.cbs_levels(acc, spectra(cyc, "ak"), PARAMS)
    ggsw = cbs.scheme_switch(glev, spectra(cyc, "ssk"), PARAMS.l1_params, PARAMS.cbs_radix,
                             PARAMS.ss_radix)
    l1 = cyc.select(ggsw)
    return glev, inv_limb(ggsw).permute(4, 0, 1, 2, 3), l1, cyc.keyswitch(l1)


def test_port_and_reference_cycle_agree(setting):
    s = setting
    glev, ggsw, l1, out = _port_stages(s)
    assert torch.equal(out, s["cycle"](s["ct"]))  # the stages are the timed path
    r_glev, r_ggsw, r_l1, r_out = ref.cycle_stages(s["ct"], **s["keys"], params=REF_PARAMS)
    assert tuple(r_out.shape) == tuple(out.shape) == (N0 + 1, B)
    sk_flat = s["glwe_sk"].reshape(-1).numpy()
    for o in (out, r_out):
        phases = plain.lwe_phases(o.numpy().T.view(np.uint64), s["lwe_sk"])
        decoded, share = plain.decode(phases, s["bits"], 1)
        assert np.array_equal(decoded, s["bits"]) and share.max() < 0.05
    # each level encrypts bit * q/16^(i+1) at coefficient 0 and 0 elsewhere
    p_glev = ref.glwe_phases(glev.permute(0, 3, 1, 2), s["glwe_sk"])  # [l, B, N]
    want = torch.zeros_like(p_glev)
    for i in range(PARAMS.cbs_radix.count):
        want[i, :, 0] = torch.from_numpy(s["bits"]) << (64 - 4 * (i + 1))
    assert ref.gap_log2(p_glev, want) < 50
    assert ref.gap_log2(p_glev, ref.glwe_phases(r_glev, s["glwe_sk"])) < GLEV_GAP_LOG2
    # every row and level of both GGSWs decodes, and the two lie close
    bits = torch.from_numpy(s["bits"])
    for g in (ggsw, r_ggsw):
        assert ref.ggsw_error_shares(g, bits, s["glwe_sk"], PARAMS.cbs_radix.radix_log).max() < 0.05
    assert ref.gap_log2(ref.glwe_phases(ggsw, s["glwe_sk"]),
                        ref.glwe_phases(r_ggsw, s["glwe_sk"])) < GGSW_GAP_LOG2
    l1_phases = [plain.lwe_phases(x.numpy().T.view(np.uint64), sk_flat) for x in (l1, r_l1)]
    assert ref.gap_log2(*l1_phases) < L1_GAP_LOG2
    l0_phases = [plain.lwe_phases(x.numpy().T.view(np.uint64), s["lwe_sk"]) for x in (out, r_out)]
    assert ref.gap_log2(*l0_phases) < L0_GAP_LOG2


def test_ggsw_rows_and_levels_the_cmux_does_not_read_are_held(setting):
    """The CMux of (0, q/2) reads only row k, level 0 of a GGSW: rows
    j < k or levels 1-3 left zero still decrypt the cycle's output right,
    and fail `ggsw_error_shares` on every lane of bit 1."""
    s = setting
    _, ggsw, _, _ = _port_stages(s)
    bits = torch.from_numpy(s["bits"])
    rows, levels = ggsw.clone(), ggsw.clone()
    rows[:, :-1] = 0
    levels[:, :, 1:] = 0
    for bad in (rows, levels):
        shares = ref.ggsw_error_shares(bad, bits, s["glwe_sk"], PARAMS.cbs_radix.radix_log)
        assert torch.equal(shares >= 1, bits == 1)


def test_float32_reference_misses_the_tolerances(setting):
    """The control: the same reference one precision below the port's ds32."""
    s = setting
    glev, ggsw, l1, _ = _port_stages(s)
    r_glev, r_ggsw, r_l1, _ = ref.cycle_stages(s["ct"], **s["keys"], params=REF_PARAMS,
                                               dtype=torch.float32)
    p_glev = ref.glwe_phases(glev.permute(0, 3, 1, 2), s["glwe_sk"])
    assert ref.gap_log2(p_glev, ref.glwe_phases(r_glev, s["glwe_sk"])) >= GLEV_GAP_LOG2
    assert ref.gap_log2(ref.glwe_phases(ggsw, s["glwe_sk"]),
                        ref.glwe_phases(r_ggsw, s["glwe_sk"])) >= GGSW_GAP_LOG2
    sk_flat = s["glwe_sk"].reshape(-1).numpy()
    l1_phases = [plain.lwe_phases(x.numpy().T.view(np.uint64), sk_flat) for x in (l1, r_l1)]
    assert ref.gap_log2(*l1_phases) >= L1_GAP_LOG2


def _span_counts(fn) -> dict:
    _, rec = trace.profile_calls(lambda i: fn(), 1, False)
    counts: dict = {}
    for name, *_ in rec["host_ops"]:
        if name.startswith(("cbs.", "cycle.")):
            counts[name] = counts.get(name, 0) + 1
    return counts


def _cbs_counters() -> dict:
    return {k: v for k, v in metrics.snapshot().items() if k.startswith("cbs.")}


def test_cycle_spans_and_counters_under_the_profiler(setting):
    s = setting
    before = _cbs_counters()
    counts = _span_counts(lambda: s["cycle"](s["ct"]))
    levels = PARAMS.cbs_radix.count
    assert counts == {"cbs.rotate": 1, "cbs.levels": 1, "cbs.trace": levels,
                      "cbs.scheme_switch": 1, "cycle.cmux": 1, "cycle.keyswitch": 1}
    after = _cbs_counters()
    delta = {k: v - before.get(k, 0) for k, v in after.items()}
    assert delta == {"cbs.calls": 1, "cbs.lanes": B,
                     "cbs.glwe_keyswitches": levels * PARAMS.l1_params.log_degree}


def test_multibit_pbs_runs_no_cbs_span(setting):
    """The PBS's path (`MultibitBootstrap`) opens no span and counts
    nothing of the cycle's."""
    s = setting
    glwe = glwe_def(1, N, 1e-16)
    gen = torch.Generator().manual_seed(5)
    pbs_radix = PARAMS.pbs_radix
    bsk = keygen.generate_multibit_bsk(torch.from_numpy(s["lwe_sk"]), s["glwe_sk"], glwe,
                                       radix_def([pbs_radix.count, pbs_radix.radix_log]), 3, gen)
    lut = keygen.generate_lut_np([lambda x: (x + 1) % 8], glwe, 3)
    pbs = multibit.MultibitBootstrap(bsk, lut, PARAMS.l1_params, pbs_radix, 3, device="cpu")
    before = _cbs_counters()
    assert _span_counts(lambda: pbs(s["ct"])) == {}
    assert _cbs_counters() == before
