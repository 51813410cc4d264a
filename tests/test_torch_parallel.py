"""The port's multi-device layer (`spf_tpu_torch/parallel/`) on the CPU:
meshes of "cpu" entries stand for cards, as the JAX package's tests use
eight virtual CPU devices.

Every sharded function's output is bit for bit the unsharded call's on
the same inputs (the split changes where lanes run, not their
arithmetic): on a 4-entry mesh, on a one-process 2 x 2 multi-host mesh,
and across two gloo processes, where each process's superblock equals
its slice of the unsharded output, the keys go out by the one broadcast
of `replicate_multihost` and no collective runs during the step.
`scaling_model` equals the JAX package's.
"""

import itertools
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from spf_tpu_torch.ops import cbs
from spf_tpu_torch.ops import encryption as penc
from spf_tpu_torch.ops.lut import generate_lut_np
from spf_tpu_torch.ops.multibit import MultibitBootstrap
from spf_tpu_torch.ops.torus import from_u64_np
from spf_tpu_torch.ops.u64 import bootstrap as u64_bs
from spf_tpu_torch.ops.u64 import cbs as u64_cbs
from spf_tpu_torch.parallel import (
    make_mesh,
    make_multihost_mesh,
    replicate,
    replicate_multihost,
    scaling_model,
    shard_batch,
    shard_lanes,
    shard_lanes_multihost,
    sharded_cbs,
    sharded_cbs_u32,
    sharded_pbs,
    sharded_pbs_multibit,
    sharded_pbs_multibit_multihost,
)
from spf_tpu_torch.parallel.multihost import lane_spec
from spf_tpu_torch.params import GlweDef, LweDef, Params, RadixDecomposition
from spf_tpu_torch.runtime import generate_keys

torch.set_num_threads(1)

LWE = LweDef(dim=8, std=1e-16)
GLWE = GlweDef(size=1, degree=64, std=1e-16)
PBS_RADIX = RadixDecomposition(count=2, radix_log=16)
PARAMS = Params(
    l0_params=LWE,
    l1_params=GLWE,
    cbs_radix=RadixDecomposition(count=2, radix_log=9),
    pbs_radix=PBS_RADIX,
    ks_radix=RadixDecomposition(count=9, radix_log=4),
    pfks_radix=RadixDecomposition(count=4, radix_log=11),
    ss_radix=RadixDecomposition(count=6, radix_log=8),
    tr_radix=RadixDecomposition(count=6, radix_log=7),
)
GROUP = 2
LANES = 8
SEED = 1717
CPU4 = ["cpu"] * 4

# every collective and point-to-point call of torch.distributed
COLLECTIVES = ("broadcast", "all_reduce", "reduce", "all_gather", "all_gather_into_tensor",
               "gather", "scatter", "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
               "all_to_all_single", "barrier", "send", "recv", "isend", "irecv",
               "broadcast_object_list", "all_gather_object")


def _multibit_material():
    """A multi-bit key (g = 2) as `MultibitBootstrap` holds it, the LUT
    (x + 1) % 4 and LANES ciphertexts, all from SEED on the CPU."""
    gen = torch.Generator().manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    lwe_sk = rng.integers(0, 2, LWE.dim).astype(np.int64)
    glwe_sk = penc.generate_glwe_sk(GLWE, gen)
    bsk = penc.generate_multibit_bsk(lwe_sk, glwe_sk, GLWE, PBS_RADIX, GROUP, gen)
    lut = generate_lut_np([lambda x: (x + 1) % 4], GLWE, 2)
    pbs = MultibitBootstrap(bsk, lut, GLWE, PBS_RADIX, GROUP, device="cpu")
    msgs = np.arange(LANES, dtype=np.uint64) % 4
    cts = penc.encrypt_lwe_np(rng, msgs << np.uint64(61), lwe_sk, LWE)
    return pbs, from_u64_np(cts.T.copy())  # [n0+1, LANES]


class _Counter:
    """Counts the calls of every torch.distributed collective while on."""

    def __init__(self, monkeypatch_setattr):
        self.calls = {}
        for name in COLLECTIVES:
            fn = getattr(dist, name, None)
            if fn is not None:
                monkeypatch_setattr(dist, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def counted(*args, **kwargs):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*args, **kwargs)

        return counted


def test_mesh_shape_and_axes():
    mesh = make_mesh(devices=CPU4)
    assert mesh.axis_names == ("batch",) and mesh.devices.shape == (4,)
    assert make_mesh(n_devices=2, devices=CPU4).devices.shape == (4,)  # devices given win
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    mh = make_multihost_mesh(hosts=2, chips_per_host=4, devices=["cpu"] * 8)
    assert mh.axis_names == ("dcn", "ici") and mh.devices.shape == (2, 4)
    assert mh.shape == {"dcn": 2, "ici": 4} and mh.size == 8
    assert make_multihost_mesh(hosts=2, devices=["cpu"] * 8).devices.shape == (2, 4)
    assert make_multihost_mesh(devices=CPU4).devices.shape == (1, 4)  # one process: one host
    assert lane_spec(3) == (None, None, ("dcn", "ici"))


def test_uneven_hosts_and_lanes_raise():
    with pytest.raises(ValueError):
        make_multihost_mesh(hosts=3, devices=["cpu"] * 8)
    mesh = make_mesh(devices=CPU4)
    x = torch.arange(2 * 10).reshape(2, 10)
    with pytest.raises(ValueError):
        shard_lanes(x, mesh)
    with pytest.raises(ValueError):
        shard_batch(x.T[:6], mesh)
    with pytest.raises(ValueError):
        shard_lanes_multihost(x, make_multihost_mesh(hosts=2, devices=CPU4))
    assert [s.shape for s in shard_lanes(x[:, :8], mesh)] == [(2, 2)] * 4
    assert [s.shape for s in shard_batch(x.T[:8], mesh)] == [(2, 2)] * 4
    assert len(replicate((x, x), mesh)) == 4


def test_sharded_multibit_pbs_and_cbs_bit_for_bit(monkeypatch):
    """sharded_pbs_multibit and sharded_cbs_u32 on 4 "cpu" entries, and the
    multi-bit PBS on a one-process 2 x 2 multi-host mesh, equal the
    unsharded calls bit for bit; no collective runs."""
    counter = _Counter(monkeypatch.setattr)
    pbs, ct = _multibit_material()
    want = pbs(ct)
    mesh = make_mesh(devices=CPU4)
    step = sharded_pbs_multibit(LWE, GLWE, PBS_RADIX, GROUP, pbs.bsk_freq, pbs.lut, mesh)
    assert torch.equal(step(ct), want)
    assert torch.equal(step(shard_lanes(ct, mesh)), want)
    mh = make_multihost_mesh(hosts=2, chips_per_host=2, devices=CPU4)
    step_mh = sharded_pbs_multibit_multihost(LWE, GLWE, PBS_RADIX, GROUP, pbs.bsk_freq, pbs.lut,
                                             mh)
    assert torch.equal(step_mh(ct), want)

    gen = torch.Generator().manual_seed(SEED + 1)
    glwe_sk = penc.generate_glwe_sk(GLWE, gen)
    lwe_sk = np.random.default_rng(SEED).integers(0, 2, LWE.dim).astype(np.int64)
    p = PARAMS
    bsk = penc.generate_multibit_bsk(lwe_sk, glwe_sk, GLWE, p.cbs_pbs_radix_eff, GROUP, gen)
    ak = penc.generate_automorphism_keys(glwe_sk, GLWE, p.tr_radix, gen)
    ssk = penc.generate_scheme_switch_key(glwe_sk, GLWE, p.ss_radix, gen)
    ksk = np.zeros((GLWE.size * GLWE.degree, p.ks_radix.count, LWE.dim + 1), np.uint64)
    cycle = cbs.ConversionCycle(bsk, ak, ssk, ksk, p, device="cpu")
    keys = tuple(tuple(cbs.spectra(cycle, k)) for k in ("bsk", "ak", "ssk"))
    ct4 = ct[:, :4]
    ggsw = cbs.circuit_bootstrap(ct4, *keys, p)
    got = sharded_cbs_u32(p, *keys, mesh)(ct4)
    for g, w in zip(got, ggsw, strict=True):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert counter.calls == {}


def test_sharded_u64_pbs_and_cbs_bit_for_bit():
    """sharded_pbs and sharded_cbs (the u64 API on c128, batch first) on 4
    "cpu" entries equal the unsharded calls bit for bit."""
    _, _, ck = generate_keys(SEED, PARAMS, device="cpu")
    rng = np.random.default_rng(SEED)
    cts = from_u64_np(rng.integers(0, 2**64, (LANES, LWE.dim + 1), dtype=np.uint64))
    lut = u64_bs.generate_lut([lambda x: (x + 3) % 4], GLWE, 2, device="cpu")
    mesh = make_mesh(devices=CPU4)
    want = u64_bs.programmable_bootstrap_univariate(cts, lut, ck.bsk, LWE, GLWE, PBS_RADIX)
    assert torch.equal(sharded_pbs(PARAMS, ck.bsk, mesh, lut)(cts), want)
    assert torch.equal(sharded_pbs(PARAMS, replicate(ck.bsk, mesh), mesh, lut)(cts), want)
    want = u64_cbs.circuit_bootstrap(cts[:4], ck.bsk, ck.auto_keys, ck.ssk, PARAMS)
    assert torch.equal(sharded_cbs(PARAMS, ck, mesh)(cts[:4]), want)


def test_scaling_model_equals_reference():
    from spf_tpu.parallel.multihost import scaling_model as j_scaling_model

    grid = itertools.product((0, 1, 100, 1024, 4096), (1, 2, 8), (1, 4), (1.0, 1e-3),
                             (None, 400 << 20), (1, 1000))
    for lanes, hosts, chips, cost, bcast, steps in grid:
        kw = dict(per_lane_cost=cost, key_broadcast_bytes=bcast, steps=steps)
        assert scaling_model(lanes, hosts, chips, **kw) == j_scaling_model(lanes, hosts, chips,
                                                                           **kw)


def _gloo_worker(rank: int, port: int, world: int):
    """One process of the two-process job: join by gloo, build the 2 x 2
    multi-host mesh of its two "cpu" entries, take the keys from rank 0's
    broadcast (rank 1 passes zeros), run its superblock with every
    collective counted, and check it against its slice of the unsharded
    output."""
    from spf_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    assert init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu") == (rank, world)
    try:
        pbs, ct = _multibit_material()
        want = pbs(ct)
        mesh = make_multihost_mesh(devices=["cpu", "cpu"])
        assert mesh.devices.shape == (world, 2)
        bsk, lut = pbs.bsk_freq, pbs.lut
        if rank:
            bsk, lut = tuple(torch.zeros_like(c) for c in bsk), torch.zeros_like(lut)
        bsk, lut = replicate_multihost(bsk, mesh), replicate_multihost(lut, mesh)
        assert len(bsk) == len(lut) == 2
        assert all(torch.equal(a, b) for a, b in zip(bsk[1], pbs.bsk_freq))
        assert torch.equal(lut[1], pbs.lut)
        calls = {}
        saved = {n: getattr(dist, n) for n in COLLECTIVES if hasattr(dist, n)}
        for name, fn in saved.items():
            def counted(*a, _n=name, _fn=fn, **k):
                calls[_n] = calls.get(_n, 0) + 1
                return _fn(*a, **k)
            setattr(dist, name, counted)
        try:
            step = sharded_pbs_multibit_multihost(LWE, GLWE, PBS_RADIX, GROUP, bsk, lut, mesh)
            out = step(ct)
        finally:
            for name, fn in saved.items():
                setattr(dist, name, fn)
        assert calls == {}, calls
        per = LANES // world
        assert torch.equal(out, want[:, rank * per:(rank + 1) * per])
    finally:
        dist.destroy_process_group()


def test_two_process_gloo_superblocks():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_gloo_worker, args=(port, 2), nprocs=2, join=True)
