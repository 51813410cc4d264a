"""Multi-process (multi-host) ciphertext-batch parallelism.

Port of `spf_tpu/parallel/multihost.py`. The design keeps the one-process
invariant, no collective on the hot path, across processes:

- a 2-D device grid ("dcn", "ici"): the outer axis enumerates processes
  (hosts, on slow links), the inner one each process's local cards;
- the lane axis is split over both, dcn-major: each process owns one
  contiguous superblock of lanes, split over its local cards;
- evaluation keys are broadcast from rank 0 once (`replicate_multihost`,
  the only collective of a run) and copied to every local card;
- every PBS / CBS reads only its own lane and the keys, so each card runs
  the one-card body and no collective runs in steady state.

`init_distributed` joins a `torch.distributed` job (NCCL between cards,
gloo where the caller asks for the CPU); each process then builds the
same `make_multihost_mesh` and runs its own row of it. In one process,
`hosts` folds a flat device list into [hosts, chips_per_host] and the
process runs every row: the same split and join, as the JAX package's
tests simulate hosts on virtual CPU devices.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import torus
from .mesh import (
    Mesh,
    Replicated,
    Sharded,
    _device_grid,
    _place,
    per_device_keys,
    run_sharded,
    split_axis,
    tree_map,
)

DCN, ICI = "dcn", "ici"


def _world():
    """(rank, world size) of the torch.distributed job, (0, 1) outside one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device="cuda"):
    """Join a multi-process job (one process per host): NCCL on the card,
    gloo where `device` is the CPU; `coordinator_address` "host:port"
    (or "tcp://host:port") of rank 0. A no-op for one process or a job
    already joined. Returns (rank, world size)."""
    device = torus.resolve_device(device)
    dist = torch.distributed
    if num_processes is not None and num_processes > 1 and not dist.is_initialized():
        if coordinator_address is None or process_id is None:
            raise ValueError("a multi-process job needs coordinator_address and process_id")
        addr = coordinator_address
        if "://" not in addr:
            addr = f"tcp://{addr}"
        dist.init_process_group("gloo" if device.type == "cpu" else "nccl", init_method=addr,
                                world_size=num_processes, rank=process_id)
    return _world()


def make_multihost_mesh(hosts: int | None = None,
                        chips_per_host: int | None = None,
                        devices=None) -> Mesh:
    """A 2-D ("dcn", "ici") mesh. `devices` are this process's devices
    (default: its CUDA devices; raises without a card). In a job of
    `hosts` processes every row is one process's devices; in one process,
    pass `hosts` to fold the flat list into [hosts, chips_per_host]."""
    if devices is None:
        torus.resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(_device_grid(list(devices)))
    _, world = _world()
    if hosts is None:
        hosts = max(world, 1)
    if hosts > 1 and world == hosts:
        devices = devices * hosts  # row h: process h's local devices
    if chips_per_host is None:
        if len(devices) % hosts:
            raise ValueError(f"{len(devices)} devices do not split over {hosts} hosts")
        chips_per_host = len(devices) // hosts
    grid = np.empty((hosts, chips_per_host), dtype=object)
    grid.reshape(-1)[:] = devices[: hosts * chips_per_host]
    return Mesh(grid, axis_names=(DCN, ICI))


def lane_spec(ndim: int) -> tuple:
    """How a lane-trailing tensor of rank `ndim` is split: no axis but the
    last, which is split over (dcn, ici) jointly, dcn-major."""
    return (None,) * (ndim - 1) + ((DCN, ICI),)


def _owned_rows(mesh: Mesh) -> list:
    """The mesh rows this process runs: its own in a job of one process a
    row, every row in one process."""
    rank, world = _world()
    hosts = mesh.devices.shape[0]
    return [rank] if world == hosts and hosts > 1 else list(range(hosts))


def _local_devices(mesh: Mesh) -> list:
    return [d for r in _owned_rows(mesh) for d in mesh.devices[r]]


def shard_lanes_multihost(x, mesh: Mesh) -> Sharded:
    """This process's part of a pytree of lane-trailing tensors holding
    every lane of the job: its dcn-major superblock(s), split over its
    devices, each shard on its device."""
    hosts, chips = mesh.devices.shape
    pieces = split_axis(x, hosts * chips, -1)
    owned = [r * chips + c for r in _owned_rows(mesh) for c in range(chips)]
    return Sharded(_place([pieces[i] for i in owned], _local_devices(mesh)))


def replicate_multihost(x, mesh: Mesh) -> Replicated:
    """Evaluation keys broadcast from rank 0 (every process passes tensors
    of the keys' shapes and dtypes; the others' values are replaced), then
    copied to each of this process's devices. The broadcast is the only
    collective of a run."""
    devices = _local_devices(mesh)
    _, world = _world()
    if world > 1:
        def bcast(t):
            t = t.to(devices[0]).contiguous()
            buf = torch.view_as_real(t) if t.is_complex() else t
            torch.distributed.broadcast(buf, src=0)
            return t

        x = tree_map(bcast, x)
    return Replicated(_place([x] * len(devices), devices))


def _multihost_step(body, keys: tuple, mesh: Mesh):
    devices = _local_devices(mesh)
    per_device = per_device_keys(keys, mesh, replicate_multihost)

    def step(x):
        shards = x if isinstance(x, Sharded) else shard_lanes_multihost(x, mesh)
        return run_sharded(body, shards, per_device, devices, axis=-1)

    return step


def sharded_pbs_multibit_multihost(lwe, glwe, radix, group: int,
                                   bsk_mb_freq, lut, mesh: Mesh):
    """This process's body of the multi-bit PBS with lanes split over
    (dcn, ici) and keys replicated: its superblock's outputs, LWE int64
    [k*N+1, B / hosts], joined on its first device. No collective."""
    from ..ops import multibit as mb

    def body(ct, key):
        bsk, lut_d = key
        return mb.programmable_bootstrap_multibit(ct, lut_d, bsk, glwe, radix, group)

    return _multihost_step(body, (bsk_mb_freq, lut), mesh)


def sharded_cbs_u32_multihost(params, bsk_freq, ak_freq, ssk_freq, mesh: Mesh):
    """This process's body of the circuit bootstrap (`ops.cbs`) with lanes
    split over (dcn, ici), keys replicated: its superblock's GGSW spectra
    [k+1, l, k+1, K, B / hosts]. No collective."""
    from ..ops import cbs

    def body(ct, key):
        return cbs.circuit_bootstrap(ct, *key, params)

    return _multihost_step(body, (bsk_freq, ak_freq, ssk_freq), mesh)


def scaling_model(total_lanes: int, hosts: int, chips_per_host: int,
                  per_lane_cost: float = 1.0,
                  key_broadcast_bytes: int | None = None,
                  dcn_bytes_per_s: float = 25e9,
                  steps: int = 1) -> dict:
    """Analytic scaling model for the zero-collective lane sharding.

    Steady-state step time on N = hosts*chips devices is set by the
    most-loaded device: ceil(L / N) lanes (there are no collectives to
    add latency), so efficiency = (L / N) / ceil(L / N) — pure load
    imbalance from lane remainders. The one-time key broadcast
    amortizes over `steps`."""
    n = hosts * chips_per_host
    per_dev = -(-total_lanes // n)  # ceil
    eff = (total_lanes / n) / per_dev if total_lanes else 0.0
    out = {
        "devices": n,
        "hosts": hosts,
        "lanes_per_device": per_dev,
        "load_imbalance_efficiency": round(eff, 4),
        "speedup_vs_1": round(eff * n, 2),
    }
    if key_broadcast_bytes is not None:
        bcast_s = key_broadcast_bytes * max(hosts - 1, 0) / dcn_bytes_per_s
        step_s = per_dev * per_lane_cost
        out["key_broadcast_s"] = round(bcast_s, 3)
        out["broadcast_amortized_overhead"] = round(
            bcast_s / max(steps * step_s, 1e-12), 6
        )
    return out
