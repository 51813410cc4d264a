"""Ciphertext-batch parallelism over the devices of one process.

Port of `spf_tpu/parallel/mesh.py`: the batch (or lane) axis of a
ciphertext batch is split across devices, the evaluation keys are copied
to every device once, and each device runs the one-device path on its
shard against its own copy of the keys. Bootstraps and CBS read only
their own lane and the keys, so no collective crosses devices on the hot
path: the shards are joined in lane order at the end, on the mesh's
first device.

A `Mesh` is the device list and its axis names. Its entries are
`torch.device`s and may repeat: a mesh of four "cpu" entries runs the
same split and join on the CPU that four cards run, as the JAX package's
tests run on eight virtual CPU devices. The per-device bodies run one
after another from this thread; each card runs its kernels asynchronously,
so a card computes while the host enqueues the next one's work, and no
call waits on a device before the join.

| sharded function       | per-device body                                            |
|------------------------|------------------------------------------------------------|
| `sharded_pbs_multibit` | `ops.multibit.programmable_bootstrap_multibit` (lanes last)  |
| `sharded_cbs_u32`      | `ops.cbs.circuit_bootstrap` (lanes last)                    |
| `sharded_pbs`          | `ops.u64.bootstrap.programmable_bootstrap_univariate` (batch first) |
| `sharded_cbs`          | `ops.u64.cbs.circuit_bootstrap` (batch first)               |
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..ops import torus
from ..params import Params


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A device grid: `devices` a numpy object array of `torch.device`s
    (1-D for `make_mesh`, [hosts, chips_per_host] for the multi-host
    mesh), one axis name a dimension."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size


class Sharded(tuple):
    """Per-device shards of a pytree along its batch or lane axis, one per
    device this process runs, in lane order."""


class Replicated(tuple):
    """Per-device copies of a pytree, one per device this process runs."""


def _device_grid(devices) -> np.ndarray:
    grid = np.empty(len(devices), dtype=object)
    grid[:] = [torus.resolve_device(d) for d in devices]
    return grid


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over the `batch` axis: every CUDA device (the first
    `n_devices`), or the `devices` given (e.g. ["cpu"] * 4). Raises
    without a card unless `devices` names the CPU."""
    if devices is None:
        torus.resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(_device_grid(devices), axis_names=("batch",))


def tree_map(fn, x):
    """fn on every tensor of a pytree (tensors, tuples, lists, dataclasses
    such as `ComputeKey`); other leaves as they are."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: tree_map(fn, getattr(x, f.name))
                                         for f in dataclasses.fields(x) if f.init})
    return x


def _leaves(x) -> list:
    out = []
    tree_map(out.append, x)
    return out


def split_axis(x, n: int, axis: int) -> list:
    """n equal pieces of every tensor of pytree x along `axis`, as n
    pytrees; ValueError where the axis does not divide (as `shard_map`)."""
    for leaf in _leaves(x):
        if leaf.shape[axis] % n:
            raise ValueError(f"axis {axis} of length {leaf.shape[axis]} does not split over "
                             f"{n} devices")
    return [tree_map(lambda t, i=i: t.chunk(n, dim=axis)[i].contiguous(), x) for i in range(n)]


def _place(pieces, devices) -> list:
    return [tree_map(lambda t, d=d: t.to(d), p) for p, d in zip(pieces, devices)]


def shard_batch(x, mesh: Mesh) -> Sharded:
    """Split the leading axis of every tensor of pytree `x` into one shard
    per mesh entry, each on its device."""
    devices = list(mesh.devices.flat)
    return Sharded(_place(split_axis(x, len(devices), 0), devices))


def shard_lanes(x, mesh: Mesh) -> Sharded:
    """Split the last (lane) axis of every tensor of pytree `x`: the
    t-layout / batch-last pipelines' batch axis."""
    devices = list(mesh.devices.flat)
    return Sharded(_place(split_axis(x, len(devices), -1), devices))


def replicate(x, mesh: Mesh) -> Replicated:
    """Copy a pytree (evaluation keys) to every device of the mesh once."""
    devices = list(mesh.devices.flat)
    return Replicated(_place([x] * len(devices), devices))


def _device_context(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def run_sharded(body, shards: Sharded, keys: list, devices: list, axis: int):
    """body(shard, keys) on each device, launched one after another with no
    wait between them, then the outputs (tensors or tuples of tensors)
    joined along `axis` in shard order on the first device."""
    if not (len(shards) == len(keys) == len(devices)):
        raise ValueError(f"{len(shards)} shards, {len(keys)} key copies, {len(devices)} devices")
    outs = []
    for shard, key, dev in zip(shards, keys, devices):
        with _device_context(dev):
            outs.append(body(shard, key))
    home = devices[0]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat([o[c].to(home) for o in outs], dim=axis)
                     for c in range(len(outs[0])))
    return torch.cat([o.to(home) for o in outs], dim=axis)


def per_device_keys(keys: tuple, mesh: Mesh, replicate_fn) -> list:
    """Each key argument replicated (by `replicate_fn`, unless it already
    is `Replicated`), regrouped as one tuple of every argument a device."""
    copies = [k if isinstance(k, Replicated) else replicate_fn(k, mesh) for k in keys]
    return list(zip(*copies))


def _sharded_step(body, keys: tuple, mesh: Mesh, axis: int):
    """A callable running body(shard, keys) over `mesh` with its batch
    (axis 0) or lane (axis -1) axis split; each key argument replicated
    once, here, unless given as `replicate`'s output."""
    devices = list(mesh.devices.flat)
    per_device = per_device_keys(keys, mesh, replicate)
    split = shard_batch if axis == 0 else shard_lanes

    def step(x):
        shards = x if isinstance(x, Sharded) else split(x, mesh)
        return run_sharded(body, shards, per_device, devices, axis)

    return step


def sharded_pbs(params: Params, bsk_fft, mesh: Mesh, lut_glwe, be=None):
    """A batched-PBS step of the u64 API, its batch axis split over `mesh`
    and the key replicated: LWE batch int64 [B, n0+1] -> LWE batch
    [B, k*N+1] under the extracted key (c128 unless `be`)."""
    from ..ops.u64 import bootstrap as bs
    from ..ops.u64.fft import C128

    be = be or C128
    glwe = params.l1_params

    def body(cts, key):
        bsk, lut = key
        return bs.programmable_bootstrap_univariate(cts, lut, bsk, params.l0_params, glwe,
                                                    params.pbs_radix, be)

    return _sharded_step(body, (bsk_fft, lut_glwe), mesh, axis=0)


def sharded_cbs(params: Params, compute_key, mesh: Mesh, be=None):
    """A batched circuit-bootstrap step of the u64 API, batch-split:
    LWE batch int64 [B, n0+1] -> GGSW spectra [B, k+1, l_cbs, k+1, N/2]."""
    from ..ops.u64 import cbs as cbs_ops
    from ..ops.u64.fft import C128

    be = be or C128

    def body(cts, key):
        (ck,) = key
        return cbs_ops.circuit_bootstrap(cts, ck.bsk, ck.auto_keys, ck.ssk, params, be)

    return _sharded_step(body, (compute_key,), mesh, axis=0)


def sharded_pbs_multibit(lwe, glwe, radix, group: int, bsk_mb_freq, lut, mesh: Mesh):
    """The multi-bit PBS (the path of `MultibitBootstrap`), lanes split over
    `mesh` and the key replicated: LWE int64 [n0+1, B] -> LWE int64
    [k*N+1, B]. `bsk_mb_freq`: 4 f32 planes [n_groups, 2^g-1, k+1, l, k+1,
    K] (`MultibitBootstrap.bsk_freq`); `lut` int64 [k+1, N]. `lwe` is the
    reference's argument; the body reads n0 from the ciphertexts."""
    from ..ops import multibit as mb

    def body(ct, key):
        bsk, lut_d = key
        return mb.programmable_bootstrap_multibit(ct, lut_d, bsk, glwe, radix, group)

    return _sharded_step(body, (bsk_mb_freq, lut), mesh, axis=-1)


def sharded_cbs_u32(params: Params, bsk_freq, ak_freq, ssk_freq, mesh: Mesh):
    """The circuit bootstrap of the conversion cycle (`ops.cbs`, multi-bit
    or single-bit key by its rank), lanes split over `mesh`, every key
    replicated: L0 LWE int64 [n0+1, B] -> GGSW spectra, 4 f32 planes
    [k+1, l, k+1, K, B]."""
    from ..ops import cbs

    def body(ct, key):
        return cbs.circuit_bootstrap(ct, *key, params)

    return _sharded_step(body, (bsk_freq, ak_freq, ssk_freq), mesh, axis=-1)
