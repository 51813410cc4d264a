"""Safe (de)serialization of ciphertexts and keys.

Port of `spf_tpu/utils/serialization.py` (≙ reference
`parasol_runtime/src/safe_bincode.rs:1-116`: the `GetSize` trait computes
exact params-derived buffer sizes so deserialization of untrusted payloads
is bounded and shape-checked).

The same format as the JAX package's: an .npz holding `kind` and `data`,
`data` a u64 array of the exact shape `expected_shapes` gives; a payload
is size-bounded before it is parsed, and its kind, shape and dtype are
checked before any use. A payload saved by either package loads in the
other with the same bytes.

The port's arrays are wrapping int64 tensors: `serialize` takes one (its
bits read as u64, from whatever device holds it, since the payload is host
bytes) or a numpy u64 array. `deserialize` returns a numpy u64 array, as
the reference does, or with `device=` an int64 tensor on the device the
caller names: nothing lands on a device the caller did not ask for.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from ..params import Params


class DeserializationError(Exception):
    pass


def expected_shapes(params: Params) -> dict:
    """Exact array shapes for every L-typed entity at `params`
    (the analog of `GetSize::get_size`)."""
    n0 = params.l0_params.dim
    k = params.l1_params.size
    n = params.l1_params.degree
    l_cbs = params.cbs_radix.count
    return {
        "lwe0": (n0 + 1,),
        "lwe1": (k * n + 1,),
        "glwe1": (k + 1, n),
        "glev1": (l_cbs, k + 1, n),
        "ggsw1": (k + 1, l_cbs, k + 1, n),
        "lwe0_sk": (n0,),
        "glwe1_sk": (k, n),
        "ksk": (k * n, params.ks_radix.count, n0 + 1),
    }


def _host_u64(array) -> np.ndarray:
    """A numpy array as it is, or an int64 tensor's bits as numpy u64."""
    if isinstance(array, torch.Tensor):
        if array.dtype != torch.int64:
            raise DeserializationError(f"tensor dtype {array.dtype} != torch.int64")
        return array.detach().cpu().numpy().view(np.uint64)
    return np.asarray(array)


def serialize(kind: str, array, params: Params) -> bytes:
    arr = _host_u64(array)
    _check(kind, arr, params)
    buf = io.BytesIO()
    np.savez_compressed(buf, kind=kind, data=arr)
    return buf.getvalue()


def deserialize(data: bytes, kind: str, params: Params, device=None):
    """Validate and load an untrusted payload; size is bounded before
    parsing (`safe_bincode.rs` bounds malicious payloads). Returns numpy
    u64, or an int64 tensor on `device` when the caller names one."""
    shapes = expected_shapes(params)
    if kind not in shapes:
        raise DeserializationError(f"unknown entity kind {kind!r}")
    max_bytes = int(np.prod(shapes[kind])) * 8 * 4 + 4096
    if len(data) > max_bytes:
        raise DeserializationError(
            f"payload of {len(data)} bytes exceeds bound {max_bytes} for {kind}"
        )
    with np.load(io.BytesIO(data)) as f:
        if str(f["kind"]) != kind:
            raise DeserializationError(f"expected {kind}, got {f['kind']}")
        arr = f["data"]
    _check(kind, arr, params)
    if device is None:
        return arr
    return torch.from_numpy(arr.view(np.int64)).to(device)


def _check(kind: str, arr: np.ndarray, params: Params) -> None:
    shapes = expected_shapes(params)
    if kind not in shapes:
        raise DeserializationError(f"unknown entity kind {kind!r}")
    if arr.shape != shapes[kind]:
        raise DeserializationError(
            f"{kind}: shape {arr.shape} != expected {shapes[kind]}"
        )
    if arr.dtype != np.uint64:
        raise DeserializationError(f"{kind}: dtype {arr.dtype} != uint64")
