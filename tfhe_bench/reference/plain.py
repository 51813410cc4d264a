"""The plain reference: decryption and the plaintext functions the cells
compute, in NumPy.

Imports nothing of the program. It works from the secret keys and the
messages that the benchmark made (`frozen/keygen.py`, `traffic.py`) and
judges the program's outputs by what they decrypt to:

- an LWE ciphertext u64 [n+1] under key s decrypts to its phase
  b - <a, s> mod 2^64;
- a GLWE ciphertext u64 [k+1, N] decrypts, at coefficient 0, to
  b_0 - sum_i (a_i (*) s_i)_0, with (a (*) s)_0 = a_0 s_0 - sum_{j>=1} a_j s_{N-j}
  (negacyclic);
- a message m of `bits` bits is encoded as m * 2^(64 - bits); its decision
  boundary lies half a step, 2^(63 - bits), either side.

For each output the check reports whether it decodes to what the
plaintext function gives, and its error: the distance of its phase from
the exact encoding, as a share of the distance to the decision boundary
(below 1 decodes right).
"""

from __future__ import annotations

import numpy as np

_U64 = np.uint64


def lwe_phases(cts: np.ndarray, sk: np.ndarray) -> np.ndarray:
    """Phases b - <a, s> mod 2^64 of LWE ciphertexts u64 [M, n+1] under a
    binary key [n]."""
    cts = np.asarray(cts, dtype=_U64)
    on = np.flatnonzero(np.asarray(sk) != 0)
    return cts[:, -1] - cts[:, on].sum(axis=1, dtype=_U64)


def glwe_phases0(cts: np.ndarray, sk: np.ndarray) -> np.ndarray:
    """Phases at coefficient 0 of GLWE ciphertexts u64 [M, k+1, N] under
    a binary key [k, N]."""
    cts = np.asarray(cts, dtype=_U64)
    sk = np.asarray(sk, dtype=np.int64)
    n = sk.shape[-1]
    # (a (*) s)_0 = a_0 s_0 - sum_{j>=1} a_j s_{N-j}: a dot product with
    # w = (s_0, -s_{N-1}, ..., -s_1)
    w = np.concatenate([sk[:, :1], -sk[:, :0:-1]], axis=1).astype(np.int64).view(_U64)
    dot = (cts[:, :-1, :] * w[None]).sum(axis=(1, 2), dtype=_U64)
    return cts[:, -1, 0] - dot


def decode(phases: np.ndarray, expected: np.ndarray, bits: int):
    """(decoded messages, error share) of phases u64 [M] against the
    expected messages [M] of `bits` bits encoded as m * 2^(64 - bits).
    The error share is |phase - encoding| / 2^(63 - bits)."""
    phases = np.asarray(phases, dtype=_U64)
    shift = _U64(64 - bits)
    rbit = (phases >> _U64(63 - bits)) & _U64(1)
    decoded = ((phases >> shift) + rbit) & _U64((1 << bits) - 1)
    err = (phases - (np.asarray(expected, dtype=_U64) << shift)).view(np.int64)
    share = np.abs(err.astype(np.float64)) / 2.0 ** (63 - bits)
    return decoded.astype(np.int64), share


def add_mod(x: np.ndarray, add: int, bits: int) -> np.ndarray:
    """The LUT function of a bootstrapping cell: (x + add) mod 2^bits."""
    return (np.asarray(x, dtype=np.int64) + add) % (1 << bits)


def integer_op(op: str, a: np.ndarray, b: np.ndarray, out_bits: int) -> np.ndarray:
    """The plaintext result of an encrypted-integer cell, mod 2^out_bits."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    if op == "mul":
        r = a * b
    elif op == "add":
        r = a + b
    else:
        raise ValueError(f"unknown integer op {op!r}")
    return r % (1 << out_bits)
