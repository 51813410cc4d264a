"""Argument serialization for the stack-based ABI.

(≙ reference `parasol_cpu/src/proc/args.rs`: `ToArg` byte serialization
of plaintext + encrypted values, `ArgsBuilder` -> `CallData`.)

Plaintext values serialize little-endian; encrypted integers serialize
as one `EncByte` (8 GLWE bit handles) per byte.

A copy of `spf_tpu/cpu/args.py`. `decrypt_return` takes an encryption
object with `decrypt_glwe_l1(bit_ct, sk)`: the u64 API's
`runtime.encryption.Encryption` (`ev.enc`), which reads tensor and host
numpy handles alike; `utils.host_crypto.decrypt_uint_bits_np` over each
`EncByte`'s bits decrypts host handles without it.
"""

from __future__ import annotations

import dataclasses

from .memory import EncByte


@dataclasses.dataclass
class Arg:
    alignment: int
    bytes: list


@dataclasses.dataclass
class CallData:
    args: list
    return_size: int
    return_alignment: int
    return_encrypted: bool

    def alloc_size(self) -> int:
        """(`args.rs:515-530`)"""
        offset = 0
        for arg in self.args:
            offset = -(-offset // arg.alignment) * arg.alignment
            offset += len(arg.bytes)
        if self.return_size > 0:
            offset = -(-offset // self.return_alignment) * self.return_alignment
            offset += self.return_size
        return -(-offset // 16) * 16


def _nbytes(width: int) -> int:
    return (width + 7) // 8


def _alignment(width: int) -> int:
    n = _nbytes(width)
    for a in (16, 8, 4, 2, 1):
        if n >= a:
            return a
    return 1


class ArgsBuilder:
    """(≙ `args.rs:425` ArgsBuilder)"""

    def __init__(self):
        self._args: list[Arg] = []
        self._ret = (0, 1, False)

    def arg(self, value: int, width: int) -> "ArgsBuilder":
        """A plaintext integer argument."""
        n = _nbytes(width)
        bs = [(value >> (8 * i)) & 0xFF for i in range(n)]
        self._args.append(Arg(alignment=_alignment(width), bytes=bs))
        return self

    def arg_encrypted(self, bit_cts: list) -> "ArgsBuilder":
        """An encrypted integer argument given as GLWE bit ciphertexts
        (LSB-first; width = len(bit_cts), must be a multiple of 8)."""
        assert len(bit_cts) % 8 == 0
        bs = [EncByte(bit_cts[8 * i : 8 * i + 8]) for i in range(len(bit_cts) // 8)]
        self._args.append(Arg(alignment=_alignment(len(bit_cts)), bytes=bs))
        return self

    def arg_bytes(self, data: bytes, alignment: int = None) -> "ArgsBuilder":
        """A raw plaintext struct argument (≙ `derive(IntoBytes)`,
        `parasol_cpu_macros/src/lib.rs:11-25`): the caller serializes
        the struct little-endian, field by field."""
        self._args.append(
            Arg(alignment=alignment or _alignment(len(data) * 8), bytes=list(data))
        )
        return self

    def arg_struct(self, fields) -> "ArgsBuilder":
        """A plaintext struct from (value, width_bits) fields, packed in
        order with natural per-field alignment."""
        out = []
        for value, width in fields:
            n = _nbytes(width)
            align = _alignment(width)
            while len(out) % align:
                out.append(0)
            out.extend((value >> (8 * i)) & 0xFF for i in range(n))
        self._args.append(Arg(alignment=16, bytes=out))
        return self

    def return_value(self, width: int, encrypted: bool = True) -> "ArgsBuilder":
        self._ret = (_nbytes(width), _alignment(width), encrypted)
        return self

    def no_return_value(self) -> "ArgsBuilder":
        self._ret = (0, 1, False)
        return self

    def build(self) -> CallData:
        size, align, encrypted = self._ret
        return CallData(
            args=list(self._args),
            return_size=size,
            return_alignment=align,
            return_encrypted=encrypted,
        )


def read_return_bytes(memory, return_ptr: int, size: int) -> list:
    """Raw return bytes (plaintext ints and/or EncBytes)."""
    return [memory.load_byte(return_ptr + i) for i in range(size)]


def decode_plaintext_return(memory, return_ptr: int, size: int) -> int:
    bs = read_return_bytes(memory, return_ptr, size)
    assert all(isinstance(b, int) for b in bs), "return value is encrypted"
    return sum(b << (8 * i) for i, b in enumerate(bs))


def decrypt_return(memory, return_ptr: int, size: int, encryption, sk) -> int:
    """Decrypt an encrypted return value via the host-side secret key."""
    bs = read_return_bytes(memory, return_ptr, size)
    value = 0
    for i, b in enumerate(bs):
        if isinstance(b, EncByte):
            for j, bit_ct in enumerate(b.bits):
                value |= int(encryption.decrypt_glwe_l1(bit_ct, sk)[0]) << (8 * i + j)
        else:
            value |= b << (8 * i)
    return value
