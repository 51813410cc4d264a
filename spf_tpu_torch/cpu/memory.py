"""32-bit paged virtual memory with plaintext/encrypted bytes and an
ELF32 loader.

(≙ reference `parasol_cpu/src/memory/mod.rs`: 4 KiB pages, little
endian, stack top 0xFFFF8000 with 16 KiB growing down, natural
alignment required, 8-byte instructions, brk-style allocation; ELF
loading maps PT_LOAD segments and resolves STT_FUNC symbols.)

A `Byte` is either a plaintext int in [0, 256) or an `EncByte` holding
8 L1 GLWE bit ciphertext handles (LSB-first). Loads/stores never mix
plaintext and ciphertext bytes within one access
(`memory/mod.rs:117-128,754-812`).

A copy of `spf_tpu/cpu/memory.py`.
"""

from __future__ import annotations

import dataclasses
import struct

from .isa import INSTRUCTION_SIZE, Instr, encode

LOG2_PAGE_SIZE = 12
PAGE_SIZE = 1 << LOG2_PAGE_SIZE
STACK_TOP = 0xFFFF8000
STACK_SIZE = 0x4000  # 16 KiB
SUPPORTED_ABI_VERSION = 3
PARASOL_MACHINE = 0x23E


class MemoryError_(Exception):
    pass


class UnalignedAccess(MemoryError_):
    pass


class AccessViolation(MemoryError_):
    pass


@dataclasses.dataclass
class EncByte:
    """An encrypted byte: 8 GLWE bit ciphertexts, LSB-first."""

    bits: list


Byte = object  # int (plaintext) or EncByte


class Memory:
    def __init__(self):
        self.pages: dict[int, list] = {}
        self._brk = 0x1000  # first page reserved (null)
        # stack (grows down from STACK_TOP)
        for addr in range(STACK_TOP - STACK_SIZE, STACK_TOP, PAGE_SIZE):
            self._map_page(addr >> LOG2_PAGE_SIZE)
        self._sp = STACK_TOP
        self.function_entries: dict[str, int] = {}

    # --- pages ---

    def _map_page(self, page_id: int):
        if page_id not in self.pages:
            self.pages[page_id] = [0] * PAGE_SIZE

    def _page_of(self, addr: int):
        page = self.pages.get(addr >> LOG2_PAGE_SIZE)
        if page is None:
            raise AccessViolation(f"unmapped address 0x{addr:08x}")
        return page

    # --- allocation ---

    def try_allocate(self, size: int, align: int = 16) -> int:
        """brk-style allocation (`memory/mod.rs:598`)."""
        base = (self._brk + align - 1) // align * align
        for addr in range(base, base + max(size, 1), PAGE_SIZE):
            self._map_page(addr >> LOG2_PAGE_SIZE)
        self._map_page((base + max(size, 1) - 1) >> LOG2_PAGE_SIZE)
        self._brk = base + size
        return base

    def allocate_program(self, instrs: list[Instr]) -> int:
        """Write encoded instructions to fresh memory and return the
        entry address (≙ `memory/mod.rs:439` allocate_program)."""
        base = self.try_allocate(len(instrs) * INSTRUCTION_SIZE, align=PAGE_SIZE)
        for i, instr in enumerate(instrs):
            word = encode(instr)
            for b in range(8):
                self.store_byte(base + i * 8 + b, (word >> (8 * b)) & 0xFF)
        return base

    def iter_enc_bytes(self):
        """Yield every EncByte currently stored (architectural ciphertext
        state; used by the processor's deferred-graph flush)."""
        for page in self.pages.values():
            for b in page:
                if isinstance(b, EncByte):
                    yield b

    # --- byte access ---

    def load_byte(self, addr: int):
        return self._page_of(addr)[addr & (PAGE_SIZE - 1)]

    def store_byte(self, addr: int, byte) -> None:
        self._page_of(addr)[addr & (PAGE_SIZE - 1)] = byte

    def load_bytes(self, addr: int, count: int, align_check: bool = True) -> list:
        if align_check and addr % count != 0 and count in (1, 2, 4, 8, 16):
            raise UnalignedAccess(f"0x{addr:08x} % {count}")
        return [self.load_byte(addr + i) for i in range(count)]

    def store_bytes(self, addr: int, data: list, align_check: bool = True) -> None:
        n = len(data)
        if align_check and addr % n != 0 and n in (1, 2, 4, 8, 16):
            raise UnalignedAccess(f"0x{addr:08x} % {n}")
        for i, b in enumerate(data):
            self.store_byte(addr + i, b)

    def try_load_plaintext_dword(self, addr: int) -> int:
        """Instruction fetch: 8 plaintext bytes, little endian."""
        bs = self.load_bytes(addr, 8)
        if any(isinstance(b, EncByte) for b in bs):
            raise MemoryError_("encrypted instruction fetch")
        return sum(b << (8 * i) for i, b in enumerate(bs))

    # --- stack ---

    @property
    def stack_ptr(self) -> int:
        return self._sp

    def try_push_arg_onto_stack(self, data: list, alignment: int) -> int:
        """Push bytes onto the stack with alignment; 16-byte aligned SP
        (`memory/mod.rs:465-497`)."""
        sp = self._sp - len(data)
        sp -= sp % alignment
        sp -= sp % 16
        if sp < STACK_TOP - STACK_SIZE:
            raise AccessViolation("stack overflow")
        for i, b in enumerate(data):
            self.store_byte(sp + i, b)
        self._sp = sp
        return sp

    # --- ELF loading (≙ `memory/mod.rs:325-463`) ---

    @classmethod
    def new_from_elf(cls, data: bytes) -> "Memory":
        mem = cls()
        mem.load_elf(data)
        return mem

    def load_elf(self, data: bytes) -> None:
        if data[:4] != b"\x7fELF":
            raise MemoryError_("not an ELF file")
        ei_class, ei_data, _, _, ei_abiversion = data[4:9]
        if ei_class != 1 or ei_data != 1:
            raise MemoryError_("expected ELF32 little-endian")
        if ei_abiversion != SUPPORTED_ABI_VERSION:
            raise MemoryError_(
                f"unsupported Parasol ABI version {ei_abiversion} "
                f"(supported: {SUPPORTED_ABI_VERSION})"
            )
        (
            _type,
            _machine,
            _version,
            _entry,
            e_phoff,
            e_shoff,
            _flags,
            _ehsize,
            e_phentsize,
            e_phnum,
            e_shentsize,
            e_shnum,
            _shstrndx,
        ) = struct.unpack_from("<HHIIIIIHHHHHH", data, 16)

        # map PT_LOAD segments
        for i in range(e_phnum):
            off = e_phoff + i * e_phentsize
            p_type, p_offset, p_vaddr, _paddr, p_filesz, p_memsz = struct.unpack_from(
                "<IIIIII", data, off
            )
            if p_type != 1:  # PT_LOAD
                continue
            for a in range(p_vaddr, p_vaddr + max(p_memsz, 1), PAGE_SIZE):
                self._map_page(a >> LOG2_PAGE_SIZE)
            self._map_page((p_vaddr + max(p_memsz, 1) - 1) >> LOG2_PAGE_SIZE)
            for j in range(p_filesz):
                self.store_byte(p_vaddr + j, data[p_offset + j])
            self._brk = max(self._brk, p_vaddr + p_memsz)

        # symbol table for function entries
        sections = []
        for i in range(e_shnum):
            off = e_shoff + i * e_shentsize
            sh = struct.unpack_from("<IIIIIIIIII", data, off)
            sections.append(sh)
        for sh in sections:
            sh_type = sh[1]
            if sh_type != 2:  # SHT_SYMTAB
                continue
            sh_offset, sh_size, sh_link, _info, _align, sh_entsize = sh[4:10]
            str_sh = sections[sh_link]
            str_off = str_sh[4]
            for j in range(sh_size // sh_entsize):
                st_name, st_value, _size, st_info = struct.unpack_from(
                    "<IIIB", data, sh_offset + j * sh_entsize
                )
                if st_info & 0xF != 2:  # STT_FUNC
                    continue
                end = data.index(b"\x00", str_off + st_name)
                name = data[str_off + st_name : end].decode()
                self.function_entries[name] = st_value

    def get_function_entry(self, name: str) -> int:
        if name not in self.function_entries:
            raise MemoryError_(f"no such function {name!r}")
        return self.function_entries[name]
