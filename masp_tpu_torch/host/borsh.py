# Copy of masp_tpu/utils/borsh.py, verbatim apart from import paths. The port imports nothing of
# masp_tpu.
"""Borsh primitive codec (https://borsh.io binary format).

Namada consumes masp_primitives through borsh; the reference derives or
hand-writes BorshSerialize/BorshDeserialize for its types
(masp_primitives/src/transaction.rs:352-365, components/amount.rs:203-231,
components/sapling/builder.rs:96-283). This module provides the byte-level
building blocks; type-specific layouts live in
masp_tpu/transaction/borsh_io.py.

Conventions (borsh spec + borsh-rs):
- integers little-endian, fixed width; usize as u64
- Vec<T>: u32 LE count + items
- Option<T>: u8 tag (0 = None, 1 = Some) + payload
- [u8; N]: N raw bytes, no length prefix
- enums: u8 variant tag + payload
"""

from __future__ import annotations

from masp_tpu_torch.host.encoding import Reader, Writer

__all__ = [
    "Reader", "Writer",
    "write_u8", "write_u16", "write_u32", "write_u64", "write_usize",
    "write_i64", "write_i128", "write_vec", "write_option", "write_bytes_fixed",
    "read_u8", "read_u16", "read_u32", "read_u64", "read_usize",
    "read_i64", "read_i128", "read_vec", "read_option", "read_bytes_fixed",
]


def write_u8(w: Writer, v: int) -> None:
    w.write(int(v).to_bytes(1, "little"))


def write_u16(w: Writer, v: int) -> None:
    w.write(int(v).to_bytes(2, "little"))


def write_u32(w: Writer, v: int) -> None:
    w.write(int(v).to_bytes(4, "little"))


def write_u64(w: Writer, v: int) -> None:
    w.write(int(v).to_bytes(8, "little"))


# borsh-rs serializes usize as u64
write_usize = write_u64


def write_i64(w: Writer, v: int) -> None:
    w.write(int(v).to_bytes(8, "little", signed=True))


def write_i128(w: Writer, v: int) -> None:
    w.write(int(v).to_bytes(16, "little", signed=True))


def write_vec(w: Writer, items, write_item) -> None:
    write_u32(w, len(items))
    for item in items:
        write_item(w, item)


def write_option(w: Writer, value, write_value) -> None:
    if value is None:
        write_u8(w, 0)
    else:
        write_u8(w, 1)
        write_value(w, value)


def write_bytes_fixed(w: Writer, data: bytes, n: int) -> None:
    if len(data) != n:
        raise ValueError(f"expected {n} bytes, got {len(data)}")
    w.write(data)


def read_u8(r: Reader) -> int:
    return r.read(1)[0]


def read_u16(r: Reader) -> int:
    return int.from_bytes(r.read(2), "little")


def read_u32(r: Reader) -> int:
    return int.from_bytes(r.read(4), "little")


def read_u64(r: Reader) -> int:
    return int.from_bytes(r.read(8), "little")


read_usize = read_u64


def read_i64(r: Reader) -> int:
    return int.from_bytes(r.read(8), "little", signed=True)


def read_i128(r: Reader) -> int:
    return int.from_bytes(r.read(16), "little", signed=True)


def read_vec(r: Reader, read_item) -> list:
    n = read_u32(r)
    return [read_item(r) for _ in range(n)]


def read_option(r: Reader, read_value):
    tag = read_u8(r)
    if tag == 0:
        return None
    if tag == 1:
        return read_value(r)
    raise ValueError(f"invalid Option tag {tag}")


def read_bytes_fixed(r: Reader, n: int) -> bytes:
    return r.read(n)
