# Copy of masp_tpu/utils/encoding.py, verbatim apart from import paths; the port imports nothing of
# masp_tpu.
"""Byte-stream helpers: CompactSize / Vector (zcash_encoding semantics) and
small read/write utilities shared by the transaction layer."""

from __future__ import annotations

import io


class Reader:
    def __init__(self, data: bytes | io.BufferedIOBase):
        self._r = io.BytesIO(data) if isinstance(data, (bytes, bytearray)) else data

    def read(self, n: int) -> bytes:
        b = self._r.read(n)
        if len(b) != n:
            raise ValueError(f"unexpected end of stream (wanted {n}, got {len(b)})")
        return b

    def u8(self) -> int:
        return self.read(1)[0]

    def u32_le(self) -> int:
        return int.from_bytes(self.read(4), "little")

    def u64_le(self) -> int:
        return int.from_bytes(self.read(8), "little")

    def i64_le(self) -> int:
        return int.from_bytes(self.read(8), "little", signed=True)

    def i128_le(self) -> int:
        return int.from_bytes(self.read(16), "little", signed=True)

    def compact_size(self) -> int:
        """CompactSize with canonicity checks (zcash_encoding)."""
        flag = self.u8()
        if flag < 253:
            return flag
        if flag == 253:
            n = int.from_bytes(self.read(2), "little")
            if n < 253:
                raise ValueError("non-canonical CompactSize")
            return n
        if flag == 254:
            n = int.from_bytes(self.read(4), "little")
            if n < 0x10000:
                raise ValueError("non-canonical CompactSize")
            return n
        n = int.from_bytes(self.read(8), "little")
        if n < 0x100000000:
            raise ValueError("non-canonical CompactSize")
        if n > 0x02000000:
            raise ValueError("CompactSize too large")
        return n

    def remaining(self) -> bytes:
        return self._r.read()


class Writer:
    def __init__(self):
        self._w = io.BytesIO()

    def write(self, data: bytes) -> "Writer":
        self._w.write(data)
        return self

    def u8(self, v: int) -> "Writer":
        return self.write(bytes([v]))

    def u32_le(self, v: int) -> "Writer":
        return self.write(v.to_bytes(4, "little"))

    def u64_le(self, v: int) -> "Writer":
        return self.write(v.to_bytes(8, "little"))

    def i64_le(self, v: int) -> "Writer":
        return self.write(v.to_bytes(8, "little", signed=True))

    def i128_le(self, v: int) -> "Writer":
        return self.write(v.to_bytes(16, "little", signed=True))

    def compact_size(self, n: int) -> "Writer":
        if n < 253:
            return self.u8(n)
        if n <= 0xFFFF:
            return self.u8(253).write(n.to_bytes(2, "little"))
        if n <= 0xFFFFFFFF:
            return self.u8(254).write(n.to_bytes(4, "little"))
        return self.u8(255).write(n.to_bytes(8, "little"))

    def getvalue(self) -> bytes:
        return self._w.getvalue()


def write_vector(w: Writer, items, write_item) -> None:
    w.compact_size(len(items))
    for it in items:
        write_item(w, it)


def read_vector(r: Reader, read_item) -> list:
    n = r.compact_size()
    return [read_item(r) for _ in range(n)]


__all__ = ["Reader", "Writer", "write_vector", "read_vector"]
