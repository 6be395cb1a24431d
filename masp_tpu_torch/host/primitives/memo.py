# Copy of masp_tpu/primitives/memo.py, verbatim apart from import paths. The port imports nothing of
# masp_tpu.
"""Memo field (masp_primitives/src/memo.rs): 512-byte memo with typed views."""

from __future__ import annotations


class MemoBytes:
    """Raw 512-byte memo, trailing zeros stripped for equality of content."""

    SIZE = 512

    __slots__ = ("data",)

    def __init__(self, data: bytes):
        assert len(data) == self.SIZE
        self.data = data

    @staticmethod
    def empty() -> "MemoBytes":
        return MemoBytes(b"\xf6" + b"\x00" * 511)

    @staticmethod
    def from_bytes(data: bytes) -> "MemoBytes":
        if len(data) > MemoBytes.SIZE:
            raise ValueError("memo too long")
        return MemoBytes(data + b"\x00" * (MemoBytes.SIZE - len(data)))

    def as_array(self) -> bytes:
        return self.data

    def __eq__(self, other):
        return isinstance(other, MemoBytes) and self.data == other.data

    def __hash__(self):
        return hash(self.data)


class Memo:
    """Typed memo: Empty | Text(str) | Future(bytes) | Arbitrary(bytes)."""

    EMPTY, TEXT, FUTURE, ARBITRARY = range(4)

    def __init__(self, kind: int, text: str = "", raw: bytes = b""):
        self.kind = kind
        self.text = text
        self.raw = raw

    @staticmethod
    def from_memo_bytes(mb: MemoBytes) -> "Memo":
        data = mb.data
        first = data[0]
        stripped = data.rstrip(b"\x00")
        if first == 0xF6 and stripped == b"\xf6":
            return Memo(Memo.EMPTY)
        if first <= 0xF4:
            try:
                return Memo(Memo.TEXT, text=stripped.decode("utf-8"))
            except UnicodeDecodeError:
                raise ValueError("invalid UTF-8 in text memo")
        if first == 0xFF:
            return Memo(Memo.ARBITRARY, raw=data[1:])
        return Memo(Memo.FUTURE, raw=data)

    def to_memo_bytes(self) -> MemoBytes:
        if self.kind == Memo.EMPTY:
            return MemoBytes.empty()
        if self.kind == Memo.TEXT:
            return MemoBytes.from_bytes(self.text.encode("utf-8"))
        if self.kind == Memo.ARBITRARY:
            return MemoBytes.from_bytes(b"\xff" + self.raw)
        return MemoBytes(self.raw)

    def __eq__(self, other):
        return (
            isinstance(other, Memo)
            and self.kind == other.kind
            and self.text == other.text
            and self.raw == other.raw
        )


__all__ = ["MemoBytes", "Memo"]
