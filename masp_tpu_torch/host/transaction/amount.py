# Copy of masp_tpu/transaction/amount.py, verbatim apart from import paths; the port imports nothing of
# masp_tpu.
"""Multi-asset value sums (masp_primitives/src/transaction/components/amount.rs).

``ValueSum`` is an ordered map asset-type -> amount with zero components
dropped; typed variants (I8Sum..I128Sum etc.) carry checked-range semantics.
"""

from __future__ import annotations

from masp_tpu_torch.host.primitives.asset_type import AssetType
from masp_tpu_torch.host.encoding import Reader, Writer, read_vector, write_vector

MAX_MONEY = 2**64 - 1


class BalanceError(Exception):
    OVERFLOW = "overflow"
    UNDERFLOW = "underflow"

    def __init__(self, kind: str):
        super().__init__(f"ValueSum {kind} outside the valid range")
        self.kind = kind


class ValueType:
    """Value-type spec: bit width + signedness (i8..u128)."""

    def __init__(self, bits: int, signed: bool):
        self.bits = bits
        self.signed = signed
        if signed:
            self.min = -(1 << (bits - 1))
            self.max = (1 << (bits - 1)) - 1
        else:
            self.min = 0
            self.max = (1 << bits) - 1

    def check(self, v: int) -> int:
        if v > self.max:
            raise BalanceError(BalanceError.OVERFLOW)
        if v < self.min:
            raise BalanceError(BalanceError.UNDERFLOW)
        return v

    def fits(self, v: int) -> bool:
        return self.min <= v <= self.max


I8, U8 = ValueType(8, True), ValueType(8, False)
I16, U16 = ValueType(16, True), ValueType(16, False)
I32, U32 = ValueType(32, True), ValueType(32, False)
I64, U64 = ValueType(64, True), ValueType(64, False)
I128, U128 = ValueType(128, True), ValueType(128, False)


class ValueSum:
    """Ordered (by asset identifier) map of non-zero amounts."""

    __slots__ = ("vtype", "_map")

    def __init__(self, vtype: ValueType, components: dict | None = None):
        self.vtype = vtype
        self._map: dict[AssetType, int] = {}
        if components:
            for k, v in components.items():
                if v != 0:
                    self._map[k] = vtype.check(v)

    # --- constructors -----------------------------------------------------
    @classmethod
    def zero(cls, vtype: ValueType = I128) -> "ValueSum":
        return cls(vtype)

    @classmethod
    def from_pair(cls, atype: AssetType, amount: int, vtype: ValueType = I128) -> "ValueSum":
        vtype.check(amount)
        return cls(vtype, {atype: amount})

    @classmethod
    def from_nonnegative(cls, atype: AssetType, amount: int, vtype: ValueType = I128) -> "ValueSum":
        if amount < 0:
            raise ValueError("negative amount")
        return cls.from_pair(atype, amount, vtype)

    def with_type(self, vtype: ValueType) -> "ValueSum":
        """try_from_sum / from_sum: re-type, checking each component."""
        return ValueSum(vtype, dict(self._map))

    # --- accessors --------------------------------------------------------
    def is_zero(self) -> bool:
        return not self._map

    def get(self, atype: AssetType) -> int:
        return self._map.get(atype, 0)

    __getitem__ = get

    def components(self):
        """Iterate (asset, amount) ordered by asset identifier (BTreeMap)."""
        return sorted(self._map.items(), key=lambda kv: kv[0].identifier)

    def asset_types(self):
        return [k for k, _v in self.components()]

    def project(self, atype: AssetType) -> "ValueSum":
        return ValueSum.from_pair(atype, self.get(atype), self.vtype) if self.get(atype) else ValueSum(self.vtype)

    def reject(self, atype: AssetType) -> "ValueSum":
        m = dict(self._map)
        m.pop(atype, None)
        return ValueSum(self.vtype, m)

    # --- lattice ----------------------------------------------------------
    def inf(self, rhs: "ValueSum") -> "ValueSum":
        comps = {}
        for atype, r in rhs._map.items():
            l = self.get(atype)
            if l <= r and l != 0:
                comps[atype] = l
            elif l > r and r != 0:
                comps[atype] = r
        return ValueSum(self.vtype, comps)

    def sup(self, rhs: "ValueSum") -> "ValueSum":
        comps = {}
        for atype, r in rhs._map.items():
            l = self.get(atype)
            if l <= r and r != 0:
                comps[atype] = r
            elif l > r and l != 0:
                comps[atype] = l
        return ValueSum(self.vtype, comps)

    # --- arithmetic (checked against the value type) ----------------------
    def __add__(self, rhs: "ValueSum") -> "ValueSum":
        m = dict(self._map)
        for atype, v in rhs._map.items():
            nv = m.get(atype, 0) + v
            if nv == 0:
                m.pop(atype, None)
            else:
                m[atype] = self.vtype.check(nv)
        return ValueSum(self.vtype, m)

    def __sub__(self, rhs: "ValueSum") -> "ValueSum":
        return self + (-rhs)

    def __neg__(self) -> "ValueSum":
        return ValueSum(self.vtype, {k: self.vtype.check(-v) for k, v in self._map.items()})

    def __mul__(self, k: int) -> "ValueSum":
        return ValueSum(self.vtype, {a: self.vtype.check(v * k) for a, v in self._map.items()})

    def dot(self, rhs: "ValueSum") -> int:
        """Sum over assets of lhs[a] * rhs[a] (the Mul<&ValueSum> impl)."""
        out = 0
        for atype, v in rhs._map.items():
            out = self.vtype.check(out + self.get(atype) * v)
        return out

    # --- comparisons ------------------------------------------------------
    def __eq__(self, other):
        return isinstance(other, ValueSum) and self._map == other._map

    def __hash__(self):
        return hash(tuple(sorted((k.identifier, v) for k, v in self._map.items())))

    def partial_cmp(self, other: "ValueSum"):
        """Pointwise partial order: returns -1/0/1 or None if incomparable."""
        keys = set(self._map) | set(other._map)
        sign = 0
        for k in keys:
            d = self.get(k) - other.get(k)
            if d == 0:
                continue
            s = 1 if d > 0 else -1
            if sign == 0:
                sign = s
            elif sign != s:
                return None
        return sign

    def __le__(self, other):
        c = self.partial_cmp(other)
        return c is not None and c <= 0

    def __ge__(self, other):
        c = self.partial_cmp(other)
        return c is not None and c >= 0

    def __repr__(self):
        inner = ", ".join(f"{k.identifier.hex()[:8]}..: {v}" for k, v in self.components())
        return f"ValueSum({{{inner}}})"

    # --- serialization (Vector of (asset, value-LE)) ----------------------
    def write(self, w: Writer) -> None:
        nbytes = self.vtype.bits // 8

        def write_item(w: Writer, kv):
            atype, v = kv
            w.write(atype.identifier)
            w.write(v.to_bytes(nbytes, "little", signed=self.vtype.signed))

        write_vector(w, self.components(), write_item)

    @classmethod
    def read(cls, r: Reader, vtype: ValueType = I128) -> "ValueSum":
        nbytes = vtype.bits // 8

        def read_item(r: Reader):
            ident = r.read(32)
            atype = AssetType.from_identifier(ident)
            if atype is None:
                raise ValueError("invalid asset type")
            v = int.from_bytes(r.read(nbytes), "little", signed=vtype.signed)
            return (atype, v)

        items = read_vector(r, read_item)
        out = cls.zero(vtype)
        for atype, v in items:
            out = out + cls.from_pair(atype, v, vtype)
        return out

    def to_bytes(self) -> bytes:
        w = Writer()
        self.write(w)
        return w.getvalue()


def zec() -> AssetType:
    return AssetType.new(b"ZEC")


def default_fee() -> ValueSum:
    """DEFAULT_FEE: 1000 of asset "ZEC" (amount.rs:19-21)."""
    return ValueSum.from_pair(zec(), 1000, U64)


__all__ = [
    "MAX_MONEY", "BalanceError", "ValueType", "ValueSum",
    "I8", "U8", "I16", "U16", "I32", "U32", "I64", "U64", "I128", "U128",
    "zec", "default_fee",
]
