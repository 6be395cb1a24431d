# Copy of masp_tpu/transaction/components/transparent.py, verbatim apart from import paths. The port imports nothing of
# masp_tpu.
"""Transparent components: MASP's simplified 20-byte-address transparent
layer (masp_primitives/src/transaction/components/transparent.rs)."""

from __future__ import annotations

from dataclasses import dataclass

from masp_tpu_torch.host.primitives.asset_type import AssetType
from masp_tpu_torch.host.transaction.amount import I128, MAX_MONEY, ValueSum
from masp_tpu_torch.host.encoding import Reader, Writer


@dataclass(frozen=True)
class TransparentAddress:
    data: bytes  # 20 bytes

    def __post_init__(self):
        assert len(self.data) == 20


@dataclass
class TxIn:
    asset_type: AssetType
    value: int
    address: TransparentAddress
    transparent_sig: object = None  # () for Authorized

    @staticmethod
    def read(r: Reader) -> "TxIn":
        atype = AssetType.from_identifier(r.read(32))
        if atype is None:
            raise ValueError("invalid asset type")
        value = r.u64_le()
        if value > MAX_MONEY:
            raise ValueError("value out of range")
        address = TransparentAddress(r.read(20))
        return TxIn(atype, value, address)

    def write(self, w: Writer) -> None:
        w.write(self.asset_type.get_identifier())
        w.u64_le(self.value)
        w.write(self.address.data)

    def __eq__(self, other):
        return (
            isinstance(other, TxIn)
            and self.asset_type == other.asset_type
            and self.value == other.value
            and self.address == other.address
        )


@dataclass
class TxOut:
    asset_type: AssetType
    value: int
    address: TransparentAddress

    @staticmethod
    def read(r: Reader) -> "TxOut":
        atype = AssetType.from_identifier(r.read(32))
        if atype is None:
            raise ValueError("invalid asset type")
        value = r.u64_le()
        if value > MAX_MONEY:
            raise ValueError("value out of range")
        address = TransparentAddress(r.read(20))
        return TxOut(atype, value, address)

    def write(self, w: Writer) -> None:
        w.write(self.asset_type.get_identifier())
        w.u64_le(self.value)
        w.write(self.address.data)

    def __eq__(self, other):
        return (
            isinstance(other, TxOut)
            and self.asset_type == other.asset_type
            and self.value == other.value
            and self.address == other.address
        )


@dataclass
class Bundle:
    vin: list[TxIn]
    vout: list[TxOut]
    authorization: object = None

    def value_balance(self) -> ValueSum:
        total = ValueSum.zero(I128)
        for t in self.vin:
            total = total + ValueSum.from_pair(t.asset_type, t.value, I128)
        for t in self.vout:
            total = total - ValueSum.from_pair(t.asset_type, t.value, I128)
        return total

    def __eq__(self, other):
        return isinstance(other, Bundle) and self.vin == other.vin and self.vout == other.vout


__all__ = ["TransparentAddress", "TxIn", "TxOut", "Bundle"]
