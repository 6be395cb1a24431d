# Copy of masp_tpu/transaction/components/transparent_builder.py, verbatim apart from import paths. The port imports nothing of
# masp_tpu.
"""Transparent bundle builder
(masp_primitives/src/transaction/components/transparent/builder.rs)."""

from __future__ import annotations

from masp_tpu_torch.host.primitives.asset_type import AssetType
from masp_tpu_torch.host.transaction.amount import I128, MAX_MONEY, ValueSum
from masp_tpu_torch.host.transaction.components.transparent import (
    Bundle, TransparentAddress, TxIn, TxOut,
)


class TransparentBuilderError(Exception):
    pass


class TransparentBuilder:
    def __init__(self):
        self.vin: list[TxIn] = []
        self.vout: list[TxOut] = []

    def add_input(self, coin: TxOut) -> None:
        if coin.value > MAX_MONEY:
            raise TransparentBuilderError("invalid amount")
        self.vin.append(
            TxIn(asset_type=coin.asset_type, value=coin.value, address=coin.address)
        )

    def add_output(self, to: TransparentAddress, asset_type: AssetType, value: int) -> None:
        if value > MAX_MONEY:
            raise TransparentBuilderError("invalid amount")
        self.vout.append(TxOut(asset_type=asset_type, value=value, address=to))

    def outputs(self) -> list[TxOut]:
        return self.vout

    def value_balance(self) -> ValueSum:
        total = ValueSum.zero(I128)
        for t in self.vin:
            total = total + ValueSum.from_pair(t.asset_type, t.value, I128)
        for t in self.vout:
            total = total - ValueSum.from_pair(t.asset_type, t.value, I128)
        return total

    def build(self) -> Bundle | None:
        if not self.vin and not self.vout:
            return None
        return Bundle(vin=list(self.vin), vout=list(self.vout))


__all__ = ["TransparentBuilder", "TransparentBuilderError"]
