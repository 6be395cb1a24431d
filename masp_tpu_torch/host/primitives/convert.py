# Copy of masp_tpu/primitives/convert.py, verbatim apart from import paths; the port imports nothing of
# masp_tpu.
"""AllowedConversion: homomorphic multi-asset conversion notes
(masp_primitives/src/convert.rs)."""

from __future__ import annotations

from masp_tpu_torch.host.jubjub import ExtendedPoint
from masp_tpu_torch.host.fields import JubjubFr, Scalar
from masp_tpu_torch.host.primitives.pedersen import Personalization, pedersen_hash
from masp_tpu_torch.host.primitives.sapling import Node, ValueCommitment
from masp_tpu_torch.host.transaction.amount import I128, ValueSum
from masp_tpu_torch.host.encoding import Reader, Writer


class AllowedConversion:
    """assets (I128Sum) + memoized generator sum_i [value_i] asset_gen_i."""

    __slots__ = ("assets", "generator")

    def __init__(self, assets: ValueSum, generator: ExtendedPoint):
        self.assets = assets
        self.generator = generator

    @staticmethod
    def from_assets(assets: ValueSum) -> "AllowedConversion":
        gen = ExtendedPoint.identity()
        for asset, value in assets.components():
            abs_v = abs(value)
            vb = asset.asset_generator() * JubjubFr(abs_v)
            if value < 0:
                vb = -vb
            gen = gen + vb
        return AllowedConversion(assets, gen)

    @staticmethod
    def uncommitted() -> Scalar:
        return Scalar(1)

    def cm_full_point(self) -> ExtendedPoint:
        gen_bytes = self.generator.to_bytes()
        bits = [(b >> i) & 1 == 1 for b in gen_bytes for i in range(8)]
        return pedersen_hash(Personalization.note_commitment(), bits)

    def cmu(self) -> Scalar:
        u, _v = self.cm_full_point().to_affine()
        return u

    def commitment(self) -> Node:
        return Node.from_scalar(self.cmu())

    def value_commitment(self, value: int, randomness: JubjubFr) -> ValueCommitment:
        return ValueCommitment(
            asset_generator=self.generator, value=value, randomness=randomness
        )

    # homomorphic ops
    def __add__(self, rhs: "AllowedConversion") -> "AllowedConversion":
        return AllowedConversion(self.assets + rhs.assets, self.generator + rhs.generator)

    def __sub__(self, rhs: "AllowedConversion") -> "AllowedConversion":
        return AllowedConversion(self.assets - rhs.assets, self.generator - rhs.generator)

    def __neg__(self) -> "AllowedConversion":
        return AllowedConversion(-self.assets, -self.generator)

    def __eq__(self, other):
        return (
            isinstance(other, AllowedConversion)
            and self.assets == other.assets
            and self.generator == other.generator
        )

    # serialization: assets (I128 legacy write) + generator bytes; checked
    # deserialization recomputes the generator (convert.rs:146-160)
    def write(self, w: Writer) -> None:
        self.assets.write(w)
        w.write(self.generator.to_bytes())

    @staticmethod
    def read(r: Reader) -> "AllowedConversion":
        unchecked = UncheckedAllowedConversion.read(r)
        safe = AllowedConversion.from_assets(unchecked.assets)
        if safe.generator != unchecked.generator:
            raise ValueError("generator does not match asset sum")
        return safe

    def to_bytes(self) -> bytes:
        w = Writer()
        self.write(w)
        return w.getvalue()


class UncheckedAllowedConversion:
    """Deserializer that trusts the stored generator (convert.rs:217-232)."""

    def __init__(self, conversion: AllowedConversion):
        self.conversion = conversion

    @property
    def assets(self):
        return self.conversion.assets

    @property
    def generator(self):
        return self.conversion.generator

    @staticmethod
    def read(r: Reader) -> "UncheckedAllowedConversion":
        assets = ValueSum.read(r, I128)
        gen = ExtendedPoint.from_bytes(r.read(32))
        if gen is None:
            raise ValueError("invalid generator point")
        return UncheckedAllowedConversion(AllowedConversion(assets, gen))


__all__ = ["AllowedConversion", "UncheckedAllowedConversion"]
