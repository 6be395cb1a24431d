# Copy of masp_tpu/primitives/asset_type.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""Multi-asset type identifiers (the core MASP extension over Sapling).

Mirrors masp_primitives/src/asset_type.rs: 32-byte identifier =
BLAKE2s("MASP__t_", GH_FIRST_BLOCK || name || nonce), rejection-sampled so
BLAKE2s("MASP__v_", id) decodes to a non-small-order Jubjub point.
"""

from __future__ import annotations

import hashlib

from masp_tpu_torch.host.jubjub import ExtendedPoint
from masp_tpu_torch.host.fields import JubjubFr
from masp_tpu_torch.host.primitives.constants import (
    ASSET_IDENTIFIER_LENGTH,
    ASSET_IDENTIFIER_PERSONALIZATION,
    GH_FIRST_BLOCK,
    VALUE_COMMITMENT_GENERATOR_PERSONALIZATION,
)


def _hash_to_point(identifier: bytes) -> ExtendedPoint | None:
    """BLAKE2s("MASP__v_", id) -> point; None if invalid or small order.
    Returns the point WITHOUT clearing the cofactor (asset_type.rs:70-102)."""
    h = hashlib.blake2s(
        digest_size=32, person=VALUE_COMMITMENT_GENERATOR_PERSONALIZATION
    )
    h.update(identifier)
    p = ExtendedPoint.from_bytes(h.digest())
    if p is None:
        return None
    if p.clear_cofactor().is_identity():
        return None
    return p


class AssetType:
    __slots__ = ("identifier", "nonce")

    def __init__(self, identifier: bytes, nonce: int | None = None):
        assert len(identifier) == ASSET_IDENTIFIER_LENGTH
        self.identifier = identifier
        self.nonce = nonce

    @staticmethod
    def new(name: bytes) -> "AssetType":
        nonce = 0
        while True:
            at = AssetType.new_with_nonce(name, nonce)
            if at is not None:
                return at
            nonce += 1
            if nonce > 255:
                raise ValueError("nonce overflow")

    @staticmethod
    def new_with_nonce(name: bytes, nonce: int) -> "AssetType | None":
        h = hashlib.blake2s(
            digest_size=ASSET_IDENTIFIER_LENGTH,
            person=ASSET_IDENTIFIER_PERSONALIZATION,
        )
        h.update(GH_FIRST_BLOCK)
        h.update(name)
        h.update(bytes([nonce]))
        ident = h.digest()
        if _hash_to_point(ident) is not None:
            return AssetType(ident, nonce)
        return None

    @staticmethod
    def from_identifier(identifier: bytes) -> "AssetType | None":
        if _hash_to_point(identifier) is not None:
            return AssetType(identifier, None)
        return None

    def get_identifier(self) -> bytes:
        return self.identifier

    def asset_generator(self) -> ExtendedPoint:
        """Asset generator, cofactor NOT cleared."""
        p = _hash_to_point(self.identifier)
        assert p is not None, "AssetType internal identifier state inconsistent"
        return p

    def value_commitment_generator(self) -> ExtendedPoint:
        return self.asset_generator().clear_cofactor()

    def identifier_bits(self) -> list[bool]:
        return [(b >> i) & 1 == 1 for b in self.identifier for i in range(8)]

    def value_commitment(self, value: int, randomness: JubjubFr):
        from masp_tpu_torch.host.primitives.sapling import ValueCommitment

        return ValueCommitment(
            asset_generator=self.asset_generator(), value=value, randomness=randomness
        )

    # identity / ordering by identifier
    def __eq__(self, other):
        return isinstance(other, AssetType) and self.identifier == other.identifier

    def __lt__(self, other):
        return self.identifier < other.identifier

    def __le__(self, other):
        return self.identifier <= other.identifier

    def __hash__(self):
        return hash(self.identifier)

    def __repr__(self):
        return f"AssetType({self.identifier.hex()})"


__all__ = ["AssetType"]
