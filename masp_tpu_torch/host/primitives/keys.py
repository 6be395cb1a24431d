# Copy of masp_tpu/primitives/keys.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""Key hierarchy: PRF^expand and Sapling expanded/viewing keys.

Mirrors masp_primitives/src/keys.rs and masp_primitives/src/sapling/keys.rs.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from masp_tpu_torch.host.jubjub import ExtendedPoint, subgroup_from_bytes
from masp_tpu_torch.host.fields import JubjubFr

PRF_EXPAND_PERSONALIZATION = b"MASP__ExpandSeed"


def prf_expand(sk: bytes, t: bytes) -> bytes:
    """PRF^expand(sk, t) := BLAKE2b-512("MASP__ExpandSeed", sk || t)."""
    return prf_expand_vec(sk, [t])


def prf_expand_vec(sk: bytes, ts: list[bytes]) -> bytes:
    h = hashlib.blake2b(digest_size=64, person=PRF_EXPAND_PERSONALIZATION)
    h.update(sk)
    for t in ts:
        h.update(t)
    return h.digest()


@dataclass(frozen=True)
class OutgoingViewingKey:
    data: bytes  # 32 bytes

    def __post_init__(self):
        assert len(self.data) == 32


@dataclass
class ExpandedSpendingKey:
    """{ask, nsk, ovk} derived from sk via PRF^expand t=0x00/0x01/0x02
    (sapling/keys.rs:64-79)."""

    ask: JubjubFr
    nsk: JubjubFr
    ovk: OutgoingViewingKey

    @staticmethod
    def from_spending_key(sk: bytes) -> "ExpandedSpendingKey":
        ask = JubjubFr.from_bytes_wide(prf_expand(sk, b"\x00"))
        nsk = JubjubFr.from_bytes_wide(prf_expand(sk, b"\x01"))
        ovk = OutgoingViewingKey(prf_expand(sk, b"\x02")[:32])
        return ExpandedSpendingKey(ask, nsk, ovk)

    def proof_generation_key(self) -> "ProofGenerationKey":
        from masp_tpu_torch.host.primitives.constants import spending_key_generator
        from masp_tpu_torch.host.primitives.sapling import ProofGenerationKey

        return ProofGenerationKey(ak=spending_key_generator() * self.ask, nsk=self.nsk)

    def to_bytes(self) -> bytes:
        return self.ask.to_bytes() + self.nsk.to_bytes() + self.ovk.data

    @staticmethod
    def from_bytes(b: bytes) -> "ExpandedSpendingKey":
        if len(b) != 96:
            raise ValueError(f"expected 96 bytes, got {len(b)}")
        ask = JubjubFr.from_bytes(b[0:32])
        if ask is None:
            raise ValueError("ask not in field")
        nsk = JubjubFr.from_bytes(b[32:64])
        if nsk is None:
            raise ValueError("nsk not in field")
        return ExpandedSpendingKey(ask, nsk, OutgoingViewingKey(b[64:96]))


@dataclass
class FullViewingKey:
    """{vk, ovk} (sapling/keys.rs:134-220)."""

    vk: "ViewingKey"
    ovk: OutgoingViewingKey

    @staticmethod
    def from_expanded_spending_key(expsk: ExpandedSpendingKey) -> "FullViewingKey":
        from masp_tpu_torch.host.primitives.constants import (
            proof_generation_key_generator,
            spending_key_generator,
        )
        from masp_tpu_torch.host.primitives.sapling import NullifierDerivingKey, ViewingKey

        return FullViewingKey(
            vk=ViewingKey(
                ak=spending_key_generator() * expsk.ask,
                nk=NullifierDerivingKey(proof_generation_key_generator() * expsk.nsk),
            ),
            ovk=expsk.ovk,
        )

    def to_bytes(self) -> bytes:
        return self.vk.ak.to_bytes() + self.vk.nk.point.to_bytes() + self.ovk.data

    @staticmethod
    def from_bytes(b: bytes) -> "FullViewingKey":
        from masp_tpu_torch.host.primitives.sapling import NullifierDerivingKey, ViewingKey

        if len(b) != 96:
            raise ValueError("expected 96 bytes")
        ak = subgroup_from_bytes(b[0:32])
        if ak is None or ak.is_identity():
            raise ValueError("ak not of prime order")
        nk = subgroup_from_bytes(b[32:64])
        if nk is None:
            raise ValueError("nk not in prime-order subgroup")
        return FullViewingKey(
            vk=ViewingKey(ak=ak, nk=NullifierDerivingKey(nk)),
            ovk=OutgoingViewingKey(b[64:96]),
        )


__all__ = [
    "PRF_EXPAND_PERSONALIZATION", "prf_expand", "prf_expand_vec",
    "OutgoingViewingKey", "ExpandedSpendingKey", "FullViewingKey",
]
