# Copy of masp_tpu/primitives/sapling.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""Sapling core: notes, nullifiers, value commitments, keys, Merkle node hash.

Mirrors masp_primitives/src/sapling.rs (tree depth 32, merkle_hash, Node,
EMPTY_ROOTS, spend_sig, ValueCommitment, ProofGenerationKey, ViewingKey,
SaplingIvk, Diversifier, PaymentAddress, Rseed, Nullifier, Note).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from functools import lru_cache

from masp_tpu_torch.host.jubjub import ExtendedPoint, subgroup_from_bytes
from masp_tpu_torch.host.fields import JubjubFr, Scalar
from masp_tpu_torch.host.primitives import constants
from masp_tpu_torch.host.primitives.group_hash import group_hash
from masp_tpu_torch.host.primitives.keys import prf_expand
from masp_tpu_torch.host.primitives.pedersen import Personalization, pedersen_hash

SAPLING_COMMITMENT_TREE_DEPTH = 32

# MAX_MONEY (transaction/components/amount.rs:18)
MAX_MONEY = 2**64 - 1


def _le_bits(data: bytes, limit: int | None = None) -> list[bool]:
    bits = [(byte >> i) & 1 == 1 for byte in data for i in range(8)]
    return bits if limit is None else bits[:limit]


def merkle_hash(depth: int, lhs: bytes, rhs: bytes) -> bytes:
    """Parent node hash: Pedersen over both children truncated to 255 bits
    (sapling.rs:54-85)."""
    bits = _le_bits(lhs, 255) + _le_bits(rhs, 255)
    p = pedersen_hash(Personalization.merkle_tree(depth), bits)
    u, _v = p.to_affine()
    return u.to_bytes()


class Node:
    """Commitment-tree node (32-byte scalar repr)."""

    __slots__ = ("repr",)

    def __init__(self, repr_: bytes):
        assert len(repr_) == 32
        self.repr = repr_

    @staticmethod
    def from_scalar(cmu: Scalar) -> "Node":
        return Node(cmu.to_bytes())

    @staticmethod
    def blank() -> "Node":
        return Node(uncommitted().to_bytes())

    @staticmethod
    def combine(level: int, lhs: "Node", rhs: "Node") -> "Node":
        return Node(merkle_hash(level, lhs.repr, rhs.repr))

    @staticmethod
    def empty_root(level: int) -> "Node":
        return empty_roots()[level]

    def to_scalar(self) -> Scalar:
        s = Scalar.from_bytes(self.repr)
        assert s is not None, "tree node not in prime field"
        return s

    def __eq__(self, other):
        return isinstance(other, Node) and self.repr == other.repr

    def __hash__(self):
        return hash(self.repr)

    def __repr__(self):
        return f"Node({self.repr.hex()})"


def uncommitted() -> Scalar:
    """Uncommitted leaf value: Scalar::ONE (sapling.rs:789-793)."""
    return Scalar(1)


@lru_cache(maxsize=None)
def empty_roots() -> list[Node]:
    v = [Node.blank()]
    for d in range(SAPLING_COMMITMENT_TREE_DEPTH):
        v.append(Node.combine(d, v[d], v[d]))
    return v


# ---------------------------------------------------------------------------


@dataclass
class ValueCommitment:
    """cv = [value] clear_cofactor(asset_gen) + [rcv] R (sapling.rs:198-209)."""

    asset_generator: ExtendedPoint
    value: int
    randomness: JubjubFr

    def commitment(self) -> ExtendedPoint:
        return (
            self.asset_generator.clear_cofactor() * JubjubFr(self.value)
            + constants.value_commitment_randomness_generator() * self.randomness
        )


@dataclass
class NullifierDerivingKey:
    point: ExtendedPoint

    def to_bytes(self) -> bytes:
        return self.point.to_bytes()

    def __eq__(self, other):
        return isinstance(other, NullifierDerivingKey) and self.point == other.point


@dataclass
class ProofGenerationKey:
    ak: ExtendedPoint
    nsk: JubjubFr

    def to_viewing_key(self) -> "ViewingKey":
        return ViewingKey(
            ak=self.ak,
            nk=NullifierDerivingKey(constants.proof_generation_key_generator() * self.nsk),
        )


@dataclass
class ViewingKey:
    ak: ExtendedPoint
    nk: NullifierDerivingKey

    def rk(self, ar: JubjubFr) -> ExtendedPoint:
        return self.ak + constants.spending_key_generator() * ar

    def ivk(self) -> "SaplingIvk":
        """ivk = BLAKE2s("MASP_ivk", ak || nk), top 5 bits dropped
        (sapling.rs:338-355)."""
        h = hashlib.blake2s(digest_size=32, person=constants.CRH_IVK_PERSONALIZATION)
        h.update(self.ak.to_bytes())
        h.update(self.nk.point.to_bytes())
        out = bytearray(h.digest())
        out[31] &= 0b0000_0111
        fr = JubjubFr.from_bytes(bytes(out))
        assert fr is not None
        return SaplingIvk(fr)

    def to_payment_address(self, diversifier: "Diversifier") -> "PaymentAddress | None":
        return self.ivk().to_payment_address(diversifier)

    def to_bytes(self) -> bytes:
        return self.ak.to_bytes() + self.nk.point.to_bytes()

    @staticmethod
    def from_bytes(b: bytes) -> "ViewingKey":
        ak = subgroup_from_bytes(b[0:32])
        if ak is None or ak.is_identity():
            raise ValueError("ak not of prime order")
        nk = subgroup_from_bytes(b[32:64])
        if nk is None:
            raise ValueError("nk not in prime-order subgroup")
        return ViewingKey(ak=ak, nk=NullifierDerivingKey(nk))


@dataclass
class SaplingIvk:
    fr: JubjubFr

    def to_payment_address(self, diversifier: "Diversifier") -> "PaymentAddress | None":
        g_d = diversifier.g_d()
        if g_d is None:
            return None
        pk_d = g_d * self.fr
        return PaymentAddress.from_parts(diversifier, pk_d)

    def to_repr(self) -> bytes:
        return self.fr.to_bytes()


@dataclass(frozen=True)
class Diversifier:
    d: bytes  # 11 bytes

    def __post_init__(self):
        assert len(self.d) == 11

    def g_d(self) -> ExtendedPoint | None:
        return group_hash(self.d, constants.KEY_DIVERSIFICATION_PERSONALIZATION)


class PaymentAddress:
    """(diversifier, pk_d); pk_d guaranteed non-identity (sapling.rs:479-572)."""

    __slots__ = ("pk_d", "diversifier")

    def __init__(self, pk_d: ExtendedPoint, diversifier: Diversifier):
        self.pk_d = pk_d
        self.diversifier = diversifier

    @staticmethod
    def from_parts(diversifier: Diversifier, pk_d: ExtendedPoint) -> "PaymentAddress | None":
        if pk_d.is_identity():
            return None
        return PaymentAddress(pk_d, diversifier)

    @staticmethod
    def from_bytes(b: bytes) -> "PaymentAddress | None":
        if len(b) != 43:
            return None
        diversifier = Diversifier(b[0:11])
        if diversifier.g_d() is None:
            return None
        pk_d = subgroup_from_bytes(b[11:43])
        if pk_d is None:
            return None
        return PaymentAddress.from_parts(diversifier, pk_d)

    def to_bytes(self) -> bytes:
        return self.diversifier.d + self.pk_d.to_bytes()

    def g_d(self) -> ExtendedPoint | None:
        return self.diversifier.g_d()

    def create_note(self, asset_type, value: int, rseed: "Rseed") -> "Note | None":
        g_d = self.g_d()
        if g_d is None:
            return None
        return Note(asset_type=asset_type, value=value, g_d=g_d, pk_d=self.pk_d, rseed=rseed)

    def __eq__(self, other):
        return (
            isinstance(other, PaymentAddress)
            and self.pk_d == other.pk_d
            and self.diversifier == other.diversifier
        )

    def __hash__(self):
        return hash(self.to_bytes())


class Rseed:
    """Note randomness: BeforeZip212(rcm: JubjubFr) or AfterZip212(bytes32)."""

    __slots__ = ("kind", "rcm_value", "rseed_bytes")

    BEFORE = 1
    AFTER = 2

    def __init__(self, kind: int, rcm_value: JubjubFr | None = None, rseed_bytes: bytes | None = None):
        self.kind = kind
        self.rcm_value = rcm_value
        self.rseed_bytes = rseed_bytes

    @staticmethod
    def before_zip212(rcm: JubjubFr) -> "Rseed":
        return Rseed(Rseed.BEFORE, rcm_value=rcm)

    @staticmethod
    def after_zip212(rseed: bytes) -> "Rseed":
        assert len(rseed) == 32
        return Rseed(Rseed.AFTER, rseed_bytes=rseed)

    def rcm(self) -> JubjubFr:
        if self.kind == Rseed.BEFORE:
            return self.rcm_value
        return JubjubFr.from_bytes_wide(prf_expand(self.rseed_bytes, b"\x04"))

    def derive_esk(self) -> JubjubFr | None:
        if self.kind == Rseed.BEFORE:
            return None
        return JubjubFr.from_bytes_wide(prf_expand(self.rseed_bytes, b"\x05"))

    def __eq__(self, other):
        if not isinstance(other, Rseed) or self.kind != other.kind:
            return False
        if self.kind == Rseed.BEFORE:
            return self.rcm_value == other.rcm_value
        return self.rseed_bytes == other.rseed_bytes


@dataclass(frozen=True)
class Nullifier:
    data: bytes

    def __post_init__(self):
        assert len(self.data) == 32

    def hex(self) -> str:
        return self.data.hex()


@dataclass
class Note:
    asset_type: "AssetType"
    value: int
    g_d: ExtendedPoint
    pk_d: ExtendedPoint
    rseed: Rseed

    def cm_full_point(self) -> ExtendedPoint:
        """Note commitment as a full point (sapling.rs:796-824):
        Pedersen(asset_gen(256b) || value(64b LE) || g_d(256b) || pk_d(256b))
        + [rcm] R."""
        note_contents = (
            self.asset_type.asset_generator().to_bytes()
            + self.value.to_bytes(8, "little")
            + self.g_d.to_bytes()
            + self.pk_d.to_bytes()
        )
        assert len(note_contents) == 32 + 8 + 32 + 32
        hash_of_contents = pedersen_hash(
            Personalization.note_commitment(), _le_bits(note_contents)
        )
        return (
            constants.note_commitment_randomness_generator() * self.rcm()
            + hash_of_contents
        )

    def nf(self, nk: NullifierDerivingKey, position: int) -> Nullifier:
        """nf = BLAKE2s("MASP__nf", nk || (cm + [position] J))
        (sapling.rs:828-845)."""
        rho = self.cm_full_point() + (
            constants.nullifier_position_generator() * JubjubFr(position)
        )
        h = hashlib.blake2s(digest_size=32, person=constants.PRF_NF_PERSONALIZATION)
        h.update(nk.point.to_bytes())
        h.update(rho.to_bytes())
        return Nullifier(h.digest())

    def cmu(self) -> Scalar:
        u, _v = self.cm_full_point().to_affine()
        return u

    def rcm(self) -> JubjubFr:
        return self.rseed.rcm()

    def derive_esk(self) -> JubjubFr | None:
        return self.rseed.derive_esk()

    def generate_or_derive_esk(self, rng) -> JubjubFr:
        esk = self.derive_esk()
        if esk is None:
            from masp_tpu_torch.host.rng import random_jubjub_fr

            return random_jubjub_fr(rng)
        return esk

    def commitment(self) -> Node:
        return Node(self.cmu().to_bytes())

    def __eq__(self, other):
        return (
            isinstance(other, Note)
            and self.value == other.value
            and self.asset_type == other.asset_type
            and self.g_d == other.g_d
            and self.pk_d == other.pk_d
            and self.rcm() == other.rcm()
        )


def spend_sig(ask: "redjubjub.PrivateKey", ar: JubjubFr, sighash: bytes, rng) -> "redjubjub.Signature":
    """spendAuthSig (sapling.rs:167-195): randomize ask by ar, sign rk||sighash."""
    from masp_tpu_torch.host.primitives import redjubjub

    rsk = ask.randomize(ar)
    rk = redjubjub.PublicKey.from_private(rsk, constants.spending_key_generator())
    data_to_be_signed = rk.point.to_bytes() + sighash
    return rsk.sign(data_to_be_signed, rng, constants.spending_key_generator())


__all__ = [
    "SAPLING_COMMITMENT_TREE_DEPTH", "MAX_MONEY", "merkle_hash", "Node",
    "uncommitted", "empty_roots", "ValueCommitment", "NullifierDerivingKey",
    "ProofGenerationKey", "ViewingKey", "SaplingIvk", "Diversifier",
    "PaymentAddress", "Rseed", "Nullifier", "Note", "spend_sig",
]
