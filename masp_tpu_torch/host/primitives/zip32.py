# Copy of masp_tpu/primitives/zip32.py, verbatim apart from import paths. The port imports nothing of
# masp_tpu.
"""ZIP-32 hierarchical deterministic key derivation with MASP
personalizations (masp_primitives/src/zip32{,/sapling}.rs)."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from masp_tpu_torch.host.fields import JubjubFr
from masp_tpu_torch.host.primitives.ff1 import FF1Radix2
from masp_tpu_torch.host.primitives.keys import (
    ExpandedSpendingKey, FullViewingKey, OutgoingViewingKey, prf_expand,
    prf_expand_vec,
)
from masp_tpu_torch.host.primitives.sapling import Diversifier, PaymentAddress

ZIP32_SAPLING_MASTER_PERSONALIZATION = b"MASP_IP32Sapling"
ZIP32_SAPLING_FVFP_PERSONALIZATION = b"MASP_SaplingFVFP"
ZIP32_SAPLING_INT_PERSONALIZATION = b"MASP__SaplingInt"


class ChildIndex:
    """Hardened(n) == n + (1 << 31)."""

    def __init__(self, value: int):
        self.raw = value & 0xFFFFFFFF

    @staticmethod
    def hardened(i: int) -> "ChildIndex":
        return ChildIndex(i + (1 << 31))

    @staticmethod
    def non_hardened(i: int) -> "ChildIndex":
        return ChildIndex(i)

    @staticmethod
    def master() -> "ChildIndex":
        return ChildIndex(0)

    def is_hardened(self) -> bool:
        return self.raw >= (1 << 31)

    def value(self) -> int:
        return self.raw

    def __eq__(self, other):
        return isinstance(other, ChildIndex) and self.raw == other.raw


class DiversifierIndex:
    """11-byte little-endian index."""

    def __init__(self, data: bytes = b"\x00" * 11):
        assert len(data) == 11
        self.data = bytes(data)

    @staticmethod
    def from_u64(i: int) -> "DiversifierIndex":
        return DiversifierIndex(i.to_bytes(8, "little") + b"\x00" * 3)

    def to_int(self) -> int:
        return int.from_bytes(self.data, "little")

    def increment(self) -> "DiversifierIndex":
        v = self.to_int() + 1
        if v >= 1 << 88:
            raise OverflowError("diversifier index overflow")
        return DiversifierIndex(v.to_bytes(11, "little"))

    def __eq__(self, other):
        return isinstance(other, DiversifierIndex) and self.data == other.data


def fvk_fingerprint(fvk: FullViewingKey) -> bytes:
    h = hashlib.blake2b(digest_size=32, person=ZIP32_SAPLING_FVFP_PERSONALIZATION)
    h.update(fvk.to_bytes())
    return h.digest()


def fvk_tag(fvk: FullViewingKey) -> bytes:
    return fvk_fingerprint(fvk)[:4]


@dataclass(frozen=True)
class DiversifierKey:
    data: bytes  # 32 bytes

    @staticmethod
    def master(sk_m: bytes) -> "DiversifierKey":
        return DiversifierKey(prf_expand(sk_m, b"\x10")[:32])

    def derive_child(self, i_l: bytes) -> "DiversifierKey":
        return DiversifierKey(prf_expand_vec(i_l, [b"\x16", self.data])[:32])

    def _ff1(self) -> FF1Radix2:
        return FF1Radix2(self.data)

    def diversifier(self, j: DiversifierIndex) -> Diversifier | None:
        d_j = self._ff1().encrypt_bytes_le(b"", j.data)
        d = Diversifier(d_j)
        return d if d.g_d() is not None else None

    def diversifier_index(self, d: Diversifier) -> DiversifierIndex:
        return DiversifierIndex(self._ff1().decrypt_bytes_le(b"", d.d))

    def find_diversifier(self, j: DiversifierIndex) -> tuple[DiversifierIndex, Diversifier] | None:
        ff = self._ff1()
        while True:
            d_j = ff.encrypt_bytes_le(b"", j.data)
            d = Diversifier(d_j)
            if d.g_d() is not None:
                return (j, d)
            try:
                j = j.increment()
            except OverflowError:
                return None


def derive_child_ovk(parent: OutgoingViewingKey, i_l: bytes) -> OutgoingViewingKey:
    return OutgoingViewingKey(prf_expand_vec(i_l, [b"\x15", parent.data])[:32])


@dataclass
class ExtendedSpendingKey:
    depth: int
    parent_fvk_tag: bytes
    child_index: ChildIndex
    chain_code: bytes
    expsk: ExpandedSpendingKey
    dk: DiversifierKey

    @staticmethod
    def master(seed: bytes) -> "ExtendedSpendingKey":
        h = hashlib.blake2b(digest_size=64, person=ZIP32_SAPLING_MASTER_PERSONALIZATION)
        h.update(seed)
        i = h.digest()
        sk_m, c_m = i[:32], i[32:]
        return ExtendedSpendingKey(
            depth=0,
            parent_fvk_tag=b"\x00" * 4,
            child_index=ChildIndex.master(),
            chain_code=c_m,
            expsk=ExpandedSpendingKey.from_spending_key(sk_m),
            dk=DiversifierKey.master(sk_m),
        )

    @staticmethod
    def from_path(master: "ExtendedSpendingKey", path: list[ChildIndex]) -> "ExtendedSpendingKey":
        xsk = master
        for i in path:
            xsk = xsk.derive_child(i)
        return xsk

    def derive_child(self, i: ChildIndex) -> "ExtendedSpendingKey":
        fvk = FullViewingKey.from_expanded_spending_key(self.expsk)
        le_i = i.value().to_bytes(4, "little")
        if i.is_hardened():
            tmp = prf_expand_vec(
                self.chain_code, [b"\x11", self.expsk.to_bytes(), self.dk.data, le_i]
            )
        else:
            tmp = prf_expand_vec(
                self.chain_code, [b"\x12", fvk.to_bytes(), self.dk.data, le_i]
            )
        i_l, c_i = tmp[:32], tmp[32:]
        ask = JubjubFr.from_bytes_wide(prf_expand(i_l, b"\x13")) + self.expsk.ask
        nsk = JubjubFr.from_bytes_wide(prf_expand(i_l, b"\x14")) + self.expsk.nsk
        ovk = derive_child_ovk(self.expsk.ovk, i_l)
        return ExtendedSpendingKey(
            depth=self.depth + 1,
            parent_fvk_tag=fvk_tag(fvk),
            child_index=i,
            chain_code=c_i,
            expsk=ExpandedSpendingKey(ask, nsk, ovk),
            dk=self.dk.derive_child(i_l),
        )

    def derive_internal(self) -> "ExtendedSpendingKey":
        fvk = FullViewingKey.from_expanded_spending_key(self.expsk)
        h = hashlib.blake2b(digest_size=32, person=ZIP32_SAPLING_INT_PERSONALIZATION)
        h.update(fvk.to_bytes())
        h.update(self.dk.data)
        i = h.digest()
        i_nsk = JubjubFr.from_bytes_wide(prf_expand(i, b"\x17"))
        r = prf_expand(i, b"\x18")
        return ExtendedSpendingKey(
            depth=self.depth,
            parent_fvk_tag=self.parent_fvk_tag,
            child_index=self.child_index,
            chain_code=self.chain_code,
            expsk=ExpandedSpendingKey(
                ask=self.expsk.ask,
                nsk=i_nsk + self.expsk.nsk,
                ovk=OutgoingViewingKey(r[32:]),
            ),
            dk=DiversifierKey(r[:32]),
        )

    def to_bytes(self) -> bytes:
        return (
            bytes([self.depth])
            + self.parent_fvk_tag
            + self.child_index.value().to_bytes(4, "little")
            + self.chain_code
            + self.expsk.to_bytes()
            + self.dk.data
        )

    @staticmethod
    def from_bytes(b: bytes) -> "ExtendedSpendingKey":
        if len(b) != 169:
            raise ValueError(f"expected 169 bytes, got {len(b)}")
        return ExtendedSpendingKey(
            depth=b[0],
            parent_fvk_tag=b[1:5],
            child_index=ChildIndex(int.from_bytes(b[5:9], "little")),
            chain_code=b[9:41],
            expsk=ExpandedSpendingKey.from_bytes(b[41:137]),
            dk=DiversifierKey(b[137:169]),
        )

    def to_extended_full_viewing_key(self) -> "ExtendedFullViewingKey":
        return ExtendedFullViewingKey(
            depth=self.depth,
            parent_fvk_tag=self.parent_fvk_tag,
            child_index=self.child_index,
            chain_code=self.chain_code,
            fvk=FullViewingKey.from_expanded_spending_key(self.expsk),
            dk=self.dk,
        )

    def to_diversifiable_full_viewing_key(self) -> "DiversifiableFullViewingKey":
        return DiversifiableFullViewingKey(
            fvk=FullViewingKey.from_expanded_spending_key(self.expsk), dk=self.dk
        )

    def default_address(self) -> tuple[DiversifierIndex, PaymentAddress]:
        return self.to_diversifiable_full_viewing_key().default_address()

    def __eq__(self, other):
        return isinstance(other, ExtendedSpendingKey) and self.to_bytes() == other.to_bytes()


@dataclass
class ExtendedFullViewingKey:
    depth: int
    parent_fvk_tag: bytes
    child_index: ChildIndex
    chain_code: bytes
    fvk: FullViewingKey
    dk: DiversifierKey

    def derive_child(self, i: ChildIndex) -> "ExtendedFullViewingKey":
        if i.is_hardened():
            raise ValueError("cannot derive hardened child from FVK")
        le_i = i.value().to_bytes(4, "little")
        tmp = prf_expand_vec(
            self.chain_code, [b"\x12", self.fvk.to_bytes(), self.dk.data, le_i]
        )
        i_l, c_i = tmp[:32], tmp[32:]
        from masp_tpu_torch.host.primitives.constants import (
            proof_generation_key_generator, spending_key_generator,
        )
        from masp_tpu_torch.host.primitives.sapling import NullifierDerivingKey, ViewingKey

        i_ask = JubjubFr.from_bytes_wide(prf_expand(i_l, b"\x13"))
        i_nsk = JubjubFr.from_bytes_wide(prf_expand(i_l, b"\x14"))
        ak = spending_key_generator() * i_ask + self.fvk.vk.ak
        nk = proof_generation_key_generator() * i_nsk + self.fvk.vk.nk.point
        return ExtendedFullViewingKey(
            depth=self.depth + 1,
            parent_fvk_tag=fvk_tag(self.fvk),
            child_index=i,
            chain_code=c_i,
            fvk=FullViewingKey(
                vk=ViewingKey(ak=ak, nk=NullifierDerivingKey(nk)),
                ovk=derive_child_ovk(self.fvk.ovk, i_l),
            ),
            dk=self.dk.derive_child(i_l),
        )

    def address(self, j: DiversifierIndex) -> PaymentAddress | None:
        d = self.dk.diversifier(j)
        if d is None:
            return None
        return self.fvk.vk.to_payment_address(d)

    def find_address(self, j: DiversifierIndex) -> tuple[DiversifierIndex, PaymentAddress] | None:
        found = self.dk.find_diversifier(j)
        if found is None:
            return None
        j, d = found
        addr = self.fvk.vk.to_payment_address(d)
        return None if addr is None else (j, addr)

    def default_address(self) -> tuple[DiversifierIndex, PaymentAddress]:
        out = self.find_address(DiversifierIndex())
        assert out is not None, "diversifier space is large enough"
        return out

    def to_bytes(self) -> bytes:
        return (
            bytes([self.depth])
            + self.parent_fvk_tag
            + self.child_index.value().to_bytes(4, "little")
            + self.chain_code
            + self.fvk.to_bytes()
            + self.dk.data
        )

    @staticmethod
    def from_bytes(b: bytes) -> "ExtendedFullViewingKey":
        if len(b) != 169:
            raise ValueError("expected 169 bytes")
        return ExtendedFullViewingKey(
            depth=b[0],
            parent_fvk_tag=b[1:5],
            child_index=ChildIndex(int.from_bytes(b[5:9], "little")),
            chain_code=b[9:41],
            fvk=FullViewingKey.from_bytes(b[41:137]),
            dk=DiversifierKey(b[137:169]),
        )

    def __eq__(self, other):
        return isinstance(other, ExtendedFullViewingKey) and self.to_bytes() == other.to_bytes()


@dataclass
class DiversifiableFullViewingKey:
    fvk: FullViewingKey
    dk: DiversifierKey

    def to_bytes(self) -> bytes:
        return self.fvk.to_bytes() + self.dk.data

    @staticmethod
    def from_bytes(b: bytes) -> "DiversifiableFullViewingKey | None":
        if len(b) != 128:
            return None
        try:
            fvk = FullViewingKey.from_bytes(b[:96])
        except ValueError:
            return None
        return DiversifiableFullViewingKey(fvk=fvk, dk=DiversifierKey(b[96:128]))

    def address(self, j: DiversifierIndex) -> PaymentAddress | None:
        d = self.dk.diversifier(j)
        if d is None:
            return None
        return self.fvk.vk.to_payment_address(d)

    def find_address(self, j: DiversifierIndex):
        found = self.dk.find_diversifier(j)
        if found is None:
            return None
        j, d = found
        addr = self.fvk.vk.to_payment_address(d)
        return None if addr is None else (j, addr)

    def default_address(self) -> tuple[DiversifierIndex, PaymentAddress]:
        out = self.find_address(DiversifierIndex())
        assert out is not None
        return out

    def decrypt_diversifier(self, d: Diversifier) -> DiversifierIndex:
        return self.dk.diversifier_index(d)


@dataclass
class PseudoExtendedKey:
    """Extended FVK bundled with optional spend/proof authorizations
    (zip32/sapling.rs:990+)."""

    xfvk: ExtendedFullViewingKey
    ask: JubjubFr | None = None
    nsk: JubjubFr | None = None

    @staticmethod
    def from_spending_key(xsk: ExtendedSpendingKey) -> "PseudoExtendedKey":
        return PseudoExtendedKey(
            xfvk=xsk.to_extended_full_viewing_key(),
            ask=xsk.expsk.ask,
            nsk=xsk.expsk.nsk,
        )

    @staticmethod
    def from_viewing_key(xfvk: ExtendedFullViewingKey) -> "PseudoExtendedKey":
        return PseudoExtendedKey(xfvk=xfvk)

    def to_viewing_key(self) -> ExtendedFullViewingKey:
        return self.xfvk

    def to_proof_generation_key(self):
        from masp_tpu_torch.host.primitives.sapling import ProofGenerationKey

        if self.nsk is None:
            return None
        return ProofGenerationKey(ak=self.xfvk.fvk.vk.ak, nsk=self.nsk)

    def to_spend_authorizing_key(self) -> JubjubFr | None:
        return self.ask


def sapling_derive_internal_fvk(fvk: FullViewingKey, dk: DiversifierKey):
    """Internal-change FVK derivation (zip32/sapling.rs:90-121)."""
    from masp_tpu_torch.host.primitives.constants import proof_generation_key_generator
    from masp_tpu_torch.host.primitives.sapling import NullifierDerivingKey, ViewingKey

    h = hashlib.blake2b(digest_size=32, person=ZIP32_SAPLING_INT_PERSONALIZATION)
    h.update(fvk.to_bytes())
    h.update(dk.data)
    i = h.digest()
    i_nsk = JubjubFr.from_bytes_wide(prf_expand(i, b"\x17"))
    r = prf_expand(i, b"\x18")
    nk_internal = proof_generation_key_generator() * i_nsk + fvk.vk.nk.point
    return (
        FullViewingKey(
            vk=ViewingKey(ak=fvk.vk.ak, nk=NullifierDerivingKey(nk_internal)),
            ovk=OutgoingViewingKey(r[32:]),
        ),
        DiversifierKey(r[:32]),
    )


__all__ = [
    "ZIP32_SAPLING_MASTER_PERSONALIZATION", "ZIP32_SAPLING_FVFP_PERSONALIZATION",
    "ZIP32_SAPLING_INT_PERSONALIZATION", "ChildIndex", "DiversifierIndex",
    "DiversifierKey", "ExtendedSpendingKey", "ExtendedFullViewingKey",
    "DiversifiableFullViewingKey", "PseudoExtendedKey", "fvk_fingerprint",
    "fvk_tag", "sapling_derive_internal_fvk", "derive_child_ovk",
]
