# Copy of masp_tpu/transaction/components/sapling.py, verbatim apart from import paths. The port imports nothing of
# masp_tpu.
"""Sapling bundle components
(masp_primitives/src/transaction/components/sapling.rs): descriptions with
canonical-encoding-enforcing readers, V5 compact forms, Bundle."""

from __future__ import annotations

from dataclasses import dataclass, field

from masp_tpu_torch.host.jubjub import ExtendedPoint
from masp_tpu_torch.host.fields import Scalar
from masp_tpu_torch.host.note_encryption import ENC_CIPHERTEXT_SIZE, OUT_CIPHERTEXT_SIZE
from masp_tpu_torch.host.primitives import redjubjub
from masp_tpu_torch.host.primitives.sapling import Nullifier
from masp_tpu_torch.host.transaction.amount import ValueSum
from masp_tpu_torch.host.encoding import Reader, Writer

GROTH_PROOF_SIZE = 48 + 96 + 48


def read_point(r: Reader, field_name: str) -> ExtendedPoint:
    p = ExtendedPoint.from_bytes(r.read(32))
    if p is None:
        raise ValueError(f"invalid {field_name}")
    return p


def read_base(r: Reader, field_name: str) -> Scalar:
    s = Scalar.from_bytes(r.read(32))
    if s is None:
        raise ValueError(f"{field_name} not in field")
    return s


def read_zkproof(r: Reader) -> bytes:
    return r.read(GROTH_PROOF_SIZE)


@dataclass
class Authorized:
    binding_sig: redjubjub.Signature


@dataclass
class SpendDescription:
    cv: ExtendedPoint
    anchor: Scalar
    nullifier: Nullifier
    rk: redjubjub.PublicKey
    zkproof: bytes | None = None
    spend_auth_sig: redjubjub.Signature | None = None

    def write_v5_without_witness_data(self, w: Writer) -> None:
        w.write(self.cv.to_bytes())
        w.write(self.nullifier.data)
        w.write(self.rk.to_bytes())

    @staticmethod
    def read_v5(r: Reader) -> "SpendDescriptionV5":
        cv = read_point(r, "cv")
        nullifier = Nullifier(r.read(32))
        rk = redjubjub.PublicKey.from_bytes(r.read(32))
        return SpendDescriptionV5(cv, nullifier, rk)

    def __eq__(self, other):
        return (
            isinstance(other, SpendDescription)
            and self.cv == other.cv
            and self.anchor == other.anchor
            and self.nullifier == other.nullifier
            and self.rk.point == other.rk.point
            and self.zkproof == other.zkproof
            and self.spend_auth_sig == other.spend_auth_sig
        )


@dataclass
class SpendDescriptionV5:
    cv: ExtendedPoint
    nullifier: Nullifier
    rk: redjubjub.PublicKey

    def into_spend_description(self, anchor: Scalar, zkproof: bytes, spend_auth_sig) -> SpendDescription:
        return SpendDescription(self.cv, anchor, self.nullifier, self.rk, zkproof, spend_auth_sig)


@dataclass
class OutputDescription:
    cv: ExtendedPoint
    cmu: Scalar
    ephemeral_key: bytes
    enc_ciphertext: bytes
    out_ciphertext: bytes
    zkproof: bytes | None = None

    def __post_init__(self):
        assert len(self.enc_ciphertext) == ENC_CIPHERTEXT_SIZE
        assert len(self.out_ciphertext) == OUT_CIPHERTEXT_SIZE

    # ShieldedOutput interface for note decryption
    def cmstar_bytes(self) -> bytes:
        return self.cmu.to_bytes()

    def write_v5_without_proof(self, w: Writer) -> None:
        w.write(self.cv.to_bytes())
        w.write(self.cmu.to_bytes())
        w.write(self.ephemeral_key)
        w.write(self.enc_ciphertext)
        w.write(self.out_ciphertext)

    @staticmethod
    def read_v5(r: Reader) -> "OutputDescriptionV5":
        cv = read_point(r, "cv")
        cmu = read_base(r, "cmu")
        ephemeral_key = r.read(32)
        enc_ciphertext = r.read(ENC_CIPHERTEXT_SIZE)
        out_ciphertext = r.read(OUT_CIPHERTEXT_SIZE)
        return OutputDescriptionV5(cv, cmu, ephemeral_key, enc_ciphertext, out_ciphertext)

    def __eq__(self, other):
        return (
            isinstance(other, OutputDescription)
            and self.cv == other.cv
            and self.cmu == other.cmu
            and self.ephemeral_key == other.ephemeral_key
            and self.enc_ciphertext == other.enc_ciphertext
            and self.out_ciphertext == other.out_ciphertext
            and self.zkproof == other.zkproof
        )

    # for trial decryption APIs
    def ephemeral_key_bytes(self) -> bytes:
        return self.ephemeral_key


@dataclass
class OutputDescriptionV5:
    cv: ExtendedPoint
    cmu: Scalar
    ephemeral_key: bytes
    enc_ciphertext: bytes
    out_ciphertext: bytes

    def into_output_description(self, zkproof: bytes) -> OutputDescription:
        return OutputDescription(
            self.cv, self.cmu, self.ephemeral_key, self.enc_ciphertext,
            self.out_ciphertext, zkproof,
        )


class CompactOutputDescription:
    """Compact form for light clients (84-byte ciphertext prefix)."""

    def __init__(self, out: OutputDescription):
        from masp_tpu_torch.host.note_encryption import COMPACT_NOTE_SIZE

        self.ephemeral_key_ = out.ephemeral_key
        self.cmu = out.cmu
        self.enc_ciphertext_ = out.enc_ciphertext[:COMPACT_NOTE_SIZE]

    def ephemeral_key(self):
        return self.ephemeral_key_

    def cmstar_bytes(self):
        return self.cmu.to_bytes()

    def enc_ciphertext(self):
        return self.enc_ciphertext_


@dataclass
class ConvertDescription:
    cv: ExtendedPoint
    anchor: Scalar
    zkproof: bytes | None = None

    def write_v5_without_witness_data(self, w: Writer) -> None:
        w.write(self.cv.to_bytes())

    @staticmethod
    def read_v5(r: Reader) -> "ConvertDescriptionV5":
        return ConvertDescriptionV5(read_point(r, "cv"))

    def __eq__(self, other):
        return (
            isinstance(other, ConvertDescription)
            and self.cv == other.cv
            and self.anchor == other.anchor
            and self.zkproof == other.zkproof
        )


@dataclass
class ConvertDescriptionV5:
    cv: ExtendedPoint

    def into_convert_description(self, anchor: Scalar, zkproof: bytes) -> ConvertDescription:
        return ConvertDescription(self.cv, anchor, zkproof)


@dataclass
class Bundle:
    shielded_spends: list[SpendDescription] = field(default_factory=list)
    shielded_converts: list[ConvertDescription] = field(default_factory=list)
    shielded_outputs: list[OutputDescription] = field(default_factory=list)
    value_balance: ValueSum = field(default_factory=ValueSum.zero)
    authorization: object = None

    def is_empty(self) -> bool:
        return not (self.shielded_spends or self.shielded_converts or self.shielded_outputs)

    def map_authorization(self, map_proof, map_auth_sig, map_auth) -> "Bundle":
        """MapAuth machinery (components/sapling.rs:61-157): rebuild the
        bundle with transformed proofs/signatures/authorization."""
        return Bundle(
            shielded_spends=[
                SpendDescription(
                    cv=d.cv, anchor=d.anchor, nullifier=d.nullifier, rk=d.rk,
                    zkproof=map_proof(d.zkproof, pos),
                    spend_auth_sig=map_auth_sig(d.spend_auth_sig, pos),
                )
                for pos, d in enumerate(self.shielded_spends)
            ],
            shielded_converts=[
                ConvertDescription(
                    cv=c.cv, anchor=c.anchor, zkproof=map_proof(c.zkproof, pos)
                )
                for pos, c in enumerate(self.shielded_converts)
            ],
            shielded_outputs=[
                OutputDescription(
                    cv=o.cv, cmu=o.cmu, ephemeral_key=o.ephemeral_key,
                    enc_ciphertext=o.enc_ciphertext,
                    out_ciphertext=o.out_ciphertext,
                    zkproof=map_proof(o.zkproof, pos),
                )
                for pos, o in enumerate(self.shielded_outputs)
            ],
            value_balance=self.value_balance,
            authorization=map_auth(self.authorization),
        )

    def __eq__(self, other):
        return (
            isinstance(other, Bundle)
            and self.shielded_spends == other.shielded_spends
            and self.shielded_converts == other.shielded_converts
            and self.shielded_outputs == other.shielded_outputs
            and self.value_balance == other.value_balance
        )


__all__ = [
    "GROTH_PROOF_SIZE", "read_point", "read_base", "read_zkproof",
    "Authorized", "SpendDescription", "SpendDescriptionV5",
    "OutputDescription", "OutputDescriptionV5", "CompactOutputDescription",
    "ConvertDescription", "ConvertDescriptionV5", "Bundle",
]
