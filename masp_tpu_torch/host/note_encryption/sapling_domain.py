# Copy of masp_tpu/note_encryption/sapling_domain.py, verbatim apart from import paths. The port imports nothing of
# masp_tpu.
"""Sapling note-encryption domain
(masp_primitives/src/sapling/note_encryption.rs)."""

from __future__ import annotations

import hashlib

from masp_tpu_torch.host.jubjub import ExtendedPoint, subgroup_from_bytes
from masp_tpu_torch.host.fields import JubjubFr
from masp_tpu_torch.host.note_encryption import COMPACT_NOTE_SIZE, NOTE_PLAINTEXT_SIZE, NoteEncryption
from masp_tpu_torch.host.primitives.asset_type import AssetType
from masp_tpu_torch.host.primitives.consensus import NetworkUpgrade, Parameters
from masp_tpu_torch.host.primitives.keys import OutgoingViewingKey
from masp_tpu_torch.host.primitives.memo import MemoBytes
from masp_tpu_torch.host.primitives.sapling import Diversifier, Note, PaymentAddress, Rseed, SaplingIvk

KDF_SAPLING_PERSONALIZATION = b"MASP__SaplingKDF"
PRF_OCK_PERSONALIZATION = b"MASP__Derive_ock"


def sapling_ka_agree(esk: JubjubFr, pk_d: ExtendedPoint) -> ExtendedPoint:
    """[8 esk] pk_d (note_encryption.rs:62-73)."""
    return (pk_d * esk).clear_cofactor()


def kdf_sapling(dhsecret: ExtendedPoint, ephemeral_key: bytes) -> bytes:
    h = hashlib.blake2b(digest_size=32, person=KDF_SAPLING_PERSONALIZATION)
    h.update(dhsecret.to_bytes())
    h.update(ephemeral_key)
    return h.digest()


def prf_ock(ovk: OutgoingViewingKey, cv: ExtendedPoint, cmu_bytes: bytes, ephemeral_key: bytes) -> bytes:
    h = hashlib.blake2b(digest_size=32, person=PRF_OCK_PERSONALIZATION)
    h.update(ovk.data)
    h.update(cv.to_bytes())
    h.update(cmu_bytes)
    h.update(ephemeral_key)
    return h.digest()


def plaintext_version_is_valid(params: Parameters, height: int, leadbyte: int) -> bool:
    if params.is_nu_active(NetworkUpgrade.MASP, height):
        return leadbyte == 0x02
    return leadbyte == 0x01


class SaplingDomain:
    """Domain implementation; ivk values are SaplingIvk, epk values are
    ExtendedPoints."""

    def __init__(self, params: Parameters, height: int):
        self.params = params
        self.height = height

    @staticmethod
    def for_height(params: Parameters, height: int) -> "SaplingDomain":
        return SaplingDomain(params, height)

    # --- Domain methods ---------------------------------------------------
    def derive_esk(self, note: Note) -> JubjubFr | None:
        return note.derive_esk()

    def get_pk_d(self, note: Note) -> ExtendedPoint:
        return note.pk_d

    def ka_derive_public(self, note: Note, esk: JubjubFr) -> ExtendedPoint:
        return note.g_d * esk

    def ka_agree_enc(self, esk: JubjubFr, pk_d: ExtendedPoint) -> ExtendedPoint:
        return sapling_ka_agree(esk, pk_d)

    def ka_agree_dec(self, ivk: SaplingIvk, epk: ExtendedPoint) -> ExtendedPoint:
        return sapling_ka_agree(ivk.fr, epk)

    def kdf(self, secret: ExtendedPoint, ephemeral_key: bytes) -> bytes:
        return kdf_sapling(secret, ephemeral_key)

    def note_plaintext_bytes(self, note: Note, to: PaymentAddress, memo: MemoBytes) -> bytes:
        out = bytearray(NOTE_PLAINTEXT_SIZE)
        out[0] = 1 if note.rseed.kind == Rseed.BEFORE else 2
        out[1:12] = to.diversifier.d
        out[12:20] = note.value.to_bytes(8, "little")
        out[20:52] = note.asset_type.get_identifier()
        if note.rseed.kind == Rseed.BEFORE:
            out[52:COMPACT_NOTE_SIZE] = note.rseed.rcm_value.to_bytes()
        else:
            out[52:COMPACT_NOTE_SIZE] = note.rseed.rseed_bytes
        out[COMPACT_NOTE_SIZE:NOTE_PLAINTEXT_SIZE] = memo.as_array()
        return bytes(out)

    def derive_ock(self, ovk, cv, cmstar_bytes, ephemeral_key) -> bytes:
        return prf_ock(ovk, cv, cmstar_bytes, ephemeral_key)

    def outgoing_plaintext_bytes(self, note: Note, esk: JubjubFr) -> bytes:
        return note.pk_d.to_bytes() + esk.to_bytes()

    def epk_bytes(self, epk: ExtendedPoint) -> bytes:
        return epk.to_bytes()

    def epk(self, ephemeral_key: bytes) -> ExtendedPoint | None:
        return ExtendedPoint.from_bytes(ephemeral_key)

    def cmstar(self, note: Note):
        return note.cmu()

    def cmstar_to_bytes(self, cmstar) -> bytes:
        return cmstar.to_bytes()

    def _parse_without_memo(self, plaintext: bytes, get_validated_pk_d):
        assert len(plaintext) >= COMPACT_NOTE_SIZE
        if not plaintext_version_is_valid(self.params, self.height, plaintext[0]):
            return None
        diversifier = Diversifier(bytes(plaintext[1:12]))
        value = int.from_bytes(plaintext[12:20], "little")
        asset_type = AssetType.from_identifier(bytes(plaintext[20:52]))
        if asset_type is None:
            return None
        r = bytes(plaintext[52:COMPACT_NOTE_SIZE])
        if plaintext[0] == 0x01:
            rcm = JubjubFr.from_bytes(r)
            if rcm is None:
                return None
            rseed = Rseed.before_zip212(rcm)
        else:
            rseed = Rseed.after_zip212(r)
        pk_d = get_validated_pk_d(diversifier)
        if pk_d is None:
            return None
        to = PaymentAddress.from_parts(diversifier, pk_d)
        if to is None:
            return None
        note = to.create_note(asset_type, value, rseed)
        if note is None:
            return None
        return note, to

    def parse_note_plaintext_without_memo_ivk(self, ivk: SaplingIvk, plaintext: bytes):
        def pk_d_from(diversifier):
            g_d = diversifier.g_d()
            if g_d is None:
                return None
            return g_d * ivk.fr

        return self._parse_without_memo(plaintext, pk_d_from)

    def parse_note_plaintext_without_memo_ovk(self, pk_d, esk, ephemeral_key, plaintext):
        def validated(diversifier):
            g_d = diversifier.g_d()
            if g_d is None:
                return None
            if (g_d * esk).to_bytes() != ephemeral_key:
                return None
            return pk_d

        return self._parse_without_memo(plaintext, validated)

    def extract_memo(self, plaintext: bytes) -> MemoBytes:
        return MemoBytes(bytes(plaintext[COMPACT_NOTE_SIZE:NOTE_PLAINTEXT_SIZE]))

    def extract_pk_d(self, out_plaintext: bytes) -> ExtendedPoint | None:
        return subgroup_from_bytes(out_plaintext[0:32])

    def extract_esk(self, out_plaintext: bytes) -> JubjubFr | None:
        return JubjubFr.from_bytes(out_plaintext[32:64])

    # --- BatchDomain ------------------------------------------------------
    def batch_epk(self, ephemeral_keys: list[bytes], use_device: bool | None = None):
        """Returns [(epk or None, ephemeral_key)].

        For wallet-scanning-sized batches the decompression runs as ONE
        device program (ops/jubjub_jax.batch_from_bytes: batched
        Tonelli-Shanks sqrt — the analogue of the reference's
        jubjub batch_from_bytes, note_encryption.rs:385-400); small
        batches stay on the host decoder. Threshold via
        MASP_EPK_DEVICE_MIN (default 64; 0 disables the device path)."""
        if use_device is None:
            import os

            min_n = int(os.environ.get("MASP_EPK_DEVICE_MIN", "64"))
            use_device = min_n > 0 and len(ephemeral_keys) >= min_n
        if use_device:
            from masp_tpu_torch.ops.jubjub import batch_from_bytes

            pts = batch_from_bytes(ephemeral_keys)
            return list(zip(pts, ephemeral_keys))
        return [(ExtendedPoint.from_bytes(ek), ek) for ek in ephemeral_keys]

    def batch_kdf(self, items):
        return [
            None if secret is None else kdf_sapling(secret, ek)
            for (secret, ek) in items
        ]


def sapling_note_encryption(ovk, note, to, memo, params, height) -> NoteEncryption:
    domain = SaplingDomain(params, height)
    return NoteEncryption.new(domain, ovk, note, to, memo)


__all__ = [
    "KDF_SAPLING_PERSONALIZATION", "PRF_OCK_PERSONALIZATION",
    "sapling_ka_agree", "kdf_sapling", "prf_ock",
    "plaintext_version_is_valid", "SaplingDomain", "sapling_note_encryption",
]
