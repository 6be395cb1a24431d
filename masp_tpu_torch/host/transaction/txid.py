# Copy of masp_tpu/transaction/txid.py, verbatim apart from import paths. The port imports nothing of
# masp_tpu.
"""ZIP-244-style transaction digest tree
(masp_primitives/src/transaction/txid.rs) with the MASP convert branch."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from masp_tpu_torch.host.note_encryption import COMPACT_NOTE_SIZE, NOTE_PLAINTEXT_SIZE

ZCASH_TX_PERSONALIZATION_PREFIX = b"ZcashTxHash_"
ZCASH_HEADERS_HASH_PERSONALIZATION = b"ZTxIdHeadersHash"
ZCASH_TRANSPARENT_HASH_PERSONALIZATION = b"ZTxIdTranspaHash"
ZCASH_SAPLING_HASH_PERSONALIZATION = b"ZTxIdSaplingHash"
ZCASH_INPUTS_HASH_PERSONALIZATION = b"ZTxIdInputs_Hash"
ZCASH_OUTPUTS_HASH_PERSONALIZATION = b"ZTxIdOutputsHash"
ZCASH_SAPLING_SPENDS_HASH_PERSONALIZATION = b"ZTxIdSSpendsHash"
ZCASH_SAPLING_SPENDS_COMPACT_HASH_PERSONALIZATION = b"ZTxIdSSpendCHash"
ZCASH_SAPLING_SPENDS_NONCOMPACT_HASH_PERSONALIZATION = b"ZTxIdSSpendNHash"
ZCASH_SAPLING_CONVERTS_HASH_PERSONALIZATION = b"ZTxIdConvertHash"
ZCASH_SAPLING_OUTPUTS_HASH_PERSONALIZATION = b"ZTxIdSOutputHash"
ZCASH_SAPLING_OUTPUTS_COMPACT_HASH_PERSONALIZATION = b"ZTxIdSOutC__Hash"
ZCASH_SAPLING_OUTPUTS_MEMOS_HASH_PERSONALIZATION = b"ZTxIdSOutM__Hash"
ZCASH_SAPLING_OUTPUTS_NONCOMPACT_HASH_PERSONALIZATION = b"ZTxIdSOutN__Hash"
ZCASH_AUTH_PERSONALIZATION_PREFIX = b"ZTxAuthHash_"
ZCASH_TRANSPARENT_SCRIPTS_HASH_PERSONALIZATION = b"ZTxAuthTransHash"
ZCASH_SAPLING_SIGS_HASH_PERSONALIZATION = b"ZTxAuthSapliHash"


def hasher(personal: bytes):
    return hashlib.blake2b(digest_size=32, person=personal)


@dataclass
class TransparentDigests:
    inputs_digest: bytes
    outputs_digest: bytes


@dataclass
class TxDigests:
    header_digest: bytes
    transparent_digests: TransparentDigests | None
    sapling_digest: bytes | None


def transparent_inputs_hash(vin) -> bytes:
    h = hasher(ZCASH_INPUTS_HASH_PERSONALIZATION)
    for t in vin:
        h.update(t.asset_type.get_identifier())
        h.update(t.value.to_bytes(8, "little"))
        h.update(t.address.data)
    return h.digest()


def transparent_outputs_hash(vout) -> bytes:
    from masp_tpu_torch.host.encoding import Writer

    h = hasher(ZCASH_OUTPUTS_HASH_PERSONALIZATION)
    for t in vout:
        w = Writer()
        t.write(w)
        h.update(w.getvalue())
    return h.digest()


def hash_sapling_spends(shielded_spends) -> bytes:
    h = hasher(ZCASH_SAPLING_SPENDS_HASH_PERSONALIZATION)
    if shielded_spends:
        ch = hasher(ZCASH_SAPLING_SPENDS_COMPACT_HASH_PERSONALIZATION)
        nh = hasher(ZCASH_SAPLING_SPENDS_NONCOMPACT_HASH_PERSONALIZATION)
        for s in shielded_spends:
            ch.update(s.nullifier.data)
            nh.update(s.cv.to_bytes())
            nh.update(s.anchor.to_bytes())
            nh.update(s.rk.to_bytes())
        h.update(ch.digest())
        h.update(nh.digest())
    return h.digest()


def hash_sapling_converts(shielded_converts) -> bytes:
    h = hasher(ZCASH_SAPLING_CONVERTS_HASH_PERSONALIZATION)
    for c in shielded_converts:
        h.update(c.cv.to_bytes())
        h.update(c.anchor.to_bytes())
    return h.digest()


def hash_sapling_outputs(shielded_outputs) -> bytes:
    h = hasher(ZCASH_SAPLING_OUTPUTS_HASH_PERSONALIZATION)
    if shielded_outputs:
        ch = hasher(ZCASH_SAPLING_OUTPUTS_COMPACT_HASH_PERSONALIZATION)
        mh = hasher(ZCASH_SAPLING_OUTPUTS_MEMOS_HASH_PERSONALIZATION)
        nh = hasher(ZCASH_SAPLING_OUTPUTS_NONCOMPACT_HASH_PERSONALIZATION)
        for o in shielded_outputs:
            ch.update(o.cmu.to_bytes())
            ch.update(o.ephemeral_key)
            ch.update(o.enc_ciphertext[:COMPACT_NOTE_SIZE])
            mh.update(o.enc_ciphertext[COMPACT_NOTE_SIZE:NOTE_PLAINTEXT_SIZE])
            nh.update(o.cv.to_bytes())
            nh.update(o.enc_ciphertext[NOTE_PLAINTEXT_SIZE:])
            nh.update(o.out_ciphertext)
        h.update(ch.digest())
        h.update(mh.digest())
        h.update(nh.digest())
    return h.digest()


def hash_header_txid_data(version, consensus_branch_id: int, lock_time: int, expiry_height: int) -> bytes:
    h = hasher(ZCASH_HEADERS_HASH_PERSONALIZATION)
    h.update(version.header().to_bytes(4, "little"))
    h.update(version.version_group_id().to_bytes(4, "little"))
    h.update(consensus_branch_id.to_bytes(4, "little"))
    h.update(lock_time.to_bytes(4, "little"))
    h.update(expiry_height.to_bytes(4, "little"))
    return h.digest()


def hash_transparent_txid_data(t_digests: TransparentDigests | None) -> bytes:
    h = hasher(ZCASH_TRANSPARENT_HASH_PERSONALIZATION)
    if t_digests is not None:
        h.update(t_digests.inputs_digest)
        h.update(t_digests.outputs_digest)
    return h.digest()


def hash_sapling_txid_data(bundle) -> bytes:
    h = hasher(ZCASH_SAPLING_HASH_PERSONALIZATION)
    if not bundle.is_empty():
        h.update(hash_sapling_spends(bundle.shielded_spends))
        h.update(hash_sapling_converts(bundle.shielded_converts))
        h.update(hash_sapling_outputs(bundle.shielded_outputs))
        h.update(bundle.value_balance.to_bytes())
    return h.digest()


def hash_sapling_txid_empty() -> bytes:
    return hasher(ZCASH_SAPLING_HASH_PERSONALIZATION).digest()


class TxIdDigester:
    """Produces TxDigests for txid computation."""

    def digest_header(self, version, consensus_branch_id, lock_time, expiry_height):
        return hash_header_txid_data(version, consensus_branch_id, lock_time, expiry_height)

    def digest_transparent(self, transparent_bundle):
        if transparent_bundle is None:
            return None
        return TransparentDigests(
            inputs_digest=transparent_inputs_hash(transparent_bundle.vin),
            outputs_digest=transparent_outputs_hash(transparent_bundle.vout),
        )

    def digest_sapling(self, sapling_bundle):
        if sapling_bundle is None:
            return None
        return hash_sapling_txid_data(sapling_bundle)

    def combine(self, header_digest, transparent_digests, sapling_digest):
        return TxDigests(header_digest, transparent_digests, sapling_digest)


def to_hash(txversion, consensus_branch_id: int, header_digest: bytes,
            transparent_digest: bytes, sapling_digest: bytes | None) -> bytes:
    personal = ZCASH_TX_PERSONALIZATION_PREFIX + consensus_branch_id.to_bytes(4, "little")
    h = hasher(personal)
    h.update(header_digest)
    h.update(transparent_digest)
    h.update(sapling_digest if sapling_digest is not None else hash_sapling_txid_empty())
    return h.digest()


def to_txid(txversion, consensus_branch_id: int, digests: TxDigests) -> bytes:
    return to_hash(
        txversion,
        consensus_branch_id,
        digests.header_digest,
        hash_transparent_txid_data(digests.transparent_digests),
        digests.sapling_digest,
    )


class BlockTxCommitmentDigester:
    """Witness-data (auth) digest (txid.rs:343-427)."""

    def digest_header(self, version, consensus_branch_id, lock_time, expiry_height):
        return consensus_branch_id

    def digest_transparent(self, transparent_bundle):
        h = hasher(ZCASH_TRANSPARENT_SCRIPTS_HASH_PERSONALIZATION)
        if transparent_bundle is not None:
            for txout in transparent_bundle.vout:
                h.update(txout.asset_type.get_identifier())
                h.update(txout.value.to_bytes(8, "little"))
                h.update(txout.address.data)
        return h.digest()

    def digest_sapling(self, sapling_bundle):
        h = hasher(ZCASH_SAPLING_SIGS_HASH_PERSONALIZATION)
        if sapling_bundle is not None:
            for spend in sapling_bundle.shielded_spends:
                h.update(spend.zkproof)
            for spend in sapling_bundle.shielded_spends:
                h.update(spend.spend_auth_sig.to_bytes())
            for convert in sapling_bundle.shielded_converts:
                h.update(convert.zkproof)
            for output in sapling_bundle.shielded_outputs:
                h.update(output.zkproof)
            h.update(sapling_bundle.authorization.binding_sig.to_bytes())
        return h.digest()

    def combine(self, consensus_branch_id, transparent_digest, sapling_digest):
        personal = ZCASH_AUTH_PERSONALIZATION_PREFIX + consensus_branch_id.to_bytes(4, "little")
        h = hasher(personal)
        h.update(transparent_digest)
        h.update(sapling_digest)
        return h.digest()


__all__ = [
    "TransparentDigests", "TxDigests", "TxIdDigester",
    "BlockTxCommitmentDigester", "to_txid", "to_hash",
    "hash_transparent_txid_data", "transparent_inputs_hash",
    "transparent_outputs_hash",
]
