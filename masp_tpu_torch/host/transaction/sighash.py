# Copy of masp_tpu/transaction/sighash.py, verbatim apart from import paths. The port imports nothing of
# masp_tpu.
"""Signature hash (masp_primitives/src/transaction/{sighash,sighash_v5}.rs)."""

from __future__ import annotations

from masp_tpu_torch.host.transaction.txid import TxDigests, hash_transparent_txid_data, to_hash

SIGHASH_ALL = 0x01
SIGHASH_NONE = 0x02
SIGHASH_SINGLE = 0x03
SIGHASH_MASK = 0x1F
SIGHASH_ANYONECANPAY = 0x80


class SignableInput:
    SHIELDED = "shielded"
    TRANSPARENT = "transparent"

    def __init__(self, kind=SHIELDED, hash_type=SIGHASH_ALL, index=0, value=0, asset_type=None):
        self.kind = kind
        self._hash_type = hash_type
        self.index = index
        self.value = value
        self.asset_type = asset_type

    @staticmethod
    def shielded() -> "SignableInput":
        return SignableInput()

    def hash_type(self) -> int:
        return SIGHASH_ALL if self.kind == self.SHIELDED else self._hash_type


def v5_signature_hash(tx, signable_input: SignableInput, txid_parts: TxDigests) -> bytes:
    assert (tx.transparent_bundle is not None) == (
        txid_parts.transparent_digests is not None
    )
    transparent_digest = hash_transparent_txid_data(txid_parts.transparent_digests)
    return to_hash(
        tx.version,
        tx.consensus_branch_id,
        txid_parts.header_digest,
        transparent_digest,
        txid_parts.sapling_digest,
    )


def signature_hash(tx, signable_input: SignableInput, txid_parts: TxDigests) -> bytes:
    return v5_signature_hash(tx, signable_input, txid_parts)


__all__ = [
    "SIGHASH_ALL", "SIGHASH_NONE", "SIGHASH_SINGLE", "SIGHASH_MASK",
    "SIGHASH_ANYONECANPAY", "SignableInput", "signature_hash",
    "v5_signature_hash",
]
