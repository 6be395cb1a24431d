# Copy of masp_tpu/transaction/transaction.py, verbatim apart from import paths. The port imports nothing of
# masp_tpu.
"""MASPv5 transaction model (masp_primitives/src/transaction.rs): version
header, TransactionData, v5 byte format (arrays of descriptions with shared
anchors, proofs split from description arrays), txid computation."""

from __future__ import annotations

from dataclasses import dataclass

from masp_tpu_torch.host.fields import Scalar
from masp_tpu_torch.host.primitives import redjubjub
from masp_tpu_torch.host.primitives.consensus import BranchId
from masp_tpu_torch.host.transaction.amount import I128, ValueSum
from masp_tpu_torch.host.transaction.components import sapling as sapling_mod
from masp_tpu_torch.host.transaction.components import transparent as transparent_mod
from masp_tpu_torch.host.transaction.components.sapling import (
    Authorized as SaplingAuthorized,
    Bundle as SaplingBundle,
    ConvertDescription, OutputDescription, SpendDescription,
    read_base, read_zkproof,
)
from masp_tpu_torch.host.transaction.components.transparent import Bundle as TransparentBundle, TxIn, TxOut
from masp_tpu_torch.host.transaction.txid import BlockTxCommitmentDigester, TxIdDigester, to_txid
from masp_tpu_torch.host.encoding import Reader, Writer, read_vector, write_vector

GROTH_PROOF_SIZE = sapling_mod.GROTH_PROOF_SIZE

MASPV5_TX_VERSION = 2
MASPV5_VERSION_GROUP_ID = 0x26A7270A


class TxVersion:
    MASPv5 = "MASPv5"

    def __init__(self, kind: str = MASPv5):
        self.kind = kind

    def header(self) -> int:
        return MASPV5_TX_VERSION

    def version_group_id(self) -> int:
        return MASPV5_VERSION_GROUP_ID

    def write(self, w: Writer) -> None:
        w.u32_le(self.header())
        w.u32_le(self.version_group_id())

    @staticmethod
    def read(r: Reader) -> "TxVersion":
        header = r.u32_le()
        version = header & 0x7FFFFFFF
        group = r.u32_le()
        if version == MASPV5_TX_VERSION and group == MASPV5_VERSION_GROUP_ID:
            return TxVersion()
        raise ValueError("Unknown transaction format")

    @staticmethod
    def suggested_for_branch(branch_id: int) -> "TxVersion":
        return TxVersion()

    def __eq__(self, other):
        return isinstance(other, TxVersion) and self.kind == other.kind


@dataclass(frozen=True)
class TxId:
    data: bytes

    def __post_init__(self):
        assert len(self.data) == 32

    def __str__(self):
        return self.data[::-1].hex()


class TransactionData:
    def __init__(
        self,
        version: TxVersion,
        consensus_branch_id: int,
        lock_time: int,
        expiry_height: int,
        transparent_bundle: TransparentBundle | None,
        sapling_bundle: SaplingBundle | None,
    ):
        self.version = version
        self.consensus_branch_id = consensus_branch_id
        self.lock_time = lock_time
        self.expiry_height = expiry_height
        self.transparent_bundle = transparent_bundle
        self.sapling_bundle = sapling_bundle

    @staticmethod
    def from_parts(version, consensus_branch_id, lock_time, expiry_height,
                   transparent_bundle, sapling_bundle) -> "TransactionData":
        return TransactionData(
            version, consensus_branch_id, lock_time, expiry_height,
            transparent_bundle, sapling_bundle,
        )

    def digest(self, digester):
        return digester.combine(
            digester.digest_header(
                self.version, self.consensus_branch_id, self.lock_time, self.expiry_height
            ),
            digester.digest_transparent(self.transparent_bundle),
            digester.digest_sapling(self.sapling_bundle),
        )

    def sapling_value_balance(self) -> ValueSum:
        if self.sapling_bundle is None:
            return ValueSum.zero(I128)
        return self.sapling_bundle.value_balance

    def freeze(self) -> "Transaction":
        return Transaction.from_data(self)


class Transaction:
    def __init__(self, txid: TxId, data: TransactionData):
        self.txid_ = txid
        self.data = data

    @staticmethod
    def from_data(data: TransactionData) -> "Transaction":
        txid = to_txid(
            data.version, data.consensus_branch_id, data.digest(TxIdDigester())
        )
        return Transaction(TxId(txid), data)

    def txid(self) -> TxId:
        return self.txid_

    def auth_commitment(self) -> bytes:
        return self.data.digest(BlockTxCommitmentDigester())

    # pass-through accessors
    @property
    def version(self):
        return self.data.version

    @property
    def consensus_branch_id(self):
        return self.data.consensus_branch_id

    @property
    def transparent_bundle(self):
        return self.data.transparent_bundle

    @property
    def sapling_bundle(self):
        return self.data.sapling_bundle

    def __eq__(self, other):
        return isinstance(other, Transaction) and self.txid_ == other.txid_

    # --- v5 serialization -------------------------------------------------
    def write(self, w: Writer) -> None:
        d = self.data
        d.version.write(w)
        w.u32_le(d.consensus_branch_id)
        w.u32_le(d.lock_time)
        w.u32_le(d.expiry_height)
        self._write_transparent(w)
        self._write_v5_sapling(w)

    def to_bytes(self) -> bytes:
        w = Writer()
        self.write(w)
        return w.getvalue()

    def _write_transparent(self, w: Writer) -> None:
        b = self.data.transparent_bundle
        if b is not None:
            write_vector(w, b.vin, lambda w, e: e.write(w))
            write_vector(w, b.vout, lambda w, e: e.write(w))
        else:
            w.compact_size(0)
            w.compact_size(0)

    def _write_v5_sapling(self, w: Writer) -> None:
        b = self.data.sapling_bundle
        if b is None:
            w.compact_size(0)
            w.compact_size(0)
            w.compact_size(0)
            return
        write_vector(w, b.shielded_spends, lambda w, e: e.write_v5_without_witness_data(w))
        write_vector(w, b.shielded_converts, lambda w, e: e.write_v5_without_witness_data(w))
        write_vector(w, b.shielded_outputs, lambda w, e: e.write_v5_without_proof(w))
        if not b.is_empty():
            b.value_balance.write(w)
        if b.shielded_spends:
            w.write(b.shielded_spends[0].anchor.to_bytes())
        if b.shielded_converts:
            w.write(b.shielded_converts[0].anchor.to_bytes())
        for s in b.shielded_spends:
            w.write(s.zkproof)
        for s in b.shielded_spends:
            w.write(s.spend_auth_sig.to_bytes())
        for c in b.shielded_converts:
            w.write(c.zkproof)
        for o in b.shielded_outputs:
            w.write(o.zkproof)
        if not b.is_empty():
            w.write(b.authorization.binding_sig.to_bytes())

    @staticmethod
    def read(r: Reader, _consensus_branch_id: int | None = None) -> "Transaction":
        version = TxVersion.read(r)
        consensus_branch_id = BranchId.try_from(r.u32_le())
        lock_time = r.u32_le()
        expiry_height = r.u32_le()
        transparent_bundle = Transaction._read_transparent(r)
        sapling_bundle = Transaction._read_v5_sapling(r)
        data = TransactionData(
            version, consensus_branch_id, lock_time, expiry_height,
            transparent_bundle, sapling_bundle,
        )
        return Transaction.from_data(data)

    @staticmethod
    def from_bytes(data: bytes) -> "Transaction":
        return Transaction.read(Reader(data))

    @staticmethod
    def _read_transparent(r: Reader) -> TransparentBundle | None:
        vin = read_vector(r, TxIn.read)
        vout = read_vector(r, TxOut.read)
        if not vin and not vout:
            return None
        return TransparentBundle(vin=vin, vout=vout, authorization=transparent_mod)

    @staticmethod
    def _read_v5_sapling(r: Reader) -> SaplingBundle | None:
        sd_v5s = read_vector(r, SpendDescription.read_v5)
        cd_v5s = read_vector(r, ConvertDescription.read_v5)
        od_v5s = read_vector(r, OutputDescription.read_v5)
        n_spends, n_converts, n_outputs = len(sd_v5s), len(cd_v5s), len(od_v5s)
        has_any = n_spends > 0 or n_converts > 0 or n_outputs > 0
        value_balance = ValueSum.read(r, I128) if has_any else ValueSum.zero(I128)
        spend_anchor = read_base(r, "spend anchor") if n_spends else None
        convert_anchor = read_base(r, "convert anchor") if n_converts else None
        v_spend_proofs = [read_zkproof(r) for _ in range(n_spends)]
        v_spend_auth_sigs = [redjubjub.Signature.from_bytes(r.read(64)) for _ in range(n_spends)]
        v_convert_proofs = [read_zkproof(r) for _ in range(n_converts)]
        v_output_proofs = [read_zkproof(r) for _ in range(n_outputs)]
        binding_sig = redjubjub.Signature.from_bytes(r.read(64)) if has_any else None
        if binding_sig is None:
            return None
        return SaplingBundle(
            shielded_spends=[
                sd.into_spend_description(spend_anchor, proof, sig)
                for sd, proof, sig in zip(sd_v5s, v_spend_proofs, v_spend_auth_sigs)
            ],
            shielded_converts=[
                cd.into_convert_description(convert_anchor, proof)
                for cd, proof in zip(cd_v5s, v_convert_proofs)
            ],
            shielded_outputs=[
                od.into_output_description(proof)
                for od, proof in zip(od_v5s, v_output_proofs)
            ],
            value_balance=value_balance,
            authorization=SaplingAuthorized(binding_sig=binding_sig),
        )


__all__ = [
    "GROTH_PROOF_SIZE", "TxVersion", "TxId", "TransactionData", "Transaction",
    "MASPV5_TX_VERSION", "MASPV5_VERSION_GROUP_ID",
]
