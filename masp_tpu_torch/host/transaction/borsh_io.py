# Copy of masp_tpu/transaction/borsh_io.py, verbatim apart from import paths. The port imports nothing of
# masp_tpu.
"""Borsh serialization for the builder/checkpoint types, byte-compatible
with the reference's BorshSerialize/BorshDeserialize impls.

What Namada persists through borsh and where the reference defines the
layout:

- StoredBuildParams + {Spend,Convert,Output}BuildParams — replayable build
  randomness for deterministic rebuilds / hardware wallets
  (masp_primitives/src/transaction/components/sapling/builder.rs:96-283)
- SpendDescriptionInfo / ConvertDescriptionInfo / SaplingOutputInfo /
  SaplingMetadata / SaplingBuilder (builder.rs:443-467, 494-501, 595-599,
  743-752, 1218-1223)
- TransparentBuilder (+ TransparentInputInfo)
  (transparent/builder.rs:50-67)
- Builder (transaction/builder.rs:119-128; progress_notifier is
  #[borsh(skip)])
- Note / Rseed (sapling.rs:667-955), MerklePath (merkle_tree.rs:789-866 —
  identical to the legacy witness format already implemented),
  PaymentAddress (sapling.rs:605-617), AssetType (asset_type.rs:19-24:
  identifier only, nonce skipped)

Types whose borsh form equals an existing byte format and need no new
code here: Transaction (== v5 wire format, transaction.rs:352-365),
ValueSum (== Vector write, amount.rs:203-231), AllowedConversion
(convert.rs:138-160), ExtendedSpendingKey (zip32/sapling.rs:534-545),
TxIn/TxOut (transparent.rs:155-250). The helpers below delegate to those.
"""

from __future__ import annotations

from masp_tpu_torch.host.primitives.asset_type import AssetType
from masp_tpu_torch.host.primitives.keys import OutgoingViewingKey
from masp_tpu_torch.host.primitives.memo import MemoBytes
from masp_tpu_torch.host.primitives.merkle_tree import MerklePath
from masp_tpu_torch.host.primitives.sapling import Diversifier, Note, PaymentAddress, Rseed
from masp_tpu_torch.host.jubjub import ExtendedPoint, JubjubFr
from masp_tpu_torch.host.primitives.zip32 import ExtendedSpendingKey
from masp_tpu_torch.host.transaction.amount import I128, ValueSum
from masp_tpu_torch.host.transaction.components.sapling_builder import (
    ConvertBuildParams, ConvertDescriptionInfo, OutputBuildParams,
    SaplingBuilder, SaplingMetadata, SaplingOutputInfo, SpendBuildParams,
    SpendDescriptionInfo, StoredBuildParams,
)
from masp_tpu_torch.host.transaction.components.transparent import TxIn, TxOut
from masp_tpu_torch.host.transaction.components.transparent_builder import TransparentBuilder
from masp_tpu_torch.host import borsh as B
from masp_tpu_torch.host.encoding import Reader, Writer


def _fr_from_bytes(b: bytes) -> JubjubFr:
    fr = JubjubFr.from_bytes(b)
    if fr is None:
        raise ValueError("scalar not in field")
    return fr


# --- build params (sapling/builder.rs:96-283) ------------------------------


def write_spend_build_params(w: Writer, p: SpendBuildParams) -> None:
    w.write(p.rcv.to_bytes())
    w.write(p.alpha.to_bytes())


def read_spend_build_params(r: Reader) -> SpendBuildParams:
    rcv = _fr_from_bytes(r.read(32))
    alpha = _fr_from_bytes(r.read(32))
    return SpendBuildParams(rcv=rcv, alpha=alpha)


def write_convert_build_params(w: Writer, p: ConvertBuildParams) -> None:
    w.write(p.rcv.to_bytes())


def read_convert_build_params(r: Reader) -> ConvertBuildParams:
    return ConvertBuildParams(rcv=_fr_from_bytes(r.read(32)))


def write_output_build_params(w: Writer, p: OutputBuildParams) -> None:
    w.write(p.rcv.to_bytes())
    w.write(p.rcm.to_bytes())
    B.write_bytes_fixed(w, p.rseed, 32)


def read_output_build_params(r: Reader) -> OutputBuildParams:
    rcv = _fr_from_bytes(r.read(32))
    rcm = _fr_from_bytes(r.read(32))
    rseed = r.read(32)
    return OutputBuildParams(rcv=rcv, rcm=rcm, rseed=rseed)


def write_stored_build_params(w: Writer, p: StoredBuildParams) -> None:
    B.write_vec(w, p.spend_params, write_spend_build_params)
    B.write_vec(w, p.convert_params, write_convert_build_params)
    B.write_vec(w, p.output_params, write_output_build_params)


def read_stored_build_params(r: Reader) -> StoredBuildParams:
    return StoredBuildParams(
        spend_params=B.read_vec(r, read_spend_build_params),
        convert_params=B.read_vec(r, read_convert_build_params),
        output_params=B.read_vec(r, read_output_build_params),
    )


# --- notes and paths -------------------------------------------------------


def write_rseed(w: Writer, rseed: Rseed) -> None:
    """Enum tag 1 = BeforeZip212 (rcm repr), 2 = AfterZip212 (raw bytes)
    (sapling.rs:667-686)."""
    if rseed.kind == Rseed.BEFORE:
        B.write_u8(w, 1)
        w.write(rseed.rcm_value.to_bytes())
    else:
        B.write_u8(w, 2)
        B.write_bytes_fixed(w, rseed.rseed_bytes, 32)


def read_rseed(r: Reader) -> Rseed:
    tag = B.read_u8(r)
    data = r.read(32)
    if tag == 1:
        return Rseed.before_zip212(_fr_from_bytes(data))
    # reference treats any non-1 tag as AfterZip212 (sapling.rs:687-705)
    return Rseed.after_zip212(data)


def write_note(w: Writer, note: Note) -> None:
    w.write(note.asset_type.identifier)
    B.write_u64(w, note.value)
    w.write(note.g_d.to_bytes())
    w.write(note.pk_d.to_bytes())
    write_rseed(w, note.rseed)


def read_note(r: Reader) -> Note:
    atype = AssetType.from_identifier(r.read(32))
    if atype is None:
        raise ValueError("invalid asset type")
    value = B.read_u64(r)
    g_d = ExtendedPoint.from_bytes(r.read(32))
    pk_d = ExtendedPoint.from_bytes(r.read(32))
    if g_d is None or pk_d is None:
        raise ValueError("invalid note point")
    rseed = read_rseed(r)
    return Note(asset_type=atype, value=value, g_d=g_d, pk_d=pk_d, rseed=rseed)


def write_payment_address(w: Writer, addr: PaymentAddress) -> None:
    w.write(addr.to_bytes())


def read_payment_address(r: Reader) -> PaymentAddress:
    addr = PaymentAddress.from_bytes(r.read(43))
    if addr is None:
        raise ValueError("invalid payment address")
    return addr


# --- builder info records (sapling/builder.rs) -----------------------------


def write_spend_description_info(w: Writer, info: SpendDescriptionInfo) -> None:
    w.write(info.extsk.to_bytes())
    B.write_bytes_fixed(w, info.diversifier.d, 11)
    write_note(w, info.note)
    info.merkle_path.write(w)


def read_spend_description_info(r: Reader) -> SpendDescriptionInfo:
    extsk = ExtendedSpendingKey.from_bytes(r.read(169))
    diversifier = Diversifier(r.read(11))
    note = read_note(r)
    merkle_path = MerklePath.read(r)
    return SpendDescriptionInfo(
        extsk=extsk, diversifier=diversifier, note=note, merkle_path=merkle_path
    )


def write_convert_description_info(w: Writer, info: ConvertDescriptionInfo) -> None:
    info.allowed.write(w)
    B.write_u64(w, info.value)
    info.merkle_path.write(w)


def read_convert_description_info(r: Reader) -> ConvertDescriptionInfo:
    from masp_tpu_torch.host.primitives.convert import AllowedConversion

    allowed = AllowedConversion.read(r)
    value = B.read_u64(r)
    merkle_path = MerklePath.read(r)
    return ConvertDescriptionInfo(allowed=allowed, value=value, merkle_path=merkle_path)


def write_sapling_output_info(w: Writer, info: SaplingOutputInfo) -> None:
    """ovk Option + PaymentAddress + Note<()> + MemoBytes
    (builder.rs:494-501). Note<()> carries no rseed payload; g_d/pk_d come
    from the recipient address."""
    B.write_option(w, info.ovk, lambda w, ovk: B.write_bytes_fixed(w, ovk.data, 32))
    write_payment_address(w, info.to)
    w.write(info.asset_type.identifier)
    B.write_u64(w, info.value)
    w.write(info.to.g_d().to_bytes())
    w.write(info.to.pk_d.to_bytes())
    B.write_bytes_fixed(w, info.memo.data, 512)


def read_sapling_output_info(r: Reader) -> SaplingOutputInfo:
    ovk = B.read_option(r, lambda r: OutgoingViewingKey(r.read(32)))
    to = read_payment_address(r)
    atype = AssetType.from_identifier(r.read(32))
    if atype is None:
        raise ValueError("invalid asset type")
    value = B.read_u64(r)
    g_d = ExtendedPoint.from_bytes(r.read(32))
    pk_d = ExtendedPoint.from_bytes(r.read(32))
    if g_d is None or pk_d is None:
        raise ValueError("invalid note point")
    if g_d != to.g_d() or pk_d != to.pk_d:
        raise ValueError("note points inconsistent with payment address")
    memo = MemoBytes(r.read(512))
    return SaplingOutputInfo(ovk=ovk, to=to, asset_type=atype, value=value, memo=memo)


def write_sapling_metadata(w: Writer, m: SaplingMetadata) -> None:
    B.write_vec(w, m.spend_indices, B.write_usize)
    B.write_vec(w, m.convert_indices, B.write_usize)
    B.write_vec(w, m.output_indices, B.write_usize)


def read_sapling_metadata(r: Reader) -> SaplingMetadata:
    return SaplingMetadata(
        spend_indices=B.read_vec(r, B.read_usize),
        convert_indices=B.read_vec(r, B.read_usize),
        output_indices=B.read_vec(r, B.read_usize),
    )


# --- builders --------------------------------------------------------------


def _write_scalar_opt(w: Writer, v: int | None) -> None:
    B.write_option(w, v, lambda w, n: w.write(int(n).to_bytes(32, "little")))


def _read_scalar_opt(r: Reader) -> int | None:
    from masp_tpu_torch.host.bls12_381 import R

    def rd(r):
        n = int.from_bytes(r.read(32), "little")
        if n >= R:
            raise ValueError("anchor not in field")
        return n

    return B.read_option(r, rd)


def write_sapling_builder(w: Writer, b: SaplingBuilder) -> None:
    """Field order per the derive (builder.rs:743-752): params (unit
    consensus struct, zero bytes), spend_anchor, target_height,
    value_balance, convert_anchor, spends, converts, outputs."""
    _write_scalar_opt(w, b.spend_anchor)
    B.write_u32(w, b.target_height)
    b.value_balance.write(w)
    _write_scalar_opt(w, b.convert_anchor)
    B.write_vec(w, b.spends, write_spend_description_info)
    B.write_vec(w, b.converts, write_convert_description_info)
    B.write_vec(w, b.outputs, write_sapling_output_info)


def read_sapling_builder(r: Reader, params) -> SaplingBuilder:
    spend_anchor = _read_scalar_opt(r)
    target_height = B.read_u32(r)
    value_balance = ValueSum.read(r, I128)
    convert_anchor = _read_scalar_opt(r)
    b = SaplingBuilder(params, target_height)
    b.spend_anchor = spend_anchor
    b.value_balance = value_balance
    b.convert_anchor = convert_anchor
    b.spends = B.read_vec(r, read_spend_description_info)
    b.converts = B.read_vec(r, read_convert_description_info)
    b.outputs = B.read_vec(r, read_sapling_output_info)
    return b


def _write_txout(w: Writer, t) -> None:
    w.write(t.asset_type.identifier)
    B.write_u64(w, t.value)
    B.write_bytes_fixed(w, t.address.data, 20)


def _read_txout(r: Reader) -> TxOut:
    from masp_tpu_torch.host.transaction.components.transparent import TransparentAddress

    atype = AssetType.from_identifier(r.read(32))
    if atype is None:
        raise ValueError("invalid asset type")
    value = B.read_u64(r)
    addr = TransparentAddress(r.read(20))
    return TxOut(asset_type=atype, value=value, address=addr)


def write_transparent_builder(w: Writer, b: TransparentBuilder) -> None:
    """inputs: Vec<TransparentInputInfo { coin: TxOut }> then vout
    (transparent/builder.rs:50-67)."""
    B.write_vec(w, b.vin, _write_txout)
    B.write_vec(w, b.vout, _write_txout)


def read_transparent_builder(r: Reader) -> TransparentBuilder:
    b = TransparentBuilder()
    for coin in B.read_vec(r, _read_txout):
        b.vin.append(TxIn(asset_type=coin.asset_type, value=coin.value, address=coin.address))
    b.vout = B.read_vec(r, _read_txout)
    return b


def write_builder(w: Writer, b) -> None:
    """Builder derive (transaction/builder.rs:119-128): params (unit),
    target_height, expiry_height, transparent_builder, sapling_builder;
    progress_notifier is #[borsh(skip)]."""
    B.write_u32(w, b.target_height)
    B.write_u32(w, b.expiry_height)
    write_transparent_builder(w, b.transparent_builder)
    write_sapling_builder(w, b.sapling_builder)


def read_builder(r: Reader, params):
    from masp_tpu_torch.host.transaction.builder import Builder

    target_height = B.read_u32(r)
    expiry_height = B.read_u32(r)
    b = Builder(params, target_height, expiry_height)
    b.transparent_builder = read_transparent_builder(r)
    b.sapling_builder = read_sapling_builder(r, params)
    return b


def _to_bytes(write_fn, value) -> bytes:
    w = Writer()
    write_fn(w, value)
    return w.getvalue()


# --- delegating borsh forms --------------------------------------------------


def value_sum_to_borsh(vs: ValueSum) -> bytes:
    """ValueSum BorshSerialize (amount.rs:203-216): identical to the legacy
    Vector write — CompactSize count + (identifier, value-LE) pairs in
    BTreeMap (identifier) order."""
    return vs.to_bytes()


def value_sum_from_borsh(data: bytes, vtype=I128) -> ValueSum:
    """ValueSum BorshDeserialize (amount.rs:218-231). Unlike ValueSum::read,
    the borsh path reads AssetType via its derived impl — raw identifier
    bytes with NO generator-validity check — so this accepts identifiers
    that ValueSum.read would reject."""
    from masp_tpu_torch.host.encoding import read_vector

    r = Reader(data)
    nbytes = vtype.bits // 8

    def read_item(rr):
        ident = rr.read(32)
        v = int.from_bytes(rr.read(nbytes), "little", signed=vtype.signed)
        return (AssetType(ident, None), v)

    items = read_vector(r, read_item)
    out = ValueSum.zero(vtype)
    for atype, v in items:
        out = out + ValueSum.from_pair(atype, v, vtype)
    return out


def transaction_to_borsh(tx) -> bytes:
    """Transaction BorshSerialize == its MASPv5 wire write
    (transaction.rs:352-357)."""
    return tx.to_bytes()


def transaction_from_borsh(data: bytes):
    """Transaction BorshDeserialize == Transaction::read under the MASP
    consensus branch (transaction.rs:358-364)."""
    from masp_tpu_torch.host.transaction.transaction import Transaction

    return Transaction.read(Reader(data))


def stored_build_params_to_bytes(p: StoredBuildParams) -> bytes:
    return _to_bytes(write_stored_build_params, p)


def stored_build_params_from_bytes(data: bytes) -> StoredBuildParams:
    return read_stored_build_params(Reader(data))


def builder_to_bytes(b) -> bytes:
    return _to_bytes(write_builder, b)


def builder_from_bytes(data: bytes, params):
    return read_builder(Reader(data), params)


__all__ = [
    "write_stored_build_params", "read_stored_build_params",
    "stored_build_params_to_bytes", "stored_build_params_from_bytes",
    "write_spend_build_params", "read_spend_build_params",
    "write_convert_build_params", "read_convert_build_params",
    "write_output_build_params", "read_output_build_params",
    "write_note", "read_note", "write_rseed", "read_rseed",
    "write_payment_address", "read_payment_address",
    "write_spend_description_info", "read_spend_description_info",
    "write_convert_description_info", "read_convert_description_info",
    "write_sapling_output_info", "read_sapling_output_info",
    "write_sapling_metadata", "read_sapling_metadata",
    "write_sapling_builder", "read_sapling_builder",
    "write_transparent_builder", "read_transparent_builder",
    "write_builder", "read_builder",
    "builder_to_bytes", "builder_from_bytes",
    "value_sum_to_borsh", "value_sum_from_borsh",
    "transaction_to_borsh", "transaction_from_borsh",
]
