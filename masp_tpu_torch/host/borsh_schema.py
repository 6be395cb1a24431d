# Copy of masp_tpu/utils/borsh_schema.py, verbatim apart from import paths. The port imports nothing of
# masp_tpu.
"""Borsh schema descriptions (borsh-rs ``BorshSchema`` equivalent).

Namada introspects masp_primitives types through borsh's self-describing
schema machinery; the reference hand-writes or derives ``BorshSchema`` for
its public types (masp_primitives/src/transaction.rs:382-553 Transaction,
components/amount.rs:233-280 ValueSum, components/sapling.rs:288-307 /
427-446 / 603-617 the V5 descriptions, consensus.rs:290-305 BranchId,
transaction.rs:169-196 TxVersion). This module mirrors that model:

- a ``Declaration`` is a string naming a type ("u32", "[u8; 32]",
  "Transaction", ...),
- a ``Definition`` describes its layout (Primitive / Sequence / Tuple /
  Enum / Struct, matching borsh-rs 1.x ``borsh::schema::Definition``),
- each schema'd type contributes ``(declaration, definitions)`` via
  ``add_definitions_recursively`` semantics.

``schema_container(name)`` returns the full definition map for a root
type, like borsh-rs ``BorshSchemaContainer::for_type``.
"""

from __future__ import annotations

from dataclasses import dataclass, field


# --- definition model (borsh::schema::Definition) ---------------------------


@dataclass(frozen=True)
class Primitive:
    size: int  # bytes


@dataclass(frozen=True)
class Sequence:
    length_width: int  # 0 = no length prefix (fixed/externally counted)
    length_range: tuple[int, int]  # inclusive
    elements: str


@dataclass(frozen=True)
class Tuple:
    elements: tuple[str, ...]


@dataclass(frozen=True)
class Enum:
    tag_width: int
    variants: tuple[tuple[int, str, str], ...]  # (discriminant, name, decl)


@dataclass(frozen=True)
class Struct:
    # exactly one of named / unnamed is set; both empty = unit struct
    named: tuple[tuple[str, str], ...] = ()
    unnamed: tuple[str, ...] = ()


U64_MAX = (1 << 64) - 1


def add_definition(decl: str, definition, definitions: dict) -> None:
    existing = definitions.get(decl)
    if existing is not None and existing != definition:
        raise ValueError(f"conflicting definitions for {decl!r}")
    definitions[decl] = definition


# --- primitives and combinators ---------------------------------------------

_PRIMITIVES = {
    "u8": 1, "u16": 2, "u32": 4, "u64": 8, "u128": 16,
    "i8": 1, "i16": 2, "i32": 4, "i64": 8, "i128": 16,
    "bool": 1, "()": 0,
}


def primitive(name: str, definitions: dict) -> str:
    add_definition(name, Primitive(_PRIMITIVES[name]), definitions)
    return name


def array(elem: str, n: int, definitions: dict) -> str:
    """[T; N] — fixed array, no length prefix."""
    decl = f"[{elem}; {n}]"
    add_definition(decl, Sequence(0, (n, n), elem), definitions)
    return decl


def tuple_decl(elems: tuple[str, ...], definitions: dict) -> str:
    decl = "(" + ", ".join(elems) + ")"
    add_definition(decl, Tuple(elems), definitions)
    return decl


def compact_size(owner: str, definitions: dict) -> str:
    """The Zcash CompactSize pseudo-type the reference declares per owner
    (amount.rs:237-247, transaction.rs:386-398): a 1-byte-tag enum whose
    253/254/255 variants carry u16/u32/u64 (values <253 are inline)."""
    decl = f"{owner}::CompactSize"
    add_definition(
        decl,
        Enum(1, ((253, "u16", "u16"), (254, "u32", "u32"), (255, "u64", "u64"))),
        definitions,
    )
    primitive("u16", definitions)
    primitive("u32", definitions)
    primitive("u64", definitions)
    return decl


def untagged_vec(owner_field: str, elem: str, definitions: dict) -> str:
    """untagged_vec::<X>() (transaction.rs:365-371): items with no inline
    count (the count travels separately as a CompactSize field)."""
    add_definition(owner_field, Sequence(0, (0, U64_MAX), elem), definitions)
    return owner_field


def untagged_option(owner_field: str, some: str, definitions: dict) -> str:
    """untagged_option::<X>() (transaction.rs:373-380): presence is implied
    by other fields, so tag_width = 0."""
    add_definition(
        owner_field, Enum(0, ((0, "None", "()"), (1, "Some", some))), definitions
    )
    primitive("()", definitions)
    return owner_field


# --- leaf type schemas (derived in the reference) ----------------------------


def _newtype(decl: str, inner: str, definitions: dict) -> str:
    add_definition(decl, Struct(unnamed=(inner,)), definitions)
    return decl


def nullifier(definitions: dict) -> str:
    # sapling.rs:719 Nullifier(pub [u8; 32]), derived
    return _newtype("Nullifier", array("u8", 32, definitions), definitions)


def public_key(definitions: dict) -> str:
    # redjubjub.rs:78-92 hand-written: PublicKey([u8; 32])
    return _newtype("PublicKey", array("u8", 32, definitions), definitions)


def nullifier_deriving_key(definitions: dict) -> str:
    # sapling.rs:302-314 hand-written newtype over [u8; 32]
    return _newtype(
        "NullifierDerivingKey", array("u8", 32, definitions), definitions
    )


def ephemeral_key_bytes(definitions: dict) -> str:
    # masp_note_encryption/src/lib.rs:94 EphemeralKeyBytes(pub [u8; 32])
    return _newtype(
        "EphemeralKeyBytes", array("u8", 32, definitions), definitions
    )


def transparent_address(definitions: dict) -> str:
    # transaction.rs:58 TransparentAddress(pub [u8; 20]), derived
    return _newtype(
        "TransparentAddress", array("u8", 20, definitions), definitions
    )


def block_height(definitions: dict) -> str:
    # consensus.rs:21 BlockHeight(u32), derived
    return _newtype("BlockHeight", primitive("u32", definitions), definitions)


def signature(definitions: dict) -> str:
    # redjubjub.rs:42-46 Signature { rbar: [u8; 32], sbar: [u8; 32] }, derived
    a32 = array("u8", 32, definitions)
    add_definition(
        "Signature", Struct(named=(("rbar", a32), ("sbar", a32))), definitions
    )
    return "Signature"


def sapling_authorized(definitions: dict) -> str:
    # components/sapling.rs:51-54 Authorized { binding_sig: Signature }, derived
    add_definition(
        "Authorized",
        Struct(named=(("binding_sig", signature(definitions)),)),
        definitions,
    )
    return "Authorized"


def asset_type(definitions: dict) -> str:
    # asset_type.rs:19-24: identifier [u8; 32]; nonce is #[borsh(skip)]
    add_definition(
        "AssetType",
        Struct(named=(("identifier", array("u8", 32, definitions)),)),
        definitions,
    )
    return "AssetType"


def branch_id(definitions: dict) -> str:
    # consensus.rs:290-305: 4-byte-tag enum, single MASP variant
    add_definition(
        "BranchId", Enum(4, ((0xE9FF_75A6, "MASP", "()"),)), definitions
    )
    primitive("()", definitions)
    return "BranchId"


def tx_version(definitions: dict) -> str:
    # transaction.rs:181-196: header + version_group_id
    u32 = primitive("u32", definitions)
    add_definition(
        "TxVersion",
        Struct(named=(("header", u32), ("version_group_id", u32))),
        definitions,
    )
    return "TxVersion"


# --- composite schemas (hand-written in the reference) -----------------------


def value_sum(unit: str, value: str, definitions: dict) -> str:
    """ValueSum<Unit, Value> (amount.rs:233-280): CompactSize count +
    unprefixed sequence of (Unit, Value) pairs."""
    decl = f"ValueSum<{unit}, {value}>"
    cs = compact_size(decl, definitions)
    pair = tuple_decl((unit, value), definitions)
    seq = f"{decl}::Sequence"
    add_definition(seq, Sequence(0, (0, U64_MAX), pair), definitions)
    add_definition(decl, Struct(unnamed=(cs, seq)), definitions)
    return decl


def i128_sum(definitions: dict) -> str:
    primitive("i128", definitions)
    return value_sum(asset_type(definitions), "i128", definitions)


def tx_in_authorized(definitions: dict) -> str:
    # transparent.rs:167-187 (MASP has no script: asset/value/address)
    add_definition(
        "TxIn<Authorized>",
        Struct(
            named=(
                ("asset_type", asset_type(definitions)),
                ("value", primitive("u64", definitions)),
                ("address", transparent_address(definitions)),
            )
        ),
        definitions,
    )
    return "TxIn<Authorized>"


def tx_out(definitions: dict) -> str:
    # transparent.rs:249-267
    add_definition(
        "TxOut",
        Struct(
            named=(
                ("asset_type", asset_type(definitions)),
                ("value", primitive("u64", definitions)),
                ("address", transparent_address(definitions)),
            )
        ),
        definitions,
    )
    return "TxOut"


def spend_description_v5(definitions: dict) -> str:
    # components/sapling.rs:288-307
    add_definition(
        "SpendDescriptionV5",
        Struct(
            named=(
                ("cv", array("u8", 32, definitions)),
                ("nullifier", nullifier(definitions)),
                ("rk", public_key(definitions)),
            )
        ),
        definitions,
    )
    return "SpendDescriptionV5"


def output_description_v5(definitions: dict) -> str:
    # components/sapling.rs:427-446
    add_definition(
        "OutputDescriptionV5",
        Struct(
            named=(
                ("cv", array("u8", 32, definitions)),
                ("cmu", array("u8", 32, definitions)),
                ("ephemeral_key", ephemeral_key_bytes(definitions)),
                ("enc_ciphertext", array("u8", 612, definitions)),
                ("out_ciphertext", array("u8", 80, definitions)),
            )
        ),
        definitions,
    )
    return "OutputDescriptionV5"


def convert_description_v5(definitions: dict) -> str:
    # components/sapling.rs:603-617
    add_definition(
        "ConvertDescriptionV5",
        Struct(named=(("cv", array("u8", 32, definitions)),)),
        definitions,
    )
    return "ConvertDescriptionV5"


GROTH_PROOF_SIZE = 48 + 96 + 48


def transaction(definitions: dict) -> str:
    """Transaction (transaction.rs:382-553): the MASPv5 wire layout described
    field-by-field — counts as per-owner CompactSize pseudo-types, vectors
    and options untagged (their counts/presence live in sibling fields)."""
    decl = "Transaction"
    cs = compact_size(decl, definitions)
    untagged_vec(f"{decl}::vin", tx_in_authorized(definitions), definitions)
    untagged_vec(f"{decl}::vout", tx_out(definitions), definitions)
    untagged_vec(f"{decl}::sd_v5s", spend_description_v5(definitions), definitions)
    untagged_vec(f"{decl}::cd_v5s", convert_description_v5(definitions), definitions)
    untagged_vec(f"{decl}::od_v5s", output_description_v5(definitions), definitions)
    untagged_option(f"{decl}::value_balance", i128_sum(definitions), definitions)
    untagged_option(
        f"{decl}::spend_anchor", array("u8", 32, definitions), definitions
    )
    untagged_option(
        f"{decl}::convert_anchor", array("u8", 32, definitions), definitions
    )
    proof = array("u8", GROTH_PROOF_SIZE, definitions)
    untagged_vec(f"{decl}::v_spend_proofs", proof, definitions)
    untagged_vec(f"{decl}::v_spend_auth_sigs", signature(definitions), definitions)
    untagged_vec(f"{decl}::v_convert_proofs", proof, definitions)
    untagged_vec(f"{decl}::v_output_proofs", proof, definitions)
    untagged_option(
        f"{decl}::authorization", sapling_authorized(definitions), definitions
    )
    add_definition(
        decl,
        Struct(
            named=(
                ("version", tx_version(definitions)),
                ("consensus_branch_id", branch_id(definitions)),
                ("lock_time", primitive("u32", definitions)),
                ("expiry_height", block_height(definitions)),
                ("vin::count", cs),
                ("vin", f"{decl}::vin"),
                ("vout::count", cs),
                ("vout", f"{decl}::vout"),
                ("sd_v5s::count", cs),
                ("sd_v5s", f"{decl}::sd_v5s"),
                ("cd_v5s::count", cs),
                ("cd_v5s", f"{decl}::cd_v5s"),
                ("od_v5s::count", cs),
                ("od_v5s", f"{decl}::od_v5s"),
                ("value_balance", f"{decl}::value_balance"),
                ("spend_anchor", f"{decl}::spend_anchor"),
                ("convert_anchor", f"{decl}::convert_anchor"),
                ("v_spend_proofs", f"{decl}::v_spend_proofs"),
                ("v_spend_auth_sigs", f"{decl}::v_spend_auth_sigs"),
                ("v_convert_proofs", f"{decl}::v_convert_proofs"),
                ("v_output_proofs", f"{decl}::v_output_proofs"),
                ("authorization", f"{decl}::authorization"),
            )
        ),
        definitions,
    )
    primitive("u8", definitions)
    return decl


_ROOTS = {
    "Transaction": transaction,
    "I128Sum": i128_sum,
    "TxVersion": tx_version,
    "BranchId": branch_id,
    "AssetType": asset_type,
    "TxIn<Authorized>": tx_in_authorized,
    "TxOut": tx_out,
    "SpendDescriptionV5": spend_description_v5,
    "OutputDescriptionV5": output_description_v5,
    "ConvertDescriptionV5": convert_description_v5,
    "Signature": signature,
    "Authorized": sapling_authorized,
}


def schema_container(root: str) -> tuple[str, dict]:
    """(declaration, definitions) for a root type — the equivalent of
    borsh-rs ``BorshSchemaContainer::for_type``."""
    builder = _ROOTS.get(root)
    if builder is None:
        raise KeyError(f"no schema registered for {root!r}")
    definitions: dict = {}
    decl = builder(definitions)
    return decl, dict(sorted(definitions.items()))


__all__ = [
    "Primitive", "Sequence", "Tuple", "Enum", "Struct",
    "add_definition", "schema_container",
]
