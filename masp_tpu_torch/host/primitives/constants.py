# Copy of masp_tpu/primitives/constants.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""MASP protocol constants: personalizations and fixed-base generators.

Mirrors masp_primitives/src/constants.rs.  Unlike the reference (which
hardcodes generator coordinates, constants.rs:50-251), we *derive* every
generator from ``find_group_hash`` — the reference's own tests
(constants.rs:305-374) prove the two are equivalent, and tests/test_constants.py
pins the derived values against the reference's coordinates.
"""

from __future__ import annotations

from functools import lru_cache

from masp_tpu_torch.host.jubjub import ExtendedPoint
from masp_tpu_torch.host.primitives.group_hash import group_hash

# First 64 bytes of the BLAKE2s input during group hash (constants.rs:12).
GH_FIRST_BLOCK = b"096b36a5804bfacef1691e173c366a47ff5ba84a44f26ddd7e8d9f79d5b42df0"

# BLAKE2s personalizations (constants.rs:17-46). MASP-specific — these differ
# from Zcash Sapling.
CRH_IVK_PERSONALIZATION = b"MASP_ivk"
PRF_NF_PERSONALIZATION = b"MASP__nf"
PEDERSEN_HASH_GENERATORS_PERSONALIZATION = b"MASP__PH"
KEY_DIVERSIFICATION_PERSONALIZATION = b"MASP__gd"
SPENDING_KEY_GENERATOR_PERSONALIZATION = b"MASP__G_"
PROOF_GENERATION_KEY_BASE_GENERATOR_PERSONALIZATION = b"MASP__H_"
VALUE_COMMITMENT_GENERATOR_PERSONALIZATION = b"MASP__v_"
VALUE_COMMITMENT_RANDOMNESS_PERSONALIZATION = b"MASP__r_"
NULLIFIER_POSITION_IN_TREE_GENERATOR_PERSONALIZATION = b"MASP__J_"
ASSET_IDENTIFIER_PERSONALIZATION = b"MASP__t_"

ASSET_IDENTIFIER_LENGTH = 32

PEDERSEN_HASH_CHUNKS_PER_GENERATOR = 63
PEDERSEN_HASH_EXP_WINDOW_SIZE = 8


def find_group_hash(m: bytes, personalization: bytes) -> ExtendedPoint:
    """Iterate a one-byte counter until group_hash succeeds
    (constants.rs:305-321)."""
    tag = bytearray(m)
    i = len(tag)
    tag.append(0)
    while True:
        gh = group_hash(bytes(tag), personalization)
        assert tag[i] != 0xFF, "group hash rejection loop overflow"
        tag[i] += 1
        if gh is not None:
            return gh


@lru_cache(maxsize=None)
def proof_generation_key_generator() -> ExtendedPoint:
    return find_group_hash(b"", PROOF_GENERATION_KEY_BASE_GENERATOR_PERSONALIZATION)


@lru_cache(maxsize=None)
def note_commitment_randomness_generator() -> ExtendedPoint:
    return find_group_hash(b"r", PEDERSEN_HASH_GENERATORS_PERSONALIZATION)


@lru_cache(maxsize=None)
def nullifier_position_generator() -> ExtendedPoint:
    return find_group_hash(b"", NULLIFIER_POSITION_IN_TREE_GENERATOR_PERSONALIZATION)


@lru_cache(maxsize=None)
def value_commitment_randomness_generator() -> ExtendedPoint:
    return find_group_hash(b"r", VALUE_COMMITMENT_RANDOMNESS_PERSONALIZATION)


@lru_cache(maxsize=None)
def spending_key_generator() -> ExtendedPoint:
    return find_group_hash(b"", SPENDING_KEY_GENERATOR_PERSONALIZATION)


@lru_cache(maxsize=None)
def pedersen_hash_generators() -> tuple[ExtendedPoint, ...]:
    """Six per-segment Pedersen generators (constants.rs:152-251,364-374)."""
    return tuple(
        find_group_hash(
            m.to_bytes(4, "little"), PEDERSEN_HASH_GENERATORS_PERSONALIZATION
        )
        for m in range(6)
    )


@lru_cache(maxsize=None)
def pedersen_hash_exp_table() -> list[list[list[ExtendedPoint]]]:
    """8-bit-window exponentiation tables for each Pedersen generator
    (constants.rs:259-296): table[gen][window][index] = index * 2^(8*window) * g.
    """
    from masp_tpu_torch.host.fields import JubjubFr

    window = PEDERSEN_HASH_EXP_WINDOW_SIZE
    num_bits = JubjubFr.META.num_bits  # 252
    out = []
    for g in pedersen_hash_generators():
        tables = []
        bits = 0
        while bits <= num_bits:
            table = []
            base = ExtendedPoint.identity()
            for _ in range(1 << window):
                table.append(base)
                base = base + g
            tables.append(table)
            bits += window
            for _ in range(window):
                g = g.double()
        out.append(tables)
    return out


__all__ = [
    "GH_FIRST_BLOCK",
    "CRH_IVK_PERSONALIZATION", "PRF_NF_PERSONALIZATION",
    "PEDERSEN_HASH_GENERATORS_PERSONALIZATION",
    "KEY_DIVERSIFICATION_PERSONALIZATION",
    "SPENDING_KEY_GENERATOR_PERSONALIZATION",
    "PROOF_GENERATION_KEY_BASE_GENERATOR_PERSONALIZATION",
    "VALUE_COMMITMENT_GENERATOR_PERSONALIZATION",
    "VALUE_COMMITMENT_RANDOMNESS_PERSONALIZATION",
    "NULLIFIER_POSITION_IN_TREE_GENERATOR_PERSONALIZATION",
    "ASSET_IDENTIFIER_PERSONALIZATION", "ASSET_IDENTIFIER_LENGTH",
    "PEDERSEN_HASH_CHUNKS_PER_GENERATOR", "PEDERSEN_HASH_EXP_WINDOW_SIZE",
    "find_group_hash",
    "proof_generation_key_generator", "note_commitment_randomness_generator",
    "nullifier_position_generator", "value_commitment_randomness_generator",
    "spending_key_generator", "pedersen_hash_generators",
    "pedersen_hash_exp_table",
]
