# Copy of masp_tpu/primitives/group_hash.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""Group hashing into the Jubjub prime-order subgroup.

Mirrors masp_primitives/src/sapling/group_hash.rs: BLAKE2s(personalization,
GH_FIRST_BLOCK || tag) -> point decode -> clear cofactor -> reject identity.
"""

from __future__ import annotations

import hashlib

from masp_tpu_torch.host.jubjub import ExtendedPoint


def group_hash(tag: bytes, personalization: bytes) -> ExtendedPoint | None:
    assert len(personalization) == 8
    # import here to avoid a cycle with constants.py
    from masp_tpu_torch.host.primitives.constants import GH_FIRST_BLOCK

    h = hashlib.blake2s(digest_size=32, person=personalization)
    h.update(GH_FIRST_BLOCK)
    h.update(tag)
    p = ExtendedPoint.from_bytes(h.digest())
    if p is None:
        return None
    p = p.clear_cofactor()
    if p.is_identity():
        return None
    return p


__all__ = ["group_hash"]
