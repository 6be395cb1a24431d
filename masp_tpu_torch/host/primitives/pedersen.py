# Copy of masp_tpu/primitives/pedersen.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""Native (out-of-circuit) Pedersen hash on Jubjub.

Mirrors masp_primitives/src/sapling/pedersen_hash.rs: 3-bit chunk encoding
with conditional negation, 63 chunks per generator segment, 8-bit windowed
exp-table lookups.  Used for note commitments and Merkle node hashing.

Vectorized/batched evaluation for witness generation lives in
masp_tpu.ops.pedersen_jax.
"""

from __future__ import annotations

from typing import Iterable

from masp_tpu_torch.host.jubjub import ExtendedPoint
from masp_tpu_torch.host.fields import JubjubFr
from masp_tpu_torch.host.primitives.constants import (
    PEDERSEN_HASH_CHUNKS_PER_GENERATOR,
    PEDERSEN_HASH_EXP_WINDOW_SIZE,
    pedersen_hash_exp_table,
)


class Personalization:
    """Domain prefix (6 bits) of the Pedersen hash input."""

    NOTE_COMMITMENT = "note"

    def __init__(self, kind: str, num: int = 0):
        self.kind = kind
        self.num = num

    @staticmethod
    def note_commitment() -> "Personalization":
        return Personalization(Personalization.NOTE_COMMITMENT)

    @staticmethod
    def merkle_tree(num: int) -> "Personalization":
        assert num < 63
        return Personalization("merkle", num)

    def get_bits(self) -> list[bool]:
        if self.kind == Personalization.NOTE_COMMITMENT:
            return [True] * 6
        return [(self.num >> i) & 1 == 1 for i in range(6)]


def pedersen_hash(personalization: Personalization, bits: Iterable[bool]) -> ExtendedPoint:
    """<M_i> segmented Pedersen hash; returns a subgroup point."""
    stream = iter(list(personalization.get_bits()) + list(bits))
    r_mod = JubjubFr.META.modulus
    num_bits = JubjubFr.META.num_bits  # 252
    window = PEDERSEN_HASH_EXP_WINDOW_SIZE
    window_mask = (1 << window) - 1

    result = ExtendedPoint.identity()
    exp_tables = pedersen_hash_exp_table()
    gen_idx = 0

    while True:
        # Accumulate up to 63 signed 3-bit chunks into one scalar.
        acc = 0
        cur = 1
        chunks_remaining = PEDERSEN_HASH_CHUNKS_PER_GENERATOR
        encountered_bits = False
        for a in stream:
            encountered_bits = True
            b = next(stream, False)
            c = next(stream, False)
            tmp = cur
            if a:
                tmp += cur
            cur = (cur * 2) % r_mod
            if b:
                tmp += cur
            if c:
                tmp = -tmp
            acc = (acc + tmp) % r_mod
            chunks_remaining -= 1
            if chunks_remaining == 0:
                break
            cur = (cur * 8) % r_mod
        if not encountered_bits:
            break

        tables = exp_tables[gen_idx]
        gen_idx += 1

        tmp_point = ExtendedPoint.identity()
        pos = 0
        t = 0
        while pos < num_bits:
            i = (acc >> pos) & window_mask
            tmp_point = tmp_point + tables[t][i]
            pos += window
            t += 1
        result = result + tmp_point

    return result


__all__ = ["Personalization", "pedersen_hash"]
