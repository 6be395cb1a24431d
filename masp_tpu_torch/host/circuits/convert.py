# Copy of masp_tpu/circuits/convert.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""The MASP Convert circuit (masp_proofs/src/circuit/convert.rs).

Proves an AllowedConversion note (cm = PedersenHash(asset generator bytes))
is in the conversion tree; 47,358 constraints, 3+ONE public inputs.
"""

from __future__ import annotations

from masp_tpu_torch.host.circuits.sapling import TREE_DEPTH, expose_value_commitment
from masp_tpu_torch.host.fields import SCALAR_MODULUS
from masp_tpu_torch.host.primitives.pedersen import Personalization
from masp_tpu_torch.host.r1cs.cs import ONE, lc, lc_var
from masp_tpu_torch.host.r1cs.gadgets import pedersen
from masp_tpu_torch.host.r1cs.gadgets.boolean import AllocatedBit, Boolean
from masp_tpu_torch.host.r1cs.gadgets.num import AllocatedNum, Num

R = SCALAR_MODULUS


class Convert:
    def __init__(self, value_commitment=None, auth_path=None, anchor=None):
        self.value_commitment = value_commitment
        self.auth_path = auth_path if auth_path is not None else [None] * TREE_DEPTH
        self.anchor = anchor

    def synthesize(self, cs):
        value_num = Num.zero()
        with cs.ns("value commitment"):
            asset_generator_bits, value_bits = expose_value_commitment(
                cs, self.value_commitment
            )
        coeff = 1
        for bit in value_bits:
            value_num = value_num.add_bool_with_coeff(ONE, bit, coeff)
            coeff = (coeff * 2) % R
        assert len(asset_generator_bits) == 256

        with cs.ns("note content hash"):
            cm = pedersen.pedersen_hash(
                cs, Personalization.note_commitment(), asset_generator_bits
            )

        cur = cm.get_u()
        for i, e in enumerate(self.auth_path):
            with cs.ns(f"merkle tree hash {i}"):
                with cs.ns("position bit"):
                    cur_is_right = Boolean.from_bit(
                        AllocatedBit.alloc(cs, None if e is None else e[1])
                    )
                with cs.ns("path element"):
                    path_element = AllocatedNum.alloc(cs, None if e is None else e[0])
                with cs.ns("conditional reversal of preimage"):
                    ul, ur = AllocatedNum.conditionally_reverse(
                        cs, cur, path_element, cur_is_right
                    )
                preimage = []
                with cs.ns("ul into bits"):
                    preimage.extend(ul.to_bits_le(cs))
                with cs.ns("ur into bits"):
                    preimage.extend(ur.to_bits_le(cs))
                with cs.ns("computation of pedersen hash"):
                    cur = pedersen.pedersen_hash(
                        cs, Personalization.merkle_tree(i), preimage
                    ).get_u()

        with cs.ns("conditional anchor"):
            rt = AllocatedNum.alloc(cs, self.anchor)
        cs.enforce(
            "conditionally enforce correct root",
            lc_var(cur.var) - rt.var,
            value_num.get_lc(1),
            lc(),
        )
        with cs.ns("anchor"):
            rt.inputize(cs)


__all__ = ["Convert"]
