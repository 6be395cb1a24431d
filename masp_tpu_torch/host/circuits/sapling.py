# Copy of masp_tpu/circuits/sapling.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""The MASP Spend and Output circuits.

Mirrors masp_proofs/src/circuit/sapling.rs: same gadget sequence, namespace
layout, public-input order and constraint counts (Spend: 100,637 with 7+ONE
inputs; Output: 5+ONE inputs).
"""

from __future__ import annotations

from masp_tpu_torch.host.circuits import constants as ccon
from masp_tpu_torch.host.fields import SCALAR_MODULUS
from masp_tpu_torch.host.primitives import constants as pcon
from masp_tpu_torch.host.r1cs import wit
from masp_tpu_torch.host.r1cs.cs import ONE, lc, lc_var
from masp_tpu_torch.host.r1cs.gadgets import blake2s, boolean, ecc, multipack, pedersen
from masp_tpu_torch.host.r1cs.gadgets.boolean import AllocatedBit, Boolean
from masp_tpu_torch.host.r1cs.gadgets.num import AllocatedNum, Num

R = SCALAR_MODULUS

TREE_DEPTH = 32
JUBJUB_FR_NUM_BITS = 252
JUBJUB_FR_CAPACITY = 251


class Spend:
    """Spend circuit instance; fields may be None for shape-only synthesis
    (circuit/sapling.rs:26-49)."""

    def __init__(
        self,
        value_commitment=None,
        proof_generation_key=None,
        payment_address=None,
        commitment_randomness=None,
        ar=None,
        auth_path=None,
        anchor=None,
    ):
        self.value_commitment = value_commitment
        self.proof_generation_key = proof_generation_key
        self.payment_address = payment_address
        self.commitment_randomness = commitment_randomness
        self.ar = ar
        self.auth_path = auth_path if auth_path is not None else [None] * TREE_DEPTH
        self.anchor = anchor

    def synthesize(self, cs):
        # Witness ak (on-curve check)
        with cs.ns("ak"):
            ak = ecc.EdwardsPoint.witness(
                cs,
                None
                if self.proof_generation_key is None
                else self.proof_generation_key.ak,
            )
        with cs.ns("ak not small order"):
            ak.assert_not_small_order(cs)

        # rk = ak + [ar] G, exposed as input
        with cs.ns("ar"):
            ar_bits = boolean.field_into_boolean_vec_le(
                cs, None if self.ar is None else self.ar.n, JUBJUB_FR_NUM_BITS
            )
        with cs.ns("computation of randomization for the signing key"):
            ar_point = ecc.fixed_base_multiplication(
                cs, ccon.SPENDING_KEY_GENERATOR_TABLE(), ar_bits
            )
        with cs.ns("computation of rk"):
            rk = ak.add(cs, ar_point)
        with cs.ns("rk"):
            rk.inputize(cs)

        # nk = [nsk] H
        with cs.ns("nsk"):
            nsk_bits = boolean.field_into_boolean_vec_le(
                cs,
                None
                if self.proof_generation_key is None
                else self.proof_generation_key.nsk.n,
                JUBJUB_FR_NUM_BITS,
            )
        with cs.ns("computation of nk"):
            nk = ecc.fixed_base_multiplication(
                cs, ccon.PROOF_GENERATION_KEY_GENERATOR_TABLE(), nsk_bits
            )

        ivk_preimage = []
        with cs.ns("representation of ak"):
            ivk_preimage.extend(ak.repr_bits(cs))

        nf_preimage = []
        with cs.ns("representation of nk"):
            repr_nk = nk.repr_bits(cs)
        ivk_preimage.extend(repr_nk)
        nf_preimage.extend(repr_nk)

        assert len(ivk_preimage) == 512
        assert len(nf_preimage) == 256

        # ivk = BLAKE2s(ak || nk), truncated to jubjub Fr capacity
        with cs.ns("computation of ivk"):
            ivk = blake2s.blake2s(cs, ivk_preimage, pcon.CRH_IVK_PERSONALIZATION)
        ivk = ivk[:JUBJUB_FR_CAPACITY]

        # Witness g_d
        with cs.ns("witness g_d"):
            g_d = ecc.EdwardsPoint.witness(
                cs,
                None
                if self.payment_address is None
                else self.payment_address.g_d(),
            )
        with cs.ns("g_d not small order"):
            g_d.assert_not_small_order(cs)

        with cs.ns("compute pk_d"):
            pk_d = g_d.mul(cs, ivk)

        note_contents = []
        value_num = Num.zero()
        with cs.ns("value commitment"):
            asset_generator_bits, value_bits = expose_value_commitment(
                cs, self.value_commitment
            )
        coeff = 1
        for bit in value_bits:
            value_num = value_num.add_bool_with_coeff(ONE, bit, coeff)
            coeff = (coeff * 2) % R

        note_contents.extend(asset_generator_bits)
        note_contents.extend(value_bits)

        with cs.ns("representation of g_d"):
            note_contents.extend(g_d.repr_bits(cs))
        with cs.ns("representation of pk_d"):
            note_contents.extend(pk_d.repr_bits(cs))

        assert len(note_contents) == 256 + 64 + 256 + 256

        with cs.ns("note content hash"):
            cm = pedersen.pedersen_hash(
                cs, _personalization_note_commitment(), note_contents
            )

        with cs.ns("rcm"):
            rcm_bits = boolean.field_into_boolean_vec_le(
                cs,
                None
                if self.commitment_randomness is None
                else self.commitment_randomness.n,
                JUBJUB_FR_NUM_BITS,
            )
        with cs.ns("computation of commitment randomness"):
            rcm_point = ecc.fixed_base_multiplication(
                cs, ccon.NOTE_COMMITMENT_RANDOMNESS_GENERATOR_TABLE(), rcm_bits
            )
        with cs.ns("randomization of note commitment"):
            cm = cm.add(cs, rcm_point)

        # Merkle ascent
        position_bits = []
        cur = cm.get_u()
        for i, e in enumerate(self.auth_path):
            with cs.ns(f"merkle tree hash {i}"):
                with cs.ns("position bit"):
                    cur_is_right = Boolean.from_bit(
                        AllocatedBit.alloc(cs, None if e is None else e[1])
                    )
                position_bits.append(cur_is_right)

                with cs.ns("path element"):
                    path_element = AllocatedNum.alloc(
                        cs, None if e is None else e[0]
                    )
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
                        cs, _personalization_merkle(i), preimage
                    ).get_u()

        # Conditional anchor
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

        # rho = cm + [position] J
        with cs.ns("g^position"):
            position = ecc.fixed_base_multiplication(
                cs, ccon.NULLIFIER_POSITION_GENERATOR_TABLE(), position_bits
            )
        with cs.ns("faerie gold prevention"):
            rho = cm.add(cs, position)

        with cs.ns("representation of rho"):
            nf_preimage.extend(rho.repr_bits(cs))
        assert len(nf_preimage) == 512

        with cs.ns("nf computation"):
            nf = blake2s.blake2s(cs, nf_preimage, pcon.PRF_NF_PERSONALIZATION)

        with cs.ns("pack nullifier"):
            multipack.pack_into_inputs(cs, nf)


class Output:
    """Output circuit instance (circuit/sapling.rs:52-67)."""

    def __init__(
        self,
        value_commitment=None,
        asset_identifier=None,
        payment_address=None,
        commitment_randomness=None,
        esk=None,
    ):
        self.value_commitment = value_commitment
        # list of Option<bool>, 256 entries
        self.asset_identifier = (
            asset_identifier if asset_identifier is not None else [None] * 256
        )
        self.payment_address = payment_address
        self.commitment_randomness = commitment_randomness
        self.esk = esk

    def synthesize(self, cs):
        note_contents = []

        assert len(self.asset_identifier) == 256
        asset_generator_preimage = []
        for i, bit in enumerate(self.asset_identifier):
            with cs.ns(f"witness asset type bit {i}"):
                with cs.ns("asset type bit"):
                    b = Boolean.from_bit(AllocatedBit.alloc(cs, bit))
                asset_generator_preimage.append(b)
        assert len(asset_generator_preimage) == 256

        with cs.ns("value base computation"):
            asset_generator_image = blake2s.blake2s(
                cs,
                asset_generator_preimage,
                pcon.VALUE_COMMITMENT_GENERATOR_PERSONALIZATION,
            )

        with cs.ns("value commitment"):
            asset_generator_bits, value_bits = expose_value_commitment(
                cs, self.value_commitment
            )
        assert len(asset_generator_bits) == 256
        assert len(asset_generator_image) == 256

        for i, (agb, agib) in enumerate(zip(asset_generator_bits, asset_generator_image)):
            with cs.ns(f"integrity of asset generator bit {i}"):
                Boolean.enforce_equal(cs, agb, agib)

        note_contents.extend(asset_generator_bits)
        note_contents.extend(value_bits)

        with cs.ns("witness g_d"):
            g_d = ecc.EdwardsPoint.witness(
                cs,
                None
                if self.payment_address is None
                else self.payment_address.g_d(),
            )
        with cs.ns("g_d not small order"):
            g_d.assert_not_small_order(cs)
        with cs.ns("representation of g_d"):
            note_contents.extend(g_d.repr_bits(cs))

        with cs.ns("esk"):
            esk_bits = boolean.field_into_boolean_vec_le(
                cs, None if self.esk is None else self.esk.n, JUBJUB_FR_NUM_BITS
            )
        with cs.ns("epk computation"):
            epk = g_d.mul(cs, esk_bits)
        with cs.ns("epk"):
            epk.inputize(cs)

        # pk_d: witnessed unchecked as v bits + sign bit
        if self.payment_address is not None:
            pu, pv = self.payment_address.pk_d.to_affine()
            pk_d_v, pk_d_sign = pv.n, wit.bit(pu.n, 0)
        else:
            pk_d_v = pk_d_sign = None
        with cs.ns("pk_d bits of v"):
            v_contents = boolean.field_into_boolean_vec_le(cs, pk_d_v, 255)
        with cs.ns("pk_d bit of u"):
            sign_bit = Boolean.from_bit(AllocatedBit.alloc(cs, pk_d_sign))
        note_contents.extend(v_contents)
        note_contents.append(sign_bit)

        assert len(note_contents) == 256 + 64 + 256 + 256

        with cs.ns("note content hash"):
            cm = pedersen.pedersen_hash(
                cs, _personalization_note_commitment(), note_contents
            )
        with cs.ns("rcm"):
            rcm_bits = boolean.field_into_boolean_vec_le(
                cs,
                None
                if self.commitment_randomness is None
                else self.commitment_randomness.n,
                JUBJUB_FR_NUM_BITS,
            )
        with cs.ns("computation of commitment randomness"):
            rcm_point = ecc.fixed_base_multiplication(
                cs, ccon.NOTE_COMMITMENT_RANDOMNESS_GENERATOR_TABLE(), rcm_bits
            )
        with cs.ns("randomization of note commitment"):
            cm = cm.add(cs, rcm_point)

        with cs.ns("commitment"):
            cm.get_u().inputize(cs)


def expose_value_commitment(cs, value_commitment):
    """Shared value-commitment gadget (circuit/sapling.rs:71-137): witness
    asset generator, booleanize, clear cofactor, cv = [value] gen + [rcv] R,
    inputize cv.  Returns (asset_generator_bits, value_bits)."""
    with cs.ns("asset_generator"):
        asset_generator = ecc.EdwardsPoint.witness(
            cs,
            None if value_commitment is None else value_commitment.asset_generator,
        )
    with cs.ns("unpack asset_generator"):
        asset_generator_bits = asset_generator.repr_bits(cs)

    with cs.ns("asset_generator first doubling"):
        asset_generator = asset_generator.double(cs)
    with cs.ns("asset_generator second doubling"):
        asset_generator = asset_generator.double(cs)
    with cs.ns("asset_generator third doubling"):
        asset_generator = asset_generator.double(cs)

    with cs.ns("check asset_generator != 0"):
        asset_generator.get_u().assert_nonzero(cs)

    with cs.ns("value"):
        value_bits = boolean.u64_into_boolean_vec_le(
            cs, None if value_commitment is None else value_commitment.value
        )

    with cs.ns("compute the value in the exponent"):
        value = asset_generator.mul(cs, value_bits)

    with cs.ns("rcv"):
        rcv_bits = boolean.field_into_boolean_vec_le(
            cs,
            None if value_commitment is None else value_commitment.randomness.n,
            JUBJUB_FR_NUM_BITS,
        )
    with cs.ns("computation of rcv"):
        rcv = ecc.fixed_base_multiplication(
            cs, ccon.VALUE_COMMITMENT_RANDOMNESS_GENERATOR_TABLE(), rcv_bits
        )
    with cs.ns("computation of cv"):
        cv = value.add(cs, rcv)
    with cs.ns("commitment point"):
        cv.inputize(cs)

    return asset_generator_bits, value_bits


def _personalization_note_commitment():
    return Personalization.note_commitment()


def _personalization_merkle(i: int):
    return Personalization.merkle_tree(i)


from masp_tpu_torch.host.primitives.pedersen import Personalization  # noqa: E402

__all__ = ["Spend", "Output", "expose_value_commitment", "TREE_DEPTH"]
