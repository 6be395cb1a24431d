# Copy of masp_tpu/groth16/sapling_prover.py, verbatim apart from import paths and one
# import, marked below: the proving keys are the port's Parameters (packed limb rows,
# groth16/params.py), which its prover takes on the card. The port imports nothing of
# masp_tpu.
"""Per-transaction proving context and verification contexts.

Mirrors masp_proofs/src/sapling/{prover,verifier}.rs and
masp_proofs/src/sapling/verifier/batch.rs: bsk/cv_sum accumulators,
self-verifying proof creation, public-input assembly, binding signature,
single and batch verification.
"""

from __future__ import annotations

import logging

from dataclasses import dataclass, field

from masp_tpu_torch.host.circuits.convert import Convert
from masp_tpu_torch.host.circuits.sapling import Output, Spend
from masp_tpu_torch.host.jubjub import ExtendedPoint
from masp_tpu_torch.host.fields import JubjubFr, Scalar
from masp_tpu_torch.groth16.prover import create_random_proof
# departs from the source: the port's proving keys
from masp_tpu_torch.groth16.params import Parameters
from masp_tpu_torch.host.structures import PreparedVerifyingKey, Proof
# end of departure
from masp_tpu_torch.host.verifier import verify_proof, verify_proofs_batch
from masp_tpu_torch.host.primitives import redjubjub
from masp_tpu_torch.host.primitives.asset_type import AssetType
from masp_tpu_torch.host.primitives.constants import (
    spending_key_generator, value_commitment_randomness_generator,
)
from masp_tpu_torch.host.primitives.convert import AllowedConversion
from masp_tpu_torch.host.primitives.sapling import (
    Diversifier, Note, Nullifier, ProofGenerationKey, Rseed,
)
from masp_tpu_torch.host.r1cs.gadgets.multipack import bytes_to_bits_le, compute_multipacking
from masp_tpu_torch.host.rng import OsRng, random_scalar


def masp_compute_value_balance(asset_type: AssetType, value: int) -> ExtendedPoint | None:
    """[value] cleared-asset-generator as an unknown-order point
    (sapling/mod.rs:14-38)."""
    if value < -(2**127) + 1 or value > 2**127 - 1:
        return None
    abs_v = abs(value)
    vb = asset_type.value_commitment_generator() * JubjubFr(abs_v)
    if value < 0:
        vb = -vb
    return vb


def spend_public_inputs(rk: ExtendedPoint, cv: ExtendedPoint, anchor: int, nullifier: Nullifier) -> list[int]:
    rku, rkv = rk.to_affine()
    cvu, cvv = cv.to_affine()
    packed = compute_multipacking(bytes_to_bits_le(nullifier.data))
    assert len(packed) == 2
    return [rku.n, rkv.n, cvu.n, cvv.n, anchor % Scalar.META.modulus, packed[0], packed[1]]


def output_public_inputs(cv: ExtendedPoint, epk: ExtendedPoint, cmu: int) -> list[int]:
    cvu, cvv = cv.to_affine()
    epku, epkv = epk.to_affine()
    return [cvu.n, cvv.n, epku.n, epkv.n, cmu % Scalar.META.modulus]


def convert_public_inputs(cv: ExtendedPoint, anchor: int) -> list[int]:
    cvu, cvv = cv.to_affine()
    return [cvu.n, cvv.n, anchor % Scalar.META.modulus]


class SaplingProvingContext:
    """Accumulates bsk = sum(rcv_spend) + sum(rcv_convert) - sum(rcv_output)
    and cv_sum; creates and self-verifies proofs (prover.rs:26-326)."""

    def __init__(self):
        self.bsk = JubjubFr(0)
        self.cv_sum = ExtendedPoint.identity()

    def spend_proof(
        self,
        proof_generation_key: ProofGenerationKey,
        diversifier: Diversifier,
        rseed: Rseed,
        ar: JubjubFr,
        asset_type: AssetType,
        value: int,
        anchor: int,
        merkle_path,
        proving_key: Parameters,
        verifying_key: PreparedVerifyingKey,
        rcv: JubjubFr,
        rng=None,
    ) -> tuple[Proof, ExtendedPoint, redjubjub.PublicKey]:
        rng = rng or OsRng()
        self.bsk = self.bsk + rcv
        value_commitment = asset_type.value_commitment(value, rcv)
        viewing_key = proof_generation_key.to_viewing_key()
        payment_address = viewing_key.to_payment_address(diversifier)
        if payment_address is None:
            raise ValueError("invalid diversifier")
        rk = redjubjub.PublicKey(proof_generation_key.ak).randomize(
            ar, spending_key_generator()
        )
        note = Note(
            asset_type=asset_type,
            value=value,
            g_d=diversifier.g_d(),
            pk_d=payment_address.pk_d,
            rseed=rseed,
        )
        nullifier = note.nf(viewing_key.nk, merkle_path.position)

        instance = Spend(
            value_commitment=value_commitment,
            proof_generation_key=proof_generation_key,
            payment_address=payment_address,
            commitment_randomness=note.rcm(),
            ar=ar,
            auth_path=merkle_path.to_circuit_path(),
            anchor=anchor,
        )
        proof = create_random_proof(instance, proving_key, rng)

        cv_point = value_commitment.commitment()
        public_input = spend_public_inputs(rk.point, cv_point, anchor, nullifier)
        if not verify_proof(verifying_key, proof, public_input):
            raise ValueError("spend proof failed self-verification")

        self.cv_sum = self.cv_sum + cv_point
        return proof, cv_point, rk

    def output_proof(
        self,
        esk: JubjubFr,
        payment_address,
        rcm: JubjubFr,
        asset_type: AssetType,
        value: int,
        proving_key: Parameters,
        rcv: JubjubFr,
        rng=None,
    ) -> tuple[Proof, ExtendedPoint]:
        rng = rng or OsRng()
        self.bsk = self.bsk + (-rcv)  # outputs subtract
        value_commitment = asset_type.value_commitment(value, rcv)
        cv_point = value_commitment.commitment()

        instance = Output(
            value_commitment=value_commitment,
            payment_address=payment_address,
            commitment_randomness=rcm,
            esk=esk,
            asset_identifier=asset_type.identifier_bits(),
        )
        proof = create_random_proof(instance, proving_key, rng)
        self.cv_sum = self.cv_sum - cv_point
        return proof, cv_point

    def convert_proof(
        self,
        allowed_conversion: AllowedConversion,
        value: int,
        anchor: int,
        merkle_path,
        proving_key: Parameters,
        verifying_key: PreparedVerifyingKey,
        rcv: JubjubFr,
        rng=None,
    ) -> tuple[Proof, ExtendedPoint]:
        rng = rng or OsRng()
        self.bsk = self.bsk + rcv
        value_commitment = allowed_conversion.value_commitment(value, rcv)
        cv_point = value_commitment.commitment()

        instance = Convert(
            value_commitment=value_commitment,
            auth_path=merkle_path.to_circuit_path(),
            anchor=anchor,
        )
        proof = create_random_proof(instance, proving_key, rng)
        public_input = convert_public_inputs(cv_point, anchor)
        if not verify_proof(verifying_key, proof, public_input):
            raise ValueError("convert proof failed self-verification")
        self.cv_sum = self.cv_sum + cv_point
        return proof, cv_point

    def prove_jobs(
        self,
        spend_jobs,
        convert_jobs,
        output_jobs,
        spend_params,
        spend_vk,
        convert_params,
        convert_vk,
        output_params,
        rng=None,
    ):
        """Batch-prove a whole bundle: every description's witness is
        synthesized up front and each circuit kind's proofs run through
        ONE pipelined device stream (prover.create_proofs_from_assemblies)
        instead of a host round-trip per description. TPU shape of the
        reference's rayon proof-level parallelism (prover.rs:51-275).

        Jobs are dicts with the same fields as the corresponding singular
        methods. Returns (spend_results, convert_results, output_results)
        with the singular methods' result tuples, in job order."""
        from masp_tpu_torch.groth16.prover import (
            create_proofs_from_assemblies, synthesize_witness,
        )

        rng = rng or OsRng()

        spend_insts, spend_aux = [], []
        for j in spend_jobs:
            self.bsk = self.bsk + j["rcv"]
            value_commitment = j["asset_type"].value_commitment(j["value"], j["rcv"])
            viewing_key = j["proof_generation_key"].to_viewing_key()
            payment_address = viewing_key.to_payment_address(j["diversifier"])
            if payment_address is None:
                raise ValueError("invalid diversifier")
            rk = redjubjub.PublicKey(j["proof_generation_key"].ak).randomize(
                j["ar"], spending_key_generator()
            )
            note = Note(
                asset_type=j["asset_type"], value=j["value"],
                g_d=j["diversifier"].g_d(), pk_d=payment_address.pk_d,
                rseed=j["rseed"],
            )
            nullifier = note.nf(viewing_key.nk, j["merkle_path"].position)
            spend_insts.append(Spend(
                value_commitment=value_commitment,
                proof_generation_key=j["proof_generation_key"],
                payment_address=payment_address,
                commitment_randomness=note.rcm(),
                ar=j["ar"],
                auth_path=j["merkle_path"].to_circuit_path(),
                anchor=j["anchor"],
            ))
            cv_point = value_commitment.commitment()
            self.cv_sum = self.cv_sum + cv_point
            spend_aux.append((cv_point, rk, nullifier, j["anchor"]))

        convert_insts, convert_aux = [], []
        for j in convert_jobs:
            self.bsk = self.bsk + j["rcv"]
            value_commitment = j["allowed_conversion"].value_commitment(
                j["value"], j["rcv"]
            )
            cv_point = value_commitment.commitment()
            convert_insts.append(Convert(
                value_commitment=value_commitment,
                auth_path=j["merkle_path"].to_circuit_path(),
                anchor=j["anchor"],
            ))
            self.cv_sum = self.cv_sum + cv_point
            convert_aux.append((cv_point, j["anchor"]))

        output_insts, output_aux = [], []
        for j in output_jobs:
            self.bsk = self.bsk + (-j["rcv"])  # outputs subtract
            value_commitment = j["asset_type"].value_commitment(j["value"], j["rcv"])
            cv_point = value_commitment.commitment()
            output_insts.append(Output(
                value_commitment=value_commitment,
                payment_address=j["payment_address"],
                commitment_randomness=j["rcm"],
                esk=j["esk"],
                asset_identifier=j["asset_type"].identifier_bits(),
            ))
            self.cv_sum = self.cv_sum - cv_point
            output_aux.append((cv_point,))

        def batch(insts, params):
            if not insts:
                return []
            # draw (r, s) up front (deterministic order), synthesize lazily
            # so witness i+1 overlaps device execution of proof i
            rss = [(random_scalar(rng).n, random_scalar(rng).n) for _ in insts]
            css = (synthesize_witness(inst) for inst in insts)
            return create_proofs_from_assemblies(css, params, rss)

        spend_proofs = batch(spend_insts, spend_params)
        convert_proofs = batch(convert_insts, convert_params)
        output_proofs = batch(output_insts, output_params)

        # self-verify spends and converts in one randomized batch each
        # (prover.rs verifies per proof; same acceptance condition)
        if spend_proofs:
            inputs = [
                spend_public_inputs(rk.point, cv, anchor, nf)
                for (cv, rk, nf, anchor) in spend_aux
            ]
            if not verify_proofs_batch(spend_vk, rng, spend_proofs, inputs):
                raise ValueError("spend proof failed self-verification")
        if convert_proofs:
            inputs = [
                convert_public_inputs(cv, anchor) for (cv, anchor) in convert_aux
            ]
            if not verify_proofs_batch(convert_vk, rng, convert_proofs, inputs):
                raise ValueError("convert proof failed self-verification")

        spend_results = [
            (proof, cv, rk)
            for proof, (cv, rk, _nf, _a) in zip(spend_proofs, spend_aux)
        ]
        convert_results = [
            (proof, cv) for proof, (cv, _a) in zip(convert_proofs, convert_aux)
        ]
        output_results = [
            (proof, cv) for proof, (cv,) in zip(output_proofs, output_aux)
        ]
        return spend_results, convert_results, output_results

    def binding_sig(self, assets_and_values, sighash: bytes, rng=None) -> redjubjub.Signature:
        """Checks bvk consistency against the value balance, then signs
        bvk || sighash (prover.rs:279-326)."""
        rng = rng or OsRng()
        bsk = redjubjub.PrivateKey(self.bsk)
        bvk = redjubjub.PublicKey.from_private(
            bsk, value_commitment_randomness_generator()
        )
        final_bvk = self.cv_sum
        for asset_type, value in assets_and_values.components():
            vb = masp_compute_value_balance(asset_type, value)
            if vb is None:
                raise ValueError("invalid value balance")
            final_bvk = final_bvk - vb
        if bvk.point != final_bvk:
            raise ValueError("binding signature consistency check failed")
        data_to_be_signed = bvk.point.to_bytes() + sighash
        return bsk.sign(
            data_to_be_signed, rng, value_commitment_randomness_generator()
        )


class SaplingVerificationContext:
    """Single-transaction verification context (verifier.rs:20-203 +
    single.rs ZIP-216 wrapper)."""

    def __init__(self, zip216_enabled: bool = True):
        self.cv_sum = ExtendedPoint.identity()
        self.zip216_enabled = zip216_enabled

    def check_spend(
        self, cv: ExtendedPoint, anchor: int, nullifier: Nullifier,
        rk: redjubjub.PublicKey, sighash: bytes, spend_auth_sig: redjubjub.Signature,
        zkproof: Proof, vk: PreparedVerifyingKey,
    ) -> bool:
        if cv.is_small_order() or rk.point.is_small_order():
            return False
        self.cv_sum = self.cv_sum + cv
        data = rk.point.to_bytes() + sighash
        if not rk.verify_with_zip216(
            data, spend_auth_sig, spending_key_generator(), self.zip216_enabled
        ):
            return False
        return verify_proof(vk, zkproof, spend_public_inputs(rk.point, cv, anchor, nullifier))

    def check_convert(
        self, cv: ExtendedPoint, anchor: int, zkproof: Proof, vk: PreparedVerifyingKey
    ) -> bool:
        if cv.is_small_order():
            return False
        self.cv_sum = self.cv_sum + cv
        return verify_proof(vk, zkproof, convert_public_inputs(cv, anchor))

    def check_output(
        self, cv: ExtendedPoint, cmu: int, epk: ExtendedPoint, zkproof: Proof,
        vk: PreparedVerifyingKey,
    ) -> bool:
        if cv.is_small_order() or epk.is_small_order():
            return False
        self.cv_sum = self.cv_sum - cv
        return verify_proof(vk, zkproof, output_public_inputs(cv, epk, cmu))

    def final_check(
        self, value_balance, sighash: bytes, binding_sig: redjubjub.Signature
    ) -> bool:
        bvk_point = self.cv_sum
        for asset_type, value in value_balance.components():
            vb = masp_compute_value_balance(asset_type, value)
            if vb is None:
                return False
            bvk_point = bvk_point - vb
        bvk = redjubjub.PublicKey(bvk_point)
        data = bvk_point.to_bytes() + sighash
        return bvk.verify_with_zip216(
            data, binding_sig, value_commitment_randomness_generator(),
            self.zip216_enabled,
        )


@dataclass
class _Batch:
    proofs: list = field(default_factory=list)
    inputs: list = field(default_factory=list)


class BatchValidator:
    """Queues per-kind proof batches + a RedJubjub signature batch; validate()
    runs the signature batch then randomized Groth16 batch verification per
    circuit (batch.rs:15-239)."""

    def __init__(self):
        self.bundles_added = False
        self.spend_proofs = _Batch()
        self.convert_proofs = _Batch()
        self.output_proofs = _Batch()
        self.signatures: list[redjubjub.BatchEntry] = []

    def check_bundle(self, bundle, sighash: bytes) -> bool:
        self.bundles_added = True
        ctx = SaplingVerificationContext()
        for spend in bundle.shielded_spends:
            if spend.cv.is_small_order() or spend.rk.point.is_small_order():
                return False
            ctx.cv_sum = ctx.cv_sum + spend.cv
            entry = redjubjub.BatchEntry(
                vk=spend.rk,
                msg=spend.rk.point.to_bytes() + sighash,
                sig=spend.spend_auth_sig,
            )
            entry._kind = "spend"
            self.signatures.append(entry)
            proof = Proof.try_read(spend.zkproof)
            if proof is None:
                return False
            self.spend_proofs.proofs.append(proof)
            self.spend_proofs.inputs.append(
                spend_public_inputs(spend.rk.point, spend.cv, spend.anchor.n, spend.nullifier)
            )
        for convert in bundle.shielded_converts:
            if convert.cv.is_small_order():
                return False
            ctx.cv_sum = ctx.cv_sum + convert.cv
            proof = Proof.try_read(convert.zkproof)
            if proof is None:
                return False
            self.convert_proofs.proofs.append(proof)
            self.convert_proofs.inputs.append(
                convert_public_inputs(convert.cv, convert.anchor.n)
            )
        for output in bundle.shielded_outputs:
            epk = ExtendedPoint.from_bytes(output.ephemeral_key)
            if epk is None or output.cv.is_small_order() or epk.is_small_order():
                return False
            ctx.cv_sum = ctx.cv_sum - output.cv
            proof = Proof.try_read(output.zkproof)
            if proof is None:
                return False
            self.output_proofs.proofs.append(proof)
            self.output_proofs.inputs.append(
                output_public_inputs(output.cv, epk, output.cmu.n)
            )
        # binding signature: bvk = cv_sum - value_balance
        bvk_point = ctx.cv_sum
        for asset_type, value in bundle.value_balance.components():
            vb = masp_compute_value_balance(asset_type, value)
            if vb is None:
                return False
            bvk_point = bvk_point - vb
        entry = redjubjub.BatchEntry(
            vk=redjubjub.PublicKey(bvk_point),
            msg=bvk_point.to_bytes() + sighash,
            sig=bundle.authorization.binding_sig,
        )
        entry._kind = "binding"
        self.signatures.append(entry)
        return True

    def validate(
        self,
        spend_vk: PreparedVerifyingKey,
        convert_vk: PreparedVerifyingKey,
        output_vk: PreparedVerifyingKey,
        rng=None,
        use_device_pairing: bool = False,
        use_device_sigs: bool | None = None,
    ) -> bool:
        """use_device_pairing runs the Groth16 batch check's Miller loop /
        final exponentiation on device (ops/pairing_jax.py, chunked
        dispatches); use_device_sigs evaluates each RedJubjub signature
        batch as one device Jubjub MSM (ops/jubjub_jax.py; None = the
        MASP_DEVICE_REDJUBJUB env default)."""
        if not self.bundles_added:
            return True
        rng = rng or OsRng()
        # NB: spend-auth sigs use the spending key generator; the binding sig
        # uses the value commitment randomness generator. Validate the two
        # groups separately (the reference's redjubjub batch handles mixed
        # basepoints via nam-reddsa; we split by basepoint).
        spend_sigs = [e for e in self.signatures if _is_spend_auth(e)]
        binding_sigs = [e for e in self.signatures if not _is_spend_auth(e)]
        if spend_sigs and not redjubjub.batch_verify(
            rng, spend_sigs, spending_key_generator(), use_device=use_device_sigs
        ):
            _log.debug("batch validation failed spend-auth signature check")
            return False
        if binding_sigs and not redjubjub.batch_verify(
            rng, binding_sigs, value_commitment_randomness_generator(),
            use_device=use_device_sigs,
        ):
            _log.debug("batch validation failed binding signature check")
            return False
        for batch, vk in (
            (self.spend_proofs, spend_vk),
            (self.convert_proofs, convert_vk),
            (self.output_proofs, output_vk),
        ):
            if batch.proofs and not verify_proofs_batch(
                vk, rng, batch.proofs, batch.inputs,
                use_device_pairing=use_device_pairing,
            ):
                _log.debug("batch validation failed Groth16 proof batch")
                return False
        return True


_log = logging.getLogger(__name__)


def _is_spend_auth(entry: redjubjub.BatchEntry) -> bool:
    return getattr(entry, "_kind", "spend") == "spend"


__all__ = [
    "SaplingProvingContext", "SaplingVerificationContext", "BatchValidator",
    "masp_compute_value_balance", "spend_public_inputs",
    "output_public_inputs", "convert_public_inputs",
]
