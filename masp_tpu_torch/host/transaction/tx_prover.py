# Copy of masp_tpu/transaction/tx_prover.py, verbatim apart from import paths; the port imports nothing of
# masp_tpu.
"""TxProver abstraction (masp_primitives/src/sapling/prover.rs): the proving
interface the transaction builder drives, with MockTxProver for format tests
and the real TPU-backed prover in masp_tpu.groth16.local_prover."""

from __future__ import annotations

from masp_tpu_torch.host.primitives import redjubjub
from masp_tpu_torch.host.primitives.constants import spending_key_generator

GROTH_PROOF_SIZE = 192


class TxProver:
    """Interface: spend_proof/output_proof/convert_proof return
    (proof_bytes, cv_point[, rk]); binding_sig signs the balance."""

    def new_sapling_proving_context(self):
        raise NotImplementedError

    def spend_proof(self, ctx, proof_generation_key, diversifier, rseed, ar,
                    asset_type, value, anchor, merkle_path, rcv):
        raise NotImplementedError

    def output_proof(self, ctx, esk, payment_address, rcm, asset_type, value, rcv):
        raise NotImplementedError

    def convert_proof(self, ctx, allowed_conversion, value, anchor, merkle_path, rcv):
        raise NotImplementedError

    def binding_sig(self, ctx, amount, sighash, rng=None):
        raise NotImplementedError


class MockTxProver(TxProver):
    """Zeroed 192-byte proofs but real cv/rk — lets transaction-format tests
    run without parameters (prover.rs:101-169). binding_sig fails by design
    in the reference; here we compute a REAL binding signature so format
    tests can round-trip complete transactions (the reference's builder tests
    tolerate the Err by asserting on it; ours go further)."""

    def __init__(self, real_binding_sig: bool = False):
        self.real_binding_sig = real_binding_sig

    def new_sapling_proving_context(self):
        from masp_tpu_torch.groth16.sapling_prover import SaplingProvingContext

        return SaplingProvingContext()

    def spend_proof(self, ctx, proof_generation_key, diversifier, rseed, ar,
                    asset_type, value, anchor, merkle_path, rcv):
        ctx.bsk = ctx.bsk + rcv
        cv = asset_type.value_commitment(value, rcv).commitment()
        ctx.cv_sum = ctx.cv_sum + cv
        rk = redjubjub.PublicKey(proof_generation_key.ak).randomize(
            ar, spending_key_generator()
        )
        return (b"\x00" * GROTH_PROOF_SIZE, cv, rk)

    def output_proof(self, ctx, esk, payment_address, rcm, asset_type, value, rcv):
        ctx.bsk = ctx.bsk + (-rcv)
        cv = asset_type.value_commitment(value, rcv).commitment()
        ctx.cv_sum = ctx.cv_sum - cv
        return (b"\x00" * GROTH_PROOF_SIZE, cv)

    def convert_proof(self, ctx, allowed_conversion, value, anchor, merkle_path, rcv):
        ctx.bsk = ctx.bsk + rcv
        cv = allowed_conversion.value_commitment(value, rcv).commitment()
        ctx.cv_sum = ctx.cv_sum + cv
        return (b"\x00" * GROTH_PROOF_SIZE, cv)

    def binding_sig(self, ctx, amount, sighash, rng=None):
        if not self.real_binding_sig:
            raise ValueError("MockTxProver cannot create binding signatures")
        return ctx.binding_sig(amount, sighash, rng)


__all__ = ["TxProver", "MockTxProver", "GROTH_PROOF_SIZE"]
