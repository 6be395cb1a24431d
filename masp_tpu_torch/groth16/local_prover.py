# Copy of masp_tpu/groth16/local_prover.py, verbatim apart from import paths and one
# import, marked below: the proving keys are the port's Parameters (packed limb rows,
# groth16/params.py), which its prover takes on the card. The port imports nothing of
# masp_tpu.
"""LocalTxProver (masp_proofs/src/prover.rs): the TxProver implementation
backed by the TPU Groth16 engine, serializing proofs to 192-byte
GROTH_PROOF_SIZE."""

from __future__ import annotations

from masp_tpu_torch.groth16.params_io import (
    MASP_CONVERT_NAME, MASP_OUTPUT_NAME, MASP_SPEND_NAME, MASPParameters,
    default_params_folder, load_parameters,
)
from masp_tpu_torch.groth16.sapling_prover import SaplingProvingContext
# departs from the source: the port's proving keys
from masp_tpu_torch.groth16.params import Parameters
from masp_tpu_torch.host.structures import PreparedVerifyingKey, prepare_verifying_key
# end of departure
from masp_tpu_torch.host.transaction.tx_prover import TxProver


class LocalTxProver(TxProver):
    """Holds the three circuits' parameters and drives SaplingProvingContext."""

    def __init__(
        self,
        spend_params: Parameters,
        output_params: Parameters,
        convert_params: Parameters,
        spend_vk: PreparedVerifyingKey | None = None,
        output_vk: PreparedVerifyingKey | None = None,
        convert_vk: PreparedVerifyingKey | None = None,
    ):
        self.spend_params = spend_params
        self.output_params = output_params
        self.convert_params = convert_params
        self.spend_vk = spend_vk or prepare_verifying_key(spend_params.vk)
        self.output_vk = output_vk or prepare_verifying_key(output_params.vk)
        self.convert_vk = convert_vk or prepare_verifying_key(convert_params.vk)

    @staticmethod
    def new(spend_path, output_path, convert_path) -> "LocalTxProver":
        p = load_parameters(spend_path, output_path, convert_path)
        return LocalTxProver(
            p.spend_params, p.output_params, p.convert_params,
            p.spend_vk, p.output_vk, p.convert_vk,
        )

    @staticmethod
    def with_default_location() -> "LocalTxProver | None":
        folder = default_params_folder()
        spend = folder / MASP_SPEND_NAME
        output = folder / MASP_OUTPUT_NAME
        convert = folder / MASP_CONVERT_NAME
        if not (spend.exists() and output.exists() and convert.exists()):
            return None
        return LocalTxProver.new(spend, output, convert)

    # --- TxProver ---------------------------------------------------------
    def new_sapling_proving_context(self) -> SaplingProvingContext:
        return SaplingProvingContext()

    def spend_proof(self, ctx, proof_generation_key, diversifier, rseed, ar,
                    asset_type, value, anchor, merkle_path, rcv):
        proof, cv, rk = ctx.spend_proof(
            proof_generation_key, diversifier, rseed, ar, asset_type, value,
            anchor, merkle_path, self.spend_params, self.spend_vk, rcv,
        )
        return proof.write(), cv, rk

    def output_proof(self, ctx, esk, payment_address, rcm, asset_type, value, rcv):
        proof, cv = ctx.output_proof(
            esk, payment_address, rcm, asset_type, value, self.output_params, rcv
        )
        return proof.write(), cv

    def convert_proof(self, ctx, allowed_conversion, value, anchor, merkle_path, rcv):
        proof, cv = ctx.convert_proof(
            allowed_conversion, value, anchor, merkle_path,
            self.convert_params, self.convert_vk, rcv,
        )
        return proof.write(), cv

    def prove_jobs(self, ctx, spend_jobs, convert_jobs, output_jobs, rng=None):
        """Batch TxProver entry (SaplingBuilder.build uses this when
        available): one pipelined device stream per circuit kind instead
        of a proof per host round-trip. Results mirror the singular
        methods, proofs serialized to GROTH_PROOF_SIZE bytes."""
        spends, converts, outputs = ctx.prove_jobs(
            spend_jobs, convert_jobs, output_jobs,
            self.spend_params, self.spend_vk,
            self.convert_params, self.convert_vk,
            self.output_params, rng,
        )
        return (
            [(p.write(), cv, rk) for p, cv, rk in spends],
            [(p.write(), cv) for p, cv in converts],
            [(p.write(), cv) for p, cv in outputs],
        )

    def binding_sig(self, ctx, amount, sighash, rng=None):
        return ctx.binding_sig(amount, sighash, rng)


__all__ = ["LocalTxProver"]
