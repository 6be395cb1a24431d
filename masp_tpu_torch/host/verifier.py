# Copy of verify_proof from masp_tpu/groth16/verifier.py, verbatim apart from
# import paths (the batch verifier is not copied); the port imports nothing of
# masp_tpu.
"""Groth16 verification: single and randomized-batch.

Matches bellman ``verify_proof`` / bellperson ``verify_proofs_batch``
semantics (SURVEY.md §3.2-3.3): e(A,B) = alpha*beta * e(acc, gamma) *
e(C, delta), batched by random 128-bit linear combination.
"""

from __future__ import annotations

from masp_tpu_torch.host.bls12_381 import (
    G1, R, DegeneratePairingInput, final_exponentiation, multi_miller_loop,
)
from masp_tpu_torch.host.structures import PreparedVerifyingKey, Proof


def verify_proof(pvk: PreparedVerifyingKey, proof: Proof, public_inputs: list[int]) -> bool:
    if len(public_inputs) + 1 != len(pvk.ic):
        return False
    acc = G1.multi_scalar_mul(
        list(pvk.ic), [1] + [inp % R for inp in public_inputs]
    )
    try:
        ml = multi_miller_loop(
            [
                (proof.a, proof.b),
                (acc, pvk.neg_gamma_g2),
                (proof.c, pvk.neg_delta_g2),
            ]
        )
    except DegeneratePairingInput:
        # out-of-subgroup proof point (Proof.read(check_subgroup=False)):
        # verify false, never crash (reference blst cannot panic here)
        return False
    return final_exponentiation(ml) == pvk.alpha_g1_beta_g2


__all__ = ["verify_proof"]
