# Copy of masp_tpu/groth16/verifier.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
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


def verify_proofs_batch(
    pvk: PreparedVerifyingKey,
    rng,
    proofs: list[Proof],
    public_inputs: list[list[int]],
    use_device_pairing: bool = False,
) -> bool:
    """Random linear combination batch verification:
    prod_i e(z_i A_i, B_i) == (alpha*beta)^(sum z_i) * e(sum z_i acc_i, gamma)
                              * e(sum z_i C_i, delta)."""
    if len(proofs) != len(public_inputs):
        return False
    for pi in public_inputs:
        if len(pi) + 1 != len(pvk.ic):
            return False
    zs = [int.from_bytes(rng.fill_bytes(16), "little") for _ in proofs]

    # Fold the random coefficients into the IC scalars first:
    #   sum_i z_i (IC_0 + sum_j inp_ij IC_j)
    #     = (sum_i z_i) IC_0 + sum_j (sum_i z_i inp_ij) IC_j
    # — the identical group element with len(ic) scalar muls instead of
    # B * len(ic) (scalar arithmetic is mod R = the group order).
    sum_z = 0
    ic_scalars = [0] * (len(pvk.ic) - 1)
    acc_delta = G1.identity()
    pairs = []
    for proof, inputs, z in zip(proofs, public_inputs, zs):
        sum_z = (sum_z + z) % R
        for j, inp in enumerate(inputs):
            ic_scalars[j] = (ic_scalars[j] + z * inp) % R
        acc_delta = acc_delta + proof.c * z
        pairs.append((proof.a * z, proof.b))
    acc_gamma = G1.multi_scalar_mul(list(pvk.ic), [sum_z] + ic_scalars)

    pairs.append((acc_gamma, pvk.neg_gamma_g2))
    pairs.append((acc_delta, pvk.neg_delta_g2))
    if use_device_pairing and pvk.alpha_g1 is not None:
        # fold (alpha*beta)^sum_z into the product: e(-sum_z alpha, beta)
        from masp_tpu_torch.ops.pairing import pairing_product_is_one_device

        pairs.append(((-pvk.alpha_g1) * sum_z, pvk.beta_g2))
        return pairing_product_is_one_device(pairs)
    try:
        ml = multi_miller_loop(pairs)
    except DegeneratePairingInput:
        return False
    return final_exponentiation(ml) == pvk.alpha_g1_beta_g2.pow(sum_z)


__all__ = ["verify_proof", "verify_proofs_batch"]
