# Copies of spend_public_inputs, output_public_inputs and convert_public_inputs from
# masp_tpu/groth16/sapling_prover.py, verbatim apart from import paths (that module
# imports the JAX prover, so only these functions are copied); the port imports
# nothing of masp_tpu.
"""Public inputs of the Spend, Output and Convert circuits, in the order the
verifier takes them."""

from __future__ import annotations

from masp_tpu_torch.host.fields import Scalar
from masp_tpu_torch.host.jubjub import ExtendedPoint
from masp_tpu_torch.host.primitives.sapling import Nullifier
from masp_tpu_torch.host.r1cs.gadgets.multipack import bytes_to_bits_le, compute_multipacking


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


__all__ = ["spend_public_inputs", "output_public_inputs", "convert_public_inputs"]
