"""Groth16 on the port: parameters, generation from toxic waste, proving."""

from masp_tpu_torch.groth16.generator import generate_parameters
from masp_tpu_torch.groth16.params import (
    Assembly, Parameters, assembly_from_arrays, params_from_arrays,
)
from masp_tpu_torch.groth16.prover import create_proof_from_assembly

__all__ = [
    "Assembly", "Parameters", "assembly_from_arrays", "params_from_arrays",
    "generate_parameters", "create_proof_from_assembly",
]
