# Copy of masp_tpu/r1cs/gadgets/multipack.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""Multipack: pack Booleans into field-capacity-sized public inputs
(bellman gadgets::multipack)."""

from __future__ import annotations

from masp_tpu_torch.host.fields import SCALAR_MODULUS
from masp_tpu_torch.host.r1cs.cs import lc_var
from masp_tpu_torch.host.r1cs.gadgets.boolean import Boolean
from masp_tpu_torch.host.r1cs.gadgets.num import Num
from masp_tpu_torch.host.r1cs.cs import ONE

R = SCALAR_MODULUS
CAPACITY = 254  # bls12-381 Scalar::CAPACITY


def pack_into_inputs(cs, bits: list[Boolean]):
    for i in range(0, len(bits), CAPACITY):
        chunk = bits[i : i + CAPACITY]
        num = Num.zero()
        coeff = 1
        for bit in chunk:
            num = num.add_bool_with_coeff(ONE, bit, coeff)
            coeff = (coeff * 2) % R
        idx = i // CAPACITY
        input_var = cs.alloc_input(f"input {idx}", num.get_value())
        # num * 1 = input
        cs.enforce(
            f"packing constraint {idx}", num.get_lc(1), lc_var(ONE), lc_var(input_var)
        )


def bytes_to_bits_le(data: bytes) -> list[bool]:
    return [(byte >> i) & 1 == 1 for byte in data for i in range(8)]


def compute_multipacking(bits: list[bool]) -> list[int]:
    """Host-side packing — used to assemble verifier public inputs
    (nullifier -> 2 field elements)."""
    out = []
    for i in range(0, len(bits), CAPACITY):
        cur = 0
        coeff = 1
        for bit in bits[i : i + CAPACITY]:
            if bit:
                cur = (cur + coeff) % R
            coeff = (coeff * 2) % R
        out.append(cur)
    return out


__all__ = ["pack_into_inputs", "bytes_to_bits_le", "compute_multipacking", "CAPACITY"]
