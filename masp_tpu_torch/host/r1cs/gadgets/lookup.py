# Copy of masp_tpu/r1cs/gadgets/lookup.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""3-bit window table lookups (bellman gadgets::lookup semantics).

Used by fixed-base scalar multiplication (lookup3_xy, 8-entry windows) and
the in-circuit Pedersen hash (lookup3_xy_with_conditional_negation, 4-entry
windows, 2 constraints per chunk).
"""

from __future__ import annotations

from masp_tpu_torch.host.fields import SCALAR_MODULUS
from masp_tpu_torch.host.r1cs import wit
from masp_tpu_torch.host.r1cs.cs import ONE, lc, lc_var
from masp_tpu_torch.host.r1cs.gadgets.boolean import Boolean
from masp_tpu_torch.host.r1cs.gadgets.num import AllocatedNum, Num

R = SCALAR_MODULUS


def synth(window_size: int, constants: list[int]) -> list[int]:
    """Multilinear (Moebius) coefficients c so that for every bit pattern b:
    table[b] == sum_{j subset of b} c[j]."""
    n = 1 << window_size
    assert len(constants) == n
    c = [x % R for x in constants]
    bit = 1
    while bit < n:
        for j in range(n):
            if j & bit:
                c[j] = (c[j] - c[j ^ bit]) % R
        bit <<= 1
    return c


def _bit_values(bits: list[Boolean]):
    vals = [b.get_value() for b in bits]
    return None if any(v is None for v in vals) else vals


def lookup3_xy(cs, bits: list[Boolean], coords: list[tuple[int, int]]):
    """8-entry (x, y) lookup by 3 bits; 3 constraints (incl. precomp AND)."""
    assert len(bits) == 3
    assert len(coords) == 8

    bv = _bit_values(bits)
    with cs.ns("x"):
        res_x = AllocatedNum.alloc(
            cs, None if bv is None else wit.lookup(bv, [c[0] for c in coords])
        )
    with cs.ns("y"):
        res_y = AllocatedNum.alloc(
            cs, None if bv is None else wit.lookup(bv, [c[1] for c in coords])
        )

    x_coeffs = synth(3, [c[0] for c in coords])
    y_coeffs = synth(3, [c[1] for c in coords])

    with cs.ns("precomp"):
        precomp = Boolean.and_(cs, bits[1], bits[2])

    for name, res, coeffs in (
        ("x-coordinate lookup", res_x, x_coeffs),
        ("y-coordinate lookup", res_y, y_coeffs),
    ):
        a = (
            lc_var(ONE, coeffs[0b001])
            + bits[1].lc(ONE, coeffs[0b011])
            + bits[2].lc(ONE, coeffs[0b101])
            + precomp.lc(ONE, coeffs[0b111])
        )
        b = bits[0].lc(ONE, 1)
        c = (
            lc_var(res.var)
            - (coeffs[0b000], ONE)
            - bits[1].lc(ONE, coeffs[0b010])
            - bits[2].lc(ONE, coeffs[0b100])
            - precomp.lc(ONE, coeffs[0b110])
        )
        cs.enforce(name, a, b, c)

    return res_x, res_y


def lookup3_xy_with_conditional_negation(cs, bits: list[Boolean], coords: list[tuple[int, int]]):
    """4-entry lookup by 2 bits with the third bit negating y; returns
    (Num x, Num y) — x is purely symbolic (no constraint). 2 constraints."""
    assert len(bits) == 3
    assert len(coords) == 4

    bv = _bit_values(bits[:2])
    y_val = None
    b2 = bits[2].get_value()
    if bv is not None and b2 is not None:
        y_val = wit.lookup(bv, [c[1] % R for c in coords])
        y_val = wit.select(b2, (-y_val) % R, y_val)
    with cs.ns("y"):
        y = AllocatedNum.alloc(cs, y_val)

    x_coeffs = synth(2, [c[0] for c in coords])
    y_coeffs = synth(2, [c[1] for c in coords])

    with cs.ns("precomp"):
        precomp = Boolean.and_(cs, bits[0], bits[1])

    x = (
        Num.zero()
        .add_bool_with_coeff(ONE, Boolean.constant(True), x_coeffs[0b00])
        .add_bool_with_coeff(ONE, bits[0], x_coeffs[0b01])
        .add_bool_with_coeff(ONE, bits[1], x_coeffs[0b10])
        .add_bool_with_coeff(ONE, precomp, x_coeffs[0b11])
    )

    y_lc = (
        precomp.lc(ONE, y_coeffs[0b11])
        + bits[1].lc(ONE, y_coeffs[0b10])
        + bits[0].lc(ONE, y_coeffs[0b01])
        + (y_coeffs[0b00], ONE)
    )
    # (y_lc + y_lc) * bits[2] = y_lc - y
    cs.enforce(
        "y-coordinate lookup",
        y_lc + y_lc,
        bits[2].lc(ONE, 1),
        y_lc - y.var,
    )

    y_num = Num(y.value, lc_var(y.var))
    return x, y_num


__all__ = ["synth", "lookup3_xy", "lookup3_xy_with_conditional_negation"]
