# Copy of masp_tpu/r1cs/gadgets/boolean.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""Boolean / AllocatedBit gadgets (bellman gadgets::boolean semantics).

Constraint shapes and namespace layout match the reference's gadget library
exactly so constraint counts (100,637 / ~31k / 47,358) and named-path
introspection line up.  Callers wrap each call in a namespace; the gadget
itself allocates under fixed names ("boolean", "xor result", ...).
"""

from __future__ import annotations

from masp_tpu_torch.host.fields import SCALAR_MODULUS
from masp_tpu_torch.host.r1cs import wit
from masp_tpu_torch.host.r1cs.cs import ONE, LinearCombination, SynthesisError, lc, lc_var

R = SCALAR_MODULUS


class AllocatedBit:
    __slots__ = ("var", "value")

    def __init__(self, var: int, value: bool | None):
        self.var = var
        self.value = value

    @staticmethod
    def alloc(cs, value) -> "AllocatedBit":
        var = cs.alloc("boolean", None if value is None else wit.as_bit(value))
        # (1 - a) * a = 0
        cs.enforce("boolean constraint", lc_var(ONE) - var, lc_var(var), lc())
        return AllocatedBit(var, value)

    @staticmethod
    def alloc_conditionally(cs, value, must_be_false: "AllocatedBit") -> "AllocatedBit":
        var = cs.alloc("boolean", None if value is None else wit.as_bit(value))
        # (1 - must_be_false - a) * a = 0
        cs.enforce(
            "boolean constraint",
            lc_var(ONE) - must_be_false.var - var,
            lc_var(var),
            lc(),
        )
        return AllocatedBit(var, value)

    @staticmethod
    def xor(cs, a: "AllocatedBit", b: "AllocatedBit") -> "AllocatedBit":
        value = None if a.value is None or b.value is None else wit.b_xor(a.value, b.value)
        var = cs.alloc("xor result", None if value is None else wit.as_bit(value))
        # 2a * b = a + b - c
        cs.enforce(
            "xor constraint",
            lc_var(a.var, 2),
            lc_var(b.var),
            lc_var(a.var) + b.var - var,
        )
        return AllocatedBit(var, value)

    @staticmethod
    def and_(cs, a: "AllocatedBit", b: "AllocatedBit") -> "AllocatedBit":
        value = None if a.value is None or b.value is None else wit.b_and(a.value, b.value)
        var = cs.alloc("and result", None if value is None else wit.as_bit(value))
        cs.enforce("and constraint", lc_var(a.var), lc_var(b.var), lc_var(var))
        return AllocatedBit(var, value)

    @staticmethod
    def and_not(cs, a: "AllocatedBit", b: "AllocatedBit") -> "AllocatedBit":
        value = None if a.value is None or b.value is None else wit.b_and_not(a.value, b.value)
        var = cs.alloc("and not result", None if value is None else wit.as_bit(value))
        cs.enforce("and not constraint", lc_var(a.var), lc_var(ONE) - b.var, lc_var(var))
        return AllocatedBit(var, value)

    @staticmethod
    def nor(cs, a: "AllocatedBit", b: "AllocatedBit") -> "AllocatedBit":
        value = None if a.value is None or b.value is None else wit.b_nor(a.value, b.value)
        var = cs.alloc("nor result", None if value is None else wit.as_bit(value))
        cs.enforce("nor constraint", lc_var(ONE) - a.var, lc_var(ONE) - b.var, lc_var(var))
        return AllocatedBit(var, value)


class Boolean:
    """Constant(bool) | Is(AllocatedBit) | Not(AllocatedBit)."""

    __slots__ = ("kind", "bit", "const")

    IS, NOT, CONST = 0, 1, 2

    def __init__(self, kind: int, bit: AllocatedBit | None = None, const: bool | None = None):
        self.kind = kind
        self.bit = bit
        self.const = const

    @staticmethod
    def from_bit(bit: AllocatedBit) -> "Boolean":
        return Boolean(Boolean.IS, bit=bit)

    @staticmethod
    def constant(b: bool) -> "Boolean":
        return Boolean(Boolean.CONST, const=b)

    def is_constant(self) -> bool:
        return self.kind == Boolean.CONST

    def get_value(self) -> bool | None:
        if self.kind == Boolean.CONST:
            return self.const
        if self.bit.value is None:
            return None
        return (
            wit.truthy(self.bit.value)
            if self.kind == Boolean.IS
            else wit.b_not(wit.truthy(self.bit.value))
        )

    def not_(self) -> "Boolean":
        if self.kind == Boolean.CONST:
            return Boolean.constant(not self.const)
        if self.kind == Boolean.IS:
            return Boolean(Boolean.NOT, bit=self.bit)
        return Boolean(Boolean.IS, bit=self.bit)

    def lc(self, one_var: int, coeff: int) -> LinearCombination:
        out = lc()
        if self.kind == Boolean.CONST:
            if self.const:
                out.add_term(one_var, coeff)
            return out
        if self.kind == Boolean.IS:
            out.add_term(self.bit.var, coeff)
            return out
        out.add_term(one_var, coeff)
        out.add_term(self.bit.var, -coeff)
        return out

    @staticmethod
    def xor(cs, a: "Boolean", b: "Boolean") -> "Boolean":
        if a.kind == Boolean.CONST and not a.const:
            return b
        if b.kind == Boolean.CONST and not b.const:
            return a
        if a.kind == Boolean.CONST:  # constant true
            return b.not_()
        if b.kind == Boolean.CONST:
            return a.not_()
        if a.kind == Boolean.NOT and b.kind == Boolean.NOT:
            return Boolean.from_bit(AllocatedBit.xor(cs, a.bit, b.bit))
        if a.kind == Boolean.IS and b.kind == Boolean.IS:
            return Boolean.from_bit(AllocatedBit.xor(cs, a.bit, b.bit))
        # mixed Is/Not: xor of underlying bits, negated. bellman's match
        # binds the Is-side bit first regardless of argument order, and the
        # xor constraint (2a)(b) = (a+b-c) is asymmetric — order matters for
        # structure-hash parity.
        is_bit, not_bit = (a.bit, b.bit) if a.kind == Boolean.IS else (b.bit, a.bit)
        return Boolean.from_bit(AllocatedBit.xor(cs, is_bit, not_bit)).not_()

    @staticmethod
    def and_(cs, a: "Boolean", b: "Boolean") -> "Boolean":
        if (a.kind == Boolean.CONST and not a.const) or (
            b.kind == Boolean.CONST and not b.const
        ):
            return Boolean.constant(False)
        if a.kind == Boolean.CONST:  # true
            return b
        if b.kind == Boolean.CONST:
            return a
        if a.kind == Boolean.IS and b.kind == Boolean.IS:
            return Boolean.from_bit(AllocatedBit.and_(cs, a.bit, b.bit))
        if a.kind == Boolean.IS and b.kind == Boolean.NOT:
            return Boolean.from_bit(AllocatedBit.and_not(cs, a.bit, b.bit))
        if a.kind == Boolean.NOT and b.kind == Boolean.IS:
            return Boolean.from_bit(AllocatedBit.and_not(cs, b.bit, a.bit))
        return Boolean.from_bit(AllocatedBit.nor(cs, a.bit, b.bit))

    @staticmethod
    def enforce_equal(cs, a: "Boolean", b: "Boolean"):
        if a.kind == Boolean.CONST and b.kind == Boolean.CONST:
            if a.const != b.const:
                raise SynthesisError("unsatisfiable: unequal constants")
            return
        if a.kind == Boolean.CONST or b.kind == Boolean.CONST:
            cb, other = (a, b) if a.kind == Boolean.CONST else (b, a)
            if cb.const:
                cs.enforce(
                    "enforce equal to one", lc(), lc(),
                    lc_var(ONE) - other.lc(ONE, 1),
                )
            else:
                cs.enforce("enforce equal to zero", lc(), lc(), other.lc(ONE, 1))
            return
        cs.enforce("enforce equal", lc(), lc(), a.lc(ONE, 1) - b.lc(ONE, 1))


def u64_into_boolean_vec_le(cs, value: int | None) -> list[Boolean]:
    values = (
        [None] * 64 if value is None else [wit.bit(value, i) for i in range(64)]
    )
    out = []
    for i, b in enumerate(values):
        with cs.ns(f"bit {i}"):
            out.append(Boolean.from_bit(AllocatedBit.alloc(cs, b)))
    return out


def field_into_allocated_bits_le(cs, value: int | None, num_bits: int) -> list[AllocatedBit]:
    """Allocate NUM_BITS little-endian bits of a field element (bellman's
    field_into_allocated_bits_le). ``num_bits`` is F::NUM_BITS of the value's
    own field (255 for bls scalars, 252 for jubjub Fr)."""
    values = (
        [None] * num_bits
        if value is None
        else [wit.bit(value, i) for i in range(num_bits)]
    )
    bits = []
    for i, b in enumerate(values):
        with cs.ns(f"bit {i}"):
            bits.append(AllocatedBit.alloc(cs, b))
    return bits


def field_into_boolean_vec_le(cs, value: int | None, num_bits: int = 255) -> list[Boolean]:
    """bellman's boolean::field_into_boolean_vec_le (255 bits for bls
    scalars); masp's gadgets.rs variant for jubjub::Fr passes num_bits=252."""
    return [Boolean.from_bit(b) for b in field_into_allocated_bits_le(cs, value, num_bits)]


__all__ = [
    "AllocatedBit", "Boolean", "u64_into_boolean_vec_le",
    "field_into_allocated_bits_le", "field_into_boolean_vec_le",
]
