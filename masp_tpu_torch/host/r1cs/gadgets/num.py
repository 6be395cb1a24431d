# Copy of masp_tpu/r1cs/gadgets/num.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""AllocatedNum / Num gadgets (bellman gadgets::num semantics)."""

from __future__ import annotations

from masp_tpu_torch.host.fields import SCALAR_MODULUS
from masp_tpu_torch.host.r1cs import wit
from masp_tpu_torch.host.r1cs.cs import (
    ONE, AssignmentMissing, DivisionByZero, LinearCombination, lc, lc_var,
)
from masp_tpu_torch.host.r1cs.gadgets.boolean import AllocatedBit, Boolean

R = SCALAR_MODULUS


class AllocatedNum:
    __slots__ = ("var", "value")

    def __init__(self, var: int, value: int | None):
        self.var = var
        self.value = value

    @staticmethod
    def alloc(cs, value: int | None) -> "AllocatedNum":
        var = cs.alloc("num", value)
        return AllocatedNum(var, None if value is None else value % R)

    def inputize(self, cs):
        # value may be None during shape-only synthesis; the backend decides
        # whether a missing assignment is an error (ProvingAssembly does).
        input_var = cs.alloc_input("input variable", self.value)
        cs.enforce(
            "enforce input is correct",
            lc_var(input_var),
            lc_var(ONE),
            lc_var(self.var),
        )

    def mul(self, cs, other: "AllocatedNum") -> "AllocatedNum":
        value = None
        if self.value is not None and other.value is not None:
            value = (self.value * other.value) % R
        var = cs.alloc("product num", value)
        cs.enforce(
            "multiplication constraint",
            lc_var(self.var),
            lc_var(other.var),
            lc_var(var),
        )
        return AllocatedNum(var, value)

    def square(self, cs) -> "AllocatedNum":
        value = None if self.value is None else (self.value * self.value) % R
        var = cs.alloc("squared num", value)
        cs.enforce(
            "squaring constraint", lc_var(self.var), lc_var(self.var), lc_var(var)
        )
        return AllocatedNum(var, value)

    def assert_nonzero(self, cs):
        inv = None if self.value is None else wit.inv(self.value)
        inv_var = cs.alloc("ephemeral inverse", inv)
        cs.enforce(
            "nonzero assertion constraint",
            lc_var(self.var),
            lc_var(inv_var),
            lc_var(ONE),
        )

    def to_bits_le(self, cs) -> list[Boolean]:
        from masp_tpu_torch.host.r1cs.gadgets.boolean import field_into_allocated_bits_le

        bits = field_into_allocated_bits_le(cs, self.value, 255)
        acc = lc()
        coeff = 1
        for bit in bits:
            acc.add_term(bit.var, coeff)
            coeff = (coeff * 2) % R
        acc.add_term(self.var, -1)
        cs.enforce("unpacking constraint", lc(), lc(), acc)
        return [Boolean.from_bit(b) for b in bits]

    def to_bits_le_strict(self, cs) -> list[Boolean]:
        """Bit decomposition with a strict in-field range proof against
        r - 1, exactly as bellman's to_bits_le_strict (runs-of-ones k-ary
        ANDs + conditional allocation)."""

        def kary_and(cs, v: list[AllocatedBit]) -> AllocatedBit:
            assert v
            cur = None
            for i, b in enumerate(v):
                if cur is None:
                    cur = b
                else:
                    with cs.ns(f"and {i}"):
                        cur = AllocatedBit.and_(cs, cur, b)
            return cur

        a_bits_le = (
            None
            if self.value is None
            else [wit.bit(self.value, i) for i in range(255)]
        )
        char_minus_one_be = [((R - 1) >> i) & 1 == 1 for i in range(255)][::-1]
        a_be = None if a_bits_le is None else a_bits_le[::-1]

        result: list[AllocatedBit] = []
        last_run: AllocatedBit | None = None
        current_run: list[AllocatedBit] = []

        found_one = False
        i = 0
        for pos, b in enumerate(char_minus_one_be):
            a_bit = None if a_be is None else a_be[pos]
            found_one |= b
            if not found_one:
                # leading zero bits of a reduced (< r) value; with TapeVal the
                # reduction guarantees this, so only assert on host bools
                assert a_bit is None or isinstance(a_bit, wit.TapeVal) or not a_bit
                continue
            if b:
                with cs.ns(f"bit {i}"):
                    ab = AllocatedBit.alloc(cs, a_bit)
                current_run.append(ab)
                result.append(ab)
            else:
                if current_run:
                    if last_run is not None:
                        current_run.append(last_run)
                    with cs.ns(f"run ending at {i}"):
                        last_run = kary_and(cs, current_run)
                    current_run = []
                assert last_run is not None, "char always starts with a one"
                with cs.ns(f"bit {i}"):
                    ab = AllocatedBit.alloc_conditionally(cs, a_bit, last_run)
                result.append(ab)
            i += 1

        assert not current_run or True  # char is prime: ends on a run of ones
        result.reverse()

        acc = lc()
        coeff = 1
        for bit in result:
            acc.add_term(bit.var, coeff)
            coeff = (coeff * 2) % R
        acc.add_term(self.var, -1)
        cs.enforce("unpacking constraint", lc(), lc(), acc)
        return [Boolean.from_bit(b) for b in result]

    @staticmethod
    def conditionally_reverse(cs, a: "AllocatedNum", b: "AllocatedNum", condition: Boolean):
        cond_val = condition.get_value()

        c_val = None
        if cond_val is not None and a.value is not None and b.value is not None:
            c_val = wit.select(cond_val, b.value, a.value)
        c_var = cs.alloc("conditional reversal result 1", c_val)
        cs.enforce(
            "first conditional reversal",
            lc_var(a.var) - b.var,
            condition.lc(ONE, 1),
            lc_var(a.var) - c_var,
        )
        c = AllocatedNum(c_var, c_val)

        d_val = None
        if cond_val is not None and a.value is not None and b.value is not None:
            d_val = wit.select(cond_val, a.value, b.value)
        d_var = cs.alloc("conditional reversal result 2", d_val)
        cs.enforce(
            "second conditional reversal",
            lc_var(b.var) - a.var,
            condition.lc(ONE, 1),
            lc_var(b.var) - d_var,
        )
        d = AllocatedNum(d_var, d_val)
        return c, d

    def get_value(self) -> int | None:
        return self.value

    def get_variable(self) -> int:
        return self.var


class Num:
    """A symbolic linear combination with a tracked value (bellman's Num)."""

    __slots__ = ("value", "lc")

    def __init__(self, value: int | None = 0, lc_: LinearCombination | None = None):
        self.value = value
        self.lc = lc_ if lc_ is not None else lc()

    @staticmethod
    def zero() -> "Num":
        return Num(0, lc())

    @staticmethod
    def from_allocated(num: AllocatedNum) -> "Num":
        return Num(num.value, lc_var(num.var))

    def add_bool_with_coeff(self, one_var: int, bit: Boolean, coeff: int) -> "Num":
        bv = bit.get_value()
        newval = None
        if self.value is not None and bv is not None:
            newval = (self.value + wit.select(bv, coeff, 0)) % R
        return Num(newval, self.lc + bit.lc(one_var, coeff))

    def get_lc(self, coeff: int = 1) -> LinearCombination:
        return self.lc.scale(coeff) if coeff != 1 else self.lc.copy()

    def get_value(self) -> int | None:
        return self.value


__all__ = ["AllocatedNum", "Num"]
