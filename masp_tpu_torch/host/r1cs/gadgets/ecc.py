# Copy of masp_tpu/r1cs/gadgets/ecc.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""In-circuit Jubjub: Edwards/Montgomery point gadgets.

Mirrors masp_proofs/src/circuit/ecc.rs — same constraint shapes (Edwards
add 6, double 5, Montgomery add 3, witness/interpret 4, conditional select 2)
and the same namespace layout.
"""

from __future__ import annotations

from masp_tpu_torch.host.circuits.constants import EDWARDS_D, MONTGOMERY_A, MONTGOMERY_SCALE
from masp_tpu_torch.host.fields import SCALAR_MODULUS
from masp_tpu_torch.host.r1cs import wit
from masp_tpu_torch.host.r1cs.cs import (
    ONE, DivisionByZero, fadd, fdiv, fmul, fneg, fsub, lc, lc_var,
)
from masp_tpu_torch.host.r1cs.gadgets.boolean import Boolean
from masp_tpu_torch.host.r1cs.gadgets.num import AllocatedNum, Num

R = SCALAR_MODULUS


class EdwardsPoint:
    __slots__ = ("u", "v")

    def __init__(self, u: AllocatedNum, v: AllocatedNum):
        self.u = u
        self.v = v

    def get_u(self) -> AllocatedNum:
        return self.u

    def get_v(self) -> AllocatedNum:
        return self.v

    def assert_not_small_order(self, cs):
        with cs.ns("first doubling"):
            tmp = self.double(cs)
        with cs.ns("second doubling"):
            tmp = tmp.double(cs)
        with cs.ns("third doubling"):
            tmp = tmp.double(cs)
        with cs.ns("check u != 0"):
            tmp.u.assert_nonzero(cs)

    def inputize(self, cs):
        with cs.ns("u"):
            self.u.inputize(cs)
        with cs.ns("v"):
            self.v.inputize(cs)

    def repr_bits(self, cs) -> list[Boolean]:
        """Point encoding bits: v (255, strict) then the sign bit of u."""
        with cs.ns("unpack u"):
            u = self.u.to_bits_le_strict(cs)
        with cs.ns("unpack v"):
            v = self.v.to_bits_le_strict(cs)
        out = list(v)
        out.append(u[0])
        return out

    @staticmethod
    def witness(cs, p) -> "EdwardsPoint":
        """Witness an affine point (ExtendedPoint or None), enforcing
        on-curve."""
        if p is not None:
            au, av = p.to_affine()
            uv, vv = au.n, av.n
        else:
            uv = vv = None
        with cs.ns("u"):
            u = AllocatedNum.alloc(cs, uv)
        with cs.ns("v"):
            v = AllocatedNum.alloc(cs, vv)
        with cs.ns("point interpretation"):
            return EdwardsPoint.interpret(cs, u, v)

    @staticmethod
    def interpret(cs, u: AllocatedNum, v: AllocatedNum) -> "EdwardsPoint":
        # -u^2 + v^2 = 1 + d u^2 v^2
        with cs.ns("u^2"):
            u2 = u.square(cs)
        with cs.ns("v^2"):
            v2 = v.square(cs)
        with cs.ns("u^2 v^2"):
            u2v2 = u2.mul(cs, v2)
        cs.enforce(
            "on curve check",
            lc() - u2.var + v2.var,
            lc_var(ONE),
            lc_var(ONE) + (EDWARDS_D, u2v2.var),
        )
        return EdwardsPoint(u, v)

    def conditionally_select(self, cs, condition: Boolean) -> "EdwardsPoint":
        cv = condition.get_value()
        u_val = None
        if cv is not None and self.u.value is not None:
            u_val = wit.select(cv, self.u.value, 0)
        with cs.ns("u'"):
            u_prime = AllocatedNum.alloc(cs, u_val)
        cs.enforce(
            "u' computation",
            lc_var(self.u.var),
            condition.lc(ONE, 1),
            lc_var(u_prime.var),
        )

        v_val = None
        if cv is not None and self.v.value is not None:
            v_val = wit.select(cv, self.v.value, 1)
        with cs.ns("v'"):
            v_prime = AllocatedNum.alloc(cs, v_val)
        cs.enforce(
            "v' computation",
            lc_var(self.v.var),
            condition.lc(ONE, 1),
            lc_var(v_prime.var) - condition.not_().lc(ONE, 1),
        )
        return EdwardsPoint(u_prime, v_prime)

    def mul(self, cs, by: list[Boolean]) -> "EdwardsPoint":
        """Variable-base scalar mul, double-and-add over LE bits."""
        curbase = None
        result = None
        for i, bit in enumerate(by):
            if curbase is None:
                curbase = self
            else:
                with cs.ns(f"doubling {i}"):
                    curbase = curbase.double(cs)
            with cs.ns(f"selection {i}"):
                thisbase = curbase.conditionally_select(cs, bit)
            if result is None:
                result = thisbase
            else:
                with cs.ns(f"addition {i}"):
                    result = result.add(cs, thisbase)
        assert result is not None
        return result

    def double(self, cs) -> "EdwardsPoint":
        # T = (u + v)^2
        t_val = None
        if self.u.value is not None and self.v.value is not None:
            s = (self.u.value + self.v.value) % R
            t_val = (s * s) % R
        with cs.ns("T"):
            t = AllocatedNum.alloc(cs, t_val)
        cs.enforce(
            "T computation",
            lc_var(self.u.var) + self.v.var,
            lc_var(self.u.var) + self.v.var,
            lc_var(t.var),
        )

        # A = u * v
        with cs.ns("A computation"):
            a = self.u.mul(cs, self.v)

        # C = d * A^2
        c_val = None if a.value is None else (a.value * a.value % R * EDWARDS_D) % R
        with cs.ns("C"):
            c = AllocatedNum.alloc(cs, c_val)
        cs.enforce(
            "C computation",
            lc_var(a.var, EDWARDS_D),
            lc_var(a.var),
            lc_var(c.var),
        )

        # u3 = 2A / (1 + C)
        u3_val = None
        if a.value is not None and c.value is not None:
            u3_val = fdiv((2 * a.value) % R, (1 + c.value) % R)
        with cs.ns("u3"):
            u3 = AllocatedNum.alloc(cs, u3_val)
        cs.enforce(
            "u3 computation",
            lc_var(ONE) + c.var,
            lc_var(u3.var),
            lc_var(a.var) + a.var,
        )

        # v3 = (T - 2A) / (1 - C)
        v3_val = None
        if t.value is not None and a.value is not None and c.value is not None:
            v3_val = fdiv((t.value - 2 * a.value) % R, (1 - c.value) % R)
        with cs.ns("v3"):
            v3 = AllocatedNum.alloc(cs, v3_val)
        cs.enforce(
            "v3 computation",
            lc_var(ONE) - c.var,
            lc_var(v3.var),
            lc_var(t.var) - a.var - a.var,
        )
        return EdwardsPoint(u3, v3)

    def add(self, cs, other: "EdwardsPoint") -> "EdwardsPoint":
        # U = (u1 + v1) * (u2 + v2)
        U_val = None
        if None not in (self.u.value, self.v.value, other.u.value, other.v.value):
            U_val = ((self.u.value + self.v.value) * (other.u.value + other.v.value)) % R
        with cs.ns("U"):
            uppercase_u = AllocatedNum.alloc(cs, U_val)
        cs.enforce(
            "U computation",
            lc_var(self.u.var) + self.v.var,
            lc_var(other.u.var) + other.v.var,
            lc_var(uppercase_u.var),
        )

        with cs.ns("A computation"):
            a = other.v.mul(cs, self.u)
        with cs.ns("B computation"):
            b = other.u.mul(cs, self.v)

        c_val = None
        if a.value is not None and b.value is not None:
            c_val = (a.value * b.value % R * EDWARDS_D) % R
        with cs.ns("C"):
            c = AllocatedNum.alloc(cs, c_val)
        cs.enforce(
            "C computation",
            lc_var(a.var, EDWARDS_D),
            lc_var(b.var),
            lc_var(c.var),
        )

        # u3 = (A + B) / (1 + C)
        u3_val = None
        if None not in (a.value, b.value, c.value):
            u3_val = fdiv((a.value + b.value) % R, (1 + c.value) % R)
        with cs.ns("u3"):
            u3 = AllocatedNum.alloc(cs, u3_val)
        cs.enforce(
            "u3 computation",
            lc_var(ONE) + c.var,
            lc_var(u3.var),
            lc_var(a.var) + b.var,
        )

        # v3 = (U - A - B) / (1 - C)
        v3_val = None
        if None not in (uppercase_u.value, a.value, b.value, c.value):
            v3_val = fdiv((uppercase_u.value - a.value - b.value) % R, (1 - c.value) % R)
        with cs.ns("v3"):
            v3 = AllocatedNum.alloc(cs, v3_val)
        cs.enforce(
            "v3 computation",
            lc_var(ONE) - c.var,
            lc_var(v3.var),
            lc_var(uppercase_u.var) - a.var - b.var,
        )
        return EdwardsPoint(u3, v3)


class MontgomeryPoint:
    __slots__ = ("x", "y")

    def __init__(self, x: Num, y: Num):
        self.x = x
        self.y = y

    @staticmethod
    def interpret_unchecked(x: Num, y: Num) -> "MontgomeryPoint":
        return MontgomeryPoint(x, y)

    def into_edwards(self, cs) -> EdwardsPoint:
        # u = (scale * x) / y
        u_val = None
        if self.x.value is not None and self.y.value is not None:
            u_val = fdiv((self.x.value * MONTGOMERY_SCALE) % R, self.y.value)
        with cs.ns("u"):
            u = AllocatedNum.alloc(cs, u_val)
        cs.enforce(
            "u computation",
            self.y.get_lc(1),
            lc_var(u.var),
            self.x.get_lc(MONTGOMERY_SCALE),
        )

        # v = (x - 1) / (x + 1)
        v_val = None
        if self.x.value is not None:
            v_val = fdiv((self.x.value - 1) % R, (self.x.value + 1) % R)
        with cs.ns("v"):
            v = AllocatedNum.alloc(cs, v_val)
        cs.enforce(
            "v computation",
            self.x.get_lc(1) + ONE,
            lc_var(v.var),
            self.x.get_lc(1) - ONE,
        )
        return EdwardsPoint(u, v)

    def add(self, cs, other: "MontgomeryPoint") -> "MontgomeryPoint":
        # lambda = (y' - y) / (x' - x)
        lam_val = None
        if None not in (self.x.value, self.y.value, other.x.value, other.y.value):
            lam_val = fdiv(
                (other.y.value - self.y.value) % R, (other.x.value - self.x.value) % R
            )
        with cs.ns("lambda"):
            lam = AllocatedNum.alloc(cs, lam_val)
        cs.enforce(
            "evaluate lambda",
            other.x.get_lc(1) - self.x.get_lc(1),
            lc_var(lam.var),
            other.y.get_lc(1) - self.y.get_lc(1),
        )

        # x'' = lambda^2 - A - x - x'
        x_val = None
        if lam.value is not None and self.x.value is not None and other.x.value is not None:
            x_val = (lam.value * lam.value - MONTGOMERY_A - self.x.value - other.x.value) % R
        with cs.ns("xprime"):
            xprime = AllocatedNum.alloc(cs, x_val)
        cs.enforce(
            "evaluate xprime",
            lc_var(lam.var),
            lc_var(lam.var),
            lc_var(ONE, MONTGOMERY_A) + self.x.get_lc(1) + other.x.get_lc(1) + xprime.var,
        )

        # y'' = -(y + lambda(x'' - x))
        y_val = None
        if None not in (xprime.value, self.x.value, lam.value, self.y.value):
            y_val = fneg(((xprime.value - self.x.value) * lam.value + self.y.value) % R)
        with cs.ns("yprime"):
            yprime = AllocatedNum.alloc(cs, y_val)
        # y'' + y = lambda(x - x'')
        cs.enforce(
            "evaluate yprime",
            self.x.get_lc(1) - xprime.var,
            lc_var(lam.var),
            lc_var(yprime.var) + self.y.get_lc(1),
        )
        return MontgomeryPoint(Num.from_allocated(xprime), Num.from_allocated(yprime))


def fixed_base_multiplication(cs, base_table, by: list[Boolean]) -> EdwardsPoint:
    """3-bit windowed fixed-base scalar mul over precomputed tables
    (circuit/ecc.rs:27-73)."""
    from masp_tpu_torch.host.r1cs.gadgets.lookup import lookup3_xy

    result = None
    chunks = [by[i : i + 3] for i in range(0, len(by), 3)]
    for i, (chunk, window) in enumerate(zip(chunks, base_table)):
        chunk_a = chunk[0] if len(chunk) > 0 else Boolean.constant(False)
        chunk_b = chunk[1] if len(chunk) > 1 else Boolean.constant(False)
        chunk_c = chunk[2] if len(chunk) > 2 else Boolean.constant(False)
        with cs.ns(f"window table lookup {i}"):
            u, v = lookup3_xy(cs, [chunk_a, chunk_b, chunk_c], window)
        p = EdwardsPoint(u, v)
        if result is None:
            result = p
        else:
            with cs.ns(f"addition {i}"):
                result = result.add(cs, p)
    assert result is not None
    return result


__all__ = ["EdwardsPoint", "MontgomeryPoint", "fixed_base_multiplication"]
