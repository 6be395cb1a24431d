# Copy of masp_tpu/r1cs/wit.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""Branch-free witness-value helpers shared by normal and tape-recording
synthesis.

Gadget witness computations that would branch or index on a value route
through these helpers: with plain ints/bools they behave exactly as the
original inline code; with TapeVal they emit branch-free tape ops
(select = b + c*(a-b), bool algebra over {0,1}, lookup = select chain).
"""

from __future__ import annotations

from masp_tpu_torch.host.fields import SCALAR_MODULUS
from masp_tpu_torch.host.r1cs.tape import TapeVal  # noqa: F401 (re-exported)

R = SCALAR_MODULUS


def is_tape(*xs) -> bool:
    return any(isinstance(x, TapeVal) for x in xs)


def select(cond, a, b):
    """cond ? a : b for bool/int cond or TapeVal(0/1)."""
    if isinstance(cond, TapeVal):
        ta = cond.rec._coerce(a)
        tb = cond.rec._coerce(b)
        return tb + cond * (ta - tb)
    return a if cond else b


def as_bit(value):
    """int(bool(value)) preserving TapeVal (already 0/1 by construction)."""
    if isinstance(value, TapeVal):
        if value.val not in (0, 1):
            raise ValueError("recorded bit value out of range")
        return value
    return int(bool(value))


def bit(value, i: int):
    """(value >> i) & 1 as a bool (host) or 0/1 TapeVal."""
    if isinstance(value, TapeVal):
        return (value >> i) & 1
    return (int(value) >> i) & 1 == 1


def truthy(value) -> bool | TapeVal:
    """bool(value) for host values; identity for 0/1 TapeVals."""
    return as_bit(value) if isinstance(value, TapeVal) else bool(value)


def b_not(a):
    if isinstance(a, TapeVal):
        return 1 - a
    return not a


def b_xor(a, b):
    if is_tape(a, b):
        ta, tb = _pair(a, b)
        return ta + tb - 2 * (ta * tb)
    return bool(a) ^ bool(b)


def b_and(a, b):
    if is_tape(a, b):
        ta, tb = _pair(a, b)
        return ta * tb
    return bool(a) and bool(b)


def b_and_not(a, b):
    if is_tape(a, b):
        ta, tb = _pair(a, b)
        return ta * (1 - tb)
    return bool(a) and not b


def b_nor(a, b):
    if is_tape(a, b):
        ta, tb = _pair(a, b)
        return (1 - ta) * (1 - tb)
    return (not a) and (not b)


def _pair(a, b):
    rec = a.rec if isinstance(a, TapeVal) else b.rec
    return rec._coerce(int(a) if not isinstance(a, TapeVal) else a), rec._coerce(
        int(b) if not isinstance(b, TapeVal) else b
    )


def lookup(bits: list, table: list):
    """table[index(bits)] where bits are LSB-first bools/TapeVals and table
    entries are ints (or tuples handled by the caller)."""
    if not is_tape(*bits):
        idx = 0
        for k, b in enumerate(bits):
            if b:
                idx |= 1 << k
        return table[idx]
    rec = next(x.rec for x in bits if isinstance(x, TapeVal))
    vals = [rec._coerce(int(t) % R) for t in table]
    for b in bits:
        nxt = []
        for j in range(0, len(vals), 2):
            nxt.append(select(b, vals[j + 1], vals[j]))
        vals = nxt
    assert len(vals) == 1
    return vals[0]


def inv(value):
    """Modular inverse, DivisionByZero on zero (cs.finv semantics)."""
    if isinstance(value, TapeVal):
        return value.inv()
    from masp_tpu_torch.host.r1cs.cs import DivisionByZero

    if value % R == 0:
        raise DivisionByZero()
    return pow(value, -1, R)


__all__ = [
    "is_tape", "select", "as_bit", "bit", "truthy",
    "b_not", "b_xor", "b_and", "b_and_not", "b_nor", "lookup", "inv",
]
