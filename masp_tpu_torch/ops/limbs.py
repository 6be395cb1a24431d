"""The limb format: Python ints <-> 16-bit limb arrays, and carry handling
on limb tensors.

The port keeps the JAX package's element layout at every public function:
an element is a (..., L) array of 16-bit limbs, little-endian. Host arrays
are numpy uint32 (as the reference's are); device tensors are torch.int32,
which holds a 16-bit limb exactly. The carry helpers work on (n, L) rows
widened to int64.
"""

from __future__ import annotations

import numpy as np
import torch

from masp_tpu_torch import device_const

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def int_to_limbs(x: int, n_limbs: int) -> np.ndarray:
    out = np.empty(n_limbs, dtype=np.uint32)
    for i in range(n_limbs):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    if x:
        raise ValueError("value does not fit in limbs")
    return out


def limbs_to_int(limbs) -> int:
    x = 0
    arr = np.asarray(limbs, dtype=np.uint64)
    for i in range(arr.shape[-1] - 1, -1, -1):
        x = (x << LIMB_BITS) | int(arr[..., i])
    return x


def ints_to_limbs(xs: list[int], n_limbs: int) -> np.ndarray:
    """[N] ints -> (N, n_limbs) uint32, through one little-endian byte
    buffer (the 16-bit limbs are the value's uint16 words)."""
    nbytes = 2 * n_limbs
    try:
        buf = b"".join(int(x).to_bytes(nbytes, "little") for x in xs)
    except OverflowError:
        raise ValueError("value does not fit in limbs") from None
    words = np.frombuffer(buf, dtype="<u2").reshape(len(xs), n_limbs)
    return words.astype(np.uint32)


def limbs_to_ints(arr) -> list[int]:
    """(N, n_limbs) -> [N] ints."""
    a = np.asarray(arr)
    rows = np.ascontiguousarray(a.reshape(-1, a.shape[-1]).astype("<u2"))
    nbytes = 2 * rows.shape[1]
    buf = rows.tobytes()
    return [
        int.from_bytes(buf[i : i + nbytes], "little")
        for i in range(0, len(buf), nbytes)
    ]


# --- carry propagation on (n, L) int64 limb rows ------------------------------

def _carry_in(g, p):
    """Carry (or borrow) into each limb from generate/propagate masks
    (n, L), L <= 62: limb i receives g[j] of the highest j < i whose p[j] is
    false. The masks pack into one int64 per row as the bits of X = g | p
    and Y = g; binary X + Y then generates, propagates and kills carries
    exactly as the limbs do, and (X + Y) ^ X ^ Y holds the carry into each
    bit. Returns (carry_in (n, L) int64, carry_out (n,) bool)."""
    L = g.shape[-1]
    dev = g.device
    idx = device_const(("idx", L, dev), lambda: torch.arange(L, device=dev))
    w = device_const(("pow2", L, dev), lambda: torch.ones(L, dtype=torch.int64, device=dev) << idx)
    Y = (g.to(torch.int64) * w).sum(-1)
    X = Y | (p.to(torch.int64) * w).sum(-1)
    C = (X + Y) ^ X ^ Y
    return (C[:, None] >> idx) & 1, ((C >> L) & 1).to(torch.bool)


def normalize(t):
    """Non-negative lazy columns t (n, L) int64, each < 2^40 -> canonical
    16-bit limbs (n, L) int64 and the carry out of the top limb (n,) int64."""
    cout = torch.zeros_like(t[:, 0])
    for _ in range(3):  # each pass shrinks the column excess by 16 bits
        hi = t >> LIMB_BITS
        cout = cout + hi[:, -1]
        t = t & LIMB_MASK
        t[:, 1:] += hi[:, :-1]
    # columns are now <= 2^16: single-bit carries, resolved by lookahead
    cin, c = _carry_in(t > LIMB_MASK, t == LIMB_MASK)
    return (t + cin) & LIMB_MASK, cout + c.to(torch.int64)


def sub_limbs(a, b):
    """a - b on canonical limbs: (limbs mod 2^(16L), borrow (n,) bool)."""
    d = a - b
    bin_, bout = _carry_in(d < 0, d == 0)
    return (d - bin_) & LIMB_MASK, bout


def add_limbs(a, b):
    """a + b on canonical limbs: (limbs mod 2^(16L), carry (n,) bool)."""
    s = a + b
    cin, cout = _carry_in(s > LIMB_MASK, s == LIMB_MASK)
    return (s + cin) & LIMB_MASK, cout


def exact_matmul(x, w):
    """x @ w as int64 for integer tensors whose partial sums are all
    integers below 2^53: one float64 matrix product, exact there (PyTorch
    has no integer matrix product on the card)."""
    return (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int64)


def reduce_once(Nl, t, carry):
    """Canonical limbs t (n, L) int64 plus a carry out; subtract the modulus
    Nl (L,) once when the value is >= it (the JAX package's
    ``_carry_reduce`` tail)."""
    d, borrow = sub_limbs(t, Nl)
    ge = (carry != 0) | ~borrow
    return torch.where(ge[:, None], d, t)


__all__ = ["LIMB_BITS", "LIMB_MASK", "int_to_limbs", "limbs_to_int",
           "ints_to_limbs", "limbs_to_ints", "normalize", "sub_limbs",
           "add_limbs", "exact_matmul", "reduce_once"]
