"""Complete projective addition on G1 / G2 (RCB'15 Algorithm 7, a = 0) over
a field-ops object, the coordinate field ops it runs on, and the packed row
layout of a point.

Shared by the point-add kernel's plain version (kernels/point_add.py, which
swaps in the plain Montgomery product) and ops/weierstrass.py (which adds
the codecs and inversion). The CUDA kernel evaluates the same formulas in
registers.

Points are packed rows (n, 3K) int32 of 16-bit limbs, [X | Y | Z], with
K = 24 on G1 and K = 48 on G2 (Fq2 coordinates as c0 limbs then c1 limbs).
"""

from __future__ import annotations

import torch

from masp_tpu_torch.ops import field as F
from masp_tpu_torch.ops.field import FQ

K_OF = {1: FQ.L, 2: 2 * FQ.L}


def mul_small(fops, a, k: int, three_rows: int = 0):
    """a * k by a doubling chain (k in {3, 12}). With ``three_rows``, the
    first that many rows stop at 3a and the rest go on to 12a (the RCB tail
    needs 3 t0 beside 12 t2 and 12 Y3)."""
    t = fops.add(fops.add(a, a), a)  # 3a
    if k == 3:
        return t
    if k != 12:
        raise ValueError(k)
    head, rest = t[:three_rows], t[three_rows:]
    rest = fops.add(rest, rest)  # 6a
    rest = fops.add(rest, rest)  # 12a
    return torch.cat([head, rest], dim=0) if three_rows else rest


def _cat(*xs):
    return torch.cat(xs, dim=0)


def _split(x, k: int):
    return x.chunk(k, dim=0)


# The formulas below evaluate RCB'15's sequence of field operations with the
# independent ones stacked along the batch axis (six products per round, as
# the JAX package's Fq2 multiply stacks its three): the same field operations
# on the same values, so the same limbs as the CUDA kernel's sequential form,
# in two multiply calls per add instead of twelve.

def _tail(fops, t0, t1, t2, t3, t4, Y3):
    mul, add, sub = fops.mul, fops.add, fops.sub
    # 3 t0, b3 t2 and b3 Y3 share the doubling chain (b3 = 12, times 1 + u on G2)
    n = t0.shape[0]
    k = mul_small(fops, _cat(t0, t2, Y3), 12, three_rows=n)
    t0 = k[:n]
    t2, Y3 = _split(fops.b3_twist(k[n:]), 2)
    Z3 = add(t1, t2)
    t1 = sub(t1, t2)
    X3, t2, Y3, t1, t0, Z3 = _split(
        mul(_cat(t4, t3, Y3, t1, t0, Z3), _cat(Y3, t1, t0, Z3, t3, t4)), 6
    )
    X3 = sub(t2, X3)  # t3 t1 - t4 Y3
    Y3, Z3 = _split(add(_cat(t1, Z3), _cat(Y3, t0)), 2)
    return (X3, Y3, Z3)


def rcb_add(fops, p, q):
    """Complete projective addition of coordinate tuples; 12 products."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    mul, add, sub = fops.mul, fops.add, fops.sub
    a1, b1, c1, a2, b2, c2 = _split(
        add(_cat(X1, Y1, X1, X2, Y2, X2), _cat(Y1, Z1, Z1, Y2, Z2, Z2)), 6
    )
    t0, t1, t2, p3, p4, p5 = _split(
        mul(_cat(X1, Y1, Z1, a1, b1, c1), _cat(X2, Y2, Z2, a2, b2, c2)), 6
    )
    # t3 = (X1+Y1)(X2+Y2) - t0 - t1, t4 = (Y1+Z1)(Y2+Z2) - t1 - t2,
    # Y3 = (X1+Z1)(X2+Z2) - t0 - t2
    t3, t4, Y3 = _split(sub(_cat(p3, p4, p5), add(_cat(t0, t1, t0), _cat(t1, t2, t2))), 3)
    return _tail(fops, t0, t1, t2, t3, t4, Y3)


def rcb_add01(fops, p, q):
    """rcb_add for Z1, Z2 in {0, mont-1}: t2 and the two cross terms become
    masked selects (9 products). Same limbs as rcb_add on such inputs."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    mul, add, sub = fops.mul, fops.add, fops.sub
    m1 = fops.live(Z1)
    m2 = fops.live(Z2)

    def keep(m, a):
        return torch.where(fops.expand_mask(m, a), a, torch.zeros_like(a))

    t2 = fops.one_or_zero(m1 & m2, Z1)
    # (Y1+Z1)(Y2+Z2) - t1 - t2 = Y1 Z2 + Z1 Y2 and (X1+Z1)(X2+Z2) - t0 - t2
    # = X1 Z2 + Z1 X2 are masked selects
    a1, a2, t4, Y3 = _split(
        add(_cat(X1, X2, keep(m2, Y1), keep(m2, X1)),
            _cat(Y1, Y2, keep(m1, Y2), keep(m1, X2))), 4
    )
    t0, t1, p3 = _split(mul(_cat(X1, Y1, a1), _cat(X2, Y2, a2)), 3)
    t3 = sub(p3, add(t0, t1))
    return _tail(fops, t0, t1, t2, t3, t4, Y3)


# --- coordinate field ops ------------------------------------------------------

def karatsuba(fq_mul, a, b):
    """Fq2 product of (n, 2, 24) limbs: c0 = a0 b0 - a1 b1,
    c1 = (a0 + a1)(b0 + b1) - a0 b0 - a1 b1, with the three products, the
    two sums and the first two differences each stacked into one call."""
    n = a.shape[0]
    s = F.add(FQ, torch.stack([a[:, 0], b[:, 0]]), torch.stack([a[:, 1], b[:, 1]]))
    p = fq_mul(torch.cat([a[:, 0], a[:, 1], s[0]]), torch.cat([b[:, 0], b[:, 1], s[1]]))
    v0, v1, ss = p[:n], p[n : 2 * n], p[2 * n :]
    d = F.sub(FQ, torch.stack([v0, ss]), torch.stack([v1, v0]))
    return torch.stack([d[0], F.sub(FQ, d[1], v1)], dim=1)


class FqArith:
    """Fq on (..., 24) limbs: the field operations the formulas use. The
    product is ``fq_mul``, which dispatches to the Montgomery kernel on CUDA
    tensors; the point-add kernel's plain version swaps in the plain one."""

    @staticmethod
    def fq_mul(a, b):
        return F.mont_mul(FQ, a, b)

    @classmethod
    def mul(cls, a, b):
        return cls.fq_mul(a, b)

    @staticmethod
    def add(a, b):
        return F.add(FQ, a, b)

    @staticmethod
    def sub(a, b):
        return F.sub(FQ, a, b)

    @staticmethod
    def b3_twist(a):
        """b3 = 12 on G1: nothing beyond the doubling chain."""
        return a

    @staticmethod
    def live(Z):
        return Z[..., 0] != 0

    @staticmethod
    def expand_mask(m, a):
        return m[..., None]

    @staticmethod
    def one_or_zero(m, like):
        one = F.one_like(FQ, like)
        return torch.where(m[..., None], one, torch.zeros_like(one))


class Fq2Arith(FqArith):
    """Fq2 = Fq[u]/(u^2+1) on (..., 2, 24) limbs (c0, c1 stacked); add and
    sub act per coefficient."""

    @classmethod
    def mul(cls, a, b):
        shape = torch.broadcast_shapes(a.shape, b.shape)
        a = a.expand(shape).reshape(-1, 2, FQ.L)
        b = b.expand(shape).reshape(-1, 2, FQ.L)
        return karatsuba(cls.fq_mul, a, b).reshape(shape)

    @staticmethod
    def b3_twist(t):
        """12a -> 12a (1 + u) = (c0 - c1) + (c0 + c1) u (b3 = 12(1 + u) on G2)."""
        c0, c1 = t[..., 0, :], t[..., 1, :]
        return torch.stack([F.sub(FQ, c0, c1), F.add(FQ, c0, c1)], dim=-2)

    @staticmethod
    def live(Z):
        return Z[..., 0, 0] != 0

    @staticmethod
    def expand_mask(m, a):
        return m[..., None, None]

    @staticmethod
    def one_or_zero(m, like):
        c0 = FqArith.one_or_zero(m, like[..., 0, :])
        return torch.stack([c0, torch.zeros_like(c0)], dim=-2)


# --- packed rows ---------------------------------------------------------------

def unpack_rows(group: int, rows):
    """(..., 3K) rows -> (X, Y, Z) coordinates: (..., 24) on G1, (..., 2, 24)
    on G2."""
    K = K_OF[group]
    shape = rows.shape[:-1] + ((FQ.L,) if group == 1 else (2, FQ.L))
    return tuple(rows[..., i * K : (i + 1) * K].reshape(shape) for i in range(3))


def pack_rows(coords):
    n = coords[0].shape[0]
    return torch.cat([c.reshape(n, -1) for c in coords], dim=1)


__all__ = ["K_OF", "mul_small", "rcb_add", "rcb_add01", "karatsuba", "FqArith",
           "Fq2Arith", "unpack_rows", "pack_rows"]
