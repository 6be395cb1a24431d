"""Batched BLS12-381 G1/G2 group operations (projective, branch-free).

Port of masp_tpu/ops/weierstrass_jax.py. Points are (X, Y, Z) coordinate
tuples; identity = (0 : 1 : 0). A coordinate is (..., 24) int32 Montgomery
limbs on G1 (Fq) and (..., 2, 24) on G2 (Fq2 = Fq[u]/(u^2+1), c0 then c1).
``g_add`` / ``g_add01`` run the point-add kernel (kernels/point_add.py) on
packed [X | Y | Z] rows; ``point_add`` composes the same formula from the
field operations.
"""

from __future__ import annotations

import numpy as np
import torch

from masp_tpu_torch.host.bls12_381 import G1, G2, Fq2, Q, _FqElt
from masp_tpu_torch.kernels import point_add as PA
from masp_tpu_torch.ops import field as F
from masp_tpu_torch.ops.field import FQ
from masp_tpu_torch.ops.projective import Fq2Arith, FqArith, rcb_add


class FqOps(FqArith):
    """Fq element ops on (..., L) limb tensors; products dispatch to the
    Montgomery kernel on CUDA tensors."""

    spec = FQ
    coord_shape = (FQ.L,)

    @staticmethod
    def zeros_like(a):
        return torch.zeros_like(a)

    @staticmethod
    def one_like(a):
        return F.one_like(FQ, a)

    @staticmethod
    def is_zero(a):
        return torch.all(a == 0, dim=-1)

    @staticmethod
    def batch_inv(a):
        return F.batch_mont_inv(FQ, a)

    @staticmethod
    def encode(vals: list[int]) -> np.ndarray:
        return F.encode(FQ, vals)

    @staticmethod
    def decode(arr) -> list[int]:
        return F.decode(FQ, arr)


class Fq2Ops(Fq2Arith):
    """Fq2 element ops on (..., 2, L) limb tensors (c0, c1 stacked)."""

    spec = FQ
    coord_shape = (2, FQ.L)

    @staticmethod
    def zeros_like(a):
        return torch.zeros_like(a)

    @staticmethod
    def one_like(a):
        one = F.one_like(FQ, a[..., 0, :])
        return torch.stack([one, torch.zeros_like(one)], dim=-2)

    @staticmethod
    def is_zero(a):
        return torch.all(torch.all(a == 0, dim=-1), dim=-1)

    @staticmethod
    def inv(a):
        # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2): both squares in one
        # product launch, the norm by the inversion kernel (0 maps to 0),
        # both scalings in one launch
        sq = F.mont_mul(FQ, a, a)
        ninv = F.mont_inv_small(FQ, F.add(FQ, sq[..., 0, :], sq[..., 1, :]))
        c = F.mont_mul(FQ, a, ninv[..., None, :])
        return torch.stack([c[..., 0, :], F.neg(FQ, c[..., 1, :])], dim=-2)

    @staticmethod
    def batch_inv(a):
        # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
        a0, a1 = a[..., 0, :], a[..., 1, :]
        norm = F.add(FQ, F.mont_mul(FQ, a0, a0), F.mont_mul(FQ, a1, a1))
        ninv = F.batch_mont_inv(FQ, norm)
        c0 = F.mont_mul(FQ, a0, ninv)
        c1 = F.neg(FQ, F.mont_mul(FQ, a1, ninv))
        return torch.stack([c0, c1], dim=-2)

    @staticmethod
    def encode(vals: list[tuple[int, int]]) -> np.ndarray:
        c0 = F.encode(FQ, [v[0] for v in vals])
        c1 = F.encode(FQ, [v[1] for v in vals])
        return np.stack([c0, c1], axis=-2)

    @staticmethod
    def decode(arr) -> list[tuple[int, int]]:
        if isinstance(arr, torch.Tensor):
            arr = arr.cpu().numpy()
        arr = np.asarray(arr)
        return list(zip(F.decode(FQ, arr[..., 0, :]), F.decode(FQ, arr[..., 1, :])))


class G1Ops(FqOps):
    """G1: y^2 = x^3 + 4; b3 = 12."""

    GROUP = 1


class G2Ops(Fq2Ops):
    """G2 twist: y^2 = x^3 + 4(u+1); b3 = 12(u+1)."""

    GROUP = 2


def rowlen(fops) -> int:
    """Packed [X | Y | Z] row length of a group: 72 on G1, 144 on G2."""
    return 3 * int(np.prod(fops.coord_shape))


def point_add(fops, p, q):
    """Complete projective addition (RCB'15 Algorithm 7, a = 0) composed
    from the field operations; 12 products, no branches."""
    return rcb_add(fops, p, q)


def _kernel_add(fops, p, q, leaf01: bool):
    cshape = fops.coord_shape
    nb = len(cshape)
    batch = torch.broadcast_shapes(*(c.shape[:-nb] for c in (*p, *q)))

    def rows(pt):
        return torch.cat(
            [c.expand(batch + cshape).reshape(-1, int(np.prod(cshape))) for c in pt], dim=1
        ).to(torch.int32)

    out = PA.point_add(fops.GROUP, rows(p), rows(q), leaf01)
    k = int(np.prod(cshape))
    return tuple(out[:, i * k : (i + 1) * k].reshape(batch + cshape) for i in range(3))


def g_add(fops, p, q):
    """Complete addition through the point-add kernel."""
    return _kernel_add(fops, p, q, leaf01=False)


def g_add01(fops, p, q):
    """g_add for operands whose Z is 0 or the Montgomery 1 (encoded affine
    points or identity pads): the kernel's 9-product leaf form."""
    return _kernel_add(fops, p, q, leaf01=True)


def identity_like(fops, x_coord):
    """Identity (0 : 1 : 0) with the coordinate batch shape of x_coord."""
    zero = fops.zeros_like(x_coord)
    return (zero, fops.one_like(x_coord), zero)


def point_select(cond, p, q):
    """cond ? p : q, per batch element, on all coordinates."""

    def sel(a, b):
        c = cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim()))
        return torch.where(c != 0, a, b)

    return tuple(sel(a, b) for a, b in zip(p, q))


def to_affine(fops, p):
    """Projective -> affine via batch inversion; identity maps to (0, 0)."""
    X, Y, Z = p
    zinv = fops.batch_inv(Z)
    return fops.mul(X, zinv), fops.mul(Y, zinv)


# --- host codecs -----------------------------------------------------------

def encode_g1_points(points) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host G1 affine points -> projective limb arrays (identity -> (0,1,0))."""
    xs, ys, zs = [], [], []
    for p in points:
        if p.is_identity():
            xs.append(0)
            ys.append(1)
            zs.append(0)
        else:
            xs.append(p.x.n)
            ys.append(p.y.n)
            zs.append(1)
    return FqOps.encode(xs), FqOps.encode(ys), FqOps.encode(zs)


def decode_g1_points(X, Y, Z):
    """Projective limb arrays -> host G1 list."""
    xs = FqOps.decode(X)
    ys = FqOps.decode(Y)
    zs = FqOps.decode(Z)
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(G1.identity())
        else:
            zi = pow(z, -1, Q)
            out.append(G1.from_xy(_FqElt(x * zi % Q), _FqElt(y * zi % Q)))
    return out


def encode_g2_points(points) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    xs, ys, zs = [], [], []
    for p in points:
        if p.is_identity():
            xs.append((0, 0))
            ys.append((1, 0))
            zs.append((0, 0))
        else:
            xs.append((p.x.c0, p.x.c1))
            ys.append((p.y.c0, p.y.c1))
            zs.append((1, 0))
    return Fq2Ops.encode(xs), Fq2Ops.encode(ys), Fq2Ops.encode(zs)


def decode_g2_points(X, Y, Z):
    xs = Fq2Ops.decode(X)
    ys = Fq2Ops.decode(Y)
    zs = Fq2Ops.decode(Z)
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == (0, 0):
            out.append(G2.identity())
        else:
            zi = Fq2(z[0], z[1]).invert()
            out.append(G2.from_xy(Fq2(x[0], x[1]) * zi, Fq2(y[0], y[1]) * zi))
    return out


def decode_affine_g1(ax, ay):
    """Affine limb arrays (identity as (0, 0)) -> host G1 list."""
    return [
        G1.identity() if (x == 0 and y == 0) else G1.from_xy(_FqElt(x), _FqElt(y))
        for x, y in zip(FqOps.decode(ax), FqOps.decode(ay))
    ]


def decode_affine_g2(ax, ay):
    return [
        G2.identity() if (x == (0, 0) and y == (0, 0)) else G2.from_xy(Fq2(*x), Fq2(*y))
        for x, y in zip(Fq2Ops.decode(ax), Fq2Ops.decode(ay))
    ]


__all__ = [
    "FqOps", "Fq2Ops", "G1Ops", "G2Ops", "point_add", "g_add", "g_add01",
    "identity_like", "point_select", "to_affine", "rowlen",
    "encode_g1_points", "decode_g1_points", "encode_g2_points",
    "decode_g2_points", "decode_affine_g1", "decode_affine_g2",
]
