"""BLS12-381 pairing on the device: the Fq6/Fq12 tower, the Miller loop and
the final exponentiation.

Port of masp_tpu/ops/pairing_jax.py, section by section and with its names,
the device counterpart of the host pairing in host/bls12_381.py
(multi_miller_loop / final_exponentiation):

* the Miller loop runs in twisted affine coordinates over Fq2, batched over
  the pairs, with one ``Fq2Ops.batch_inv`` per doubling and per addition
  (one inversion kernel launch on the product tree's root);
* the line through T and S, evaluated at the embedded P, is the sparse
  element A + B (v w) + C (v^2 w) with A, B, C in Fq2: the host's line, so
  the device Miller value equals the host's exactly (the same element, not
  only the same pairing class);
* the final exponentiation is the easy part (one tower inversion and
  Frobenius^2 by the gamma constants), then the hard part as
  square-and-multiply over the bits of (q^4 - q^2 + 1)/r, whose value is the
  host's.

Element layout: Fq2 = (..., 2, 24) int32 Montgomery limbs (c0, c1 stacked);
Fq6 = (c0, c1, c2) tuple of Fq2; Fq12 = (a0, a1) tuple of Fq6. Every product
runs the Fq Montgomery kernel (``F.mont_mul``) on CUDA tensors and every
inversion the divstep inversion kernel (``F.mont_inv_small``); on CPU
tensors their plain versions. Where one level of the tower has independent
Fq2 products, they are stacked into one ``Fq2Ops.mul`` call: one kernel
launch, the same products. BLS_X's bits and the hard exponent's bits are
public constants, so the loops branch on them in Python where the reference
computes both sides and selects: the same element, about half the hard
part's products.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from masp_tpu_torch import device_const, resolve_device
from masp_tpu_torch.host.bls12_381 import BLS_X, Q, XI
from masp_tpu_torch.host.bls12_381 import Fq2 as HostFq2
from masp_tpu_torch.host.bls12_381 import Fq6 as HostFq6
from masp_tpu_torch.host.bls12_381 import Fq12 as HostFq12
from masp_tpu_torch.host.fields import SCALAR_MODULUS as R
from masp_tpu_torch.ops import field as F
from masp_tpu_torch.ops.field import FQ
from masp_tpu_torch.ops.weierstrass import Fq2Ops

# ---------------------------------------------------------------------------
# Fq2 helpers (on top of Fq2Ops)

f2mul, f2add, f2sub = Fq2Ops.mul, Fq2Ops.add, Fq2Ops.sub


def f2neg(a):
    return F.neg(FQ, a)


def f2sq(a):
    return f2mul(a, a)


def f2xi(a):
    """a * xi where xi = u + 1: (a0 - a1) + (a0 + a1)u."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    return torch.stack([F.sub(FQ, a0, a1), F.add(FQ, a0, a1)], dim=-2)


def _many(op, xs, ys):
    """op(x, y) for every pair of xs and ys in one call: the operands are
    broadcast to one shape and stacked on a new leading axis."""
    shape = torch.broadcast_shapes(*(t.shape for t in (*xs, *ys)))
    out = op(torch.stack([x.expand(shape) for x in xs]), torch.stack([y.expand(shape) for y in ys]))
    return out.unbind(0)


def _f2xi_many(xs):
    return f2xi(torch.stack(xs)).unbind(0)


def _enc2(c: HostFq2, dev):
    return torch.as_tensor(Fq2Ops.encode([(c.c0, c.c1)])[0].astype(np.int32), device=dev)


def f2const(c: HostFq2, like):
    """A host Fq2 constant on like's device, broadcast against its shape."""
    dev = like.device
    return device_const(("fq2", c.c0, c.c1, dev), lambda: _enc2(c, dev)).expand(like.shape)


def _f2zero(like):
    return torch.zeros_like(like)


def _f2one(like):
    return Fq2Ops.one_like(like)


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v]/(v^3 - xi): elements are (c0, c1, c2) tuples of Fq2 tensors

def _f6mul_many(pairs):
    """f6mul of each (a, b) of pairs: the 9 Fq2 products of every pair in
    one launch, the sums and xi products of every pair in one call each."""
    xs, ys = [], []
    for (a0, a1, a2), (b0, b1, b2) in pairs:
        xs += [a0, a1, a2, a1, a2, a0, a1, a0, a2]
        ys += [b0, b1, b2, b2, b1, b1, b0, b2, b0]
    p = _many(f2mul, xs, ys)
    k = len(pairs)
    t00, t11, t22 = ([p[9 * i + j] for i in range(k)] for j in range(3))
    # a1 b2 + a2 b1, a0 b1 + a1 b0, a0 b2 + a2 b0
    s = _many(f2add, [p[9 * i + j] for i in range(k) for j in (3, 5, 7)],
              [p[9 * i + j] for i in range(k) for j in (4, 6, 8)])
    x = _f2xi_many([s[3 * i] for i in range(k)] + t22)
    c = _many(f2add, [v for i in range(k) for v in (t00[i], s[3 * i + 1], s[3 * i + 2])],
              [v for i in range(k) for v in (x[i], x[k + i], t11[i])])
    return [tuple(c[3 * i : 3 * i + 3]) for i in range(k)]


def f6mul(a, b):
    return _f6mul_many([(a, b)])[0]


def f6add(a, b):
    return _many(f2add, a, b)


def f6sub(a, b):
    return _many(f2sub, a, b)


def f6neg(a):
    return F.neg(FQ, torch.stack(a)).unbind(0)


def f6mul_by_v(a):
    """a * v: (c0, c1, c2) -> (xi c2, c0, c1)."""
    return (f2xi(a[2]), a[0], a[1])


def f6inv(a):
    a0, a1, a2 = a
    a00, a12, a22, a01, a11, a02 = _many(f2mul, [a0, a1, a2, a0, a1, a0], [a0, a2, a2, a1, a1, a2])
    x12, x22 = _f2xi_many([a12, a22])
    c0, c1, c2 = _many(f2sub, [a00, x22, a11], [x12, a01, a02])
    p0, p1, p2 = _many(f2mul, [a0, a2, a1], [c0, c1, c2])
    t = f2add(p0, f2xi(f2add(p1, p2)))
    tinv = Fq2Ops.inv(t)
    return _many(f2mul, [c0, c1, c2], [tinv, tinv, tinv])


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w]/(w^2 - v): elements are (a0, a1) tuples of Fq6

def f12mul(a, b):
    a0, a1 = a
    b0, b1 = b
    sums = _many(f2add, [*a0, *b0], [*a1, *b1])
    v0, v1, v01 = _f6mul_many([(a0, b0), (a1, b1), (sums[:3], sums[3:])])
    # c0 = v0 + v1 v; c1 = (a0 + a1)(b0 + b1) - v0 - v1
    c = _many(f2add, [*v0, *v0], [*f6mul_by_v(v1), *v1])
    return (c[:3], f6sub(v01, c[3:]))


def f12sq(a):
    return f12mul(a, a)


def f12conj(a):
    return (a[0], f6neg(a[1]))


def f12inv(a):
    a0, a1 = a
    s0, s1 = _f6mul_many([(a0, a0), (a1, a1)])
    tinv = f6inv(f6sub(s0, f6mul_by_v(s1)))
    c0, c1 = _f6mul_many([(a0, tinv), (a1, tinv)])
    return (c0, f6neg(c1))


def f12one(like_fq2):
    one2 = _f2one(like_fq2)
    zero2 = _f2zero(like_fq2)
    return ((one2, zero2, zero2), (zero2, zero2, zero2))


@lru_cache(maxsize=None)
def _frob2_gammas() -> tuple:
    """gamma_{j,i} = xi^((2i + j)(q^2 - 1)/6): Frobenius^2 maps
    c_{j,i} v^i w^j to gamma_{j,i} c_{j,i}.

    Frobenius^2 fixes Fq2 pointwise (x^(q^2) = x), so it is a pure
    coefficient scaling; matches the host's f.frobenius().frobenius()."""
    e6 = (Q * Q - 1) // 6
    return tuple(
        tuple(XI.pow((2 * i + j) * e6) for i in range(3)) for j in range(2)
    )


def f12frobenius2(a):
    gammas = _frob2_gammas()
    like = a[0][0]
    p = _many(f2mul, [a[j][i] for j in range(2) for i in range(3)],
              [f2const(gammas[j][i], like) for j in range(2) for i in range(3)])
    return (p[:3], p[3:])


# ---------------------------------------------------------------------------
# host <-> device Fq12 conversion (tests / verifier boundary)

def encode_fq12(f: HostFq12, device="cuda"):
    """Host Fq12 -> device tuple with batch shape ()."""
    dev = resolve_device(device)
    return tuple(tuple(_enc2(c, dev) for c in (f6.c0, f6.c1, f6.c2)) for f6 in (f.c0, f.c1))


def decode_fq12(d) -> HostFq12:
    def dec2(a):
        c0, c1 = Fq2Ops.decode(a[None])[0]
        return HostFq2(c0, c1)

    def dec6(t):
        return HostFq6(dec2(t[0]), dec2(t[1]), dec2(t[2]))

    return HostFq12(dec6(d[0]), dec6(d[1]))


def _fq12_map(fn, f):
    return tuple(tuple(fn(x) for x in f6) for f6 in f)


# ---------------------------------------------------------------------------
# Miller loop (twisted affine, batched over pairs)

def _line_fq12(A, B, C, like):
    """Sparse line A + B (v w) + C (v^2 w) as a full Fq12 tuple."""
    z = _f2zero(like)
    return ((A, z, z), (z, B, C))


def _slope_lines(px, py, tx, ty, lam):
    """Line through untwisted T, S with slope lambda = lambda' w^-1,
    evaluated at embedded (px, py) in G1:
    p_y - lambda' p_x xi^-1 v^2 w + (lambda' x_T - y_T) xi^-1 v w.

    px, py are Fq elements embedded into Fq2 (c1 = 0). With
    w^-2 = xi^-1 v^2, w^-3 = xi^-1 v w and T = (x_T w^-2, y_T w^-3) this is
    exactly the host's p_y - Y_T - lambda (p_x - X_T)
    (host/bls12_381.py _line)."""
    xi_inv = _XI_INV_CONST(px)
    lt, lp = _many(f2mul, [lam, lam], [tx, px])
    b, c = _many(f2mul, [f2sub(lt, ty), lp], [xi_inv, xi_inv])
    return py, b, f2neg(c)


@lru_cache(maxsize=None)
def _xi_inv_host():
    inv = XI.invert()
    assert inv is not None
    return inv


def _XI_INV_CONST(like):
    return f2const(_xi_inv_host(), like)


def _three(a):
    return f2add(f2add(a, a), a)


_MILLER_BITS = tuple(int(b) for b in bin(BLS_X)[3:])  # skip leading 1


def _miller_step(f, t, px, py, qx, qy, bit: int):
    """One bit of the loop: the doubling and its tangent line; then, where
    the bit is set, the addition of Q and its chord line."""
    tx, ty = t
    # doubling: lambda' = 3x^2 / 2y; T2 = (lambda'^2 - 2x, lambda'(x - x3) - y)
    inv_dbl = Fq2Ops.batch_inv(f2add(ty, ty))
    lam_d = f2mul(_three(f2sq(tx)), inv_dbl)
    x_d = f2sub(f2sq(lam_d), f2add(tx, tx))
    y_d = f2sub(f2mul(lam_d, f2sub(tx, x_d)), ty)
    A, B, C = _slope_lines(px, py, tx, ty, lam_d)
    f = f12mul(f12sq(f), _line_fq12(A, B, C, px))
    if not bit:
        return f, (x_d, y_d)

    # addition of Q to the post-double T
    inv_add = Fq2Ops.batch_inv(f2sub(qx, x_d))
    lam_a = f2mul(f2sub(qy, y_d), inv_add)
    x_a = f2sub(f2sub(f2sq(lam_a), x_d), qx)
    y_a = f2sub(f2mul(lam_a, f2sub(x_d, x_a)), y_d)
    Aa, Ba, Ca = _slope_lines(px, py, x_d, y_d, lam_a)
    f = f12mul(f, _line_fq12(Aa, Ba, Ca, px))
    return f, (x_a, y_a)


def multi_miller_loop_device(px, py, qx, qy, chunk: int | None = None):
    """Batched Miller loop: per-pair f_i, all pairs at once.

    px, py: (n, 2, 24) embedded G1 affine coordinates (Fq in c0, c1 = 0).
    qx, qy: (n, 2, 24) twisted G2 affine coordinates.
    Returns the Fq12 product over pairs, batch shape (1,): identical to the
    host multi_miller_loop on the same (non-identity) pairs.

    ``chunk`` bounds the length of one XLA program in the reference
    (MASP_PAIR_MILLER_CHUNK); the port runs the loop as it goes, so it has
    no effect here and no result depends on it."""
    n = px.shape[0]
    f = f12one(px)
    t = (qx, qy)
    for bit in _MILLER_BITS:
        f, t = _miller_step(f, t, px, py, qx, qy, bit)

    # product over the pair axis, then conjugate (BLS_X is negative)
    acc = _fq12_map(lambda x: x[0:1], f)
    for i in range(1, n):
        acc = f12mul(acc, _fq12_map(lambda x: x[i : i + 1], f))
    return f12conj(acc)


# ---------------------------------------------------------------------------
# final exponentiation

@lru_cache(maxsize=None)
def _hard_exp_bits() -> tuple:
    d = (Q**4 - Q**2 + 1) // R
    return tuple(int(b) for b in bin(d)[2:])


def _easy_part(f):
    """Easy part f^((q^6 - 1)(q^2 + 1)), with the one Fq12 tower inversion."""
    g = f12mul(f12conj(f), f12inv(f))
    return f12mul(f12frobenius2(g), g)


def _hard_chunk(acc, base, bits):
    """Square-and-multiply: acc^(2^len(bits)) * base^e for e the MSB-first
    bits."""
    for bit in bits:
        acc = f12sq(acc)
        if bit:
            acc = f12mul(acc, base)
    return acc


def final_exponentiation_device(f, chunk: int | None = None):
    """f^((q^12 - 1)/r), matching the host final_exponentiation exactly.

    The hard part's exponent starts with a set bit, so the accumulator
    starts at the easy part's value and runs the remaining bits. ``chunk``
    (MASP_PAIR_EXP_CHUNK in the reference) bounds an XLA program there; it
    has no effect here and no result depends on it."""
    f = _easy_part(f)
    bits = _hard_exp_bits()
    return _hard_chunk(f, f, bits[1:])


def _is_one_host(f) -> bool:
    """f == 1, decoded on the host."""
    return decode_fq12(_fq12_map(lambda x: x[0], f)) == HostFq12.one()


# ---------------------------------------------------------------------------
# public entry points (host-typed boundary)

def encode_pairs(pairs, device="cuda"):
    """[(G1, G2)] (non-identity, affine) -> device coordinate tensors."""
    dev = resolve_device(device)
    px = Fq2Ops.encode([(p.x.n, 0) for p, _ in pairs])
    py = Fq2Ops.encode([(p.y.n, 0) for p, _ in pairs])
    qx = Fq2Ops.encode([(q.x.c0, q.x.c1) for _, q in pairs])
    qy = Fq2Ops.encode([(q.y.c0, q.y.c1) for _, q in pairs])
    return tuple(torch.as_tensor(v.astype(np.int32), device=dev) for v in (px, py, qx, qy))


def pairing_product_is_one_device(pairs, device="cuda") -> bool:
    """Device evaluation of prod e(P_i, Q_i) == 1 (the Groth16 check).

    Filters identity pairs on the host (a pair with an identity component
    contributes 1), then runs the Miller loop and the final exponentiation
    on the device. Mirrors host/bls12_381.py pairing_product_is_one."""
    dev = resolve_device(device)
    live = [
        (p, q) for (p, q) in pairs
        if not (p.is_identity() or q.is_identity())
    ]
    if not live:
        return True
    px, py, qx, qy = encode_pairs(live, dev)
    f = multi_miller_loop_device(px, py, qx, qy)
    out = final_exponentiation_device(f)
    return _is_one_host(out)


__all__ = [
    "multi_miller_loop_device", "final_exponentiation_device",
    "pairing_product_is_one_device", "encode_pairs", "encode_fq12",
    "decode_fq12", "f2neg", "f2xi", "f6mul", "f6inv", "f12mul", "f12sq",
    "f12conj", "f12inv", "f12frobenius2",
]
