"""One batch-affine ladder level on G1 or G2: P1 + P2 for a batch of affine
pairs with one batched inversion.

For G1 it replaces the Pallas kernels ``_affine_pre_kernel`` and
``_affine_post_kernel`` of masp_tpu/kernels/field_kernels.py, and
``affine_level`` is the counterpart of their composite
``klay_affine_level``; for G2 it replaces the JAX package's composed level
(masp_tpu/ops/msm_sorted.py ``_affine_level`` over Fq2), which has no Pallas
body. One level is the pre kernel (case masks, slope numerator n, the
denominator d's norm to Fq, case code), the product-tree inversion of every
norm through the Fq Montgomery kernel with the root's Fermat inversion as
one launch of the inversion kernel (kernels/mont_mul.mont_inv), and the post
kernel (d again from the points, d^-1 from the norm's inverse, lam = n / d,
x3, y3, pass-throughs, identity normalisation). On G1 the norm is d itself;
on G2 it is d0^2 + d1^2, and d^-1 = (d0 - d1 u) / (d0^2 + d1^2). The CUDA
kernels are ``csrc/affine.cu``, one template over the coordinate element.

An affine node is a packed row (n, 2K + 1) int32 ``[x | y | f]``: x and y
as K canonical 16-bit Montgomery limbs (K = 24 on G1, 48 on G2 with c0
then c1), f != 0 marking the identity, whose coordinates may hold any
canonical values. Operand rows may be strided views (the last axis
contiguous), so the MSM ladder pairs even and odd rows of one tensor
without copies. Identity results come out as (0, mont-1) with f = 1, so a
projective lift Z = f ? 0 : mont-1 gives (0 : 1 : 0). The case code is bit
0 P1 = identity, bit 1 P2 = identity, bit 2 P1 + P2 = identity with both
finite (P + (-P)), bit 3 doubling.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from masp_tpu_torch.kernels import count_launch
from masp_tpu_torch.kernels import mont_mul as MK
from masp_tpu_torch.kernels.build import library
from masp_tpu_torch.ops import field as F
from masp_tpu_torch.ops.field import FQ

# int32 a row [x | y | f] -> group
_GROUP_OF_ROW = {2 * FQ.L + 1: 1, 4 * FQ.L + 1: 2}


def _coords(rows):
    """(n, 2K+1) rows -> x, y as (n, c, 24) Fq coefficients (c = 1 on G1, 2
    on G2) and the identity mask."""
    n, k = rows.shape[0], (rows.shape[1] - 1) // 2
    return rows[:, :k].reshape(n, -1, FQ.L), rows[:, k : 2 * k].reshape(n, -1, FQ.L), rows[:, 2 * k] != 0


def _mul(a, b):
    """Product of (n, c, 24) elements: Fq, or Fq2 by Karatsuba."""
    if a.shape[1] == 1:
        return MK.mont_mul_plain(FQ, a[:, 0], b[:, 0])[:, None]
    v0 = MK.mont_mul_plain(FQ, a[:, 0], b[:, 0])
    v1 = MK.mont_mul_plain(FQ, a[:, 1], b[:, 1])
    s = MK.mont_mul_plain(FQ, F.add(FQ, a[:, 0], a[:, 1]), F.add(FQ, b[:, 0], b[:, 1]))
    return torch.stack([F.sub(FQ, v0, v1), F.sub(FQ, F.sub(FQ, s, v0), v1)], dim=1)


def _sel(cond, a, b):
    return torch.where(cond[:, None, None], a, b)


def _norm(d):
    """(n, c, 24) -> (n, 24): d on G1, d0^2 + d1^2 on G2."""
    if d.shape[1] == 1:
        return d[:, 0]
    return F.add(FQ, MK.mont_mul_plain(FQ, d[:, 0], d[:, 0]), MK.mont_mul_plain(FQ, d[:, 1], d[:, 1]))


def _inv_from_norm(d, ninv):
    """d^-1 from the inverse of d's norm: ninv on G1, (d0, -d1) ninv on G2."""
    if d.shape[1] == 1:
        return ninv[:, None]
    return torch.stack([MK.mont_mul_plain(FQ, d[:, 0], ninv),
                        F.neg(FQ, MK.mont_mul_plain(FQ, d[:, 1], ninv))], dim=1)


def _one_like(x):
    """The Montgomery 1 of Fq or Fq2 in x's (n, c, 24) shape."""
    one = torch.zeros_like(x)
    one[:, 0] = FQ.const("ONE_MONT", x.device)
    return one


def _slope_den(x1, y1, x2, use_dbl):
    """d = use_dbl ? 2 y1 : x2 - x1."""
    return _sel(use_dbl, F.add(FQ, y1, y1), F.sub(FQ, x2, x1))


def affine_pre_plain(p1, p2):
    """Plain PyTorch version of the pre kernel: n (n, K), d's norm (n, 24),
    code (n,)."""
    x1, y1, i1 = _coords(p1)
    x2, y2, i2 = _coords(p2)
    fin = ~i1 & ~i2
    xeq = (x1 == x2).flatten(1).all(dim=1)
    yneg = (y1 == F.neg(FQ, y2)).flatten(1).all(dim=1)
    res_inf = fin & xeq & yneg
    use_dbl = fin & xeq & ~yneg
    live = fin & ~res_inf
    sq1 = _mul(x1, x1)
    n = _sel(use_dbl, F.add(FQ, F.add(FQ, sq1, sq1), sq1), F.sub(FQ, y2, y1))
    d = _sel(live, _slope_den(x1, y1, x2, use_dbl), _one_like(x1))
    code = (i1.to(torch.int32) | (i2.to(torch.int32) << 1) | (res_inf.to(torch.int32) << 2)
            | (use_dbl.to(torch.int32) << 3))
    return n.reshape(n.shape[0], -1), _norm(d), code


def affine_post_plain(n, ninv, p1, p2, code):
    """Plain PyTorch version of the post kernel: (n, 2K+1) result rows from
    the pre kernel's n and code and the inverse of d's norm."""
    x1, y1, _ = _coords(p1)
    x2, y2, _ = _coords(p2)
    i1, i2, res_inf, use_dbl = (((code >> b) & 1) != 0 for b in range(4))
    dinv = _inv_from_norm(_slope_den(x1, y1, x2, use_dbl), ninv)
    lam = _mul(n.reshape(x1.shape), dinv)
    x3 = F.sub(FQ, F.sub(FQ, _mul(lam, lam), x1), x2)
    y3 = F.sub(FQ, _mul(lam, F.sub(FQ, x1, x3)), y1)
    xo = _sel(i1, x2, _sel(i2, x1, x3))
    yo = _sel(i1, y2, _sel(i2, y1, y3))
    fo = (i1 & i2) | res_inf
    xo = _sel(fo, torch.zeros_like(xo), xo)
    yo = _sel(fo, _one_like(yo), yo)
    m = xo.shape[0]
    return torch.cat([xo.reshape(m, -1), yo.reshape(m, -1), fo.to(torch.int32)[:, None]], dim=1)


def _level(pre, mul, root_inv, post, p1, p2):
    n, norm, code = pre(p1, p2)
    ninv = F.tree_batch_inv(FQ, norm, mul, root_inv)
    return post(n, ninv, p1, p2, code)


def _plain_mul(a, b):
    return MK.mont_mul_plain(FQ, a, b)


def _plain_inv(r):
    return MK.mont_inv_plain(FQ, r)


def affine_level_plain(p1, p2):
    """Plain version of ``affine_level``: the same steps over the plain
    pre/post versions, the plain Montgomery product and the plain
    inversion."""
    return _level(affine_pre_plain, _plain_mul, _plain_inv, affine_post_plain, p1, p2)


# --- the CUDA kernels' wrappers --------------------------------------------------

@functools.cache
def _c_fn(name: str):
    """masp_affine_pre(group, p1, s1, p2, s2, n, norm, code, lanes, stream)
    or masp_affine_post(group, n, ninv, p1, s1, p2, s2, code, out, lanes,
    stream)."""
    fn = getattr(library("affine"), f"masp_affine_{name}")
    ptrs_before, ptrs_after = (0, 3) if name == "pre" else (2, 2)
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * ptrs_before
                   + [ctypes.c_void_p, ctypes.c_longlong] * 2
                   + [ctypes.c_void_p] * ptrs_after + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(name, p1, p2, *rest):
    """The group of the two row operands (G1 rows (n, 49) or G2 rows (n,
    97)), their shapes and types and those of the (n, ...) others, given as
    (tensor, shape for G1, shape for G2); and whether the plain version runs
    (CPU tensors)."""
    group = _GROUP_OF_ROW.get(p1.shape[1]) if p1.dim() == 2 else None
    for t in (p1, p2):
        if group is None or t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != p1.shape[1]:
            raise ValueError(f"{name} takes two G1 rows (n, 49) or G2 rows (n, 97) of int32, got "
                             f"{p1.dtype} {tuple(p1.shape)}, {t.dtype} {tuple(t.shape)}")
    n = p1.shape[0]
    for t, *shapes in rest:
        shape = (n,) + shapes[group - 1]
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} takes {shape} int32, got {t.dtype} {tuple(t.shape)}")
    tensors = [p1, p2] + [t for t, *_ in rest]
    if p2.shape[0] != n or any(t.device != p1.device for t in tensors):
        raise ValueError(f"{name} operands differ in length or device")
    if p1.device.type == "cpu":
        return group, True
    if p1.device.type != "cuda":
        raise ValueError(f"unsupported device {p1.device}")
    if p1.stride(1) != 1 or p2.stride(1) != 1:
        raise ValueError(f"{name} rows must be contiguous along the limb axis")
    if not all(t.is_contiguous() for t, *_ in rest):
        raise ValueError(f"{name} takes contiguous n, norm inverse and code tensors")
    return group, False


def _launch(name, group, p1, p2, before, after):
    """Launch with the C argument order: the group, ``before`` pointers, the
    two row operands with their row strides, ``after`` pointers, the lane
    count."""
    with torch.cuda.device(p1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _c_fn(name)(group, *(t.data_ptr() for t in before), p1.data_ptr(), p1.stride(0),
                          p2.data_ptr(), p2.stride(0), *(t.data_ptr() for t in after),
                          p1.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"affine_{name} kernel launch failed for G{group}: CUDA error {err}")
    count_launch(f"affine_{name}" if group == 1 else f"affine_{name}_g2")


def affine_pre(p1, p2):
    """(n, norm, code) of one affine level from two batches of G1 (n, 49) or
    G2 (n, 97) rows: n (n, K), d's norm (n, 24), code (n,). A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel or raises."""
    group, plain = _check("affine_pre", p1, p2)
    if plain:
        return affine_pre_plain(p1, p2)
    n = p1.shape[0]
    outs = (torch.empty((n, group * FQ.L), dtype=torch.int32, device=p1.device),
            torch.empty((n, FQ.L), dtype=torch.int32, device=p1.device),
            torch.empty((n,), dtype=torch.int32, device=p1.device))
    if n:
        _launch("pre", group, p1, p2, (), outs)
    return outs


def affine_post(n_, ninv, p1, p2, code):
    """(n, 2K+1) result rows from the pre kernel's n and code and the
    inverse of d's norm. A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel or raises."""
    group, plain = _check("affine_post", p1, p2, (n_, (FQ.L,), (2 * FQ.L,)),
                          (ninv, (FQ.L,), (FQ.L,)), (code, (), ()))
    if plain:
        return affine_post_plain(n_, ninv, p1, p2, code)
    out = torch.empty(p1.shape, dtype=torch.int32, device=p1.device)
    if p1.shape[0]:
        _launch("post", group, p1, p2, (n_, ninv), (code, out))
    return out


def _kernel_mul(a, b):
    return F.mont_mul(FQ, a, b)


def _kernel_inv(r):
    return F.mont_inv_small(FQ, r)


def affine_level(p1, p2):
    """P1 + P2 on two batches of G1 (n, 49) or G2 (n, 97) affine rows, n a
    power of two: the pre kernel, the product-tree inversion of the norms
    through the Fq Montgomery kernel (log2 n launches up, 2 log2 n down)
    with one inversion kernel launch on the root, the post kernel. On CPU
    tensors every step runs its plain version."""
    return _level(affine_pre, _kernel_mul, _kernel_inv, affine_post, p1, p2)


__all__ = ["affine_pre", "affine_post", "affine_level", "affine_pre_plain",
           "affine_post_plain", "affine_level_plain"]
