"""One batch-affine ladder level on G1: P1 + P2 for a batch of affine pairs
with one batched inversion.

Replaces the Pallas kernels ``_affine_pre_kernel`` and
``_affine_post_kernel`` of masp_tpu/kernels/field_kernels.py, and
``affine_level`` is the counterpart of their composite
``klay_affine_level``: the pre kernel (case masks, slope numerator n and
denominator d, case code), the product-tree inversion of every d through
the Fq Montgomery kernel with the root's Fermat inversion as one launch of
the inversion kernel (kernels/mont_mul.mont_inv), and the
post kernel (lam = n / d, x3, y3, pass-throughs, identity normalisation).
The CUDA kernels are ``csrc/affine.cu``.

An affine node is a packed row (n, 49) int32 ``[x | y | f]``: x and y as 24
canonical 16-bit Montgomery limbs, f != 0 marking the identity, whose
coordinates may hold any canonical values. Operand rows may be strided
views (the last axis contiguous), so the MSM ladder pairs even and odd rows
of one tensor without copies. Identity results come out as (0, mont-1)
with f = 1, so a projective lift Z = f ? 0 : mont-1 gives (0 : 1 : 0).
The case code is bit 0 P1 = identity, bit 1 P2 = identity, bit 2
P1 + P2 = identity with both finite (P + (-P)).
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

K = FQ.L
ROW = 2 * K + 1


def _coords(rows):
    return rows[:, :K], rows[:, K : 2 * K], rows[:, 2 * K] != 0


def _plain_mul(a, b):
    return MK.mont_mul_plain(FQ, a, b)


def affine_pre_plain(p1, p2):
    """Plain PyTorch version of the pre kernel: (n, 24) n and d, (n,) code."""
    x1, y1, i1 = _coords(p1)
    x2, y2, i2 = _coords(p2)
    fin = ~i1 & ~i2
    xeq = (x1 == x2).all(dim=-1)
    yneg = (y1 == F.neg(FQ, y2)).all(dim=-1)
    res_inf = fin & xeq & yneg
    use_dbl = fin & xeq & ~yneg
    live = fin & ~res_inf
    sq1 = _plain_mul(x1, x1)
    n = F.select(use_dbl, F.add(FQ, F.add(FQ, sq1, sq1), sq1), F.sub(FQ, y2, y1))
    d = F.select(use_dbl, F.add(FQ, y1, y1), F.sub(FQ, x2, x1))
    d = F.select(live, d, F.one_like(FQ, d))
    code = i1.to(torch.int32) | (i2.to(torch.int32) << 1) | (res_inf.to(torch.int32) << 2)
    return n, d, code


def affine_post_plain(n, inv, p1, p2, code):
    """Plain PyTorch version of the post kernel: (n, 49) result rows."""
    x1, y1, _ = _coords(p1)
    x2, y2, _ = _coords(p2)
    i1, i2, res_inf = (code & 1) != 0, (code & 2) != 0, (code & 4) != 0
    lam = _plain_mul(n, inv)
    x3 = F.sub(FQ, F.sub(FQ, _plain_mul(lam, lam), x1), x2)
    y3 = F.sub(FQ, _plain_mul(lam, F.sub(FQ, x1, x3)), y1)
    xo = F.select(i1, x2, F.select(i2, x1, x3))
    yo = F.select(i1, y2, F.select(i2, y1, y3))
    fo = (i1 & i2) | res_inf
    xo = F.select(fo, torch.zeros_like(xo), xo)
    yo = F.select(fo, F.one_like(FQ, yo), yo)
    return torch.cat([xo, yo, fo.to(torch.int32)[:, None]], dim=1)


def _level(pre, mul, root_inv, post, p1, p2):
    n, d, code = pre(p1, p2)
    inv = F.tree_batch_inv(FQ, d, mul, root_inv)
    return post(n, inv, p1, p2, code)


def _plain_inv(r):
    return MK.mont_inv_plain(FQ, r)


def affine_level_plain(p1, p2):
    """Plain version of ``affine_level``: the same steps over the plain
    pre/post versions, the plain Montgomery product and the Fermat chain
    over it."""
    return _level(affine_pre_plain, _plain_mul, _plain_inv, affine_post_plain, p1, p2)


# --- the CUDA kernels' wrappers --------------------------------------------------

@functools.cache
def _c_fn(name: str):
    """masp_affine_pre(p1, s1, p2, s2, n, d, code, lanes, stream) or
    masp_affine_post(n, inv, p1, s1, p2, s2, code, out, lanes, stream)."""
    fn = getattr(library("affine"), f"masp_affine_{name}")
    ptrs_before, ptrs_after = (0, 3) if name == "pre" else (2, 2)
    fn.argtypes = ([ctypes.c_void_p] * ptrs_before + [ctypes.c_void_p, ctypes.c_longlong] * 2
                   + [ctypes.c_void_p] * ptrs_after + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(name, p1, p2, *rest):
    """Shapes and types of the two row operands and of the (n, ...) others;
    True when the plain version runs (CPU tensors)."""
    for t in (p1, p2):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != ROW:
            raise ValueError(f"{name} takes (n, {ROW}) int32 rows, got {t.dtype} {tuple(t.shape)}")
    n = p1.shape[0]
    for t, shape in rest:
        if t.dtype != torch.int32 or tuple(t.shape) != (n,) + shape:
            raise ValueError(f"{name} takes {(n,) + shape} int32, got {t.dtype} {tuple(t.shape)}")
    tensors = [p1, p2] + [t for t, _ in rest]
    if p2.shape[0] != n or any(t.device != p1.device for t in tensors):
        raise ValueError(f"{name} operands differ in length or device")
    if p1.device.type == "cpu":
        return True
    if p1.device.type != "cuda":
        raise ValueError(f"unsupported device {p1.device}")
    if p1.stride(1) != 1 or p2.stride(1) != 1:
        raise ValueError(f"{name} rows must be contiguous along the limb axis")
    if not all(t.is_contiguous() for t, _ in rest):
        raise ValueError(f"{name} takes contiguous n, d, inverse and code tensors")
    return False


def _launch(name, p1, p2, before, after):
    """Launch with the C argument order: ``before`` pointers, the two row
    operands with their row strides, ``after`` pointers, the lane count."""
    with torch.cuda.device(p1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _c_fn(name)(*(t.data_ptr() for t in before), p1.data_ptr(), p1.stride(0),
                          p2.data_ptr(), p2.stride(0), *(t.data_ptr() for t in after),
                          p1.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"affine_{name} kernel launch failed: CUDA error {err}")
    count_launch(f"affine_{name}")


def affine_pre(p1, p2):
    """(n, d, code) of one affine level from two batches of (n, 49) rows. A
    CPU tensor runs the plain version; a CUDA tensor launches the kernel or
    raises."""
    if _check("affine_pre", p1, p2):
        return affine_pre_plain(p1, p2)
    n = p1.shape[0]
    outs = (torch.empty((n, K), dtype=torch.int32, device=p1.device),
            torch.empty((n, K), dtype=torch.int32, device=p1.device),
            torch.empty((n,), dtype=torch.int32, device=p1.device))
    if n:
        _launch("pre", p1, p2, (), outs)
    return outs


def affine_post(n_, inv, p1, p2, code):
    """(n, 49) result rows from the pre kernel's n and code and d's inverse.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
    raises."""
    if _check("affine_post", p1, p2, (n_, (K,)), (inv, (K,)), (code, ())):
        return affine_post_plain(n_, inv, p1, p2, code)
    out = torch.empty((p1.shape[0], ROW), dtype=torch.int32, device=p1.device)
    if p1.shape[0]:
        _launch("post", p1, p2, (n_, inv), (code, out))
    return out


def _kernel_mul(a, b):
    return F.mont_mul(FQ, a, b)


def _kernel_inv(r):
    return F.mont_inv_small(FQ, r)


def affine_level(p1, p2):
    """P1 + P2 on two batches of (n, 49) affine rows, n a power of two: the
    pre kernel, the product-tree inversion through the Fq Montgomery kernel
    (log2 n launches up, 2 log2 n down) with one inversion kernel launch on
    the root, the post kernel. On CPU tensors every step runs its plain
    version."""
    return _level(affine_pre, _kernel_mul, _kernel_inv, affine_post, p1, p2)


__all__ = ["affine_pre", "affine_post", "affine_level", "affine_pre_plain",
           "affine_post_plain", "affine_level_plain"]
