"""Complete projective addition on G1 / G2 (RCB'15 Algorithm 7, a = 0).

Replaces the Pallas kernels ``_g1_add_kernel``, ``_g2_add_kernel``,
``_g1_add01_kernel`` and ``_g2_add01_kernel`` of
masp_tpu/kernels/field_kernels.py (all behind ``_g_add_callable``). The CUDA
kernel is ``group_add_kernel<E, LEAF>`` in ``csrc/point_add.cu``, one
template over the coordinate field and the form: each pair gets a group of
six threads that follow the schedule ``ADD_L1`` ... ``ADD_OUT``; the leaf
form (Z in {0, mont-1}, 9 products instead of 12) computes three products of
layer 1 as selects and its linear step from ``LEAF_LIN``.

Points are packed rows (n, 3K) int32 of 16-bit limbs, [X | Y | Z], with
K = 24 on G1 and K = 48 on G2 (Fq2 coordinates as c0 limbs then c1 limbs);
the rows' last axis is contiguous, their row stride is free, so the MSM
ladder passes even/odd views of one tensor without copies.

The plain PyTorch version runs the formulas of ops/projective.py over the
plain Montgomery product.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from masp_tpu_torch.kernels import count_launch
from masp_tpu_torch.kernels import mont_mul as MK
from masp_tpu_torch.kernels.build import library
from masp_tpu_torch.ops.field import FQ
from masp_tpu_torch.ops.projective import K_OF, Fq2Arith, FqArith, pack_rows, rcb_add, rcb_add01, unpack_rows


def _plain_fq_mul(a, b):
    return MK.mont_mul_plain(FQ, a, b)


class _PlainFq(FqArith):
    fq_mul = staticmethod(_plain_fq_mul)


class _PlainFq2(Fq2Arith):
    fq_mul = staticmethod(_plain_fq_mul)


# The adds' schedule on either group (csrc/point_add.cu, group_add_kernel,
# which holds the same tables). Its twelve products (Fq on
# G1, Fq2 on G2) run in two layers of six; thread j of a pair's group of six
# computes product, operand or output j of every step (an Fq2 product as
# three Fq products, Karatsuba).
# Layer 1: P_j = (A_u + A_v)(B_u + B_v), (u, v) = ADD_L1[j] over the operands'
# coordinates X 0, Y 1, Z 2, and 3 for zero.
ADD_L1 = ((0, 3), (1, 3), (2, 3), (0, 1), (1, 2), (0, 2))
# Linear step: O_j = P_d + s * beta(P_a - P_b - P_c), (d, s, beta, a, b, c) =
# ADD_LIN[j], index 6 for zero, beta = b3 (12 on G1, 12(1 + u) on G2) when
# set: O = (t0, t1, Z3, t3, t4, Y3) of RCB'15 Algorithm 7 before its second
# round of products.
ADD_LIN = (
    (0, -1, 0, 6, 0, 0),  # t0 = 3 P0
    (1, -1, 1, 2, 6, 6),  # t1 = P1 - b3 P2
    (1, 1, 1, 2, 6, 6),   # Z3 = P1 + b3 P2
    (6, 1, 0, 3, 0, 1),   # t3 = P3 - P0 - P1
    (6, 1, 0, 4, 1, 2),   # t4 = P4 - P1 - P2
    (6, 1, 1, 5, 0, 2),   # Y3 = b3 (P5 - P0 - P2)
)
# The leaf form (Z in {0, mont-1}): threads 2, 4 and 5 write selects in place
# of their layer-1 products: P2 = Z1 Z2 (mont-1 when both operands are live,
# else 0), P4 and P5 = A_u Z2 + Z1 B_u (u = ADD_L1[j][0]: Y, then X), the
# cross terms themselves; its linear step takes those two as they are.
LEAF_LIN = ADD_LIN[:4] + (
    (4, 1, 0, 6, 6, 6),   # t4 = P4
    (6, 1, 1, 5, 6, 6),   # Y3 = b3 P5
)
# Layer 2: Q_j = O_a O_b, (a, b) = ADD_L2[j].
ADD_L2 = ((4, 5), (3, 1), (5, 0), (1, 2), (0, 3), (2, 4))
# Output coordinate i (X3, Y3, Z3) = Q_a + s Q_b, (a, b, s) = ADD_OUT[i]: output
# j = i of the step on G1; on G2 its coefficient c is output j = 2 i + c.
ADD_OUT = ((1, 0, -1), (3, 2, 1), (5, 4, 1))


def point_add_plain(group: int, p, q, leaf01: bool = False):
    """Plain PyTorch version of the kernel on (n, 3K) rows: the formulas of
    ops/projective.py over the plain Montgomery product."""
    fops = _PlainFq if group == 1 else _PlainFq2
    formula = rcb_add01 if leaf01 else rcb_add
    out = formula(fops, unpack_rows(group, p), unpack_rows(group, q))
    return pack_rows(out).to(torch.int32)


# --- the CUDA kernel's wrapper ----------------------------------------------------

@functools.cache
def _c_fn():
    fn = library("point_add").masp_point_add
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def point_add(group: int, p, q, leaf01: bool = False):
    """Sum of two batches of projective points as (n, 3K) int32 rows. A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel or
    raises. ``leaf01``: every Z is 0 or the Montgomery 1."""
    if group not in K_OF:
        raise ValueError(f"group must be 1 or 2, got {group}")
    K = K_OF[group]
    for t in (p, q):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != 3 * K:
            raise ValueError(f"point_add takes (n, {3 * K}) int32 rows, got {t.dtype} {tuple(t.shape)}")
    if p.shape != q.shape or p.device != q.device:
        raise ValueError("point_add operands differ in shape or device")
    if p.device.type == "cpu":
        return point_add_plain(group, p, q, leaf01)
    if p.device.type != "cuda":
        raise ValueError(f"unsupported device {p.device}")
    if p.stride(1) != 1 or q.stride(1) != 1:
        raise ValueError("point_add rows must be contiguous along the limb axis")
    n = p.shape[0]
    out = torch.empty((n, 3 * K), dtype=torch.int32, device=p.device)
    if n == 0:
        return out
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _c_fn()(group, int(leaf01), p.data_ptr(), p.stride(0), q.data_ptr(),
                      q.stride(0), out.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"point_add kernel launch failed: CUDA error {err}")
    count_launch(f"g{group}_add01" if leaf01 else f"g{group}_add")
    return out


__all__ = ["point_add", "point_add_plain", "ADD_L1", "ADD_LIN", "LEAF_LIN", "ADD_L2", "ADD_OUT"]
