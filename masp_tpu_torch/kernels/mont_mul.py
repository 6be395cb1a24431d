"""Montgomery multiplication a*b*R^-1 mod N for Fr (L=16) and Fq (L=24),
and the Fermat inversion a^(N-2) of either field in one launch.

Replaces the Pallas kernel ``_mont_mul_kernel`` of
masp_tpu/kernels/field_kernels.py (called through ``pallas_mont_mul``), and
the chain of its launches that masp_tpu/ops/field_jax.py ``mont_inv_small``
runs. The CUDA kernels are ``csrc/mont_mul.cu`` (CIOS over 32-bit words);
``mont_mul_plain`` below is the product's plain PyTorch version over
int64-held 16-bit limbs, ``mont_inv_plain`` the inversion's (the 4-bit
fixed-window chain over ``mont_mul_plain``). The product's kernel and plain
version both return the fully reduced product (< N), so their limbs equal the
JAX package's exactly whenever one operand is < N (always the case in the
prover): the product before the final subtraction is the unique
(ab + mN)/R with m = -ab/N mod R, whatever the limb width or the order in
which m's digits are found. The product reads each operand where it lies,
through a two-level row map (``row_map``), so the NTT's strided halves and
broadcast tables reach the kernel without a copy.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from masp_tpu_torch import device_const as _const
from masp_tpu_torch.kernels import count_launch
from masp_tpu_torch.kernels.build import library
from masp_tpu_torch.ops.limbs import exact_matmul, ints_to_limbs, limbs_to_ints, normalize, reduce_once


def _spread(L: int, device) -> torch.Tensor:
    """(L*L, 2L) 0/1 float64: product (i, j) -> column i + j."""
    S = torch.zeros(L * L, 2 * L, dtype=torch.float64, device=device)
    ij = torch.arange(L * L, device=device)
    S[ij, ij // L + ij % L] = 1.0
    return S


def _toeplitz(limbs, width: int, device) -> torch.Tensor:
    """(L, width) float64 with row i holding the constant's limbs from
    column i: x @ it is the schoolbook product of x by the constant."""
    L = len(limbs)
    T = torch.zeros(L, width, dtype=torch.float64, device=device)
    c = torch.as_tensor(limbs.astype("float64"), device=device)
    for i in range(min(L, width)):
        k = min(L, width - i)
        T[i, i : i + k] = c[:k]
    return T


# rows up to which the plain product runs on Python ints (``_redc_ints``):
# below a few hundred rows the limb route's fixed tensor operations cost
# more than the rows' integer arithmetic on the CPU
INT_ROWS = 256


def _redc_ints(spec, a, b):
    """The same whole-number REDC on Python ints, row by row, for a few
    rows (the width-1 Fermat chains, the Horner tails, the bucket chains):
    there the limb version's tensor operations cost more than the
    arithmetic.
    U = (ab + mN) / R < R + N, and one conditional subtraction, as
    reduce_once does: the same limbs for every input below R."""
    R, N = spec.R, spec.modulus
    out = []
    for x, y in zip(limbs_to_ints(a.cpu().numpy()), limbs_to_ints(b.cpu().numpy())):
        t = x * y
        u = (t + (t * spec.n_prime % R) * N) >> spec.bits
        out.append(u - N if u >= N else u)
    return torch.as_tensor(ints_to_limbs(out, spec.L).astype(np.int32), device=a.device)


def mont_mul_plain(spec, a, b):
    """Plain PyTorch Montgomery product; a, b (n, L) int limbs, returns
    (n, L) int32. Used on CPU tensors, and on the card as the kernel's
    reference.

    The reduction is whole-number REDC over 16-bit limbs: m = T (-N^-1) mod
    R in one product, then (T + m N) / R. That m is the unique one that the
    word-serial CIOS loops of the kernel and of the JAX package build digit
    by digit, so the limbs agree. The limb products sum into columns as
    exact float64 matrix products (each column < L 2^32 < 2^53), which keeps
    the plain version to a few dozen tensor operations: it runs in every CPU
    test. Up to INT_ROWS rows run it on Python ints (``_redc_ints``)."""
    L = spec.L
    dev = a.device
    n = a.shape[0]
    if n <= INT_ROWS:
        return _redc_ints(spec, a, b)
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    # T = a * b as 2L canonical limbs
    spread = _const(("S", L, dev), lambda: _spread(L, dev))
    t_np = _const(("Np", spec.name, dev), lambda: _toeplitz(spec.N_PRIME, L, dev))
    t_n = _const(("N", spec.name, dev), lambda: _toeplitz(spec.N, 2 * L, dev))
    T, _ = normalize(exact_matmul((a[:, :, None] * b[:, None, :]).reshape(n, L * L), spread))
    # m = T * (-N^-1) mod R: the low L columns of the product
    m, _ = normalize(exact_matmul(T[:, :L], t_np))
    # (T + m N) / R: the low L limbs cancel; the high L limbs and the carry
    # are the product before the final subtraction
    U, carry = normalize(exact_matmul(m, t_n) + T)
    return reduce_once(spec.const("N", dev), U[:, L:], carry).to(torch.int32)


def fermat_chain(spec, a, mul):
    """a^(N-2) in Montgomery form by 4-bit fixed windows over ``mul(x, y)``:
    the table a^0 .. a^15 (14 products), then per lower nibble of N - 2 four
    squarings and one table product (489 products for Fq). Bit-identical to
    the bit-serial chain: the inverse is unique and every product is fully
    reduced; 0 maps to 0."""
    table = [spec.const("ONE_MONT", a.device).expand(a.shape).clone(), a]
    for _ in range(2, 16):
        table.append(mul(table[-1], a))
    nibs = spec.inv_exp_nibbles
    acc = table[nibs[0]]
    for nib in nibs[1:]:
        for _ in range(4):
            acc = mul(acc, acc)
        acc = mul(acc, table[nib])
    return acc


def mont_inv_plain(spec, a):
    """Plain PyTorch version of the inversion kernel on (n, L) int limb rows:
    the Fermat chain over the plain product. Returns (n, L) int32."""
    return fermat_chain(spec, a.to(torch.int32), lambda x, y: mont_mul_plain(spec, x, y))


# --- the CUDA kernels' wrappers ---------------------------------------------

def row_map(t):
    """(inner, s_outer, s_inner) in int32 elements: row i of the (..., L)
    view ``t``, its leading dimensions flattened, starts (i // inner) *
    s_outer + (i % inner) * s_inner elements after ``t``'s first limb; None
    when the leading dimensions need more than two levels. Size-1
    dimensions are skipped and dimensions whose strides chain are merged,
    so a contiguous or evenly strided view has one level and an NTT
    stage's odd half (or a table broadcast over the transforms) two."""
    dims = []
    for size, stride in zip(t.shape[:-1], t.stride()[:-1]):
        if size == 1:
            continue
        if dims and dims[-1][1] == size * stride:
            dims[-1] = (dims[-1][0] * size, stride)
        else:
            dims.append((size, stride))
    if len(dims) > 2:
        return None
    if len(dims) == 2:
        return dims[1][0], dims[0][1], dims[1][1]
    return (dims[0][0], 0, dims[0][1]) if dims else (1, 0, 0)


def mapped_rows(t, rmap):
    """The (n, L) rows of the view ``t`` read through its row map, as the
    kernel reads them (the plain route's operands)."""
    inner, s_outer, s_inner = rmap
    L = t.shape[-1]
    n = t.numel() // L
    return torch.as_strided(t, (n // inner, inner, L), (s_outer, s_inner, 1), t.storage_offset()).reshape(n, L)


def _mapped(t):
    """(t, its row map): a view whose limb axis is not contiguous, or whose
    rows need more than two levels, is copied first."""
    rmap = row_map(t) if t.stride(-1) == 1 else None
    if rmap is None:
        t = t.contiguous()
        rmap = row_map(t)
    return t, rmap


@functools.cache
def _c_fn(name: str):
    fn = getattr(library("mont_mul"), {"Fr": "masp_mont_mul_fr", "Fq": "masp_mont_mul_fq"}[name])
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3) * 2 + [ctypes.c_void_p, ctypes.c_longlong,
                                                                        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mont_mul(spec, a, b):
    """a*b*R^-1 mod N on (..., L) int32 limb tensors of one shape and
    device; returns a new contiguous tensor of that shape. Each operand is
    read where it lies through its row map (``row_map``: strided and
    broadcast views are not copied). A CPU tensor runs the plain version on
    the mapped rows; a CUDA tensor launches the kernel or raises."""
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("mont_mul takes int32 limb tensors")
    if a.dim() < 1 or a.shape[-1] != spec.L or a.shape != b.shape:
        raise ValueError(f"mont_mul takes two (..., {spec.L}) tensors of one shape, "
                         f"got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError("mont_mul operands on different devices")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")
    n = a.numel() // spec.L
    if n == 0:
        return torch.empty(a.shape, dtype=torch.int32, device=a.device)
    (a, ma), (b, mb) = _mapped(a), _mapped(b)
    if a.device.type == "cpu":
        return mont_mul_plain(spec, mapped_rows(a, ma), mapped_rows(b, mb)).reshape(a.shape)
    if n >= 1 << 31:
        raise ValueError(f"mont_mul takes fewer than 2^31 rows, got {n}")
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _c_fn(spec.name)(a.data_ptr(), *ma, b.data_ptr(), *mb, out.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"mont_mul kernel launch failed: CUDA error {err}")
    count_launch("mont_mul_" + spec.name.lower())
    return out


@functools.cache
def _c_inv(name: str):
    fn = getattr(library("mont_mul"), {"Fr": "masp_mont_inv_fr", "Fq": "masp_mont_inv_fq"}[name])
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mont_inv(spec, a):
    """a^(N-2) (the inverse, 0 for 0) on (n, L) int32 Montgomery rows of
    canonical values, Fr or Fq. A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel (one thread per row walks the whole chain) or
    raises."""
    if a.dtype != torch.int32 or a.dim() != 2 or a.shape[1] != spec.L:
        raise ValueError(f"mont_inv takes (n, {spec.L}) int32 rows, got {a.dtype} {tuple(a.shape)}")
    if a.device.type == "cpu":
        return mont_inv_plain(spec, a)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if not a.is_contiguous():
        raise ValueError("mont_inv takes a contiguous tensor")
    out = torch.empty_like(a)
    if a.shape[0] == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _c_inv(spec.name)(a.data_ptr(), out.data_ptr(), a.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"mont_inv kernel launch failed: CUDA error {err}")
    count_launch("mont_inv_" + spec.name.lower())
    return out


__all__ = ["mont_mul", "mont_mul_plain", "row_map", "mapped_rows", "mont_inv", "mont_inv_plain", "fermat_chain"]
