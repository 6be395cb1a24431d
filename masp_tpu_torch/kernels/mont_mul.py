"""Montgomery multiplication a*b*R^-1 mod N for Fr (L=16) and Fq (L=24),
and the inversion of either field in one launch.

Replaces the Pallas kernel ``_mont_mul_kernel`` of
masp_tpu/kernels/field_kernels.py (called through ``pallas_mont_mul``), and
the chain of its launches that masp_tpu/ops/field_jax.py ``mont_inv_small``
runs. The CUDA kernels are ``csrc/mont_mul.cu`` (CIOS over 32-bit words; the
inversion a constant-time divstep GCD); ``mont_mul_plain`` below is the
product's plain PyTorch version over int64-held 16-bit limbs,
``mont_inv_plain`` the inversion's (the same divsteps over signed 30-bit
limbs in int64 tensors, on Python ints for a few rows), and ``fermat_chain`` the JAX package's 4-bit
fixed-window chain, the inversion's independent yardstick. The product's
kernel and plain version both return the fully reduced product (< N), so
their limbs equal the JAX package's exactly whenever one operand is < N
(always the case in the prover): the product before the final subtraction is the unique
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


# --- the divstep inversion (Bernstein and Yang, 2019) -----------------------

M30 = (1 << 30) - 1
DIVSTEPS = 30  # divsteps a batch: the transition matrix's entries fit in int32


class DivstepConstants:
    """The inversion's constants for one field, the values csrc/mont_mul.cu
    holds: N in ``limbs`` signed 30-bit limbs (room for |f|, |g| <= N and
    d, e in (-2N, N) with a sign), N^-1 mod 2^30, R^3 mod N (one Montgomery
    product by it turns x^-1 into the Montgomery form of the inverse of
    a = x R^-1) and the batch count. ``steps`` is the proven bound
    floor((49 b + 80) / 17) on the divsteps from delta = 1 that bring g to
    0 for f = N < 2^b and 0 <= g < 2^b (Bernstein and Yang, "Fast
    constant-time gcd computation and modular inversion", 2019, Theorem
    11.2, for f^2 + 4 g^2 <= 5 2^(2b)); the batches run at least that many."""

    def __init__(self, spec):
        n = spec.modulus
        b = n.bit_length()
        self.limbs = -(-(b + 2) // 30)
        self.n30 = [(n >> (30 * k)) & M30 for k in range(self.limbs)]
        self.ninv30 = pow(n, -1, 1 << 30)
        self.r3 = pow(spec.R, 3, n)
        self.steps = (49 * b + 80) // 17
        self.batches = -(-self.steps // DIVSTEPS)


@functools.cache
def divstep_constants(spec) -> DivstepConstants:
    return DivstepConstants(spec)


def _divsteps(eta, f0, g0):
    """DIVSTEPS branch-free divsteps of every row, from eta = -delta and
    the low 30-bit limbs f0, g0 ((n,) int64): (eta, the (n, 2, 2)
    transition matrix [[u, v], [q, r]] scaled by 2^30). csrc/mont_mul.cu's
    divsteps_30 step for step: the swap where delta > 0 and g is odd
    (f, g) <- (g, (g - f) / 2), else g <- (g + (g mod 2) f) / 2; only the
    low bits of f and g decide, so the exact int64 values here give the
    kernel's choices and its matrix."""
    one, zero = torch.ones_like(f0), torch.zeros_like(f0)
    fuv = torch.stack([f0, one, zero], dim=1)  # f and its row of the matrix
    gqr = torch.stack([g0, zero, one], dim=1)
    g_shift = torch.tensor([1, 0, 0], dtype=torch.int64, device=f0.device)
    u_shift = 1 - g_shift
    for _ in range(DIVSTEPS):
        c1 = (eta >> 63)[:, None]  # -1 where eta < 0, i.e. delta > 0
        c2 = -(gqr[:, :1] & 1)  # -1 where g is odd
        gqr = gqr + (((fuv ^ c1) - c1) & c2)  # g += f or -f where g is odd
        c1 = c1 & c2  # the swap
        eta = (eta ^ c1[:, 0]) - (c1[:, 0] + 1)
        fuv = fuv + (gqr & c1)  # f <- the old g where swapped
        gqr = gqr >> g_shift  # g / 2; the matrix is scaled by 2^30 instead
        fuv = fuv << u_shift
    return eta, torch.stack([fuv[:, 1:], gqr[:, 1:]], dim=1)


def _shift30(c):
    """(..., K) int64 limb sums whose value is a multiple of 2^30 -> the
    value / 2^30 as K limbs, limbs 0 .. K-2 in [0, 2^30) and the top one
    signed: the kernel's carry chain."""
    out = torch.empty_like(c)
    carry = c[..., 0] >> 30
    for k in range(1, c.shape[-1]):
        carry = carry + c[..., k]
        out[..., k - 1] = carry & M30
        carry = carry >> 30
    out[..., -1] = carry
    return out


def _propagate(d):
    """Carry each limb's bits above 30 into the next one (in place)."""
    for k in range(d.shape[-1] - 1):
        d[:, k + 1] += d[:, k] >> 30
        d[:, k] &= M30
    return d


def _to_s30(a, limbs):
    """(n, L) 16-bit limbs -> (n, limbs) 30-bit limbs of the same value."""
    n, L = a.shape
    dev = a.device
    bits = ((a.to(torch.int64)[:, :, None] >> torch.arange(16, device=dev)) & 1).reshape(n, 16 * L)
    bits = torch.cat([bits, bits.new_zeros(n, 30 * limbs - 16 * L)], dim=1).reshape(n, limbs, 30)
    return (bits << torch.arange(30, device=dev)).sum(dim=2)


def _from_s30(d, L):
    """(n, K) 30-bit limbs of a value in [0, 2^(16 L)) -> (n, L) int32
    16-bit limbs."""
    n = d.shape[0]
    dev = d.device
    bits = ((d[:, :, None] >> torch.arange(30, device=dev)) & 1).reshape(n, -1)[:, : 16 * L]
    return (bits.reshape(n, L, 16) << torch.arange(16, device=dev)).sum(dim=2).to(torch.int32)


def _divsteps_int(eta, f, g):
    """``_divsteps`` of one row on Python ints (which mask, shift and wrap
    as infinite two's complement, so the int64 arithmetic carries over):
    (eta, (u, v, q, r)), the kernel's divsteps_30 line for line."""
    u, v, q, r = 1, 0, 0, 1
    for _ in range(DIVSTEPS):
        c1 = eta >> 63  # -1 where delta > 0
        c2 = -(g & 1)  # -1 where g is odd
        g += ((f ^ c1) - c1) & c2
        q += ((u ^ c1) - c1) & c2
        r += ((v ^ c1) - c1) & c2
        c1 &= c2  # the swap
        eta = (eta ^ c1) - (c1 + 1)
        f += g & c1
        u += q & c1
        v += r & c1
        g >>= 1
        u <<= 1
        v <<= 1
    return eta, (u, v, q, r)


def _fixed_count_failed():
    return AssertionError("mont_inv_plain: g != 0 or f != +-1 after the fixed divstep count")


def _inv_ints(spec, a):
    """x^-1 mod N of each row's value x on Python ints, row by row, for a
    few rows (the proof path's roots): the batches of ``_inv_limbs`` on
    whole numbers. Each limb of the kernel's carry chains is the whole
    number's, so the batch's low limbs (f & M30, g & M30, d & M30, e & M30)
    and the signs (of the top limbs) are the kernel's. Returns (n, L) int32."""
    c = divstep_constants(spec)
    N = spec.modulus
    out = []
    for x in limbs_to_ints(a.cpu().numpy()):
        f, g, d, e, eta = N, x, 0, 1, -1
        for _ in range(c.batches):
            eta, (u, v, q, r) = _divsteps_int(eta, f & M30, g & M30)
            md = (u if d < 0 else 0) + (v if e < 0 else 0)
            me = (q if d < 0 else 0) + (r if e < 0 else 0)
            md -= (c.ninv30 * (u * (d & M30) + v * (e & M30)) + md) & M30
            me -= (c.ninv30 * (q * (d & M30) + r * (e & M30)) + me) & M30
            f, g = (u * f + v * g) >> 30, (q * f + r * g) >> 30
            d, e = (u * d + v * e + md * N) >> 30, (q * d + r * e + me * N) >> 30
        if g != 0 or f not in ((N,) if x == 0 else (1, -1)):
            raise _fixed_count_failed()
        d += N if d < 0 else 0
        d = -d if f < 0 else d
        out.append(d + N if d < 0 else d)
    return torch.as_tensor(ints_to_limbs(out, spec.L).astype(np.int32), device=a.device)


def _inv_limbs(spec, a):
    """x^-1 mod N of each row's value x in the kernel's signed 30-bit
    limbs, held in int64 tensors: x starts as g against f = N, with d = 0,
    e = 1 and delta = 1; each of the fixed batches runs 30 divsteps on the
    low limbs (``_divsteps``) and applies their matrix to (f, g), divided
    by 2^30 exactly, and to (d, e), made divisible by 2^30 with a multiple
    of N (libsecp256k1's update_de). Then g = 0 and f = +-1 (f = N for x =
    0) in every row, which this checks, and x^-1 = sign(f) d, normalised
    into [0, N). Returns (n, L) int32."""
    c = divstep_constants(spec)
    K, dev = c.limbs, a.device
    n = a.shape[0]
    n30 = torch.tensor(c.n30, dtype=torch.int64, device=dev)
    x = _to_s30(a.to(torch.int64), K)
    f = n30.expand(n, K).clone()
    d = torch.zeros(n, K, dtype=torch.int64, device=dev)
    e = d.clone()
    e[:, 0] = 1
    g = x
    eta = torch.full((n,), -1, dtype=torch.int64, device=dev)  # eta = -delta
    for _ in range(c.batches):
        eta, t = _divsteps(eta, f[:, 0], g[:, 0])
        # the multiple of N that clears (d, e)'s low 30 bits: start from the
        # matrix's column where d or e is negative (keeps them in (-2N, N))
        sign = torch.stack([d[:, -1], e[:, -1]], dim=1) >> 63  # (n, 2)
        m = (t & sign[:, None, :]).sum(dim=2)  # (md, me)
        de0 = (t * torch.stack([d[:, 0], e[:, 0]], dim=1)[:, None, :]).sum(dim=2)
        m = m - ((c.ninv30 * (de0 & M30) + m) & M30)
        u_q, v_r = t[:, :, :1], t[:, :, 1:]  # (n, 2, 1) columns of the matrix
        sums = torch.cat([u_q * f[:, None] + v_r * g[:, None],
                          u_q * d[:, None] + v_r * e[:, None] + m[:, :, None] * n30], dim=1)  # f, g, d, e
        f, g, d, e = _shift30(sums).unbind(dim=1)
    plus, minus = torch.zeros_like(f), torch.full_like(f, M30)  # the limbs of 1 and -1
    plus[:, 0], minus[:, -1] = 1, -1
    unit = (f == plus).all(dim=1) | (f == minus).all(dim=1)
    f_ok = torch.where((x == 0).all(dim=1), (f == n30).all(dim=1), unit)
    if not (bool((g == 0).all()) and bool(f_ok.all())):
        raise _fixed_count_failed()
    # d in (-2N, N): add N if negative, negate where f = -1, add N if negative
    d = d + (n30 & (d[:, -1:] >> 63))
    neg = f[:, -1:] >> 63
    d = _propagate((d ^ neg) - neg)
    d = _propagate(d + (n30 & (d[:, -1:] >> 63)))
    return _from_s30(d, spec.L)


def mont_inv_plain(spec, a):
    """Plain PyTorch version of the inversion kernel on (n, L) int limb rows
    of canonical Montgomery values: the same divstep inversion in the same
    signed 30-bit limbs (``_inv_limbs``; up to INT_ROWS rows the same
    batches on Python ints, ``_inv_ints``, where the tensor route's fixed
    operations cost more than the arithmetic), raising AssertionError
    unless g = 0 and f = +-1 after the fixed count, then one product by R^3
    mod N, which gives the Montgomery form of the inverse, the limbs of
    a^(N-2). 0 maps to 0. Returns (n, L) int32."""
    n = a.shape[0]
    inv = _inv_ints(spec, a) if n <= INT_ROWS else _inv_limbs(spec, a)
    r3 = torch.as_tensor(ints_to_limbs([divstep_constants(spec).r3], spec.L).astype(np.int32), device=a.device)
    return mont_mul_plain(spec, inv, r3.expand(n, spec.L))


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
    """The inverse, a^(N-2) (0 for 0), on (n, L) int32 Montgomery rows of
    canonical values, Fr or Fq. A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel (one thread per row runs the whole divstep
    GCD) or raises."""
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


__all__ = ["mont_mul", "mont_mul_plain", "row_map", "mapped_rows", "mont_inv", "mont_inv_plain", "fermat_chain",
           "divstep_constants"]
