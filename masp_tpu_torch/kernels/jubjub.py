"""Jubjub over Fr: the complete Edwards add, the Pedersen fold and the
constant-time square root, each one CUDA kernel (``csrc/jubjub.cu``) with its
plain PyTorch version.

None replaces a Pallas body: the JAX package composes each from its Fr
Montgomery product, ``JubjubOps.add_points`` (masp_tpu/ops/jubjub_jax.py:104),
``batch_sqrt``'s lax.scan (:220) and the fori_loop of ``_reduce_fn``
(masp_tpu/ops/pedersen_jax.py:77). Composed from the port's product kernel
an add would be about 60 launches, so each program is one kernel.

Points are packed rows (n, 48) int32 of 16-bit limbs, [X | Y | Z] in
projective twisted-Edwards coordinates (a = -1) over Fr, Montgomery form;
the identity is (0 : 1 : 1). Every step of every formula is a canonical
field element, so the kernels, the plain versions and the JAX programs give
the same limbs. The plain versions run the same formulas over
``mont_mul_plain``: on CPU tensors, and on the card as the kernels'
reference.

The add and the fold kernels give each pair (hash) a group of threads that
share the formula's products in layers: the schedules ``ADD_*`` (the
complete add) and ``FOLD_*`` (the fold's step, the mixed add of a table
entry with Z = 1) below, which the CUDA source holds too. The fold kernel
reads its table in its own layout, ``fold_table``. The square-root kernel
walks its exponent by fixed windows, ``SQRT_DIGITS``, which the CUDA source
holds too; the plain version walks the bits, to the same value.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from masp_tpu_torch import device_const
from masp_tpu_torch.host.fields import SCALAR_MODULUS
from masp_tpu_torch.host.jubjub import EDWARDS_D
from masp_tpu_torch.kernels import count_launch
from masp_tpu_torch.kernels import mont_mul as MK
from masp_tpu_torch.kernels.build import library
from masp_tpu_torch.ops import field as F
from masp_tpu_torch.ops.field import FR

_R = SCALAR_MODULUS
PT = 3 * FR.L  # int32 limbs a packed point

# d of the curve in Montgomery form
D_MONT = F.encode(FR, [EDWARDS_D.n])[0]

# the 2-adicity of r - 1 and its odd cofactor: r - 1 = 2^S t
S = 32
T_ODD = (_R - 1) >> S
assert T_ODD & 1 == 1 and (T_ODD << S) == _R - 1


@functools.cache
def root_of_unity() -> int:
    """z = g^t for the least quadratic non-residue g: a primitive 2^S-th
    root of unity, as jubjub_jax._root_of_unity finds it."""
    g = 2
    while pow(g, (_R - 1) // 2, _R) != _R - 1:
        g += 1
    return pow(g, T_ODD, _R)


def sqrt_exponent_bits() -> list[int]:
    """The bits of (t - 1) / 2, most significant first."""
    return [int(b) for b in bin((T_ODD - 1) // 2)[2:]]


# The kernel's walk of w = a^((t - 1) / 2): fixed windows of SQRT_WINDOW
# bits, most significant first (the first digit takes the bits left over).
# w starts as a^d0; each later digit takes SQRT_WINDOW squarings and, where
# it is not 0, a product by a^d from a table of a^1 .. a^(2^SQRT_WINDOW - 1).
# csrc/jubjub.cu holds the same digits.
SQRT_WINDOW = 4


def sqrt_window_digits() -> list[int]:
    """The digits of (t - 1) / 2 in base 2^SQRT_WINDOW, most significant
    first."""
    e, digits = (T_ODD - 1) // 2, []
    while e:
        digits.append(e & ((1 << SQRT_WINDOW) - 1))
        e >>= SQRT_WINDOW
    return digits[::-1]


SQRT_DIGITS = tuple(sqrt_window_digits())


def sqrt_schedule() -> list[int]:
    """The step stream of the constant-time Tonelli-Shanks: for max_v = S
    .. 1 the inner steps j = 2 .. max_v - 1, then a boundary step (0)."""
    out = []
    for max_v in range(S, 0, -1):
        out.extend(range(2, max_v))
        out.append(0)
    return out


def constant(name: str, device) -> torch.Tensor:
    """The kernels' constants on ``device``, made once: d ("d") and the root
    of unity ("z"), 16 Montgomery limbs each."""
    def build():
        arr = D_MONT if name == "d" else F.encode(FR, [root_of_unity()])[0]
        return torch.as_tensor(np.asarray(arr).astype(np.int32), device=device)

    return device_const(("jubjub", name, torch.device(device)), build)


# --- the add and the fold kernels' schedules --------------------------------------
#
# csrc/jubjub.cu holds the same tables. A formula is a list of layers over
# slots, elements of Fr: slots below ADD_NS (FOLD_NS) lie in the pair's
# (hash's) own area, the slots from there on are read-only elements outside
# it. A product layer's rows are (out, a, b): out = a b. A linear layer's
# rows are (out, x, s, y, z): out = x + s (y + z) with s = +-1, z = NONE for
# none. The rows of a layer are independent; thread t of a group takes rows
# t, t + GROUP, ... of each layer.
NONE = 31

# The complete add, add-2008-bbjlp with a = -1: slots X1 0, Y1 1, Z1 2, X2 3,
# Y2 4, Z2 5, 6-11 free, 12 the curve's d; X3 | Y3 | Z3 end in ADD_OUT,
# ADD_OUT + 1, ADD_OUT + 2. 12 products, 4 deep.
ADD_NS = 12
ADD_LIN0 = ((6, 0, 1, 1, NONE), (7, 3, 1, 4, NONE))  # X1 + Y1, X2 + Y2
ADD_L1 = ((8, 2, 5), (9, 0, 3), (10, 1, 4), (11, 6, 7))  # A = Z1 Z2, C = X1 X2, D = Y1 Y2, H' = (X1 + Y1)(X2 + Y2)
ADD_LIN1 = ((0, 9, 1, 10, NONE), (1, 11, -1, 9, 10))  # S = C + D, H = H' - (C + D)
ADD_L2 = ((2, 8, 8), (3, 9, 10), (4, 8, 1), (5, 8, 0))  # B = A^2, C D, A H, A S
ADD_L3 = ((6, 12, 3),)  # E = d (C D)
ADD_LIN2 = ((7, 2, -1, 6, NONE), (8, 2, 1, 6, NONE))  # F = B - E, G = B + E
ADD_L4 = ((9, 4, 7), (10, 5, 8), (11, 7, 8))  # X3 = (A H) F, Y3 = (A S) G, Z3 = F G
ADD_OUT = 9
ADD_LAYERS = (("lin", ADD_LIN0), ("mul", ADD_L1), ("lin", ADD_LIN1), ("mul", ADD_L2), ("mul", ADD_L3),
              ("lin", ADD_LIN2), ("mul", ADD_L4))

# The fold's step, the mixed add of an entry with Z2 = 1: slots X1 0, Y1 1,
# Z1 2 (the accumulator, in place), 3-12 free; the entry's X2 13, Y2 14,
# X2 + Y2 15 and d X2 Y2 16 (FOLD_ENTRY). A = Z1 Z2 = Z1 and E = (X1 Y1)(d X2
# Y2): 11 products, 3 deep.
FOLD_NS = 13
FOLD_LIN0 = ((3, 0, 1, 1, NONE),)  # X1 + Y1
FOLD_L1 = ((4, 0, 13), (5, 1, 14), (6, 3, 15), (7, 0, 1))  # C, D, H' = (X1 + Y1)(X2 + Y2), P = X1 Y1
FOLD_LIN1 = ((3, 4, 1, 5, NONE), (8, 6, -1, 4, 5))  # S = C + D, H = H' - (C + D)
FOLD_L2 = ((9, 2, 2), (10, 7, 16), (11, 2, 8), (12, 2, 3))  # B = Z1^2, E = P (d X2 Y2), Z1 H, Z1 S
FOLD_LIN2 = ((4, 9, -1, 10, NONE), (5, 9, 1, 10, NONE))  # F = B - E, G = B + E
FOLD_L3 = ((0, 11, 4), (1, 12, 5), (2, 4, 5))  # X3 = (Z1 H) F, Y3 = (Z1 S) G, Z3 = F G
FOLD_LAYERS = (("lin", FOLD_LIN0), ("mul", FOLD_L1), ("lin", FOLD_LIN1), ("mul", FOLD_L2), ("lin", FOLD_LIN2),
               ("mul", FOLD_L3))
FOLD_ENTRY = 4  # elements of a fold-table entry: X2, Y2, X2 + Y2, d X2 Y2


def _words(limbs: np.ndarray) -> np.ndarray:
    """(n, 16) 16-bit limbs -> (n, 8) packed 32-bit words as int32."""
    limbs = limbs.astype(np.uint32)
    return (limbs[:, 0::2] | (limbs[:, 1::2] << 16)).view(np.int32)


def fold_table(table):
    """The fold kernel's layout of a (C, 9, 48) table whose entries all have
    Z = 1: (C, 9, 32) int32, per entry the packed 32-bit words of X2, Y2,
    X2 + Y2 and d X2 Y2 (Montgomery form). Made on the host once per table
    and kept on the table tensor (made again after an in-place write);
    raises where an entry's Z is not 1, or while a CUDA graph is being
    captured (make it before)."""
    kept = getattr(table, "_masp_fold_table", None)
    if kept is not None and kept[0] == table._version:
        return kept[1]
    if table.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("fold_table: make the fold table before capturing a CUDA graph")
    rows = table.reshape(-1, PT).cpu().numpy()
    L = FR.L
    if not (rows[:, 2 * L :] == F.encode(FR, [1])[0]).all():
        raise ValueError("fold_table: the fold kernel adds entries with Z = 1 only")
    x = F.decode(FR, rows[:, :L], mont=False)
    y = F.decode(FR, rows[:, L : 2 * L], mont=False)
    d = F.decode(FR, D_MONT[None], mont=False)[0]
    rinv2 = pow(FR.R_mod, -2, _R)
    s = [(a + b) % _R for a, b in zip(x, y)]
    t = [d * a % _R * b % _R * rinv2 % _R for a, b in zip(x, y)]
    words = np.concatenate([_words(rows[:, :L]), _words(rows[:, L : 2 * L]),
                            _words(F.encode(FR, s, mont=False)), _words(F.encode(FR, t, mont=False))], axis=1)
    out = torch.as_tensor(words.reshape(table.shape[0], 9, 8 * FOLD_ENTRY), device=table.device)
    table._masp_fold_table = (table._version, out)
    return out


# --- plain versions -------------------------------------------------------------

def _mul(a, b):
    return MK.mont_mul_plain(FR, a, b)


def edwards_add(p, q, mul, add, sub, d):
    """add-2008-bbjlp with a = -1 on coordinate triples (jubjub_jax.py:109-119),
    12 products: A = Z1 Z2, B = A^2, C = X1 X2, D = Y1 Y2, E = d C D,
    F = B - E, G = B + E, H = (X1 + Y1)(X2 + Y2) - (C + D), X3 = A F H,
    Y3 = A G (D + C), Z3 = F G. Complete on Jubjub."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    A = mul(Z1, Z2)
    B = mul(A, A)
    C = mul(X1, X2)
    D = mul(Y1, Y2)
    E = mul(d, mul(C, D))
    Fv = sub(B, E)
    G = add(B, E)
    H = sub(mul(add(X1, Y1), add(X2, Y2)), add(C, D))
    X3 = mul(mul(A, Fv), H)
    Y3 = mul(mul(A, G), add(D, C))
    Z3 = mul(Fv, G)
    return X3, Y3, Z3


def _split(rows):
    L = FR.L
    return rows[:, :L], rows[:, L : 2 * L], rows[:, 2 * L :]


def jubjub_add_plain(p, q):
    """Plain PyTorch version of the add kernel on (n, 48) rows."""
    d = constant("d", p.device).expand(p.shape[0], FR.L)
    out = edwards_add(_split(p), _split(q), _mul, functools.partial(F.add, FR), functools.partial(F.sub, FR), d)
    return torch.cat(out, dim=1).to(torch.int32)


def identity_rows(n: int, device) -> torch.Tensor:
    """(n, 48) rows of the identity (0 : 1 : 1)."""
    one = FR.const("ONE_MONT", device)
    row = torch.cat([torch.zeros_like(one), one, one])
    return row.expand(n, PT).clone()


def pedersen_fold_plain(table, idx):
    """Plain version of the fold kernel: table (C, 9, 48) rows, idx (C, N)
    in 0 .. 8; the identity plus table[c, idx[c, n]] for c = 0 .. C-1, in
    that order."""
    acc = identity_rows(idx.shape[1], table.device)
    for c in range(idx.shape[0]):
        acc = jubjub_add_plain(acc, table[c][idx[c].long()])
    return acc


def fr_sqrt_plain(a):
    """Plain version of the square-root kernel on (n, 16) Montgomery rows:
    (root (n, 16) int32, ok (n,) bool), the kernel's step loop over the
    plain product."""
    dev = a.device
    a = a.to(torch.int32)
    one = FR.const("ONE_MONT", dev).expand(a.shape)

    def sqr(x):
        return _mul(x, x)

    def is_one(x):
        return torch.all(x == one, dim=-1)

    w = one.clone()
    for bit in sqrt_exponent_bits():
        w = sqr(w)
        if bit:
            w = _mul(w, a)
    x = _mul(a, w)
    b = _mul(x, w)
    z = constant("z", dev).expand(a.shape).clone()
    n = a.shape[0]
    v = torch.full((n,), S, dtype=torch.int64, device=dev)
    k = torch.ones_like(v)
    tmp = sqr(b)
    jltv = torch.ones(n, dtype=torch.bool, device=dev)
    for j in sqrt_schedule():
        if j:  # inner step
            tmp_is_one = is_one(tmp)
            sq = sqr(F.select(tmp_is_one, z, tmp))
            jltv = jltv & (v != j)
            k = torch.where(tmp_is_one, k, torch.full_like(k, j))
            z = F.select(jltv & tmp_is_one, sq, z)
            tmp = F.select(tmp_is_one, tmp, sq)
        else:  # boundary step
            x = F.select(is_one(b), x, _mul(x, z))
            z = sqr(z)
            b = _mul(b, z)
            v, k = k, torch.ones_like(k)
            tmp = sqr(b)
            jltv = torch.ones_like(jltv)
    return x, torch.all(sqr(x) == a, dim=-1)


# --- the CUDA kernels' wrappers -----------------------------------------------------

@functools.cache
def _c_fn(name: str):
    fn = getattr(library("jubjub"), "masp_" + name)
    fn.argtypes = {
        "jubjub_add": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p],
        "pedersen_fold": [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p],
        "fr_sqrt": [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    }[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, t, *args) -> None:
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _c_fn(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    count_launch(name)


def _device_of(*ts):
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("operands on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def jubjub_add(p, q):
    """Sum of two batches of Jubjub points as (n, 48) int32 rows. The rows'
    limb axis must be contiguous, their row stride is free (the MSM ladder
    passes even and odd views of one tensor). A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel or raises."""
    for t in (p, q):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != PT:
            raise ValueError(f"jubjub_add takes (n, {PT}) int32 rows, got {t.dtype} {tuple(t.shape)}")
    if p.shape != q.shape:
        raise ValueError("jubjub_add operands differ in shape")
    if _device_of(p, q).type == "cpu":
        return jubjub_add_plain(p, q)
    if p.stride(1) != 1 or q.stride(1) != 1:
        raise ValueError("jubjub_add rows must be contiguous along the limb axis")
    n = p.shape[0]
    out = torch.empty((n, PT), dtype=torch.int32, device=p.device)
    if n:
        _launch("jubjub_add", p, p.data_ptr(), p.stride(0), q.data_ptr(), q.stride(0), out.data_ptr(), n,
                constant("d", p.device).data_ptr())
    return out


def pedersen_fold(table, idx):
    """(N, 48) rows: for each n the identity plus table[c, idx[c, n]] over
    c = 0 .. C-1 in that order; table (C, 9, 48) int32 rows, idx (C, N)
    int32 in 0 .. 8 (a digit plus 4). A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel or raises. The kernel adds entries with
    Z = 1 only, the table's affine encoding (``fold_table`` checks it)."""
    if table.dtype != torch.int32 or table.dim() != 3 or table.shape[1:] != (9, PT):
        raise ValueError(f"pedersen_fold takes a (C, 9, {PT}) int32 table, got {table.dtype} {tuple(table.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[0] != table.shape[0]:
        raise ValueError(f"pedersen_fold takes (C, N) int32 indices, got {idx.dtype} {tuple(idx.shape)}")
    if _device_of(table, idx).type == "cpu":
        return pedersen_fold_plain(table, idx)
    idx = idx.contiguous()
    C, N = idx.shape
    out = torch.empty((N, PT), dtype=torch.int32, device=idx.device)
    if N:
        _launch("pedersen_fold", idx, fold_table(table).data_ptr(), idx.data_ptr(), out.data_ptr(), C, N)
    return out


def fr_sqrt(a):
    """(root, ok) of (n, 16) int32 Montgomery rows of canonical Fr values:
    some square root where one exists (0 for 0) and whether it does. A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel or
    raises."""
    if a.dtype != torch.int32 or a.dim() != 2 or a.shape[1] != FR.L:
        raise ValueError(f"fr_sqrt takes (n, {FR.L}) int32 rows, got {a.dtype} {tuple(a.shape)}")
    if _device_of(a).type == "cpu":
        return fr_sqrt_plain(a)
    a = a.contiguous()
    n = a.shape[0]
    root = torch.empty_like(a)
    ok = torch.empty(n, dtype=torch.int32, device=a.device)
    if n:
        _launch("fr_sqrt", a, a.data_ptr(), root.data_ptr(), ok.data_ptr(), n, constant("z", a.device).data_ptr(), S)
    return root, ok != 0


__all__ = [
    "jubjub_add", "jubjub_add_plain", "pedersen_fold", "pedersen_fold_plain", "fr_sqrt", "fr_sqrt_plain",
    "edwards_add", "identity_rows", "constant", "root_of_unity", "sqrt_exponent_bits", "sqrt_schedule", "D_MONT", "S",
    "SQRT_WINDOW", "SQRT_DIGITS", "sqrt_window_digits",
    "fold_table", "ADD_LAYERS", "FOLD_LAYERS", "ADD_NS", "FOLD_NS", "ADD_OUT", "FOLD_ENTRY", "NONE",
]
