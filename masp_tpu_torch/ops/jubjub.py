"""Batched Jubjub on the device: complete Edwards adds, MSM, decompression
and RedJubjub batch verification.

Port of masp_tpu/ops/jubjub_jax.py. Points are projective twisted-Edwards
coordinates (X : Y : Z) over Fr, each a (..., 16) int32 Montgomery limb
tensor, identity (0 : 1 : 1); packed rows [X | Y | Z] of 48 limbs where the
MSM engine and the kernels take them. The add-2008-bbjlp add is complete on
Jubjub, so there is no branch: ``JubjubOps.add_points`` runs the add kernel
(kernels/jubjub.py) on a CUDA tensor and its plain version on a CPU one.

* ``msm`` runs the port's sorted-prefix MSM (ops/msm_sorted.py) through the
  hooks it checks for: ``add_points``, ``neg_point`` and ``IDENTITY_MONT``.
* ``batch_from_bytes`` decompresses a batch of encodings: v^2, 1 + d v^2 and
  u^2 = (v^2 - 1) / (1 + d v^2) through the Fr product and one batched
  inversion, then the square-root kernel (``batch_sqrt``); byte parsing, the
  sign and the ZIP-216 rejection are host logic.
* ``batch_verify_device`` is RedJubjub's randomized batch verification with
  the linear combination as one device MSM.

Entry points that make tensors take ``device`` ("cuda" by default; the tests
pass "cpu"). Results equal the host implementation's (tests/test_torch_jubjub.py
holds them against the JAX package's).
"""

from __future__ import annotations

import numpy as np
import torch

from masp_tpu_torch import resolve_device
from masp_tpu_torch.host.fields import SCALAR_MODULUS, JubjubFr, Scalar
from masp_tpu_torch.host.jubjub import ExtendedPoint
from masp_tpu_torch.kernels import jubjub as KJ
from masp_tpu_torch.ops import field as F
from masp_tpu_torch.ops.field import FR

_R = SCALAR_MODULUS

D_MONT = KJ.D_MONT
_ONE_MONT = np.asarray(FR.ONE_MONT, dtype=np.uint32)
_ZERO = np.zeros(FR.L, dtype=np.uint32)


class JubjubOps:
    """fops-interface curve ops for Jubjub (cf. weierstrass.FqOps), plugged
    into ops/msm_sorted.py through three hooks: ``add_points`` (the complete
    Edwards add in place of the Weierstrass formulas), ``neg_point`` (Edwards
    negation flips X, not Y) and ``IDENTITY_MONT`` ((0 : 1 : 1))."""

    spec = FR
    coord_shape = (FR.L,)
    IDENTITY_MONT = (_ZERO, _ONE_MONT, _ONE_MONT)

    @staticmethod
    def mul(a, b):
        return F.mont_mul(FR, a, b)

    @staticmethod
    def add(a, b):
        return F.add(FR, a, b)

    @staticmethod
    def sub(a, b):
        return F.sub(FR, a, b)

    @staticmethod
    def zeros_like(a):
        return torch.zeros_like(a)

    @staticmethod
    def one_like(a):
        return F.one_like(FR, a)

    @staticmethod
    def inv(a):
        return F.mont_inv_small(FR, a)

    @staticmethod
    def batch_inv(a):
        return F.batch_mont_inv(FR, a)

    @staticmethod
    def encode(vals):
        return F.encode(FR, vals)

    @staticmethod
    def decode(arr):
        return F.decode(FR, arr)

    @staticmethod
    def add_points(p, q):
        """add-2008-bbjlp with a = -1 on (X, Y, Z) tuples of (..., 16)
        tensors of one shape: the add kernel on CUDA tensors, its plain
        version on CPU ones."""
        lead = p[0].shape[:-1]
        rows = KJ.jubjub_add(_pack(p), _pack(q))
        return tuple(rows[:, i * FR.L : (i + 1) * FR.L].reshape(lead + (FR.L,)) for i in range(3))

    @staticmethod
    def neg_point(p):
        X, Y, Z = p
        return F.neg(FR, X), Y, Z


def _pack(coords) -> torch.Tensor:
    """(X, Y, Z) of (..., 16) -> (n, 48) int32 rows."""
    return torch.cat([c.reshape(-1, FR.L) for c in coords], dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# host <-> device codecs

def encode_points(points) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host ExtendedPoints -> (X, Y, Z = 1) Montgomery limb arrays. The
    identity's affine form (0, 1) is the projective identity."""
    aff = [p.to_affine() for p in points]
    X = F.encode(FR, [u.n for u, _ in aff])
    Y = F.encode(FR, [v.n for _, v in aff])
    Z = F.encode(FR, [1] * len(points))
    return X, Y, Z


def decode_points(X, Y, Z) -> list[ExtendedPoint]:
    xs, ys, zs = F.decode(FR, X), F.decode(FR, Y), F.decode(FR, Z)
    out = []
    for x, y, z in zip(xs, ys, zs):
        zi = pow(z, -1, _R)  # Z is never 0 under the complete add
        out.append(ExtendedPoint.from_affine(Scalar(x * zi % _R), Scalar(y * zi % _R)))
    return out


def decode_point(coords) -> ExtendedPoint:
    return decode_points(*coords)[0]


def _rows(points, device) -> torch.Tensor:
    """Host points -> (n, 48) int32 rows on ``device``."""
    return torch.as_tensor(np.concatenate(encode_points(points), axis=1).astype(np.int32), device=device)


# ---------------------------------------------------------------------------
# MSM

def msm(points: list[ExtendedPoint], scalars: list[int | JubjubFr], c: int = 8,
        device="cuda") -> ExtendedPoint:
    """sum_i [s_i] P_i on the device through the sorted-prefix MSM (256-bit
    digits, the points padded with identities to a power of two)."""
    from masp_tpu_torch.ops import msm as M
    from masp_tpu_torch.ops import msm_sorted as MS

    ints = [s.n if isinstance(s, JubjubFr) else int(s) for s in scalars]
    if len(points) != len(ints):
        raise ValueError("points/scalars length mismatch")
    if not points:
        return ExtendedPoint.identity()
    dev = resolve_device(device)
    n = 1 << (len(points) - 1).bit_length()
    pts = list(points) + [ExtendedPoint.identity()] * (n - len(points))
    ints = ints + [0] * (n - len(ints))
    digits = torch.as_tensor(M.scalars_to_digits(ints, c, 256), device=dev)
    row = MS.sorted_msm(JubjubOps, _rows(pts, dev), digits, c)
    return decode_point(tuple(row[i * FR.L : (i + 1) * FR.L] for i in range(3)))


# ---------------------------------------------------------------------------
# batched square root (constant-time Tonelli-Shanks, S = 32) and decompression

def batch_sqrt(a):
    """Batched square root over Fr: (N, 16) Montgomery rows -> (root,
    is_square). The ff crate's constant-time Tonelli-Shanks in one kernel
    launch (its plain version on a CPU tensor); the root is some square root
    where one exists (callers fix the sign), 0 for 0."""
    return KJ.fr_sqrt(a.to(torch.int32))


def batch_from_bytes(items: list[bytes], zip_216_enabled: bool = True,
                     device="cuda") -> list[ExtendedPoint | None]:
    """Batched ExtendedPoint.from_bytes: the inversion of 1 + d v^2 and the
    square root on the device for the whole batch; byte parsing, the sign
    flip and the canonicality rejection are host logic identical to
    host/jubjub.py's from_bytes_inner."""
    vs, signs, valid = [], [], []
    for b in items:
        if len(b) != 32:
            vs.append(0), signs.append(0), valid.append(False)
            continue
        sign = b[31] >> 7
        v_int = int.from_bytes(b[:31] + bytes([b[31] & 0x7F]), "little")
        ok = v_int < _R
        vs.append(v_int if ok else 0)
        signs.append(sign)
        valid.append(ok)
    if not items:
        return []

    dev = resolve_device(device)
    v_m = torch.as_tensor(F.encode(FR, vs).astype(np.int32), device=dev)
    one = FR.const("ONE_MONT", dev)
    v2 = F.mont_sqr(FR, v_m)
    denom = F.add(FR, one, F.mont_mul(FR, KJ.constant("d", dev), v2))
    u2 = F.mont_mul(FR, F.sub(FR, v2, one), F.batch_mont_inv(FR, denom))
    u_m, ok_dev = batch_sqrt(u2)

    us = F.decode(FR, u_m)
    oks = ok_dev.cpu().numpy()
    out: list[ExtendedPoint | None] = []
    for u, is_sq, v_int, sign, ok in zip(us, oks, vs, signs, valid):
        if not (ok and is_sq):
            out.append(None)
            continue
        flip = ((u & 1) ^ sign) == 1
        if zip_216_enabled and u == 0 and flip:
            out.append(None)  # non-canonical -0 encoding
            continue
        final_u = (_R - u) % _R if flip else u
        out.append(ExtendedPoint.from_affine(Scalar(final_u), Scalar(v_int)))
    return out


# ---------------------------------------------------------------------------
# RedJubjub batch verification as one device MSM

def batch_verify_device(rng, batch, p_g: ExtendedPoint, device="cuda") -> bool:
    """Randomized batch verification, redjubjub.rs:240-275 semantics:
    h_G(sum_i z_i R_i + (c_i z_i) vk_i - (sum_i s_i z_i) P_G) == 0. The R
    points come from the batched decompression; the linear combination is
    one device MSM over 2B + 1 points."""
    from masp_tpu_torch.host.primitives.redjubjub import h_star

    if not batch:
        return True
    rs = batch_from_bytes([e.sig.rbar for e in batch], device=device)
    points: list[ExtendedPoint] = []
    scalars: list[int] = []
    pg_scalar = 0
    q = JubjubFr.META.modulus
    for entry, r in zip(batch, rs):
        if r is None:
            return False
        s = JubjubFr.from_bytes(entry.sig.sbar)
        if s is None:
            return False
        c = h_star(entry.sig.rbar, entry.msg)
        z = JubjubFr.from_bytes_wide(rng.fill_bytes(64))
        points.append(r)
        scalars.append(z.n)
        points.append(entry.vk.point)
        scalars.append(c.n * z.n % q)
        pg_scalar = (pg_scalar - s.n * z.n) % q
    points.append(p_g)
    scalars.append(pg_scalar)
    return msm(points, scalars, device=device).mul_by_cofactor().is_identity()


__all__ = [
    "JubjubOps", "encode_points", "decode_points", "decode_point", "msm",
    "batch_sqrt", "batch_from_bytes", "batch_verify_device",
]
