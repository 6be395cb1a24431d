# Copy of masp_tpu/curves/jubjub.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""Host-exact Jubjub curve: a = -1 twisted Edwards curve over the BLS12-381
scalar field.

Matches the behavior of the ``nam-jubjub`` crate (reference Cargo.lock:1437-1449)
that the reference uses everywhere (SURVEY.md L0):

  -u^2 + v^2 = 1 + d * u^2 * v^2,   d = -(10240/10241)

Encoding: 32 bytes little-endian of the v coordinate with the sign (parity) of
u stored in the top bit — identical to ``jubjub::AffinePoint::{to,from}_bytes``,
including the ZIP-216 non-canonical -0 rejection toggle used by
``masp_primitives`` (redjubjub.rs:195-229).

The batched TPU implementation lives in masp_tpu.ops.jubjub_jax and is verified
against this module point-for-point.
"""

from __future__ import annotations

from masp_tpu_torch.host.fields import Scalar, JubjubFr, SCALAR_MODULUS

# d = -(10240/10241) mod r
EDWARDS_D = Scalar(-10240 * pow(10241, -1, SCALAR_MODULUS))
EDWARDS_D2 = EDWARDS_D + EDWARDS_D


class ExtendedPoint:
    """Extended twisted-Edwards coordinates (u, v, z, t1, t2), t1*t2 = u*v/z.

    Represents the full group E(Fr) of order 8 * r_jubjub. ``SubgroupPoint``
    semantics (prime-order subgroup) are provided via ``is_torsion_free`` /
    ``clear_cofactor`` as in the jubjub crate.
    """

    __slots__ = ("u", "v", "z", "t1", "t2")

    def __init__(self, u: Scalar, v: Scalar, z: Scalar, t1: Scalar, t2: Scalar):
        self.u, self.v, self.z, self.t1, self.t2 = u, v, z, t1, t2

    # --- constructors -----------------------------------------------------
    @staticmethod
    def identity() -> "ExtendedPoint":
        return ExtendedPoint(Scalar(0), Scalar(1), Scalar(1), Scalar(0), Scalar(0))

    @staticmethod
    def from_affine(u: Scalar, v: Scalar) -> "ExtendedPoint":
        return ExtendedPoint(u, v, Scalar(1), u, v)

    @staticmethod
    def from_bytes_inner(b: bytes, zip_216_enabled: bool) -> "ExtendedPoint | None":
        """Decode per jubjub's ``AffinePoint::from_bytes_inner``."""
        if len(b) != 32:
            return None
        b = bytearray(b)
        sign = b[31] >> 7
        b[31] &= 0b0111_1111
        v = Scalar.from_bytes(bytes(b))
        if v is None:
            return None
        # u^2 = (v^2 - 1) / (1 + d v^2)
        v2 = v.square()
        denom = (Scalar(1) + EDWARDS_D * v2).invert()
        if denom is None:  # cannot happen: 1 + d*v^2 != 0 for all v
            return None
        u2 = (v2 - Scalar(1)) * denom
        u = u2.sqrt()
        if u is None:
            return None
        flip_sign = ((u.n & 1) ^ sign) == 1
        final_u = -u if flip_sign else u
        if zip_216_enabled and u.is_zero() and flip_sign:
            # non-canonical encoding of the identity-type points (-0)
            return None
        return ExtendedPoint.from_affine(final_u, v)

    @staticmethod
    def from_bytes(b: bytes) -> "ExtendedPoint | None":
        return ExtendedPoint.from_bytes_inner(b, True)

    @staticmethod
    def from_bytes_pre_zip216(b: bytes) -> "ExtendedPoint | None":
        return ExtendedPoint.from_bytes_inner(b, False)

    # --- encoding ---------------------------------------------------------
    def to_affine(self) -> tuple[Scalar, Scalar]:
        zinv = self.z.invert()
        return (self.u * zinv, self.v * zinv)

    def to_bytes(self) -> bytes:
        u, v = self.to_affine()
        b = bytearray(v.to_bytes())
        b[31] |= (u.n & 1) << 7
        return bytes(b)

    # --- predicates -------------------------------------------------------
    def is_identity(self) -> bool:
        # affine (0, 1): u == 0 and v == z
        return self.u.is_zero() and self.v == self.z

    def is_small_order(self) -> bool:
        return self.mul_by_cofactor().is_identity()

    def is_torsion_free(self) -> bool:
        return self.mul_scalar_int(JubjubFr.META.modulus).is_identity()

    def is_prime_order(self) -> bool:
        return self.is_torsion_free() and not self.is_identity()

    # --- group law (a = -1 extended formulas, matching the jubjub crate) --
    def double(self) -> "ExtendedPoint":
        # dbl-2008-hwcd, specialized for a = -1
        uu = self.u.square()
        vv = self.v.square()
        zz2 = self.z.square().double()
        uv2 = (self.u + self.v).square()
        vv_plus_uu = vv + uu
        vv_minus_uu = vv - uu
        # completed point
        U = uv2 - vv_plus_uu
        V = vv_plus_uu
        Z = vv_minus_uu
        T = zz2 - vv_minus_uu
        return ExtendedPoint(U * T, V * Z, Z * T, U, V)

    def __add__(self, other: "ExtendedPoint") -> "ExtendedPoint":
        # add-2008-hwcd-3, a = -1
        a = (self.v - self.u) * (other.v - other.u)
        b = (self.v + self.u) * (other.v + other.u)
        c = self.t1 * self.t2 * EDWARDS_D2 * other.t1 * other.t2
        d = (self.z * other.z).double()
        U = b - a
        V = b + a
        Z = d + c
        T = d - c
        return ExtendedPoint(U * T, V * Z, Z * T, U, V)

    def __neg__(self) -> "ExtendedPoint":
        return ExtendedPoint(-self.u, self.v, self.z, -self.t1, self.t2)

    def __sub__(self, other: "ExtendedPoint") -> "ExtendedPoint":
        return self + (-other)

    def mul_by_cofactor(self) -> "ExtendedPoint":
        return self.double().double().double()

    def mul_scalar_int(self, k: int) -> "ExtendedPoint":
        acc = ExtendedPoint.identity()
        p = self
        while k:
            if k & 1:
                acc = acc + p
            p = p.double()
            k >>= 1
        return acc

    def __mul__(self, scalar: JubjubFr) -> "ExtendedPoint":
        return self.mul_scalar_int(scalar.n)

    def __rmul__(self, scalar: JubjubFr) -> "ExtendedPoint":
        return self.mul_scalar_int(scalar.n)

    def clear_cofactor(self) -> "ExtendedPoint":
        """CofactorGroup::clear_cofactor == mul_by_cofactor in jubjub."""
        return self.mul_by_cofactor()

    # --- comparisons ------------------------------------------------------
    def __eq__(self, other) -> bool:
        if not isinstance(other, ExtendedPoint):
            return NotImplemented
        return (self.u * other.z == other.u * self.z) and (
            self.v * other.z == other.v * self.z
        )

    def __hash__(self):
        return hash(self.to_bytes())

    def __repr__(self):
        u, v = self.to_affine()
        return f"Jubjub({u!r}, {v!r})"


def subgroup_from_bytes(b: bytes) -> "ExtendedPoint | None":
    """``SubgroupPoint::from_bytes``: decode then require torsion-free."""
    p = ExtendedPoint.from_bytes(b)
    if p is None or not p.is_torsion_free():
        return None
    return p


def batch_from_bytes(items) -> list["ExtendedPoint | None"]:
    """Semantics of ``jubjub::ExtendedPoint::batch_from_bytes`` (used by
    batch trial decryption, note_encryption.rs:385-400). Host-exact version;
    the vectorized TPU path batches the sqrt via ops.jubjub_jax."""
    return [ExtendedPoint.from_bytes(b) for b in items]


__all__ = [
    "EDWARDS_D", "EDWARDS_D2", "ExtendedPoint", "subgroup_from_bytes",
    "batch_from_bytes",
]
