# Copy of masp_tpu/fields/__init__.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""Host-exact prime-field arithmetic for the MASP TPU stack.

These classes are the *gold* (bit-exact) layer: plain Python integers with
byte-level encodings identical to the reference's ``nam-blstrs`` /
``nam-jubjub`` crates (ref: masp reference Cargo.lock:1385-1449).  The TPU
compute path (masp_tpu.ops) re-implements the hot operations as limb-decomposed
JAX/Pallas kernels and is validated element-for-element against this layer.

Fields:
  * ``Scalar`` — BLS12-381 scalar field Fr (255 bit). This is the field the
    R1CS circuits are defined over (``bls12_381::Scalar`` in the reference).
  * ``Fq`` — BLS12-381 base field (381 bit) for G1/G2 coordinates.
  * ``JubjubFr`` — scalar field of the Jubjub curve (252 bit), ``jubjub::Fr``.
"""

from __future__ import annotations


def _tonelli_shanks_consts(p: int) -> tuple[int, int, int]:
    """Precompute (s, q_odd, z_nonresidue) with p - 1 = q_odd * 2^s."""
    s = 0
    q = p - 1
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    return s, q, z


class FieldMeta:
    """Per-modulus constants shared by all elements of a field."""

    __slots__ = (
        "name", "modulus", "num_bits", "repr_bytes", "ts_s", "ts_q", "ts_z",
        "root_of_unity", "two_adicity",
    )

    def __init__(self, name: str, modulus: int, repr_bytes: int):
        self.name = name
        self.modulus = modulus
        self.num_bits = modulus.bit_length()
        self.repr_bytes = repr_bytes
        self.ts_s, self.ts_q, self.ts_z = _tonelli_shanks_consts(modulus)
        # 2-adic root of unity (generator^q_odd): needed for NTT domains.
        self.two_adicity = self.ts_s
        self.root_of_unity = pow(self.ts_z, self.ts_q, modulus)


class Fp:
    """An element of a prime field, stored as a canonical Python int.

    Subclasses fix ``META``.  Encoding (``to_bytes``/``from_bytes``) is
    little-endian canonical, matching ``ff::PrimeField::to_repr`` /
    ``from_repr`` in the reference crates.
    """

    __slots__ = ("n",)
    META: FieldMeta = None  # set by subclass

    def __init__(self, n: int):
        self.n = n % self.META.modulus

    # --- constructors -----------------------------------------------------
    @classmethod
    def zero(cls):
        return cls(0)

    @classmethod
    def one(cls):
        return cls(1)

    @classmethod
    def from_bytes(cls, b: bytes):
        """Canonical little-endian decode; returns None when >= modulus
        (mirrors ``CtOption::is_none`` of ``from_repr``)."""
        assert len(b) == cls.META.repr_bytes
        n = int.from_bytes(b, "little")
        if n >= cls.META.modulus:
            return None
        return cls(n)

    @classmethod
    def from_bytes_wide(cls, b: bytes):
        """Reduce a 64-byte little-endian integer (``from_bytes_wide``)."""
        return cls(int.from_bytes(b, "little"))

    @classmethod
    def from_u64s_le(cls, limbs):
        n = 0
        for i, l in enumerate(limbs):
            n |= int(l) << (64 * i)
        if n >= cls.META.modulus:
            return None
        return cls(n)

    # --- encoding ---------------------------------------------------------
    def to_bytes(self) -> bytes:
        return self.n.to_bytes(self.META.repr_bytes, "little")

    # --- arithmetic -------------------------------------------------------
    def __add__(self, other):
        return type(self)(self.n + other.n)

    def __sub__(self, other):
        return type(self)(self.n - other.n)

    def __mul__(self, other):
        return type(self)(self.n * other.n)

    def __neg__(self):
        return type(self)(-self.n)

    def double(self):
        return type(self)(self.n << 1)

    def square(self):
        return type(self)(self.n * self.n)

    def __pow__(self, e: int):
        return type(self)(pow(self.n, e, self.META.modulus))

    def invert(self):
        """Multiplicative inverse; None for zero (CtOption semantics)."""
        if self.n == 0:
            return None
        return type(self)(pow(self.n, -1, self.META.modulus))

    def is_zero(self) -> bool:
        return self.n == 0

    def is_odd(self) -> bool:
        return bool(self.n & 1)

    def sqrt(self):
        """Tonelli-Shanks square root; None if not a QR.

        Returns the *principal* root computed by the algorithm; callers that
        need the reference's exact sign convention (e.g. point decompression)
        apply their own sign fix, as the jubjub/blstrs crates do.
        """
        M = self.META
        p = M.modulus
        if self.n == 0:
            return type(self)(0)
        if pow(self.n, (p - 1) // 2, p) != 1:
            return None
        if p % 4 == 3:
            return type(self)(pow(self.n, (p + 1) // 4, p))
        # Tonelli-Shanks
        s, q, z = M.ts_s, M.ts_q, M.ts_z
        m = s
        c = pow(z, q, p)
        t = pow(self.n, q, p)
        r = pow(self.n, (q + 1) // 2, p)
        while t != 1:
            t2 = t
            i = 0
            while t2 != 1:
                t2 = (t2 * t2) % p
                i += 1
                if i == m:
                    return None
            b = pow(c, 1 << (m - i - 1), p)
            m = i
            c = (b * b) % p
            t = (t * c) % p
            r = (r * b) % p
        return type(self)(r)

    # --- comparisons / misc ----------------------------------------------
    def __eq__(self, other):
        return type(self) is type(other) and self.n == other.n

    def __hash__(self):
        return hash((self.META.name, self.n))

    def __repr__(self):
        return f"{self.META.name}(0x{self.n:0{self.META.repr_bytes * 2}x})"

    def to_le_bits(self, num_bits: int | None = None):
        nb = num_bits if num_bits is not None else self.META.num_bits
        return [(self.n >> i) & 1 == 1 for i in range(nb)]


# ---------------------------------------------------------------------------
# BLS12-381 scalar field Fr — the circuit field ("bls12_381::Scalar").
# Modulus from the BLS12-381 spec; reference: nam-blstrs (Cargo.lock:1398).
SCALAR_MODULUS = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001


class Scalar(Fp):
    META = FieldMeta("Scalar", SCALAR_MODULUS, 32)


# BLS12-381 base field Fq. Reference: nam-blst (Cargo.lock:1385).
FQ_MODULUS = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB


class Fq(Fp):
    META = FieldMeta("Fq", FQ_MODULUS, 48)

    def to_bytes_be(self) -> bytes:
        """blst G1/G2 serialization uses big-endian coordinates."""
        return self.n.to_bytes(48, "big")

    @classmethod
    def from_bytes_be(cls, b: bytes):
        n = int.from_bytes(b, "big")
        if n >= cls.META.modulus:
            return None
        return cls(n)


# Jubjub scalar field ("jubjub::Fr"), 252 bits. Reference: nam-jubjub
# (Cargo.lock:1437).
JUBJUB_FR_MODULUS = 0x0E7DB4EA6533AFA906673B0101343B00A6682093CCC81082D0970E5ED6F72CB7


class JubjubFr(Fp):
    META = FieldMeta("JubjubFr", JUBJUB_FR_MODULUS, 32)


__all__ = [
    "Fp", "FieldMeta", "Scalar", "Fq", "JubjubFr",
    "SCALAR_MODULUS", "FQ_MODULUS", "JUBJUB_FR_MODULUS",
]
