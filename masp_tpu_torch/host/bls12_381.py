# Copy of masp_tpu/curves/bls12_381.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""Host-exact BLS12-381: Fq2/Fq6/Fq12 tower, G1/G2 groups, optimal-ate pairing.

Replaces the reference's ``nam-blst`` (C + assembly) / ``nam-blstrs`` pairing
engine (SURVEY.md §2.4, Cargo.lock:1385-1413) for the host-side paths:
parameter generation, proof verification, and serialization.  Tower
conventions match zkcrypto/blst:

    Fq2  = Fq [u] / (u^2 + 1)
    Fq6  = Fq2[v] / (v^3 - xi),  xi = u + 1
    Fq12 = Fq6[w] / (w^2 - v)

Point serialization is the zcash/blst format used by bellman's
``Parameters::read`` (masp_proofs/src/lib.rs:336): big-endian coordinates with
flag bits {compressed:0x80, infinity:0x40, y-sign:0x20} in the first byte;
G2 coordinates serialize c1 before c0.

The TPU batch path for G1/G2 MSM lives in masp_tpu.ops; it is validated
against this module.
"""

from __future__ import annotations

from functools import lru_cache

Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter; x < 0 for BLS12-381.
BLS_X = 0xD201000000010000
BLS_X_IS_NEGATIVE = True

_Q_HALF = (Q - 1) // 2


# ---------------------------------------------------------------------------
# Tower fields. Elements store raw ints (mod Q) for speed; these are host-side
# classes used O(thousands) of times per pairing.

class Fq2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % Q
        self.c1 = c1 % Q

    ZERO = None
    ONE = None

    def __add__(self, o):
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o):
        # Karatsuba: (a0 + a1 u)(b0 + b1 u), u^2 = -1
        v0 = self.c0 * o.c0
        v1 = self.c1 * o.c1
        c0 = v0 - v1
        c1 = (self.c0 + self.c1) * (o.c0 + o.c1) - v0 - v1
        return Fq2(c0, c1)

    def square(self):
        # (a + bu)^2 = (a+b)(a-b) + 2ab u
        a, b = self.c0, self.c1
        return Fq2((a + b) * (a - b), 2 * a * b)

    def mul_scalar(self, k: int):
        return Fq2(self.c0 * k, self.c1 * k)

    def mul_by_xi(self):
        # * (1 + u)
        return Fq2(self.c0 - self.c1, self.c0 + self.c1)

    def conjugate(self):
        return Fq2(self.c0, -self.c1)

    def invert(self):
        # 1/(a+bu) = (a-bu)/(a^2+b^2)
        norm = (self.c0 * self.c0 + self.c1 * self.c1) % Q
        if norm == 0:
            return None
        inv = pow(norm, -1, Q)
        return Fq2(self.c0 * inv, -self.c1 * inv)

    def frobenius(self):
        # (a + bu)^q = a - bu  (since q ≡ 3 mod 4)
        return self.conjugate()

    def is_zero(self):
        return self.c0 == 0 and self.c1 == 0

    def sqrt(self):
        """Square root in Fq2 (q ≡ 3 mod 4): Atkin-style algorithm used for
        G2 point decompression."""
        if self.is_zero():
            return Fq2(0, 0)
        # a1 = self^((q-3)/4)
        a1 = self.pow((Q - 3) // 4)
        alpha = a1.square() * self
        x0 = a1 * self
        if alpha.c0 == Q - 1 and alpha.c1 == 0:
            # alpha == -1
            return Fq2(-x0.c1, x0.c0)
        b = (alpha + Fq2(1, 0)).pow(_Q_HALF)
        cand = b * x0
        if cand.square() == self:
            return cand
        return None

    def pow(self, e: int):
        result = Fq2(1, 0)
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def __eq__(self, o):
        return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __repr__(self):
        return f"Fq2(0x{self.c0:x}, 0x{self.c1:x})"


Fq2.ZERO = Fq2(0, 0)
Fq2.ONE = Fq2(1, 0)

XI = Fq2(1, 1)  # u + 1

# Frobenius coefficients: xi^((q^i - 1)/3) and xi^((q^i - 1)/2) etc.
_FROB_C1_6 = [XI.pow((Q**i - 1) // 3) for i in range(6)]  # for Fq6 c1
_FROB_C2_6 = [XI.pow(2 * (Q**i - 1) // 3) for i in range(6)]  # for Fq6 c2
_FROB_12 = [XI.pow((Q**i - 1) // 6) for i in range(12)]  # for Fq12 c1


class Fq6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @staticmethod
    def zero():
        return Fq6(Fq2.ZERO, Fq2.ZERO, Fq2.ZERO)

    @staticmethod
    def one():
        return Fq6(Fq2.ONE, Fq2.ZERO, Fq2.ZERO)

    def __add__(self, o):
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        v0 = a0 * b0
        v1 = a1 * b1
        v2 = a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - v1 - v2).mul_by_xi() + v0
        c1 = (a0 + a1) * (b0 + b1) - v0 - v1 + v2.mul_by_xi()
        c2 = (a0 + a2) * (b0 + b2) - v0 - v2 + v1
        return Fq6(c0, c1, c2)

    def square(self):
        # CH-SQR2 (Chung-Hasan): 2 Fq2 muls + 3 Fq2 squares instead of the
        # generic product's 6 muls — Fq12 complex squaring calls three Fq6
        # products per squaring, so this shaves ~15% off the final-exp hard
        # part (ADVICE round 4).
        a0, a1, a2 = self.c0, self.c1, self.c2
        s0 = a0.square()
        s1 = a0 * a1
        s1 = s1 + s1
        s2 = (a0 - a1 + a2).square()
        s3 = a1 * a2
        s3 = s3 + s3
        s4 = a2.square()
        return Fq6(
            s0 + s3.mul_by_xi(),
            s1 + s4.mul_by_xi(),
            s1 + s2 + s3 - s0 - s4,
        )

    def mul_by_v(self):
        # (c0 + c1 v + c2 v^2) * v = c2 xi + c0 v + c1 v^2
        return Fq6(self.c2.mul_by_xi(), self.c0, self.c1)

    def invert(self):
        a, b, c = self.c0, self.c1, self.c2
        t0 = a.square() - (b * c).mul_by_xi()
        t1 = c.square().mul_by_xi() - a * b
        t2 = b.square() - a * c
        denom = a * t0 + (c * t1).mul_by_xi() + (b * t2).mul_by_xi()
        dinv = denom.invert()
        if dinv is None:
            return None
        return Fq6(t0 * dinv, t1 * dinv, t2 * dinv)

    def frobenius(self):
        return Fq6(
            self.c0.frobenius(),
            self.c1.frobenius() * _FROB_C1_6[1],
            self.c2.frobenius() * _FROB_C2_6[1],
        )

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def __hash__(self):
        return hash((self.c0, self.c1, self.c2))


class Fq12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    @staticmethod
    def zero():
        return Fq12(Fq6.zero(), Fq6.zero())

    @staticmethod
    def one():
        return Fq12(Fq6.one(), Fq6.zero())

    def __add__(self, o):
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o):
        v0 = self.c0 * o.c0
        v1 = self.c1 * o.c1
        c0 = v0 + v1.mul_by_v()
        c1 = (self.c0 + self.c1) * (o.c0 + o.c1) - v0 - v1
        return Fq12(c0, c1)

    def square(self):
        # complex squaring over Fq6: (a + bw)^2 with w^2 = v costs two
        # Fq6 muls instead of the generic three.
        a, b = self.c0, self.c1
        t = a * b
        c0 = (a + b) * (a + b.mul_by_v()) - t - t.mul_by_v()
        return Fq12(c0, t + t)

    def conjugate(self):
        """f^(q^6): negates the w component."""
        return Fq12(self.c0, -self.c1)

    def invert(self):
        # 1/(a + bw) = (a - bw)/(a^2 - b^2 v)
        denom = self.c0.square() - self.c1.square().mul_by_v()
        dinv = denom.invert()
        if dinv is None:
            return None
        return Fq12(self.c0 * dinv, -(self.c1 * dinv))

    def frobenius(self):
        c0 = self.c0.frobenius()
        c1f = self.c1.frobenius()
        coef = _FROB_12[1]
        c1 = Fq6(c1f.c0 * coef, c1f.c1 * coef, c1f.c2 * coef)
        return Fq12(c0, c1)

    def pow(self, e: int):
        result = Fq12.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def is_one(self):
        return self.c0 == Fq6.one() and self.c1.is_zero()

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero()

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))


# w and its inverse powers, for the G2 untwist map.
_W = Fq12(Fq6.zero(), Fq6.one())
_W_INV = _W.invert()
_W2_INV = _W_INV * _W_INV
_W3_INV = _W2_INV * _W_INV


# ---------------------------------------------------------------------------
# Curve points. Generic short-Weierstrass y^2 = x^3 + b over a field class.

class _CurvePoint:
    """Affine point or infinity over field elements supporting the ops above.

    Used for G1 (ints mod Q), G2 (Fq2) and the pairing's E(Fq12).
    Host-side code keeps affine with modular inversion — correctness layer;
    the throughput path is the batched Jacobian JAX implementation in ops/.
    """

    __slots__ = ("x", "y", "inf")

    # subclass config
    B = None
    FIELD_ONE = None

    def __init__(self, x, y, inf=False):
        self.x, self.y, self.inf = x, y, inf

    @classmethod
    def identity(cls):
        return cls(None, None, True)

    @classmethod
    def from_xy(cls, x, y):
        return cls(x, y, False)

    def is_identity(self):
        return self.inf

    def __neg__(self):
        if self.inf:
            return self
        return type(self)(self.x, -self.y, False)

    def __add__(self, o):
        if self.inf:
            return o
        if o.inf:
            return self
        if self.x == o.x:
            if self.y == o.y:
                return self.double()
            return type(self).identity()
        lam = (o.y - self.y) * (o.x - self.x).invert()
        x3 = lam * lam - self.x - o.x
        y3 = lam * (self.x - x3) - self.y
        return type(self)(x3, y3, False)

    def __sub__(self, o):
        return self + (-o)

    def double(self):
        if self.inf:
            return self
        if self.y.is_zero() if hasattr(self.y, "is_zero") else self.y == 0:
            return type(self).identity()
        three_x2 = self.x * self.x
        three_x2 = three_x2 + three_x2 + three_x2
        lam = three_x2 * (self.y + self.y).invert()
        x3 = lam * lam - self.x - self.x
        y3 = lam * (self.x - x3) - self.y
        return type(self)(x3, y3, False)

    def _mul_int_affine(self, k: int):
        """Reference oracle: double-and-add in affine coordinates (one
        field inversion per point op). Kept for the Jacobian-path test."""
        if k < 0:
            return (-self)._mul_int_affine(-k)
        acc = type(self).identity()
        p = self
        while k:
            if k & 1:
                acc = acc + p
            p = p.double()
            k >>= 1
        return acc

    def mul_int(self, k: int):
        """Scalar multiplication in Jacobian coordinates (a = 0 curves):
        no per-op field inversion, one inversion at the end. Output
        checked against _mul_int_affine in tests."""
        return type(self).multi_scalar_mul([self], [k])

    @classmethod
    def multi_scalar_mul(cls, points, scalars):
        """sum_i k_i P_i with ONE shared Jacobian doubling chain across
        all terms and one final inversion — the host verifier's small-n
        multi-exp (the big MSMs live on-device, ops/msm_sorted.py)."""
        bases = []
        for p, k in zip(points, scalars):
            if k < 0:
                p, k = -p, -k
            if k == 0 or p.inf:
                continue
            bases.append((p.x, p.y, k))
        if not bases:
            return cls.identity()
        nbits = max(k.bit_length() for (_, _, k) in bases)
        X = Y = Z = None  # Jacobian accumulator; None = identity
        for i in range(nbits - 1, -1, -1):
            if X is not None:
                acc = _jac_double(X, Y, Z)
                X, Y, Z = acc if acc is not None else (None, None, None)
            for (x2, y2, k) in bases:
                if (k >> i) & 1:
                    if X is None:
                        X, Y, Z = x2, y2, _field_one_like(x2)
                    else:
                        acc = _jac_madd(X, Y, Z, x2, y2)
                        X, Y, Z = acc if acc is not None else (None, None, None)
        if X is None:
            return cls.identity()
        zi = Z.invert()
        zi2 = zi * zi
        return cls(X * zi2, Y * zi2 * zi, False)

    def __mul__(self, k: int):
        return self.mul_int(k)

    __rmul__ = __mul__

    def __eq__(self, o):
        if self.inf or o.inf:
            return self.inf and o.inf
        return self.x == o.x and self.y == o.y

    def __hash__(self):
        if self.inf:
            return hash("inf")
        return hash((self.x, self.y))


class _FqElt:
    """Minimal wrapper giving raw ints the interface _CurvePoint needs."""
    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n % Q

    def __add__(self, o):
        return _FqElt(self.n + o.n)

    def __sub__(self, o):
        return _FqElt(self.n - o.n)

    def __neg__(self):
        return _FqElt(-self.n)

    def __mul__(self, o):
        return _FqElt(self.n * o.n)

    def invert(self):
        return _FqElt(pow(self.n, -1, Q))

    def is_zero(self):
        return self.n == 0

    def __eq__(self, o):
        return isinstance(o, _FqElt) and self.n == o.n

    def __hash__(self):
        return hash(self.n)


def _field_one_like(x):
    """Multiplicative one of x's coordinate field (for Jacobian Z = 1)."""
    if isinstance(x, _FqElt):
        return _FqElt(1)
    if isinstance(x, Fq2):
        return Fq2(1, 0)
    return Fq12.one()


def _jac_double(XYZ_x, XYZ_y, XYZ_z):
    """Jacobian doubling on y² = x³ + b (a = 0): EFD dbl-2009-l.
    Returns None for the identity (y = 0, i.e. 2-torsion)."""
    X, Y, Z = XYZ_x, XYZ_y, XYZ_z
    if Y.is_zero():
        return None
    A = X * X
    B = Y * Y
    C = B * B
    t = X + B
    D = t * t - A - C
    D = D + D
    E = A + A + A
    F = E * E
    X3 = F - D - D
    C8 = C + C
    C8 = C8 + C8
    C8 = C8 + C8
    Y3 = E * (D - X3) - C8
    Z3 = (Y + Y) * Z
    return X3, Y3, Z3


def _jac_madd(X, Y, Z, x2, y2):
    """Mixed addition: Jacobian (X, Y, Z) + affine (x2, y2).
    Returns None for the identity result (P + (-P))."""
    Z1Z1 = Z * Z
    U2 = x2 * Z1Z1
    S2 = y2 * Z * Z1Z1
    H = U2 - X
    r = S2 - Y
    if H.is_zero():
        if r.is_zero():
            return _jac_double(X, Y, Z)
        return None
    HH = H * H
    HHH = H * HH
    V = X * HH
    X3 = r * r - HHH - V - V
    Y3 = r * (V - X3) - Y * HHH
    Z3 = Z * H
    return X3, Y3, Z3


class G1(_CurvePoint):
    """E(Fq): y^2 = x^3 + 4."""
    B = _FqElt(4)

    @staticmethod
    def generator() -> "G1":
        return G1.from_xy(
            _FqElt(0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB),
            _FqElt(0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1),
        )

    def is_on_curve(self) -> bool:
        if self.inf:
            return True
        return self.y * self.y == self.x * self.x * self.x + G1.B

    def is_torsion_free(self) -> bool:
        return self.mul_int(R).is_identity()

    # --- zcash/blst serialization ---
    def to_compressed(self) -> bytes:
        if self.inf:
            return bytes([0xC0] + [0] * 47)
        b = bytearray(self.x.n.to_bytes(48, "big"))
        b[0] |= 0x80
        if self.y.n > _Q_HALF:
            b[0] |= 0x20
        return bytes(b)

    def to_uncompressed(self) -> bytes:
        if self.inf:
            return bytes([0x40] + [0] * 95)
        return self.x.n.to_bytes(48, "big") + self.y.n.to_bytes(48, "big")

    @staticmethod
    def from_uncompressed(data: bytes, check_curve: bool = True) -> "G1 | None":
        assert len(data) == 96
        flags = data[0]
        if flags & 0x80:
            return None  # compression bit set on uncompressed encoding
        if flags & 0x40:
            if any(b for b in bytes([flags & 0x3F]) + data[1:]):
                return None
            return G1.identity()
        if flags & 0x20:
            return None
        x = int.from_bytes(data[:48], "big")
        y = int.from_bytes(data[48:], "big")
        if x >= Q or y >= Q:
            return None
        p = G1.from_xy(_FqElt(x), _FqElt(y))
        if check_curve and not p.is_on_curve():
            return None
        return p

    @staticmethod
    def from_compressed(data: bytes, check_subgroup: bool = True) -> "G1 | None":
        assert len(data) == 48
        flags = data[0]
        if not flags & 0x80:
            return None
        infinity = bool(flags & 0x40)
        sort = bool(flags & 0x20)
        x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
        if infinity:
            if sort or x != 0:
                return None
            return G1.identity()
        if x >= Q:
            return None
        y2 = (x * x % Q * x + 4) % Q
        y = pow(y2, (Q + 1) // 4, Q)
        if y * y % Q != y2:
            return None
        if (y > _Q_HALF) != sort:
            y = Q - y
        p = G1.from_xy(_FqElt(x), _FqElt(y))
        if check_subgroup and not p.is_torsion_free():
            return None
        return p


class G2(_CurvePoint):
    """E'(Fq2): y^2 = x^3 + 4(u+1) — the M-twist used by blst."""
    B = XI.mul_scalar(4)

    @staticmethod
    def generator() -> "G2":
        return G2.from_xy(
            Fq2(
                0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
                0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
            ),
            Fq2(
                0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
                0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
            ),
        )

    def is_on_curve(self) -> bool:
        if self.inf:
            return True
        return self.y.square() == self.x.square() * self.x + G2.B

    def is_torsion_free(self) -> bool:
        return self.mul_int(R).is_identity()

    def to_uncompressed(self) -> bytes:
        if self.inf:
            return bytes([0x40] + [0] * 191)
        return (
            self.x.c1.to_bytes(48, "big") + self.x.c0.to_bytes(48, "big")
            + self.y.c1.to_bytes(48, "big") + self.y.c0.to_bytes(48, "big")
        )

    def to_compressed(self) -> bytes:
        if self.inf:
            return bytes([0xC0] + [0] * 95)
        b = bytearray(self.x.c1.to_bytes(48, "big") + self.x.c0.to_bytes(48, "big"))
        b[0] |= 0x80
        # y lexicographically largest: compare (c1, c0)
        if (self.y.c1, self.y.c0) > (Q - self.y.c1 if self.y.c1 else 0,
                                     Q - self.y.c0 if self.y.c0 else 0):
            b[0] |= 0x20
        return bytes(b)

    @staticmethod
    def from_uncompressed(data: bytes, check_curve: bool = True) -> "G2 | None":
        assert len(data) == 192
        flags = data[0]
        if flags & 0x80:
            return None
        if flags & 0x40:
            if any(bytes([flags & 0x3F]) + data[1:]):
                return None
            return G2.identity()
        if flags & 0x20:
            return None
        xc1 = int.from_bytes(data[0:48], "big")
        xc0 = int.from_bytes(data[48:96], "big")
        yc1 = int.from_bytes(data[96:144], "big")
        yc0 = int.from_bytes(data[144:192], "big")
        if max(xc1, xc0, yc1, yc0) >= Q:
            return None
        p = G2.from_xy(Fq2(xc0, xc1), Fq2(yc0, yc1))
        if check_curve and not p.is_on_curve():
            return None
        return p

    @staticmethod
    def from_compressed(data: bytes, check_subgroup: bool = True) -> "G2 | None":
        assert len(data) == 96
        flags = data[0]
        if not flags & 0x80:
            return None
        infinity = bool(flags & 0x40)
        sort = bool(flags & 0x20)
        xc1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
        xc0 = int.from_bytes(data[48:96], "big")
        if infinity:
            if sort or xc1 or xc0:
                return None
            return G2.identity()
        if xc1 >= Q or xc0 >= Q:
            return None
        x = Fq2(xc0, xc1)
        y = (x.square() * x + G2.B).sqrt()
        if y is None:
            return None
        neg = Fq2(-y.c0, -y.c1)
        is_largest = (y.c1, y.c0) > (neg.c1, neg.c0)
        if is_largest != sort:
            y = neg
        p = G2.from_xy(x, y)
        if check_subgroup and not p.is_torsion_free():
            return None
        return p


class _E12(_CurvePoint):
    """E(Fq12): y^2 = x^3 + 4, home of untwisted G2 points for the pairing."""
    pass


def _untwist(q: G2) -> _E12:
    """psi: E'(Fq2) -> E(Fq12), (x, y) -> (x / w^2, y / w^3)."""
    x6 = Fq6(q.x, Fq2.ZERO, Fq2.ZERO)
    y6 = Fq6(q.y, Fq2.ZERO, Fq2.ZERO)
    X = Fq12(x6, Fq6.zero()) * _W2_INV
    Y = Fq12(y6, Fq6.zero()) * _W3_INV
    return _E12.from_xy(X, Y)


def _embed_g1(p: G1) -> tuple[Fq12, Fq12]:
    def lift(n: int) -> Fq12:
        return Fq12(Fq6(Fq2(n, 0), Fq2.ZERO, Fq2.ZERO), Fq6.zero())
    return lift(p.x.n), lift(p.y.n)


def _line(T: _E12, S: _E12, px: Fq12, py: Fq12) -> Fq12:
    """Evaluate the line through T and S (or the tangent when T == S) at
    the embedded G1 point (px, py)."""
    if T.x == S.x and T.y == S.y:
        three_x2 = T.x * T.x
        three_x2 = three_x2 + three_x2 + three_x2
        lam = three_x2 * (T.y + T.y).invert()
    else:
        lam = (S.y - T.y) * (S.x - T.x).invert()
    return py - T.y - lam * (px - T.x)


def _multi_miller_loop_untwisted(pairs: list[tuple[G1, G2]]) -> Fq12:
    """Reference oracle: the loop over untwisted E(Fq12) points with full
    Fq12 point arithmetic. Kept for the equality test against the fast
    twisted-coordinate loop below."""
    pairs = [
        (_embed_g1(p), _untwist(q))
        for (p, q) in pairs
        if not (p.is_identity() or q.is_identity())
    ]
    if not pairs:
        return Fq12.one()
    f = Fq12.one()
    Ts = [q for (_, q) in pairs]
    bits = bin(BLS_X)[3:]  # skip the leading 1
    for bit in bits:
        f = f * f
        for i, ((px, py), q) in enumerate(pairs):
            f = f * _line(Ts[i], Ts[i], px, py)
            Ts[i] = Ts[i].double()
        if bit == "1":
            for i, ((px, py), q) in enumerate(pairs):
                f = f * _line(Ts[i], q, px, py)
                Ts[i] = Ts[i] + q
    if BLS_X_IS_NEGATIVE:
        f = f.conjugate()
    return f


class DegeneratePairingInput(ValueError):
    """A Miller-loop slope denominator vanished: some input point is not
    in the order-r subgroup (a small-order/2-torsion G2 point can make
    2y_T or x_Q - x_T zero mid-ladder; unreachable for subgroup-checked
    inputs). Verifiers catch this and return False — the reference's blst
    projective Miller loop never divides and cannot panic, so a crash here
    would be a behavioral regression (ADVICE round 4)."""


def _batch_inv_fq2(xs: list[Fq2]) -> list[Fq2]:
    """Montgomery's trick: n Fq2 inversions for one Fq inversion + 3(n-1)
    Fq2 muls. Raises DegeneratePairingInput on a zero input."""
    n = len(xs)
    prefix = [None] * n
    acc = Fq2(1, 0)
    for i, x in enumerate(xs):
        prefix[i] = acc
        acc = acc * x
    inv = acc.invert()
    if inv is None:
        raise DegeneratePairingInput(
            "zero slope denominator: pairing input outside the r-order "
            "subgroup"
        )
    out = [None] * n
    for i in range(n - 1, -1, -1):
        out[i] = inv * prefix[i]
        inv = inv * xs[i]
    return out


def _mul_by_line(f: Fq12, A: Fq2, B: Fq2, C: Fq2) -> Fq12:
    """f × (A + B·vw + C·v²w) — the sparse Fq12 shape every Miller line
    takes (device twin: ops/pairing_jax.py _line_fq12). 15 Fq2 muls via
    Karatsuba over w instead of the generic 18."""
    f0, f1 = f.c0, f.c1
    # f0 · (A, 0, 0): coefficient-wise scale
    v0 = Fq6(f0.c0 * A, f0.c1 * A, f0.c2 * A)
    # f1 · (0, B, C): (a0 + a1 v + a2 v²)(B v + C v²), v³ = ξ
    a0, a1, a2 = f1.c0, f1.c1, f1.c2
    v1 = Fq6(
        (a1 * C + a2 * B).mul_by_xi(),
        a0 * B + (a2 * C).mul_by_xi(),
        a0 * C + a1 * B,
    )
    mid = (f0 + f1) * Fq6(A, B, C) - v0 - v1
    return Fq12(v0 + v1.mul_by_v(), mid)


@lru_cache(maxsize=1)
def _xi_inv() -> Fq2:
    inv = XI.invert()
    assert inv is not None
    return inv


def multi_miller_loop(pairs: list[tuple[G1, G2]]) -> Fq12:
    """Product of Miller loops for the given (P, Q) pairs — the batched form
    the Groth16 verifier wants (one shared squaring chain).

    Fast path: T stays in affine Fq2 on the twist E'; the line through the
    untwisted points evaluated at embedded (px, py) is the sparse element
    p_y + (λ'x_T − y_T)ξ⁻¹·vw − λ'p_x ξ⁻¹·v²w  (λ = λ'w⁻¹ under the
    untwist — same derivation as the device loop, ops/pairing_jax.py
    _slope_lines), multiplied in sparsely. Per-step slope denominators are
    inverted once across all pairs with Montgomery's trick. Bit-identical
    to the untwisted-E(Fq12) oracle (_multi_miller_loop_untwisted), which
    the test suite pins."""
    live = [(p, q) for (p, q) in pairs if not (p.is_identity() or q.is_identity())]
    if not live:
        return Fq12.one()
    xi_inv = _xi_inv()
    Ps = [(p.x.n, p.y.n) for (p, _) in live]
    Qs = [(q.x, q.y) for (_, q) in live]
    Ts = list(Qs)
    f = Fq12.one()
    bits = bin(BLS_X)[3:]  # skip the leading 1
    for bit in bits:
        f = f.square()
        # tangent lines: λ' = 3x² / 2y, one batched inversion for all pairs
        invs = _batch_inv_fq2([Fq2(2 * ty.c0, 2 * ty.c1) for (_, ty) in Ts])
        for i, (tx, ty) in enumerate(Ts):
            x2 = tx.square()
            lam = (x2 + x2 + x2) * invs[i]
            px, py = Ps[i]
            f = _mul_by_line(
                f, Fq2(py, 0), (lam * tx - ty) * xi_inv,
                (-lam).mul_scalar(px) * xi_inv,
            )
            x3 = lam.square() - tx - tx
            Ts[i] = (x3, lam * (tx - x3) - ty)
        if bit == "1":
            # chord lines through T and Q: λ' = (y_Q − y_T)/(x_Q − x_T)
            invs = _batch_inv_fq2([Qs[i][0] - Ts[i][0] for i in range(len(Ts))])
            for i, (tx, ty) in enumerate(Ts):
                qx, qy = Qs[i]
                lam = (qy - ty) * invs[i]
                px, py = Ps[i]
                f = _mul_by_line(
                    f, Fq2(py, 0), (lam * tx - ty) * xi_inv,
                    (-lam).mul_scalar(px) * xi_inv,
                )
                x3 = lam.square() - tx - qx
                Ts[i] = (x3, lam * (tx - x3) - ty)
    if BLS_X_IS_NEGATIVE:
        f = f.conjugate()
    return f


def _cyc_pow(g: Fq12, e: int) -> Fq12:
    """g^e for g in the cyclotomic subgroup, where inversion is free:
    g^(q^6+1) = 1 after the easy part, so g^-1 = conjugate(g)."""
    if e < 0:
        g, e = g.conjugate(), -e
    result = Fq12.one()
    base = g
    while e:
        if e & 1:
            result = result * base
        base = base.square()
        e >>= 1
    return result


def _easy_part(f: Fq12) -> Fq12:
    """f^((q^6 - 1)(q^2 + 1)) — lands f in the cyclotomic subgroup."""
    f1 = f.conjugate()  # f^(q^6)
    f2 = f.invert()
    assert f2 is not None
    f = f1 * f2
    return f.frobenius().frobenius() * f


def final_exponentiation(f: Fq12) -> Fq12:
    """f^((q^12 - 1) / r), exact value (NOT the f^(3d) shortcut some
    libraries use — keeps bit-equality with the device pairing and any
    pinned vectors).

    Hard part d = (q^4 - q^2 + 1)/r via the curve-parameter chain
    (u = -BLS_X, m = (u-1)/3; identity checked exactly in
    tests/test_bls12_381.py):

        d = m * (u-1) * (u + q) * (u^2 + q^2 - 1) + 1

    where q-powers are Frobenius maps and cyclotomic inverses are
    conjugations — ~330 squarings + ~35 muls instead of the naive
    1523-bit square-and-multiply (~6x fewer Fq12 ops)."""
    g = _easy_part(f)
    u = -BLS_X
    t = _cyc_pow(g, (u - 1) // 3)
    t = _cyc_pow(t, u - 1)
    t = _cyc_pow(t, u) * t.frobenius()  # ^(u + q)
    # ^(u^2 + q^2 - 1)
    t = _cyc_pow(_cyc_pow(t, u), u) * t.frobenius().frobenius() * t.conjugate()
    return t * g


def _final_exponentiation_naive(f: Fq12) -> Fq12:
    """Reference oracle: hard part by direct exponentiation with the
    exact integer exponent. Kept for the chain-equality test."""
    d = (Q**4 - Q**2 + 1) // R
    return _easy_part(f).pow(d)


def pairing(p: G1, q: G2) -> Fq12:
    return final_exponentiation(multi_miller_loop([(p, q)]))


def pairing_product_is_one(pairs: list[tuple[G1, G2]]) -> bool:
    """prod e(P_i, Q_i) == 1 — the form all Groth16 checks reduce to.
    Degenerate (out-of-subgroup) inputs verify as False, never crash."""
    try:
        ml = multi_miller_loop(pairs)
    except DegeneratePairingInput:
        return False
    return final_exponentiation(ml).is_one()


__all__ = [
    "Q", "R", "BLS_X", "Fq2", "Fq6", "Fq12", "G1", "G2", "XI",
    "multi_miller_loop", "final_exponentiation", "pairing",
    "pairing_product_is_one", "DegeneratePairingInput",
]
