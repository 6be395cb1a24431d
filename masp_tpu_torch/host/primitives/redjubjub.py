# Copy of masp_tpu/primitives/redjubjub.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""RedJubjub (RedDSA over Jubjub) with MASP personalization.

Mirrors masp_primitives/src/sapling/redjubjub.rs: personalization
"MASP__RedJubjubH", sign with 80 random bytes, cofactor-multiplied verify with
the ZIP-216 toggle, and randomized-linear-combination batch verification.

The batch path reduces to one Jubjub MSM (SURVEY.md §2.4 nam-redjubjub row);
the TPU batched version lives in masp_tpu.ops.jubjub_jax.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from masp_tpu_torch.host.jubjub import ExtendedPoint
from masp_tpu_torch.host.fields import JubjubFr
from masp_tpu_torch.host.rng import random_jubjub_fr

RED_JUBJUB_PERSONALIZATION = b"MASP__RedJubjubH"


def hash_to_scalar(persona: bytes, a: bytes, b: bytes) -> JubjubFr:
    h = hashlib.blake2b(digest_size=64, person=persona)
    h.update(a)
    h.update(b)
    return JubjubFr.from_bytes_wide(h.digest())


def h_star(a: bytes, b: bytes) -> JubjubFr:
    return hash_to_scalar(RED_JUBJUB_PERSONALIZATION, a, b)


@dataclass(frozen=True)
class Signature:
    rbar: bytes
    sbar: bytes

    def __post_init__(self):
        if len(self.rbar) != 32 or len(self.sbar) != 32:
            raise ValueError("signature halves must be 32 bytes each")

    def to_bytes(self) -> bytes:
        return self.rbar + self.sbar

    @staticmethod
    def from_bytes(b: bytes) -> "Signature":
        if len(b) != 64:
            raise ValueError("signature must be 64 bytes")
        return Signature(b[0:32], b[32:64])


class PrivateKey:
    __slots__ = ("fr",)

    def __init__(self, fr: JubjubFr):
        self.fr = fr

    def randomize(self, alpha: JubjubFr) -> "PrivateKey":
        return PrivateKey(self.fr + alpha)

    def to_bytes(self) -> bytes:
        return self.fr.to_bytes()

    @staticmethod
    def from_bytes(b: bytes) -> "PrivateKey":
        fr = JubjubFr.from_bytes(b)
        if fr is None:
            raise ValueError("scalar is not in field")
        return PrivateKey(fr)

    def sign(self, msg: bytes, rng, p_g: ExtendedPoint) -> Signature:
        t = rng.fill_bytes(80)
        r = h_star(t, msg)
        rbar = (p_g * r).to_bytes()
        s = h_star(rbar, msg) * self.fr + r
        return Signature(rbar, s.to_bytes())


class PublicKey:
    __slots__ = ("point",)

    def __init__(self, point: ExtendedPoint):
        self.point = point

    @staticmethod
    def from_private(privkey: PrivateKey, p_g: ExtendedPoint) -> "PublicKey":
        return PublicKey(p_g * privkey.fr)

    def randomize(self, alpha: JubjubFr, p_g: ExtendedPoint) -> "PublicKey":
        return PublicKey(p_g * alpha + self.point)

    def to_bytes(self) -> bytes:
        return self.point.to_bytes()

    def __eq__(self, other) -> bool:
        if not isinstance(other, PublicKey):
            return NotImplemented
        return self.point == other.point

    def __hash__(self):
        return hash(("redjubjub-pk", self.to_bytes()))

    @staticmethod
    def from_bytes(b: bytes) -> "PublicKey":
        p = ExtendedPoint.from_bytes(b)
        if p is None:
            raise ValueError("invalid RedJubjub public key")
        return PublicKey(p)

    def verify(self, msg: bytes, sig: Signature, p_g: ExtendedPoint) -> bool:
        return self.verify_with_zip216(msg, sig, p_g, True)

    def verify_with_zip216(
        self, msg: bytes, sig: Signature, p_g: ExtendedPoint, zip216_enabled: bool
    ) -> bool:
        c = h_star(sig.rbar, msg)
        if zip216_enabled:
            r = ExtendedPoint.from_bytes(sig.rbar)
        else:
            r = ExtendedPoint.from_bytes_pre_zip216(sig.rbar)
        if r is None:
            return False
        s = JubjubFr.from_bytes(sig.sbar)
        if s is None:
            return False
        # 0 == h_G(-S . P_G + R + c . vk)
        return ((self.point * c) + r - (p_g * s)).mul_by_cofactor().is_identity()


@dataclass
class BatchEntry:
    vk: PublicKey
    msg: bytes
    sig: Signature


def batch_verify(
    rng, batch: list[BatchEntry], p_g: ExtendedPoint,
    use_device: bool | None = None,
) -> bool:
    """Random-z linear combination: h_G(sum z_i(R_i + c_i vk_i - s_i P_G)) == 0
    (redjubjub.rs:240-275).

    use_device (default: env MASP_DEVICE_REDJUBJUB=1) evaluates the linear
    combination as one device Jubjub MSM with batched R decompression
    (ops/jubjub_jax.py) — worthwhile for node-side validation batches;
    the host loop wins for a handful of signatures."""
    if use_device is None:
        import os

        use_device = os.environ.get("MASP_DEVICE_REDJUBJUB") == "1"
    if use_device:
        from masp_tpu_torch.ops.jubjub import batch_verify_device

        return batch_verify_device(rng, batch, p_g)
    acc = ExtendedPoint.identity()
    for entry in batch:
        r = ExtendedPoint.from_bytes(entry.sig.rbar)
        if r is None:
            return False
        s = JubjubFr.from_bytes(entry.sig.sbar)
        if s is None:
            return False
        c = h_star(entry.sig.rbar, entry.msg)
        z = random_jubjub_fr(rng)
        s = -(s * z)
        r = r * z
        c = c * z
        acc = acc + r + (entry.vk.point * c) + (p_g * s)
    return acc.mul_by_cofactor().is_identity()


__all__ = [
    "RED_JUBJUB_PERSONALIZATION", "hash_to_scalar", "h_star", "Signature",
    "PrivateKey", "PublicKey", "BatchEntry", "batch_verify",
]
