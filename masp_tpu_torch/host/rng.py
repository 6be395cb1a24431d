# Copy of masp_tpu/utils/rng.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""RNG adapters.

``OsRng`` mirrors the reference's rand_core OsRng; ``XorShiftRng`` reproduces
the rand_xorshift crate bit-for-bit so the reference's fixed-seed tests
(SURVEY.md §4.4, seeds like [0x58/0x59, 0x62, ...]) can be replayed exactly.
"""

from __future__ import annotations

import os


class OsRng:
    def fill_bytes(self, n: int) -> bytes:
        return os.urandom(n)

    def next_u64(self) -> int:
        return int.from_bytes(os.urandom(8), "little")


class XorShiftRng:
    """xorshift128 as implemented by the rand_xorshift crate."""

    def __init__(self, seed: bytes):
        assert len(seed) == 16
        self.x = int.from_bytes(seed[0:4], "little")
        self.y = int.from_bytes(seed[4:8], "little")
        self.z = int.from_bytes(seed[8:12], "little")
        self.w = int.from_bytes(seed[12:16], "little")

    @classmethod
    def from_seed(cls, seed) -> "XorShiftRng":
        return cls(bytes(seed))

    def next_u32(self) -> int:
        M = 0xFFFFFFFF
        x = self.x
        t = (x ^ (x << 11)) & M
        self.x, self.y, self.z = self.y, self.z, self.w
        w = self.w
        self.w = (w ^ (w >> 19) ^ t ^ (t >> 8)) & M
        return self.w

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)

    def fill_bytes(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            out += self.next_u32().to_bytes(4, "little")
        return bytes(out[:n])


def random_jubjub_fr(rng):
    """``jubjub::Fr::random``: wide reduction of 64 random bytes."""
    from masp_tpu_torch.host.fields import JubjubFr

    return JubjubFr.from_bytes_wide(rng.fill_bytes(64))


def random_scalar(rng):
    """``bls12_381::Scalar::random``."""
    from masp_tpu_torch.host.fields import Scalar

    return Scalar.from_bytes_wide(rng.fill_bytes(64))


__all__ = ["OsRng", "XorShiftRng", "random_jubjub_fr", "random_scalar"]
