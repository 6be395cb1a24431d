# Copy of masp_tpu/primitives/blake2.py, verbatim apart from import paths. The port imports nothing of
# masp_tpu.
"""BLAKE2s/BLAKE2b with personalization — all MASP PRFs/KDFs/digests.

The reference uses blake2{s,b}_simd (SURVEY.md §2.4); Python's hashlib exposes
the same keyed/personalized BLAKE2 natively (C implementation), so the host
side needs no custom native code.  Batched witness-side BLAKE2s for nullifier
computation lives in masp_tpu.ops.blake2s_jax.
"""

from __future__ import annotations

import hashlib


def blake2s(data: bytes = b"", *, personal: bytes = b"", digest_size: int = 32) -> bytes:
    h = hashlib.blake2s(digest_size=digest_size, person=personal)
    h.update(data)
    return h.digest()


def blake2b(data: bytes = b"", *, personal: bytes = b"", digest_size: int = 64) -> bytes:
    h = hashlib.blake2b(digest_size=digest_size, person=personal)
    h.update(data)
    return h.digest()


class Blake2sState:
    """Incremental BLAKE2s mirroring blake2s_simd::State."""

    def __init__(self, personal: bytes = b"", digest_size: int = 32):
        self._h = hashlib.blake2s(digest_size=digest_size, person=personal)

    def update(self, data: bytes) -> "Blake2sState":
        self._h.update(data)
        return self

    def finalize(self) -> bytes:
        return self._h.digest()


class Blake2bState:
    """Incremental BLAKE2b mirroring blake2b_simd::State."""

    def __init__(self, personal: bytes = b"", digest_size: int = 64):
        self._h = hashlib.blake2b(digest_size=digest_size, person=personal)

    def update(self, data: bytes) -> "Blake2bState":
        self._h.update(data)
        return self

    def finalize(self) -> bytes:
        return self._h.digest()


__all__ = ["blake2s", "blake2b", "Blake2sState", "Blake2bState"]
