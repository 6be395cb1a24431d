# Copy of masp_tpu/utils/hashreader.py, verbatim apart from import paths. The port imports nothing of
# masp_tpu.
"""HashReader: pass-through reader computing a BLAKE2b-512 digest + byte
count (masp_proofs/src/hashreader.rs)."""

from __future__ import annotations

import hashlib


class HashReader:
    def __init__(self, inner):
        self.inner = inner
        self._hash = hashlib.blake2b(digest_size=64)
        self.byte_count = 0

    def read(self, n: int = -1) -> bytes:
        data = self.inner.read(n)
        self._hash.update(data)
        self.byte_count += len(data)
        return data

    def into_hash(self) -> str:
        return self._hash.hexdigest()


__all__ = ["HashReader"]
