# Copy of masp_tpu/primitives/ff1.py, verbatim apart from import paths; its cipher imports name
# masp_tpu_torch/host/crypto.py, the port's own ChaCha20-Poly1305 and AES. The port imports nothing of
# masp_tpu.
"""FF1 format-preserving encryption (NIST SP 800-38G), radix 2, AES-256.

Replaces the reference's fpe crate (SURVEY.md §2.4) for ZIP-32 diversifier
derivation. Numeral convention matches fpe's BinaryNumeralString: bits taken
little-endian per byte, numeral 0 most significant in NUM/STR.
"""

from __future__ import annotations

from masp_tpu_torch.host.crypto import Cipher, algorithms, modes


class FF1Radix2:
    def __init__(self, key: bytes):
        assert len(key) == 32
        self._aes = Cipher(algorithms.AES(key), modes.ECB())

    def _ciph(self, block: bytes) -> bytes:
        enc = self._aes.encryptor()
        return enc.update(block) + enc.finalize()

    def _prf(self, data: bytes) -> bytes:
        assert len(data) % 16 == 0
        y = b"\x00" * 16
        for i in range(0, len(data), 16):
            y = self._ciph(bytes(a ^ b for a, b in zip(y, data[i : i + 16])))
        return y

    @staticmethod
    def _bits_from_bytes_le(data: bytes) -> list[int]:
        return [(b >> i) & 1 for b in data for i in range(8)]

    @staticmethod
    def _bits_to_bytes_le(bits: list[int]) -> bytes:
        assert len(bits) % 8 == 0
        out = bytearray(len(bits) // 8)
        for i, bit in enumerate(bits):
            if bit:
                out[i // 8] |= 1 << (i % 8)
        return bytes(out)

    @staticmethod
    def _num(bits: list[int]) -> int:
        x = 0
        for b in bits:
            x = (x << 1) | b
        return x

    @staticmethod
    def _str(x: int, m: int) -> list[int]:
        return [(x >> (m - 1 - i)) & 1 for i in range(m)]

    def _setup(self, tweak: bytes, n: int):
        t = len(tweak)
        u = n // 2
        v = n - u
        b = (v + 7) // 8  # ceil(v * log2(2) / 8)
        d = 4 * ((b + 3) // 4) + 4
        P = (
            bytes([1, 2, 1])
            + (2).to_bytes(3, "big")
            + bytes([10, u % 256])
            + n.to_bytes(4, "big")
            + t.to_bytes(4, "big")
        )
        pad = (-t - b - 1) % 16
        return t, u, v, b, d, P, pad

    def _round_y(self, P, tweak, pad, i, b, d, num_bits) -> int:
        Q = tweak + b"\x00" * pad + bytes([i]) + self._num(num_bits).to_bytes(b, "big")
        R = self._prf(P + Q)
        S = R
        j = 1
        while len(S) < d:
            blk = bytes(x ^ y for x, y in zip(R, j.to_bytes(16, "big")))
            S += self._ciph(blk)
            j += 1
        return int.from_bytes(S[:d], "big")

    def encrypt_bytes_le(self, tweak: bytes, data: bytes) -> bytes:
        bits = self._bits_from_bytes_le(data)
        n = len(bits)
        t, u, v, b, d, P, pad = self._setup(tweak, n)
        A, B = bits[:u], bits[u:]
        for i in range(10):
            y = self._round_y(P, tweak, pad, i, b, d, B)
            m = u if i % 2 == 0 else v
            c = (self._num(A) + y) % (1 << m)
            A, B = B, self._str(c, m)
        return self._bits_to_bytes_le(A + B)

    def decrypt_bytes_le(self, tweak: bytes, data: bytes) -> bytes:
        bits = self._bits_from_bytes_le(data)
        n = len(bits)
        t, u, v, b, d, P, pad = self._setup(tweak, n)
        A, B = bits[:u], bits[u:]
        for i in range(9, -1, -1):
            y = self._round_y(P, tweak, pad, i, b, d, A)
            m = u if i % 2 == 0 else v
            c = (self._num(B) - y) % (1 << m)
            A, B = self._str(c, m), A
        return self._bits_to_bytes_le(A + B)


__all__ = ["FF1Radix2"]
