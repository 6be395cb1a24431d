# Copy of masp_tpu/primitives/zip339.py, verbatim apart from import paths. The port imports nothing of
# masp_tpu.
"""ZIP-339 (BIP-39) mnemonic phrases (masp_primitives/src/zip339.rs, which
re-exports the bip0039 crate).

Full algorithm: entropy <-> mnemonic with SHA-256 checksum bits, NFKD
normalization, PBKDF2-HMAC-SHA512 seed derivation (2048 rounds).

The standard 2048-word English wordlist is an external data artifact (this
build environment has no network egress); place it at
``masp_tpu/primitives/data/bip39-english.txt`` — its SHA-256 is pinned to
the official list.
"""

from __future__ import annotations

import hashlib
import pathlib
import unicodedata

ENGLISH_WORDLIST_SHA256 = (
    "2f5eed53a4727b4bf8880d8f3f199efc90e58503646d9ff8eff3a2ed3b24dbda"
)
_WORDLIST_PATH = pathlib.Path(__file__).parent / "data" / "bip39-english.txt"


class MnemonicError(Exception):
    pass


def _load_wordlist() -> list[str]:
    if not _WORDLIST_PATH.exists():
        raise MnemonicError(
            f"BIP-39 English wordlist not found at {_WORDLIST_PATH}; fetch the "
            "official list (sha256 "
            f"{ENGLISH_WORDLIST_SHA256}) to enable mnemonic support"
        )
    data = _WORDLIST_PATH.read_bytes()
    if hashlib.sha256(data).hexdigest() != ENGLISH_WORDLIST_SHA256:
        raise MnemonicError("wordlist hash mismatch — not the official BIP-39 list")
    words = data.decode("utf-8").split()
    if len(words) != 2048:
        raise MnemonicError("wordlist must contain 2048 words")
    return words


class Mnemonic:
    """A validated BIP-39 mnemonic phrase."""

    def __init__(self, phrase: str, wordlist: list[str] | None = None):
        self.wordlist = wordlist or _load_wordlist()
        self.phrase = unicodedata.normalize("NFKD", phrase.strip())
        self.entropy = self._validate(self.phrase)

    @classmethod
    def from_entropy(cls, entropy: bytes, wordlist: list[str] | None = None) -> "Mnemonic":
        if len(entropy) not in (16, 20, 24, 28, 32):
            raise MnemonicError("entropy must be 128..256 bits in 32-bit steps")
        words = wordlist or _load_wordlist()
        ent_bits = len(entropy) * 8
        cs_bits = ent_bits // 32
        checksum = hashlib.sha256(entropy).digest()
        acc = int.from_bytes(entropy, "big")
        acc = (acc << cs_bits) | (checksum[0] >> (8 - cs_bits))
        total = ent_bits + cs_bits
        indices = [(acc >> (total - 11 * (i + 1))) & 0x7FF for i in range(total // 11)]
        phrase = " ".join(words[i] for i in indices)
        return cls(phrase, wordlist=words)

    def _validate(self, phrase: str) -> bytes:
        words = phrase.split()
        if len(words) not in (12, 15, 18, 21, 24):
            raise MnemonicError("mnemonic must have 12..24 words (multiple of 3)")
        index = {w: i for i, w in enumerate(self.wordlist)}
        try:
            indices = [index[w] for w in words]
        except KeyError as e:
            raise MnemonicError(f"unknown word {e}") from None
        total = len(words) * 11
        acc = 0
        for i in indices:
            acc = (acc << 11) | i
        cs_bits = total // 33
        ent_bits = total - cs_bits
        entropy = (acc >> cs_bits).to_bytes(ent_bits // 8, "big")
        checksum = acc & ((1 << cs_bits) - 1)
        expected = hashlib.sha256(entropy).digest()[0] >> (8 - cs_bits)
        if checksum != expected:
            raise MnemonicError("invalid checksum")
        return entropy

    def to_seed(self, passphrase: str = "") -> bytes:
        """64-byte seed via PBKDF2-HMAC-SHA512 (2048 rounds)."""
        salt = ("mnemonic" + unicodedata.normalize("NFKD", passphrase)).encode()
        return hashlib.pbkdf2_hmac("sha512", self.phrase.encode(), salt, 2048)


__all__ = ["Mnemonic", "MnemonicError", "ENGLISH_WORDLIST_SHA256"]
