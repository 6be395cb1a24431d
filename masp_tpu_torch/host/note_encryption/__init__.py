# Copy of masp_tpu/note_encryption/__init__.py, verbatim apart from import paths; its cipher imports name
# masp_tpu_torch/host/crypto.py, the port's own ChaCha20-Poly1305 and AES. The port imports nothing of
# masp_tpu.
"""In-band secret distribution: generic note encryption (masp_note_encryption)
and batch trial decryption.

ChaCha20-Poly1305 with a zero nonce via the `cryptography` package (native
AEAD, replacing the reference's chacha20poly1305 crate, SURVEY.md §2.4).
"""

from __future__ import annotations

from masp_tpu_torch.host.crypto import InvalidTag
from masp_tpu_torch.host.crypto import Cipher, algorithms
from masp_tpu_torch.host.crypto import ChaCha20Poly1305

from masp_tpu_torch.host.primitives.constants import ASSET_IDENTIFIER_LENGTH

COMPACT_NOTE_SIZE = 1 + 11 + 8 + ASSET_IDENTIFIER_LENGTH + 32  # 84
NOTE_PLAINTEXT_SIZE = COMPACT_NOTE_SIZE + 512  # 596
OUT_PLAINTEXT_SIZE = 32 + 32  # 64
AEAD_TAG_SIZE = 16
ENC_CIPHERTEXT_SIZE = NOTE_PLAINTEXT_SIZE + AEAD_TAG_SIZE  # 612
OUT_CIPHERTEXT_SIZE = OUT_PLAINTEXT_SIZE + AEAD_TAG_SIZE  # 80

ZERO_NONCE = b"\x00" * 12


def aead_encrypt(key: bytes, plaintext: bytes) -> bytes:
    """ChaCha20-Poly1305, zero nonce, no AAD -> ciphertext || tag."""
    return ChaCha20Poly1305(key).encrypt(ZERO_NONCE, plaintext, b"")


def aead_decrypt(key: bytes, ciphertext_and_tag: bytes) -> bytes | None:
    try:
        return ChaCha20Poly1305(key).decrypt(ZERO_NONCE, ciphertext_and_tag, b"")
    except InvalidTag:
        return None


def chacha20_block1_decrypt(key: bytes, data: bytes) -> bytes:
    """Raw ChaCha20 keystream starting at block 1 (compact decryption skips
    the Poly1305 keying block, lib.rs:589-624)."""
    # 16-byte nonce layout for cryptography's ChaCha20: 4-byte LE counter=1
    # followed by the 12-byte zero nonce.
    full_nonce = (1).to_bytes(4, "little") + ZERO_NONCE
    cipher = Cipher(algorithms.ChaCha20(key, full_nonce), mode=None)
    return cipher.decryptor().update(data)



def _get(output, name):
    """Duck-typed ShieldedOutput accessor: attribute or zero-arg method."""
    v = getattr(output, name)
    return v() if callable(v) else v


class NoteEncryption:
    """Encryption context enforcing fresh esk (lib.rs:367-482).

    domain: a Domain instance (e.g. SaplingDomain); note/to/memo per domain.
    """

    def __init__(self, domain, ovk, note, to, memo, esk=None):
        self.domain = domain
        self.note = note
        self.to = to
        self.memo = memo
        self.ovk = ovk
        if esk is None:
            esk = domain.derive_esk(note)
            assert esk is not None, "ZIP 212 is active"
        self.esk = esk
        self.epk = domain.ka_derive_public(note, self.esk)

    @classmethod
    def new(cls, domain, ovk, note, to, memo):
        return cls(domain, ovk, note, to, memo)

    @classmethod
    def new_with_esk(cls, domain, esk, ovk, note, to, memo):
        """Pre-ZIP-212 test path (explicit esk)."""
        return cls(domain, ovk, note, to, memo, esk=esk)

    def encrypt_note_plaintext(self) -> bytes:
        d = self.domain
        pk_d = d.get_pk_d(self.note)
        shared_secret = d.ka_agree_enc(self.esk, pk_d)
        key = d.kdf(shared_secret, d.epk_bytes(self.epk))
        plaintext = d.note_plaintext_bytes(self.note, self.to, self.memo)
        assert len(plaintext) == NOTE_PLAINTEXT_SIZE
        return aead_encrypt(key, plaintext)

    def encrypt_outgoing_plaintext(self, cv, cmstar, rng) -> bytes:
        d = self.domain
        if self.ovk is not None:
            ock = d.derive_ock(self.ovk, cv, d.cmstar_to_bytes(cmstar), d.epk_bytes(self.epk))
            plaintext = d.outgoing_plaintext_bytes(self.note, self.esk)
        else:
            ock = rng.fill_bytes(32)
            plaintext = rng.fill_bytes(OUT_PLAINTEXT_SIZE)
        assert len(plaintext) == OUT_PLAINTEXT_SIZE
        return aead_encrypt(ock, plaintext)


def _check_note_validity(domain, note, ephemeral_key: bytes, cmstar_bytes: bytes) -> bool:
    if domain.cmstar_to_bytes(domain.cmstar(note)) != cmstar_bytes:
        return False
    derived_esk = domain.derive_esk(note)
    if derived_esk is not None:
        if domain.epk_bytes(domain.ka_derive_public(note, derived_esk)) != ephemeral_key:
            return False
    return True


def _parse_without_memo_ivk(domain, ivk, ephemeral_key, cmstar_bytes, plaintext):
    parsed = domain.parse_note_plaintext_without_memo_ivk(ivk, plaintext)
    if parsed is None:
        return None
    note, to = parsed
    if not _check_note_validity(domain, note, ephemeral_key, cmstar_bytes):
        return None
    return note, to


def try_note_decryption(domain, ivk, output):
    """output: ShieldedOutput-like with ephemeral_key(), cmstar_bytes(),
    enc_ciphertext() (612 bytes). Returns (note, to, memo) or None."""
    ephemeral_key = _get(output, "ephemeral_key")
    epk = domain.epk(ephemeral_key)
    if epk is None:
        return None
    shared_secret = domain.ka_agree_dec(ivk, epk)
    key = domain.kdf(shared_secret, ephemeral_key)
    return _try_note_decryption_inner(domain, ivk, ephemeral_key, output, key)


def _try_note_decryption_inner(domain, ivk, ephemeral_key, output, key):
    enc = _get(output, "enc_ciphertext")
    plaintext = aead_decrypt(key, enc)
    if plaintext is None:
        return None
    parsed = _parse_without_memo_ivk(
        domain, ivk, ephemeral_key, _get(output, "cmstar_bytes"), plaintext
    )
    if parsed is None:
        return None
    note, to = parsed
    memo = domain.extract_memo(plaintext)
    return note, to, memo


def try_compact_note_decryption(domain, ivk, output):
    """Compact path: 84-byte ciphertext, keystream seeked past block 0."""
    ephemeral_key = _get(output, "ephemeral_key")
    epk = domain.epk(ephemeral_key)
    if epk is None:
        return None
    shared_secret = domain.ka_agree_dec(ivk, epk)
    key = domain.kdf(shared_secret, ephemeral_key)
    return _try_compact_note_decryption_inner(domain, ivk, ephemeral_key, output, key)


def _try_compact_note_decryption_inner(domain, ivk, ephemeral_key, output, key):
    enc = _get(output, "enc_ciphertext")
    assert len(enc) == COMPACT_NOTE_SIZE
    plaintext = chacha20_block1_decrypt(key, enc)
    return _parse_without_memo_ivk(
        domain, ivk, ephemeral_key, _get(output, "cmstar_bytes"), plaintext
    )


def try_output_recovery_with_ovk(domain, ovk, output, cv, out_ciphertext):
    ock = domain.derive_ock(ovk, cv, _get(output, "cmstar_bytes"), _get(output, "ephemeral_key"))
    return try_output_recovery_with_ock(domain, ock, output, out_ciphertext)


def try_output_recovery_with_ock(domain, ock: bytes, output, out_ciphertext: bytes):
    op = aead_decrypt(ock, out_ciphertext)
    if op is None:
        return None
    pk_d = domain.extract_pk_d(op)
    esk = domain.extract_esk(op)
    if pk_d is None or esk is None:
        return None
    ephemeral_key = _get(output, "ephemeral_key")
    shared_secret = domain.ka_agree_enc(esk, pk_d)
    key = domain.kdf(shared_secret, ephemeral_key)
    plaintext = aead_decrypt(key, _get(output, "enc_ciphertext"))
    if plaintext is None:
        return None
    parsed = domain.parse_note_plaintext_without_memo_ovk(
        pk_d, esk, ephemeral_key, plaintext
    )
    if parsed is None:
        return None
    note, to = parsed
    memo = domain.extract_memo(plaintext)
    derived_esk = domain.derive_esk(note)
    if derived_esk is not None and derived_esk != esk:
        return None
    if not _check_note_validity(domain, note, ephemeral_key, _get(output, "cmstar_bytes")):
        return None
    return note, to, memo


# --- batch trial decryption (masp_note_encryption/src/batch.rs) -----------

def batch_try_note_decryption(ivks, outputs):
    """outputs: list of (domain, output). Returns per-output
    Optional(((note, to, memo), ivk_index))."""
    return _batch(ivks, outputs, _try_note_decryption_inner)


def batch_try_compact_note_decryption(ivks, outputs):
    return _batch(ivks, outputs, _try_compact_note_decryption_inner)


def _batch(ivks, outputs, decrypt_inner):
    if not ivks:
        return [None] * len(outputs)
    if not outputs:
        return []
    domain0 = outputs[0][0]
    ephemeral_keys = domain0.batch_epk([_get(o, "ephemeral_key") for (_d, o) in outputs])
    shared = []
    for epk, ephemeral_key in ephemeral_keys:
        for ivk in ivks:
            shared.append(
                (domain0.ka_agree_dec(ivk, epk) if epk is not None else None, ephemeral_key)
            )
    keys = domain0.batch_kdf(shared)

    results = []
    n_ivks = len(ivks)
    for oi, ((epk, ephemeral_key), (domain, output)) in enumerate(
        zip(ephemeral_keys, outputs)
    ):
        found = None
        for i, ivk in enumerate(ivks):
            key = keys[oi * n_ivks + i]
            if key is None:
                continue
            out = decrypt_inner(domain, ivk, ephemeral_key, output, key)
            if out is not None:
                found = (out, i)
                break
        results.append(found)
    return results


__all__ = [
    "COMPACT_NOTE_SIZE", "NOTE_PLAINTEXT_SIZE", "OUT_PLAINTEXT_SIZE",
    "ENC_CIPHERTEXT_SIZE", "OUT_CIPHERTEXT_SIZE", "AEAD_TAG_SIZE",
    "aead_encrypt", "aead_decrypt", "NoteEncryption",
    "try_note_decryption", "try_compact_note_decryption",
    "try_output_recovery_with_ovk", "try_output_recovery_with_ock",
    "batch_try_note_decryption", "batch_try_compact_note_decryption",
]
