"""AES-256-GCM data keys: sizes, the per-segment DEK + AAD pair, host chunks.

Counterpart of tieredstorage_tpu/security/aes.py. The chunk cipher of the
main path is the device GCM program (ops/gcm.py via transform/cuda.py), so
this module needs no `cryptography` to import: a fresh DEK + AAD pair per
segment from two independent random draws, and the `IV || ciphertext ||
tag` size rule. `encrypt_chunk` / `decrypt_chunk` are the host cipher of
the CPU backend (transform/cpu.py), and only they need `cryptography`.
"""

from __future__ import annotations

import dataclasses
import os

try:  # Optional dependency: only the host encrypt/decrypt paths need it.
    from cryptography.exceptions import InvalidTag
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:  # pragma: no cover - exercised only without cryptography
    AESGCM = None

    class InvalidTag(Exception):  # type: ignore[no-redef]
        """Stand-in so callers can catch aes.InvalidTag unconditionally."""


def _aesgcm(data_key: bytes) -> "AESGCM":
    if AESGCM is None:
        raise ModuleNotFoundError(
            "The 'cryptography' package is required for AES-GCM encryption "
            "(encryption.enabled) but is not installed"
        )
    return AESGCM(data_key)


KEY_SIZE = 32  # AES-256
IV_SIZE = 12
TAG_SIZE = 16
AAD_SIZE = 32


@dataclasses.dataclass(frozen=True)
class DataKeyAndAAD:
    data_key: bytes
    aad: bytes


class AesEncryptionProvider:
    @staticmethod
    def create_data_key_and_aad() -> DataKeyAndAAD:
        # Two independent random draws: deriving the AAD from the DEK would
        # tie the two together.
        return DataKeyAndAAD(data_key=os.urandom(KEY_SIZE), aad=os.urandom(AAD_SIZE))

    @staticmethod
    def encrypt_chunk(plaintext: bytes, data_key: bytes, aad: bytes, iv: bytes | None = None) -> bytes:
        """Returns IV || ciphertext || tag; a fresh random IV unless given."""
        if iv is None:
            iv = os.urandom(IV_SIZE)
        if len(iv) != IV_SIZE:
            raise ValueError(f"IV must be {IV_SIZE} bytes")
        return iv + _aesgcm(data_key).encrypt(iv, plaintext, aad)

    @staticmethod
    def decrypt_chunk(transformed: bytes, data_key: bytes, aad: bytes) -> bytes:
        """Inverse of encrypt_chunk: reads the IV from the chunk head."""
        if len(transformed) < IV_SIZE + TAG_SIZE:
            raise ValueError("Encrypted chunk shorter than IV+tag")
        iv, ct = transformed[:IV_SIZE], transformed[IV_SIZE:]
        return _aesgcm(data_key).decrypt(iv, ct, aad)
