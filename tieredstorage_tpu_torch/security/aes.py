"""AES-256-GCM data keys: sizes, the per-segment DEK + AAD pair.

Counterpart of tieredstorage_tpu/security/aes.py. The chunk cipher itself is
the device GCM program (ops/gcm.py via transform/cuda.py), so this module
needs no `cryptography`: a fresh DEK + AAD pair per segment from two
independent random draws, and the `IV || ciphertext || tag` size rule.
"""

from __future__ import annotations

import dataclasses
import os

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
