"""Encrypted-data-key string form: `<keyId>:<base64(encrypted DEK)>`.

Reference: core/.../security/EncryptedDataKey.java:38-60.
"""

from __future__ import annotations

import base64
import dataclasses


@dataclasses.dataclass(frozen=True)
class EncryptedDataKey:
    key_encryption_key_id: str
    encrypted_data_key: bytes

    def __post_init__(self) -> None:
        if not self.key_encryption_key_id:
            raise ValueError("keyEncryptionKeyId cannot be empty")
        if ":" in self.key_encryption_key_id:
            raise ValueError("keyEncryptionKeyId cannot contain ':'")
        if not self.encrypted_data_key:
            raise ValueError("encryptedDataKey cannot be empty")

    def serialize(self) -> str:
        return (
            self.key_encryption_key_id
            + ":"
            + base64.b64encode(self.encrypted_data_key).decode("ascii")
        )

    @staticmethod
    def parse(s: str) -> "EncryptedDataKey":
        key_id, sep, b64 = s.partition(":")
        if not sep or not key_id or not b64:
            raise ValueError(f"Malformed encrypted data key string: {s!r}")
        return EncryptedDataKey(key_id, base64.b64decode(b64))
