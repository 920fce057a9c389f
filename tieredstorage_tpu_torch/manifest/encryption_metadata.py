"""Per-segment encryption metadata stored in the manifest.

Reference: core/.../manifest/SegmentEncryptionMetadataV1.java (fields
`dataKey` — the AES-256 DEK, RSA-enveloped in JSON — and `aad`).
"""

from __future__ import annotations

import dataclasses

@dataclasses.dataclass(frozen=True)
class SegmentEncryptionMetadataV1:
    data_key: bytes  # raw AES-256 key bytes (32)
    aad: bytes
