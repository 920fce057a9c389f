"""Segment manifest V1 + JSON serde, wire-compatible with the reference.

JSON shape (reference: core/.../manifest/SegmentManifest.java:33-36 — version
discriminator "1"; SegmentManifestV1.java:31-130):

    {
      "version": "1",
      "chunkIndex": {"type": "fixed"|"variable", ...},
      "segmentIndexes": {"offset": {...}, ..., "transaction": null},
      "compression": bool,
      "encryption": {"dataKey": "<keyId>:<b64>", "aad": "<b64>"},   # optional
      "remoteLogSegmentMetadata": {...}                             # write-only
    }

The DEK in `encryption.dataKey` is RSA-enveloped during serialization
(reference: core/.../manifest/serde/{EncryptionSerdeModule,DataKeySerializer,
DataKeyDeserializer}.java) — callers pass encoder/decoder hooks so this module
stays crypto-free.
"""

from __future__ import annotations

import base64
import dataclasses
import json
from typing import Callable, Optional

from tieredstorage_tpu_torch.manifest.chunk_index import (
    ChunkIndex,
    chunk_index_from_json,
    chunk_index_to_json,
)
from tieredstorage_tpu_torch.manifest.encryption_metadata import SegmentEncryptionMetadataV1
from tieredstorage_tpu_torch.manifest.segment_indexes import SegmentIndexesV1
from tieredstorage_tpu_torch.metadata import RemoteLogSegmentMetadata

# Hook signatures: encode raw DEK bytes -> "keyId:base64" string and back.
DataKeyEncoder = Callable[[bytes], str]
DataKeyDecoder = Callable[[str], bytes]


@dataclasses.dataclass(frozen=True)
class SegmentManifestV1:
    chunk_index: ChunkIndex
    segment_indexes: SegmentIndexesV1
    compression: bool
    encryption: Optional[SegmentEncryptionMetadataV1] = None
    remote_log_segment_metadata: Optional[RemoteLogSegmentMetadata] = None
    # Extension over the reference schema: identifies which codec produced the
    # compressed chunks ("zstd" = reference-compatible; TPU-native codecs add
    # their own ids). Absent/None means zstd, so reference manifests parse
    # unchanged and manifests this framework writes with zstd stay readable
    # by the reference.
    compression_codec: Optional[str] = None
    # Extension: CRC32C of each stored (transformed) chunk, aligned with the
    # chunk index, written when `scrub.checksums.enabled` — the background
    # scrubber's at-rest integrity ground truth. Absent on reference
    # manifests (they rely on the object store's checksums alone).
    chunk_checksums: Optional[list[int]] = None


def manifest_to_json(
    manifest: SegmentManifestV1,
    data_key_encoder: Optional[DataKeyEncoder] = None,
) -> str:
    obj: dict = {
        "version": "1",
        "chunkIndex": chunk_index_to_json(manifest.chunk_index),
        "segmentIndexes": manifest.segment_indexes.to_json(),
        "compression": manifest.compression,
    }
    if manifest.compression_codec and manifest.compression_codec != "zstd":
        obj["compressionCodec"] = manifest.compression_codec
    if manifest.chunk_checksums is not None:
        obj["chunkChecksums"] = base64.b64encode(
            b"".join(c.to_bytes(4, "big") for c in manifest.chunk_checksums)
        ).decode("ascii")
    if manifest.encryption is not None:
        if data_key_encoder is None:
            raise ValueError("Manifest has encryption metadata but no data key encoder given")
        obj["encryption"] = {
            "dataKey": data_key_encoder(manifest.encryption.data_key),
            "aad": base64.b64encode(manifest.encryption.aad).decode("ascii"),
        }
    if manifest.remote_log_segment_metadata is not None:
        obj["remoteLogSegmentMetadata"] = manifest.remote_log_segment_metadata.to_json()
    return json.dumps(obj)


def manifest_from_json(
    data: str | bytes,
    data_key_decoder: Optional[DataKeyDecoder] = None,
) -> SegmentManifestV1:
    obj = json.loads(data)
    version = obj.get("version")
    if version != "1":
        raise ValueError(f"Unsupported manifest version: {version!r}")
    encryption = None
    if obj.get("encryption") is not None:
        enc = obj["encryption"]
        if data_key_decoder is None:
            raise ValueError("Manifest has encryption metadata but no data key decoder given")
        encryption = SegmentEncryptionMetadataV1(
            data_key=data_key_decoder(enc["dataKey"]),
            aad=base64.b64decode(enc["aad"]),
        )
    checksums = None
    if obj.get("chunkChecksums") is not None:
        raw = base64.b64decode(obj["chunkChecksums"])
        if len(raw) % 4:
            raise ValueError(f"chunkChecksums length {len(raw)} is not a multiple of 4")
        checksums = [
            int.from_bytes(raw[i : i + 4], "big") for i in range(0, len(raw), 4)
        ]
    return SegmentManifestV1(
        chunk_index=chunk_index_from_json(obj["chunkIndex"]),
        segment_indexes=SegmentIndexesV1.from_json(obj["segmentIndexes"]),
        compression=bool(obj["compression"]),
        encryption=encryption,
        remote_log_segment_metadata=None,  # write-only field, like the reference
        compression_codec=obj.get("compressionCodec"),
        chunk_checksums=checksums,
    )
