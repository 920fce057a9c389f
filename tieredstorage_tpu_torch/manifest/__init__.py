"""Manifest + chunk-index data model (reference L4), wire-compatible.

JSON artifacts produced here are cross-readable with the reference's
`SegmentManifestV1` (version discriminator "1", chunk-index subtypes
"fixed"/"variable", base64 chunk-size codec). Reference:
core/src/main/java/io/aiven/kafka/tieredstorage/manifest/.
"""

from tieredstorage_tpu_torch.manifest.chunk import Chunk
from tieredstorage_tpu_torch.manifest.chunk_index import (
    ChunkIndex,
    FixedSizeChunkIndex,
    FixedSizeChunkIndexBuilder,
    VariableSizeChunkIndex,
    VariableSizeChunkIndexBuilder,
    chunk_index_from_json,
    chunk_index_to_json,
)
from tieredstorage_tpu_torch.manifest.codec import decode_chunk_sizes, encode_chunk_sizes
from tieredstorage_tpu_torch.manifest.segment_indexes import (
    IndexType,
    SegmentIndexesV1,
    SegmentIndexesV1Builder,
    SegmentIndexV1,
)
from tieredstorage_tpu_torch.manifest.encryption_metadata import SegmentEncryptionMetadataV1
from tieredstorage_tpu_torch.manifest.segment_manifest import (
    SegmentManifestV1,
    manifest_from_json,
    manifest_to_json,
)

__all__ = [
    "Chunk",
    "ChunkIndex",
    "FixedSizeChunkIndex",
    "FixedSizeChunkIndexBuilder",
    "VariableSizeChunkIndex",
    "VariableSizeChunkIndexBuilder",
    "chunk_index_from_json",
    "chunk_index_to_json",
    "decode_chunk_sizes",
    "encode_chunk_sizes",
    "IndexType",
    "SegmentIndexV1",
    "SegmentIndexesV1",
    "SegmentIndexesV1Builder",
    "SegmentEncryptionMetadataV1",
    "SegmentManifestV1",
    "manifest_from_json",
    "manifest_to_json",
]
