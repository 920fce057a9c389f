"""Ranged fetch over chunks: map an original-byte range to chunk streams.

Reference: core/.../fetch/FetchChunkEnumeration.java — chunk id window from
the chunk index (ctor :54-70), skip into the first chunk and cap the last
(:100-131), lazy stream so early close stops fetching (:160-175; the broker
rarely drains a whole fetch).
"""

from __future__ import annotations

import io
from typing import BinaryIO, Iterator

from tieredstorage_tpu_torch.errors import RemoteResourceNotFoundException
from tieredstorage_tpu_torch.fetch.chunk_manager import ChunkManager
from tieredstorage_tpu_torch.manifest.segment_manifest import SegmentManifestV1
from tieredstorage_tpu_torch.storage.core import BytesRange, KeyNotFoundException, ObjectKey
from tieredstorage_tpu_torch.utils.streams import BoundedStream, LazyConcatStream


class FetchChunkEnumeration:
    def __init__(
        self,
        chunk_manager: ChunkManager,
        objects_key: ObjectKey,
        manifest: SegmentManifestV1,
        byte_range: BytesRange,
    ):
        self._chunk_manager = chunk_manager
        self._key = objects_key
        self._manifest = manifest
        index = manifest.chunk_index

        first_chunk = index.find_chunk_for_original_offset(byte_range.from_position)
        if first_chunk is None:
            raise ValueError(
                f"Invalid start position {byte_range.from_position} "
                f"in segment path {objects_key}"
            )
        self._first_chunk_id = first_chunk.id
        last_offset = min(byte_range.to_position, index.original_file_size - 1)
        self._last_chunk_id = index.find_chunk_for_original_offset(last_offset).id
        self._skip_in_first = byte_range.from_position - first_chunk.original_position
        self._total = min(byte_range.size, index.original_file_size - byte_range.from_position)

    def _parts(self) -> Iterator[BinaryIO]:
        remaining = self._total
        try:
            for chunk_id in range(self._first_chunk_id, self._last_chunk_id + 1):
                data = self._chunk_manager.get_chunks(self._key, self._manifest, [chunk_id])[0]
                if chunk_id == self._first_chunk_id:
                    data = data[self._skip_in_first :]
                if len(data) > remaining:
                    data = data[:remaining]
                remaining -= len(data)
                yield io.BytesIO(data)
        except KeyNotFoundException as e:
            raise RemoteResourceNotFoundException(str(e)) from e

    def to_stream(self) -> BinaryIO:
        return BoundedStream(LazyConcatStream(self._parts()), self._total)
