"""Chunk value object.

Reference: core/src/main/java/io/aiven/kafka/tieredstorage/Chunk.java
(`id, originalPosition, originalSize, transformedPosition, transformedSize`;
`range()` returns the transformed-side BytesRange, Chunk.java:62-64).
"""

from __future__ import annotations

import dataclasses

from tieredstorage_tpu_torch.storage.core import BytesRange


@dataclasses.dataclass(frozen=True)
class Chunk:
    id: int
    original_position: int
    original_size: int
    transformed_position: int
    transformed_size: int

    def range(self) -> BytesRange:
        """Byte range of this chunk on the transformed (stored) side."""
        return BytesRange.of_from_position_and_size(self.transformed_position, self.transformed_size)
