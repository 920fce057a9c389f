"""Chunk indexes: map original-byte offsets to stored (transformed) chunks.

Behavior parity with the reference's ChunkIndex family
(core/.../manifest/index/ChunkIndex.java:28-54, AbstractChunkIndex.java,
FixedSizeChunkIndex.java:26-56, VariableSizeChunkIndex.java:29-53, and the
streaming builders), with the same JSON shape (`type` discriminator
"fixed"/"variable", `transformedChunks` as base64 of the binary codec).

Redesigned lookup: the reference linear-scans chunks per offset
(AbstractChunkIndex.findChunkForOriginalOffset:75-108). Here original
positions are arithmetic (`i * original_chunk_size`) so offset->chunk id is
O(1), and transformed positions come from a numpy prefix sum computed once —
the same array doubles as the device-side offset table for batched TPU
detransforms.
"""

from __future__ import annotations

import abc
import base64
from typing import Sequence

import numpy as np

from tieredstorage_tpu_torch.manifest.chunk import Chunk
from tieredstorage_tpu_torch.manifest.codec import decode_chunk_sizes, encode_chunk_sizes


def _check_positive(value: int, name: str) -> None:
    if value <= 0:
        raise ValueError(f"{name} must be positive, {value} given")


def _check_non_negative(value: int, name: str) -> None:
    if value < 0:
        raise ValueError(f"{name} must be non-negative, {value} given")


class ChunkIndex(abc.ABC):
    """Common offset math for fixed/variable indexes.

    Semantics (same as reference): original chunks are `original_chunk_size`
    bytes except the final one; an empty file still materializes one zero
    chunk; offsets at/after `original_file_size` map to None.
    """

    def __init__(self, original_chunk_size: int, original_file_size: int, chunk_count: int):
        _check_positive(original_chunk_size, "Original chunk size")
        _check_non_negative(original_file_size, "Original file size")
        self.original_chunk_size = original_chunk_size
        self.original_file_size = original_file_size
        self.chunk_count = chunk_count
        # Transformed start offsets: prefix sum over transformed sizes.
        sizes = self.transformed_chunk_sizes()
        self._transformed_starts = np.concatenate(
            ([0], np.cumsum(np.asarray(sizes, dtype=np.int64)))
        )

    # --- subclass surface ---
    @abc.abstractmethod
    def transformed_chunk_sizes(self) -> np.ndarray:
        """int64[chunk_count] of transformed sizes."""

    # --- common math ---
    def _original_size_of(self, chunk_id: int) -> int:
        if chunk_id == self.chunk_count - 1:
            return self.original_file_size - (self.chunk_count - 1) * self.original_chunk_size
        return self.original_chunk_size

    def _chunk_at(self, chunk_id: int) -> Chunk:
        return Chunk(
            id=chunk_id,
            original_position=chunk_id * self.original_chunk_size,
            original_size=self._original_size_of(chunk_id),
            transformed_position=int(self._transformed_starts[chunk_id]),
            transformed_size=int(
                self._transformed_starts[chunk_id + 1] - self._transformed_starts[chunk_id]
            ),
        )

    def find_chunk_for_original_offset(self, offset: int) -> Chunk | None:
        _check_non_negative(offset, "Offset")
        if offset >= self.original_file_size:  # also covers empty files
            return None
        return self._chunk_at(offset // self.original_chunk_size)

    def chunks(self) -> list[Chunk]:
        if self.chunk_count == 0:
            return [Chunk(0, 0, 0, 0, 0)]
        return [self._chunk_at(i) for i in range(self.chunk_count)]

    @property
    def total_transformed_size(self) -> int:
        """Bytes of the stored object (the scrubber's size check)."""
        return int(self._transformed_starts[-1])


class FixedSizeChunkIndex(ChunkIndex):
    """All transformed chunks share one size except the final one.

    Produced when no compression runs (identity or encryption-only transforms).
    Reference: core/.../manifest/index/FixedSizeChunkIndex.java:26-56.
    """

    def __init__(
        self,
        original_chunk_size: int,
        original_file_size: int,
        transformed_chunk_size: int,
        final_transformed_chunk_size: int,
    ):
        _check_positive(original_chunk_size, "Original chunk size")
        _check_non_negative(original_file_size, "Original file size")
        _check_non_negative(transformed_chunk_size, "Transformed chunk size")
        _check_non_negative(final_transformed_chunk_size, "Final transformed chunk size")
        self.transformed_chunk_size = transformed_chunk_size
        self.final_transformed_chunk_size = final_transformed_chunk_size
        count = -(-original_file_size // original_chunk_size)  # ceil
        self._count = count
        super().__init__(original_chunk_size, original_file_size, count)

    def transformed_chunk_sizes(self) -> np.ndarray:
        sizes = np.full(self._count, self.transformed_chunk_size, dtype=np.int64)
        if self._count:
            sizes[-1] = self.final_transformed_chunk_size
        return sizes

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, FixedSizeChunkIndex)
            and self.original_chunk_size == other.original_chunk_size
            and self.original_file_size == other.original_file_size
            and self.transformed_chunk_size == other.transformed_chunk_size
            and self.final_transformed_chunk_size == other.final_transformed_chunk_size
        )

    def __repr__(self) -> str:
        return (
            f"FixedSizeChunkIndex(originalChunkSize={self.original_chunk_size}, "
            f"originalFileSize={self.original_file_size}, "
            f"transformedChunkSize={self.transformed_chunk_size}, "
            f"finalTransformedChunkSize={self.final_transformed_chunk_size})"
        )


class VariableSizeChunkIndex(ChunkIndex):
    """Transformed chunk sizes vary (compression); stored via the binary codec.

    Reference: core/.../manifest/index/VariableSizeChunkIndex.java:29-53.
    """

    def __init__(
        self,
        original_chunk_size: int,
        original_file_size: int,
        transformed_chunks: Sequence[int],
    ):
        if not transformed_chunks:
            raise ValueError("transformedChunks cannot be empty")
        self.transformed_chunks = [int(v) for v in transformed_chunks]
        super().__init__(original_chunk_size, original_file_size, len(self.transformed_chunks))

    def transformed_chunk_sizes(self) -> np.ndarray:
        return np.asarray(self.transformed_chunks, dtype=np.int64)

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, VariableSizeChunkIndex)
            and self.original_chunk_size == other.original_chunk_size
            and self.original_file_size == other.original_file_size
            and self.transformed_chunks == other.transformed_chunks
        )

    def __repr__(self) -> str:
        return (
            f"VariableSizeChunkIndex(originalChunkSize={self.original_chunk_size}, "
            f"originalFileSize={self.original_file_size}, "
            f"transformedChunks={len(self.transformed_chunks)} values)"
        )


# --- JSON serde (wire-compatible with Jackson's output) ---

def chunk_index_to_json(index: ChunkIndex) -> dict:
    if isinstance(index, FixedSizeChunkIndex):
        return {
            "type": "fixed",
            "originalChunkSize": index.original_chunk_size,
            "originalFileSize": index.original_file_size,
            "transformedChunkSize": index.transformed_chunk_size,
            "finalTransformedChunkSize": index.final_transformed_chunk_size,
        }
    if isinstance(index, VariableSizeChunkIndex):
        return {
            "type": "variable",
            "originalChunkSize": index.original_chunk_size,
            "originalFileSize": index.original_file_size,
            "transformedChunks": base64.b64encode(
                encode_chunk_sizes(index.transformed_chunks)
            ).decode("ascii"),
        }
    raise TypeError(f"Unknown chunk index type: {type(index)!r}")


def chunk_index_from_json(obj: dict) -> ChunkIndex:
    kind = obj.get("type")
    if kind == "fixed":
        return FixedSizeChunkIndex(
            obj["originalChunkSize"],
            obj["originalFileSize"],
            obj["transformedChunkSize"],
            obj["finalTransformedChunkSize"],
        )
    if kind == "variable":
        sizes = decode_chunk_sizes(base64.b64decode(obj["transformedChunks"]))
        return VariableSizeChunkIndex(obj["originalChunkSize"], obj["originalFileSize"], sizes)
    raise ValueError(f"Unknown chunk index type id: {kind!r}")


# --- streaming builders ---

class _ChunkIndexBuilder(abc.ABC):
    """Streaming add/finish protocol used by the transform finisher.

    Reference: core/.../manifest/index/AbstractChunkIndexBuilder.java:39-77 —
    non-final chunks must be exactly `original_chunk_size` original bytes;
    `finish` seals the index with the final (possibly short) chunk.
    """

    def __init__(self, original_chunk_size: int, original_file_size: int):
        _check_positive(original_chunk_size, "Original chunk size")
        _check_non_negative(original_file_size, "Original file size")
        self.original_chunk_size = original_chunk_size
        self.original_file_size = original_file_size
        self._non_final_expected = max(0, -(-original_file_size // original_chunk_size) - 1)
        self._added = 0
        self._finished = False

    def add_chunk(self, transformed_size: int) -> None:
        if self._finished:
            raise RuntimeError("Index already finished")
        if self._added >= self._non_final_expected:
            raise RuntimeError(
                f"Cannot add more chunks: {self._non_final_expected} non-final chunks expected"
            )
        _check_non_negative(transformed_size, "Transformed chunk size")
        self._add(transformed_size)
        self._added += 1

    def finish(self, final_transformed_size: int) -> ChunkIndex:
        if self._finished:
            raise RuntimeError("Index already finished")
        if self._added != self._non_final_expected:
            raise RuntimeError(
                f"Expected {self._non_final_expected} non-final chunks, got {self._added}"
            )
        _check_non_negative(final_transformed_size, "Final transformed chunk size")
        self._finished = True
        return self._finish(final_transformed_size)

    @abc.abstractmethod
    def _add(self, transformed_size: int) -> None: ...

    @abc.abstractmethod
    def _finish(self, final_transformed_size: int) -> ChunkIndex: ...


class FixedSizeChunkIndexBuilder(_ChunkIndexBuilder):
    def __init__(self, original_chunk_size: int, original_file_size: int, transformed_chunk_size: int):
        super().__init__(original_chunk_size, original_file_size)
        _check_non_negative(transformed_chunk_size, "Transformed chunk size")
        self.transformed_chunk_size = transformed_chunk_size

    def _add(self, transformed_size: int) -> None:
        # Fixed index sanity check (reference FixedSizeChunkIndexBuilder):
        # every non-final transformed chunk must have the declared size.
        if transformed_size != self.transformed_chunk_size:
            raise ValueError(
                f"Transformed chunk size {transformed_size} != declared {self.transformed_chunk_size}"
            )

    def _finish(self, final_transformed_size: int) -> ChunkIndex:
        return FixedSizeChunkIndex(
            self.original_chunk_size,
            self.original_file_size,
            self.transformed_chunk_size,
            final_transformed_size,
        )


class VariableSizeChunkIndexBuilder(_ChunkIndexBuilder):
    def __init__(self, original_chunk_size: int, original_file_size: int):
        super().__init__(original_chunk_size, original_file_size)
        self._sizes: list[int] = []

    def _add(self, transformed_size: int) -> None:
        self._sizes.append(transformed_size)

    def _finish(self, final_transformed_size: int) -> ChunkIndex:
        return VariableSizeChunkIndex(
            self.original_chunk_size,
            self.original_file_size,
            self._sizes + [final_transformed_size],
        )
