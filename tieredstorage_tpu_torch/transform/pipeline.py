"""Segment transformation pipeline: stream -> chunk windows -> backend -> stream.

The terminal driver of the transform seam (counterpart of
tieredstorage_tpu/transform/pipeline.py, without the scrub checksums plane):
the source stream is cut into `original_chunk_size` chunks, windows of
`backend.preferred_batch_chunks` chunks go through one backend call, and the
chunk index is built from the returned sizes as the transformed bytes stream
out to the uploader. The identity transform short-circuits: the chunk index is
computed arithmetically and the source bytes pass through untouched.
"""

from __future__ import annotations

import io
from typing import BinaryIO, Iterator, Optional

from tieredstorage_tpu_torch.manifest.chunk_index import (
    ChunkIndex,
    FixedSizeChunkIndex,
    FixedSizeChunkIndexBuilder,
    VariableSizeChunkIndexBuilder,
)
from tieredstorage_tpu_torch.transform.api import (
    DetransformOptions,
    TransformBackend,
    TransformOptions,
)
from tieredstorage_tpu_torch.utils.streams import LazyConcatStream


def read_chunks(stream: BinaryIO, chunk_size: int) -> Iterator[bytes]:
    """Split a stream into fixed-size chunks; the final one may be short."""
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, {chunk_size} given")
    while True:
        chunk = stream.read(chunk_size)
        if not chunk:
            return
        yield chunk


class SegmentTransformation:
    """Drives one segment (or index blob) through the transform backend.

    Usage: construct, consume `stream()` fully (e.g. hand it to an uploader),
    then read `chunk_index`. The index is only complete after the stream is
    drained.
    """

    def __init__(
        self,
        source: BinaryIO,
        original_file_size: int,
        original_chunk_size: int,
        backend: TransformBackend,
        opts: TransformOptions,
        chunking_disabled: bool = False,
    ):
        # chunking_disabled: treat the whole stream as a single chunk
        # (used for index blobs).
        self._source = source
        self.original_file_size = original_file_size
        self.original_chunk_size = (
            max(original_file_size, 1) if chunking_disabled else original_chunk_size
        )
        self._backend = backend
        self._opts = opts
        self._chunk_index: Optional[ChunkIndex] = None

    @property
    def chunk_index(self) -> ChunkIndex:
        if self._chunk_index is None:
            raise RuntimeError("Chunk index is not built until the stream is fully consumed")
        return self._chunk_index

    def stream(self) -> BinaryIO:
        if self._opts.is_identity:
            return self._identity_stream()
        return LazyConcatStream(self._transformed_parts())

    def _identity_stream(self) -> BinaryIO:
        size, chunk = self.original_file_size, self.original_chunk_size
        final = size - (max(0, -(-size // chunk) - 1)) * chunk if size > 0 else 0
        self._chunk_index = FixedSizeChunkIndex(chunk, size, chunk, final)
        return self._source

    def _transformed_parts(self) -> Iterator[BinaryIO]:
        fixed_size = self._opts.fixed_transformed_size(self.original_chunk_size)
        if fixed_size is not None:
            builder = FixedSizeChunkIndexBuilder(
                self.original_chunk_size, self.original_file_size, fixed_size
            )
        else:
            builder = VariableSizeChunkIndexBuilder(
                self.original_chunk_size, self.original_file_size
            )

        window_chunks = max(1, self._backend.preferred_batch_chunks)
        window_bytes = self._backend.preferred_batch_bytes
        pending: Optional[bytes] = None  # last transformed chunk, deferred for finish()
        submitted: list[int] = []  # window lengths, for 1:1 validation

        def windows() -> Iterator[list[bytes]]:
            window: list[bytes] = []
            size = 0
            for chunk in read_chunks(self._source, self.original_chunk_size):
                window.append(chunk)
                size += len(chunk)
                if len(window) >= window_chunks or (
                    window_bytes is not None and size >= window_bytes
                ):
                    submitted.append(len(window))
                    yield window
                    window, size = [], 0
            if window:
                submitted.append(len(window))
                yield window

        got_any = False
        # transform_windows lets device backends keep pipeline_depth windows
        # in flight (host staging ∥ device encrypt ∥ device->host copy).
        for transformed in self._backend.transform_windows(windows(), self._opts):
            got_any = got_any or bool(transformed)
            expected = submitted.pop(0)
            if len(transformed) != expected:
                raise RuntimeError(
                    f"Backend returned {len(transformed)} chunks for a window of {expected}"
                )
            for t in transformed:
                if pending is not None:
                    builder.add_chunk(len(pending))
                    yield io.BytesIO(pending)
                pending = t

        if not got_any:
            # Empty source: an empty object and a zero index.
            self._chunk_index = builder.finish(0)
            return
        assert pending is not None
        self._chunk_index = builder.finish(len(pending))
        yield io.BytesIO(pending)


def detransform_chunks(
    transformed_chunks: list[bytes],
    backend: TransformBackend,
    opts: DetransformOptions,
) -> list[bytes]:
    """Fetch-direction inverse over a window of stored chunks."""
    return backend.detransform(transformed_chunks, opts)
