"""Segment transformation pipeline: stream -> chunk windows -> backend -> stream.

The terminal driver of the transform seam (counterpart of
tieredstorage_tpu/transform/pipeline.py): the source stream is cut into
`original_chunk_size` chunks, windows of `backend.preferred_batch_chunks`
chunks go through one backend call, and the chunk index is built from the
returned sizes as the transformed bytes stream out to the uploader. The
identity transform short-circuits: the chunk index is computed arithmetically
and the source bytes pass through untouched.

With `collect_checksums` (`scrub.checksums.enabled`) the CRC32C of every
transformed chunk is recorded as it streams out, for the manifest's
`chunkChecksums`; the scrubber verifies stored objects against them. The
CRCs run on the transform backend's device (`backend.device` where the
backend has one, the CPU otherwise).
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
    DEFAULT_DEVICE,
    DetransformOptions,
    TransformBackend,
    TransformOptions,
    checksum_device,
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
        collect_checksums: bool = False,
        device=DEFAULT_DEVICE,
    ):
        # chunking_disabled: treat the whole stream as a single chunk
        # (used for index blobs).
        # collect_checksums: record CRC32C of every transformed chunk as it
        # streams out (`scrub.checksums.enabled`), on the backend's device,
        # or on `device` for a host backend (api.checksum_device).
        self._source = source
        self.original_file_size = original_file_size
        self.original_chunk_size = (
            max(original_file_size, 1) if chunking_disabled else original_chunk_size
        )
        self._backend = backend
        self._opts = opts
        self._chunk_index: Optional[ChunkIndex] = None
        self._collect_checksums = collect_checksums
        self._checksums: Optional[list[int]] = [] if collect_checksums else None
        self._crc_device = checksum_device(backend, device) if collect_checksums else None

    @property
    def chunk_index(self) -> ChunkIndex:
        if self._chunk_index is None:
            raise RuntimeError("Chunk index is not built until the stream is fully consumed")
        return self._chunk_index

    @property
    def chunk_checksums(self) -> Optional[list[int]]:
        """Per-transformed-chunk CRC32C, aligned with the chunk index; None
        unless collect_checksums was set. Complete only after the stream is
        fully consumed (same protocol as `chunk_index`)."""
        if self._chunk_index is None and self._collect_checksums:
            raise RuntimeError("Checksums are not built until the stream is fully consumed")
        return self._checksums

    def _crc_batch(self, chunks: list[bytes]) -> None:
        from tieredstorage_tpu_torch.ops.crc32c import crc32c_batch

        self._checksums.extend(crc32c_batch(chunks, self._crc_device))

    def stream(self) -> BinaryIO:
        if self._opts.is_identity:
            return self._identity_stream()
        return LazyConcatStream(self._transformed_parts())

    def _identity_stream(self) -> BinaryIO:
        size, chunk = self.original_file_size, self.original_chunk_size
        final = size - (max(0, -(-size // chunk) - 1)) * chunk if size > 0 else 0
        self._chunk_index = FixedSizeChunkIndex(chunk, size, chunk, final)
        if not self._collect_checksums:
            return self._source
        # Identity bytes pass through untouched, so checksum the pass-through
        # stream on chunk boundaries instead of re-reading the source.
        return _ChecksumTeeStream(self._source, chunk, self._crc_batch)

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
            if self._collect_checksums and transformed:
                self._crc_batch(list(transformed))
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


class _ChecksumTeeStream(io.RawIOBase):
    """Pass-through reader that CRCs fixed-size chunk windows as they flow.

    Chunks are buffered until `_FLUSH_CHUNKS` are pending (or EOF) so the
    CRCs go through one batched `crc32c_batch` call instead of per-chunk
    launches; memory stays bounded at _FLUSH_CHUNKS × chunk_size.
    """

    _FLUSH_CHUNKS = 32

    def __init__(self, inner: BinaryIO, chunk_size: int, sink) -> None:
        self._inner = inner
        self._chunk_size = chunk_size
        self._sink = sink  # callable(list[bytes]) appending CRCs
        self._buf = bytearray()
        self._pending: list[bytes] = []
        self._eof = False

    def readable(self) -> bool:
        return True

    def _flush(self, final: bool) -> None:
        while len(self._buf) >= self._chunk_size:
            self._pending.append(bytes(self._buf[: self._chunk_size]))
            del self._buf[: self._chunk_size]
        if final and self._buf:
            self._pending.append(bytes(self._buf))
            self._buf.clear()
        if self._pending and (final or len(self._pending) >= self._FLUSH_CHUNKS):
            self._sink(self._pending)
            self._pending = []

    def read(self, size: int = -1) -> bytes:
        data = self._inner.read(size)
        if data:
            self._buf += data
        # A read-all (size < 0) drains the source in one call, and callers
        # that read all never make the trailing empty read, so the final
        # flush must happen here.
        if (not data or size is None or size < 0) and not self._eof:
            self._eof = True
            self._flush(final=True)
        elif data:
            self._flush(final=False)
        return data

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)

    def close(self) -> None:
        try:
            self._inner.close()
        finally:
            super().close()


def detransform_chunks(
    transformed_chunks: list[bytes],
    backend: TransformBackend,
    opts: DetransformOptions,
) -> list[bytes]:
    """Fetch-direction inverse over a window of stored chunks."""
    return backend.detransform(transformed_chunks, opts)
