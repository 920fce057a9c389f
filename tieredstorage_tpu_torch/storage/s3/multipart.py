"""Multipart upload output stream.

Counterpart of tieredstorage_tpu/storage/s3/multipart.py.

Reference: storage/s3/.../S3MultiPartOutputStream.java:40-211 — buffer up to
`part_size` bytes, lazily create the multipart upload on the first flushed
part, upload each full buffer as a part, complete on close, abort on any
error; `processed_bytes()` is the upload-size accounting surfaced through
ObjectUploader.upload.
"""

from __future__ import annotations

import io
import logging

from tieredstorage_tpu_torch.storage.s3.client import S3Client

log = logging.getLogger(__name__)


class S3MultiPartOutputStream(io.RawIOBase):
    def __init__(self, client: S3Client, key: str, part_size: int):
        self.client = client
        self.key = key
        self.part_size = part_size
        self._buffer = bytearray()
        self._upload_id: str | None = None
        self._etags: list[tuple[int, str]] = []
        self._part_number = 0
        self._processed = 0
        self._aborted = False

    def writable(self) -> bool:
        return True

    @property
    def processed_bytes(self) -> int:
        return self._processed

    def write(self, data) -> int:
        if self.closed or self._aborted:
            raise ValueError("Stream is closed")
        view = memoryview(bytes(data))
        n = len(view)
        try:
            self._buffer.extend(view)
            while len(self._buffer) >= self.part_size:
                self._flush_part(self._buffer[: self.part_size])
                del self._buffer[: self.part_size]
        except Exception:
            self.abort()
            raise
        self._processed += n
        return n

    def _flush_part(self, data: bytes | bytearray) -> None:
        if self._upload_id is None:
            self._upload_id = self.client.create_multipart_upload(self.key)
        self._part_number += 1
        etag = self.client.upload_part(self.key, self._upload_id, self._part_number, bytes(data))
        self._etags.append((self._part_number, etag))

    def abort(self) -> None:
        """Best-effort abort; safe to call repeatedly
        (reference: S3MultiPartOutputStream.java:124-146)."""
        if self._aborted:
            return
        self._aborted = True
        if self._upload_id is not None:
            try:
                self.client.abort_multipart_upload(self.key, self._upload_id)
            except Exception:  # noqa: BLE001 — abort is best-effort by contract
                # Logged, not raised: the caller is already unwinding an
                # upload failure, but a leaked multipart upload accrues
                # storage until lifecycle cleanup, so leave a trace.
                log.warning(
                    "Failed to abort multipart upload %s for %s",
                    self._upload_id, self.key, exc_info=True,
                )
        self._buffer.clear()

    def close(self) -> None:
        if self.closed:
            return
        try:
            if not self._aborted:
                if self._upload_id is None:
                    # Whole object fit in one buffer: plain PutObject
                    # (cheaper than a 1-part multipart round trip).
                    self.client.put_object(self.key, bytes(self._buffer))
                else:
                    if self._buffer:
                        self._flush_part(self._buffer)
                        self._buffer.clear()
                    self.client.complete_multipart_upload(self.key, self._upload_id, self._etags)
        except Exception:
            self.abort()
            raise
        finally:
            super().close()
