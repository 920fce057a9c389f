"""S3 StorageBackend implementation.

Counterpart of tieredstorage_tpu/storage/s3/storage.py without its request
metrics: `metrics` is None and the client has no observer until the metrics
groups are ported. Reference: storage/s3/.../S3Storage.java:40-151 — upload streams through the
multipart output stream, ranged GET via the Range header, native multi-object
delete, 404 → KeyNotFoundException and 416 → InvalidRangeException mapping.
"""

from __future__ import annotations

from typing import BinaryIO, Iterable, Mapping, Optional

from tieredstorage_tpu_torch.storage.core import (
    BytesRange,
    InvalidRangeException,
    KeyNotFoundException,
    ObjectKey,
    StorageBackend,
    StorageBackendException,
)
from tieredstorage_tpu_torch.storage.httpclient import HttpError, RetryPolicy
from tieredstorage_tpu_torch.storage.proxy import ProxyConfig, socks5_socket_factory
from tieredstorage_tpu_torch.storage.s3.client import S3ApiError, S3Client
from tieredstorage_tpu_torch.storage.s3.config import S3StorageConfig
from tieredstorage_tpu_torch.storage.s3.multipart import S3MultiPartOutputStream

_COPY_BUFFER = 1024 * 1024


class S3Storage(StorageBackend):
    def __init__(self) -> None:
        self.client: Optional[S3Client] = None
        self.part_size = 0

    def configure(self, configs: Mapping[str, object]) -> None:
        config = S3StorageConfig(configs)
        proxy = ProxyConfig.from_configs(configs)
        # Reference semantics (S3StorageConfig.java:65-68 / AWS SDK): the
        # call timeout covers the whole call INCLUDING retries, the attempt
        # timeout covers one attempt. Map the former onto the retry policy's
        # total deadline and the latter onto the per-attempt socket timeout
        # (falling back to the call timeout when only that one is set).
        call_timeout_s = (
            config.api_call_timeout_ms / 1000.0
            if config.api_call_timeout_ms is not None
            else None
        )
        attempt_timeout_s = (
            config.api_call_attempt_timeout_ms / 1000.0
            if config.api_call_attempt_timeout_ms is not None
            else call_timeout_s
        )
        retry = RetryPolicy(total_deadline_s=call_timeout_s)
        self.part_size = config.part_size
        self.client = S3Client(
            config.bucket_name,
            config.region,
            endpoint_url=config.endpoint_url,
            path_style=config.path_style_access,
            access_key=config.access_key_id,
            secret_key=config.secret_access_key,
            timeout=attempt_timeout_s,
            verify_tls=config.certificate_check_enabled,
            checksum_check=config.checksum_check_enabled,
            socket_factory=socks5_socket_factory(proxy),
            retry=retry,
        )

    def _require_client(self) -> S3Client:
        if self.client is None:
            raise StorageBackendException("S3Storage is not configured")
        return self.client

    # --------------------------------------------------------------- upload
    def upload(self, input_stream: BinaryIO, key: ObjectKey) -> int:
        client = self._require_client()
        out = S3MultiPartOutputStream(client, key.value, self.part_size)
        try:
            while True:
                block = input_stream.read(_COPY_BUFFER)
                if not block:
                    break
                out.write(block)
            out.close()
        except (S3ApiError, HttpError) as e:
            out.abort()
            raise StorageBackendException(f"Failed to upload {key}") from e
        return out.processed_bytes

    # ---------------------------------------------------------------- fetch
    def fetch(self, key: ObjectKey, byte_range: Optional[BytesRange] = None) -> BinaryIO:
        client = self._require_client()
        rng = (
            (byte_range.from_position, byte_range.to_position)
            if byte_range is not None
            else None
        )
        try:
            status, headers, stream = client.get_object_stream(key.value, rng)
        except HttpError as e:
            raise StorageBackendException(f"Failed to fetch {key}") from e
        if status in (200, 206):
            return stream
        body = stream.read()
        stream.close()
        if status == 404:
            raise KeyNotFoundException(self, key)
        if status == 416:
            raise InvalidRangeException(
                f"Failed to fetch {key}: Invalid range {byte_range}"
            )
        raise StorageBackendException(
            f"Failed to fetch {key}: HTTP {status}: {body[:200]!r}"
        )

    # --------------------------------------------------------------- delete
    def delete(self, key: ObjectKey) -> None:
        client = self._require_client()
        try:
            client.delete_object(key.value)
        except (S3ApiError, HttpError) as e:
            raise StorageBackendException(f"Failed to delete {key}") from e

    def delete_all(self, keys: Iterable[ObjectKey]) -> None:
        client = self._require_client()
        key_list = [k.value for k in keys]
        if not key_list:
            return
        try:
            # S3 caps DeleteObjects at 1000 keys per call.
            for i in range(0, len(key_list), 1000):
                client.delete_objects(key_list[i : i + 1000])
        except (S3ApiError, HttpError) as e:
            raise StorageBackendException(f"Failed to delete {key_list}") from e

    # ----------------------------------------------------------------- list
    def list_objects(self, prefix: str = ""):
        """ListObjectsV2 pages (1000 keys each) chained via continuation
        tokens; S3 returns keys in lexicographic (UTF-8 binary) order."""
        client = self._require_client()
        token: Optional[str] = None
        while True:
            try:
                keys, token = client.list_objects_v2(prefix, token)
            except (S3ApiError, HttpError) as e:
                raise StorageBackendException(
                    f"Failed to list objects with prefix {prefix!r}"
                ) from e
            for key in keys:
                yield ObjectKey(key)
            if token is None:
                return

    @property
    def metrics(self):
        """The request metrics collector: None until the metrics groups are
        ported."""
        return None

    def close(self) -> None:
        if self.client is not None:
            self.client.close()

    def __str__(self) -> str:
        bucket = self.client.bucket if self.client else None
        return f"S3Storage{{bucket={bucket}, partSize={self.part_size}}}"
