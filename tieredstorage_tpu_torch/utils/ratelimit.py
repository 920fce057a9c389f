"""Token-bucket rate limiting for upload streams and scrub passes.

Counterpart of tieredstorage_tpu/utils/ratelimit.py, whole: bucket
capacity = rate/s with greedy refill, reads block until tokens are
available, tokens acquired beyond the actual read are refunded; MIN_RATE
floor. A monotonic-clock bucket under a lock (uploads and scrub walks are a
handful of threads, not a hot loop).
"""

from __future__ import annotations

import io
import threading
import time
from typing import BinaryIO

MIN_RATE = 16 * 1024  # bytes/s floor


class TokenBucket:
    def __init__(self, rate_bytes_per_second: int):
        if rate_bytes_per_second < MIN_RATE:
            raise ValueError(
                f"Upload rate {rate_bytes_per_second} must be at least {MIN_RATE} bytes/s"
            )
        self.capacity = rate_bytes_per_second
        self._tokens = float(rate_bytes_per_second)
        self._rate = float(rate_bytes_per_second)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def _refill_locked(self) -> None:
        now = time.monotonic()
        self._tokens = min(self.capacity, self._tokens + (now - self._last) * self._rate)
        self._last = now

    def consume(self, tokens: int) -> None:
        """Blocks until `tokens` are available (greedy refill)."""
        tokens = min(tokens, self.capacity)
        while True:
            with self._lock:
                self._refill_locked()
                if self._tokens >= tokens:
                    self._tokens -= tokens
                    return
                deficit = tokens - self._tokens
            time.sleep(deficit / self._rate)

    def refund(self, tokens: int) -> None:
        with self._lock:
            self._tokens = min(self.capacity, self._tokens + tokens)


class RateLimitedStream(io.RawIOBase):
    """Wraps a stream; each read first acquires tokens, refunding short reads."""

    def __init__(self, inner: BinaryIO, bucket: TokenBucket):
        self._inner = inner
        self._bucket = bucket

    def readable(self) -> bool:
        return True

    def read(self, size: int = -1) -> bytes:
        if size is None or size < 0:
            # Unbounded reads are chunked so the bucket still paces them.
            out = bytearray()
            while True:
                part = self.read(64 * 1024)
                if not part:
                    return bytes(out)
                out += part
        if size == 0:
            return b""
        want = min(size, self._bucket.capacity)
        self._bucket.consume(want)
        data = self._inner.read(want)
        if len(data) < want:
            self._bucket.refund(want - len(data))
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
