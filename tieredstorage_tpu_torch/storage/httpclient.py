"""Minimal pooled HTTP client for the cloud storage backends.

Counterpart of tieredstorage_tpu/storage/httpclient.py, with a plain
condition variable for the pool. The reference's backends ride vendor SDKs
(AWS SDK v2 sync HTTP client, google-cloud-storage's HttpTransport,
azure-core's HttpPipeline — see storage/s3/.../S3ClientBuilder.java,
storage/gcs/.../GcsStorage.java:41-88,
storage/azure/.../AzureBlobStorage.java:48-99). This build speaks the three
REST protocols directly over the standard library so the backends carry zero
SDK dependencies; this module is the shared transport: a bounded keep-alive
connection pool, timeouts, an observer hook (the analogue of the reference's
MetricCollector pipeline taps), and a socket factory hook used for SOCKS5
proxying (storage/core/.../proxy/).

Connection management: each client holds ONE bounded pool of keep-alive
connections to its host — ``max_connections`` in-flight requests at most,
idle connections reused by whichever thread asks next, callers past the
bound waiting (deadline-clamped) for a slot instead of minting sockets. A
process holds many logical in-flight fetches over a fixed socket budget, and
streamed bodies return their connection for reuse once fully drained.

Retry ownership is split the same way the reference splits it: the
transport retries only replay-safe requests (ranged GETs, HEAD, deletes,
and calls explicitly marked idempotent), so a failed segment UPLOAD is NOT
retried here — it propagates, the RSM deletes the orphaned objects
(rsm.py orphan cleanup), and Kafka's RemoteLogManager re-schedules the
whole copy, exactly as it does for the reference (whose SDK retry configs
also only replay idempotent calls, S3StorageConfig.java:65-68). Retrying a
non-replay-safe body mid-stream from a pooled connection risks duplicate
side effects on a request the server may have partially processed.
"""

from __future__ import annotations

import dataclasses
import http.client
import io
import random
import socket
import ssl
import time
from datetime import datetime, timezone
from email.utils import parsedate_to_datetime
from typing import BinaryIO, Callable, Mapping, Optional
from urllib.parse import urlsplit

from tieredstorage_tpu_torch.utils.deadline import (
    DeadlineExceededException,
    check_deadline,
    current_deadline,
)
from tieredstorage_tpu_torch.utils.locks import new_condition


class HttpError(Exception):
    """Transport-level failure (connect/read), not an HTTP status."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with full jitter for transient failures.

    The reference inherits retry behavior from the vendor SDKs (AWS SDK v2
    standard retry mode — storage/s3/.../S3StorageConfig.java:65-68 exposes a
    per-attempt timeout precisely because the SDK retries; the GCS and Azure
    SDKs ship equivalent policies). This is the hand-rolled transport's
    equivalent: replay-safe requests are retried on transport failures and on
    throttle/server statuses, sleeping full-jitter exponential backoff
    between attempts and honoring Retry-After within `max_delay_s`.

    `total_deadline_s` bounds the whole call including backoff sleeps (the
    reference's `api.call.timeout` semantics: "including all retries"); the
    per-attempt socket timeout lives on the HttpClient itself
    (`api.call.attempt.timeout`)."""

    max_attempts: int = 3
    base_delay_s: float = 0.1
    max_delay_s: float = 5.0
    total_deadline_s: Optional[float] = None
    retry_statuses: frozenset = frozenset({429, 500, 502, 503, 504})

    def backoff_s(self, retry_number: int, retry_after_s: Optional[float] = None) -> float:
        """Sleep before retry `retry_number` (0-based): U(0, min(max, base*2^n)),
        raised to the server's Retry-After when given (capped at max_delay_s —
        a server asking for minutes should surface the error, not block the
        fetch path)."""
        cap = min(self.max_delay_s, self.base_delay_s * (2**retry_number))
        delay = random.uniform(0.0, cap)
        if retry_after_s is not None:
            delay = max(delay, min(retry_after_s, self.max_delay_s))
        return delay


#: Disables retries entirely (single attempt) — for tests and callers that
#: layer their own replay logic.
NO_RETRY = RetryPolicy(max_attempts=1)


def _parse_retry_after(value: str) -> Optional[float]:
    """Both RFC 9110 forms: delta-seconds ('Retry-After: 2') and HTTP-date
    ('Retry-After: Fri, 31 Jul 2026 07:28:00 GMT') — a real S3/GCS 503 can
    send either. A past or unparsable date yields None
    (the policy's own backoff applies)."""
    try:
        return max(0.0, float(value))
    except (TypeError, ValueError):
        pass
    try:
        when = parsedate_to_datetime(value)
    except (TypeError, ValueError):
        return None
    if when is None:
        return None
    if when.tzinfo is None:
        # RFC 5322 parse of an asctime form can come back naive; HTTP dates
        # are GMT by definition.
        when = when.replace(tzinfo=timezone.utc)
    delta = (when - datetime.now(timezone.utc)).total_seconds()
    return max(0.0, delta) if delta > 0 else None


class HttpResponse:
    """A fully materialized or streaming HTTP response.

    `stream()` hands the caller ownership of the underlying response body;
    the connection is returned to the per-thread slot only once the body is
    fully drained and closed.
    """

    def __init__(self, status: int, headers: Mapping[str, str], body: bytes):
        self.status = status
        self.headers = {k.lower(): v for k, v in headers.items()}
        self.body = body

    def header(self, name: str, default: str = "") -> str:
        return self.headers.get(name.lower(), default)


class _StreamedBody(io.RawIOBase):
    """Wraps an http.client response; the stream owns a pooled connection.

    Closing returns the connection to the pool — for keep-alive REUSE when
    the body was fully drained (the overwhelmingly common case: ranged chunk
    GETs are read to completion), or closed and its slot freed when the
    caller abandoned the body mid-stream (the framing is desynced, the
    socket is useless)."""

    def __init__(
        self,
        resp: http.client.HTTPResponse,
        conn: http.client.HTTPConnection,
        pool: Optional["_ConnectionPool"] = None,
    ):
        self._resp = resp
        self._conn = conn
        self._pool = pool

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        data = self._resp.read(len(b))
        n = len(data)
        b[:n] = data
        return n

    def read(self, size: int = -1) -> bytes:
        return self._resp.read(None if size is None or size < 0 else size)

    def close(self) -> None:
        if self.closed:
            return
        try:
            try:
                drained = bool(self._resp.isclosed())
            except Exception:  # fakes/tests without isclosed
                drained = False
            try:
                self._resp.close()
            finally:
                if self._pool is None:
                    self._conn.close()
                elif drained:
                    self._conn._tstpu_used = True
                    self._pool.release(self._conn)
                else:
                    self._pool.discard(self._conn)
        finally:
            super().close()


# Observer signature: (method, url_path, status, elapsed_seconds, error) -> None
Observer = Callable[[str, str, int, float, Optional[BaseException]], None]

# Socket factory signature: (host, port, timeout) -> connected socket
SocketFactory = Callable[[str, int, Optional[float]], socket.socket]


class _Connection(http.client.HTTPConnection):
    """HTTPConnection with a pluggable socket factory (SOCKS5 support)."""

    def __init__(self, host: str, port: int, timeout, socket_factory: Optional[SocketFactory]):
        super().__init__(host, port, timeout=timeout)
        self._socket_factory = socket_factory

    def connect(self) -> None:
        if self._socket_factory is None:
            super().connect()
        else:
            self.sock = self._socket_factory(self.host, self.port, self.timeout)


class _SecureConnection(http.client.HTTPSConnection):
    def __init__(self, host, port, timeout, socket_factory, context):
        super().__init__(host, port, timeout=timeout, context=context)
        self._socket_factory = socket_factory

    def connect(self) -> None:
        if self._socket_factory is None:
            super().connect()
        else:
            raw = self._socket_factory(self.host, self.port, self.timeout)
            self.sock = self._context.wrap_socket(raw, server_hostname=self.host)


class _ConnectionPool:
    """Bounded pool of keep-alive connections to one host.

    Invariant: in-flight + idle connections never exceed `max_connections`.
    acquire() prefers an idle keep-alive connection, creates a new one while
    under the bound, and otherwise blocks (bounded by the caller's timeout)
    until release()/discard() frees a slot — so concurrency is a fixed
    socket budget, not a per-thread property."""

    def __init__(self, factory: Callable[[], http.client.HTTPConnection],
                 max_connections: int) -> None:
        if max_connections < 1:
            raise ValueError(f"max_connections must be >= 1, got {max_connections}")
        self._factory = factory
        self.max_connections = max_connections
        self._cond = new_condition("httpclient._ConnectionPool._cond")
        self._idle: list[http.client.HTTPConnection] = []
        self._in_use = 0
        #: Lifetime counters (pool health introspection).
        self.created_total = 0
        self.waited_total = 0
        self.exhausted_total = 0

    @property
    def in_use(self) -> int:
        with self._cond:
            return self._in_use

    @property
    def idle(self) -> int:
        with self._cond:
            return len(self._idle)

    def acquire(self, timeout_s: Optional[float] = None, *, fresh: bool = False):
        """An idle connection, a new one (under the bound), or a bounded
        wait. `fresh=True` skips idle reuse where possible — the
        stale-keepalive replay path must not retry onto another possibly
        stale idle socket (an idle one is closed to keep the bound)."""
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        create = False
        conn = None
        stale: list[http.client.HTTPConnection] = []
        try:
            with self._cond:
                while True:
                    if self._idle and not fresh:
                        conn = self._idle.pop()
                        self._in_use += 1
                        break
                    if self._in_use + len(self._idle) < self.max_connections:
                        self._in_use += 1
                        create = True
                        break
                    if fresh and self._idle:
                        # Under the fresh policy, trade an idle (possibly
                        # stale) socket for a new one rather than waiting.
                        # Popping it frees the slot immediately; the socket
                        # teardown itself happens outside the lock (no blocking
                        # calls under _cond).
                        stale.append(self._idle.pop())
                        continue
                    remaining = None if deadline is None else deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        self.exhausted_total += 1
                        raise HttpError(
                            f"connection pool exhausted ({self.max_connections} "
                            f"in flight); no slot within {timeout_s:.1f}s"
                        )
                    self.waited_total += 1
                    self._cond.wait(remaining)
        finally:
            for old in stale:
                try:
                    old.close()
                except OSError:
                    pass
        if not create:
            return conn
        try:
            conn = self._factory()
        except BaseException:
            with self._cond:
                self._in_use -= 1
                self._cond.notify()
            raise
        with self._cond:
            self.created_total += 1
        return conn

    def release(self, conn) -> None:
        """Return a healthy connection for keep-alive reuse."""
        with self._cond:
            self._in_use -= 1
            self._idle.append(conn)
            self._cond.notify()

    def discard(self, conn) -> None:
        """Close a broken/desynced connection and free its slot."""
        try:
            conn.close()
        finally:
            with self._cond:
                self._in_use -= 1
                self._cond.notify()

    def close(self) -> None:
        with self._cond:
            idle, self._idle = self._idle, []
        for conn in idle:
            try:
                conn.close()
            except OSError:
                pass


class HttpClient:
    """Bounded pooled keep-alive connections to a single base URL."""

    def __init__(
        self,
        base_url: str,
        *,
        timeout: Optional[float] = None,
        verify_tls: bool = True,
        socket_factory: Optional[SocketFactory] = None,
        observer: Optional[Observer] = None,
        retry: Optional[RetryPolicy] = None,
        max_connections: int = 32,
        pool_wait_timeout_s: float = 30.0,
    ) -> None:
        parts = urlsplit(base_url)
        if parts.scheme not in ("http", "https"):
            raise ValueError(f"Unsupported scheme in {base_url!r}")
        self.base_url = base_url
        self.scheme = parts.scheme
        self.host = parts.hostname or ""
        self.port = parts.port or (443 if self.scheme == "https" else 80)
        # Path prefix of the endpoint URL (e.g. Azurite's
        # http://host:10000/devstoreaccount1) — callers prepend this to every
        # request path.
        self.base_path = parts.path.rstrip("/")
        self.timeout = timeout
        self.socket_factory = socket_factory
        self.observer = observer
        self.retry = retry if retry is not None else RetryPolicy()
        self.pool_wait_timeout_s = pool_wait_timeout_s
        # Late-bound factory: tests monkeypatch `_new_connection` per
        # instance after construction, and the pool must see the override.
        self._pool = _ConnectionPool(
            lambda: self._new_connection(), max_connections
        )
        if self.scheme == "https":
            self._ssl_context = ssl.create_default_context()
            if not verify_tls:
                self._ssl_context.check_hostname = False
                self._ssl_context.verify_mode = ssl.CERT_NONE
        else:
            self._ssl_context = None

    # ----------------------------------------------------------- connections
    def _new_connection(self) -> http.client.HTTPConnection:
        if self.scheme == "https":
            return _SecureConnection(
                self.host, self.port, self.timeout, self.socket_factory, self._ssl_context
            )
        return _Connection(self.host, self.port, self.timeout, self.socket_factory)

    @property
    def pool(self) -> _ConnectionPool:
        return self._pool

    def _acquire_timeout(self, budget: Optional[float]) -> Optional[float]:
        """Longest a request may wait for a pool slot: the configured pool
        wait, clamped to the remaining call budget."""
        candidates = [self.pool_wait_timeout_s]
        if budget is not None:
            candidates.append(max(0.001, budget))
        return min(candidates)

    # -------------------------------------------------------------- requests
    def request(
        self,
        method: str,
        path_and_query: str,
        *,
        headers: Optional[Mapping[str, str]] = None,
        body: bytes = b"",
        idempotent: Optional[bool] = None,
    ) -> HttpResponse:
        """Issue a request and read the full response body, retrying
        replay-safe requests per the client's RetryPolicy.

        `idempotent` overrides the method-based replay classification for
        calls the caller KNOWS are safe to replay (e.g. S3 DeleteObjects is
        a POST, but deleting already-deleted keys is a no-op). Non-replay-
        safe requests get exactly one attempt (plus `_roundtrip`'s
        stale-keepalive replay when the failure happened before the request
        was fully sent)."""
        policy = self.retry
        replay_safe = (
            idempotent if idempotent is not None else method in self._IDEMPOTENT
        )
        check_deadline(f"{method} {path_and_query}")
        deadline = self._effective_deadline(policy)
        retry_number = 0
        while True:
            try:
                resp = self._request_once(
                    method, path_and_query, headers, body, idempotent,
                    budget=None if deadline is None else deadline - time.monotonic(),
                )
            except HttpError:
                self._raise_if_deadline_spent(method, path_and_query)
                if not replay_safe or retry_number >= policy.max_attempts - 1:
                    raise
                delay = policy.backoff_s(retry_number)
                if deadline is not None and time.monotonic() + delay > deadline:
                    # The remaining budget can't fit the backoff, let alone
                    # another attempt: stop retrying.
                    raise
                time.sleep(delay)
                retry_number += 1
                continue
            if (
                replay_safe
                and resp.status in policy.retry_statuses
                and retry_number < policy.max_attempts - 1
            ):
                delay = policy.backoff_s(
                    retry_number, _parse_retry_after(resp.header("retry-after"))
                )
                if deadline is None or time.monotonic() + delay <= deadline:
                    time.sleep(delay)
                    retry_number += 1
                    continue
            return resp

    def _request_once(
        self, method, path_and_query, headers, body, idempotent, budget=None
    ) -> HttpResponse:
        """One attempt (the retry loop's unit); the observer sees every
        attempt, so per-attempt rates/errors match what went on the wire.

        `budget` is the remaining total-deadline seconds: the attempt's
        socket timeout is capped to it so the CALL honors the deadline
        (reference semantics: api.call.timeout includes all retries — a
        late attempt must not get a full fresh socket timeout)."""
        t0 = time.perf_counter()
        err: Optional[BaseException] = None
        status = 0
        try:
            if budget is not None and budget <= 0:
                raise TimeoutError("api call deadline exceeded before attempt")
            resp, conn = self._roundtrip(
                method, path_and_query, headers, body, idempotent, budget=budget
            )
            status = resp.status
            try:
                data = resp.read()
            except (OSError, http.client.HTTPException):
                self._pool.discard(conn)
                raise
            # Body fully drained: the keep-alive connection goes back to the
            # pool for the next request on any thread.
            self._pool.release(conn)
            return HttpResponse(status, dict(resp.getheaders()), data)
        except (OSError, http.client.HTTPException) as e:
            err = e
            raise HttpError(f"{method} {path_and_query} failed: {e}") from e
        finally:
            if self.observer is not None:
                self.observer(method, path_and_query, status, time.perf_counter() - t0, err)

    def request_stream(
        self,
        method: str,
        path_and_query: str,
        *,
        headers: Optional[Mapping[str, str]] = None,
    ) -> tuple[int, Mapping[str, str], BinaryIO]:
        """Issue a request on a dedicated connection; the returned stream
        owns it. The initial exchange retries per the policy for idempotent
        methods only (a streamed POST must not be blindly replayed); once
        the stream is handed out, a mid-body failure surfaces to the caller
        (the fetch path re-requests with an adjusted Range rather than
        replaying a partially consumed body)."""
        policy = self.retry if method in self._IDEMPOTENT else NO_RETRY
        check_deadline(f"{method} {path_and_query}")
        deadline = self._effective_deadline(policy)
        retry_number = 0
        while True:
            try:
                status, hdrs, stream = self._stream_once(
                    method, path_and_query, headers,
                    budget=None if deadline is None else deadline - time.monotonic(),
                )
            except HttpError:
                self._raise_if_deadline_spent(method, path_and_query)
                if retry_number >= policy.max_attempts - 1:
                    raise
                delay = policy.backoff_s(retry_number)
                if deadline is not None and time.monotonic() + delay > deadline:
                    raise
                time.sleep(delay)
                retry_number += 1
                continue
            if status in policy.retry_statuses and retry_number < policy.max_attempts - 1:
                retry_after = _parse_retry_after(hdrs.get("retry-after", ""))
                delay = policy.backoff_s(retry_number, retry_after)
                if deadline is None or time.monotonic() + delay <= deadline:
                    stream.close()
                    time.sleep(delay)
                    retry_number += 1
                    continue
            return status, hdrs, stream

    def _stream_once(
        self, method, path_and_query, headers, budget=None
    ) -> tuple[int, Mapping[str, str], BinaryIO]:
        t0 = time.perf_counter()
        conn = self._pool.acquire(self._acquire_timeout(budget))
        self._apply_timeout(conn, budget)
        try:
            conn.request(method, path_and_query, body=None, headers=dict(headers or {}))
            resp = conn.getresponse()
        except (OSError, http.client.HTTPException) as e:
            self._pool.discard(conn)
            if self.observer is not None:
                self.observer(method, path_and_query, 0, time.perf_counter() - t0, e)
            raise HttpError(f"{method} {path_and_query} failed: {e}") from e
        if self.observer is not None:
            self.observer(method, path_and_query, resp.status, time.perf_counter() - t0, None)
        hdrs = {k.lower(): v for k, v in resp.getheaders()}
        return resp.status, hdrs, _StreamedBody(resp, conn, self._pool)

    _IDEMPOTENT = frozenset({"GET", "HEAD", "PUT", "DELETE"})

    @staticmethod
    def _effective_deadline(policy: RetryPolicy) -> Optional[float]:
        """Absolute monotonic deadline for the whole call: the tighter of the
        policy's total deadline and the ambient end-to-end Deadline (the
        cross-layer budget installed at the RSM/gateway entry)."""
        candidates = []
        if policy.total_deadline_s is not None:
            candidates.append(time.monotonic() + policy.total_deadline_s)
        ambient = current_deadline()
        if ambient is not None:
            candidates.append(ambient.at_monotonic)
        return min(candidates) if candidates else None

    @staticmethod
    def _raise_if_deadline_spent(method: str, path_and_query: str) -> None:
        """An attempt that failed AFTER the end-to-end deadline expired
        surfaces as DeadlineExceededException, not a transport error: the
        caller's budget is gone, so the distinct type must reach the
        boundary (504 / DEADLINE_EXCEEDED) instead of a generic failure."""
        ambient = current_deadline()
        if ambient is not None and ambient.expired:
            raise DeadlineExceededException(
                f"Deadline exceeded during {method} {path_and_query}"
            )

    def _apply_timeout(self, conn, budget) -> None:
        """Effective per-attempt socket timeout = min(client timeout,
        remaining deadline budget). Always (re)applied — a pooled
        connection must not inherit a clamped timeout from an earlier
        budgeted call."""
        candidates = [t for t in (self.timeout, budget) if t is not None]
        effective = max(0.001, min(candidates)) if candidates else None
        conn.timeout = effective
        sock = getattr(conn, "sock", None)  # None before connect (and on fakes)
        if sock is not None:
            sock.settimeout(effective)

    def _roundtrip(
        self, method, path_and_query, headers, body, idempotent=None, budget=None
    ) -> tuple[http.client.HTTPResponse, http.client.HTTPConnection]:
        """One exchange on a pooled connection; returns (response, conn) —
        the caller reads the body and releases/discards the connection."""
        conn = self._pool.acquire(self._acquire_timeout(budget))
        reused = getattr(conn, "_tstpu_used", False)
        sent = False
        try:
            self._apply_timeout(conn, budget)
            conn.request(method, path_and_query, body=body, headers=dict(headers or {}))
            sent = True
            resp = conn.getresponse()
        except (OSError, http.client.HTTPException):
            self._pool.discard(conn)
            # Retry once ONLY when replay is safe: the first attempt must
            # have been on a reused keep-alive connection (a fresh-connection
            # failure isn't a stale-socket artifact), and for non-idempotent
            # methods (DeleteObjects/CompleteMultipartUpload/PutBlockList
            # POSTs) only when the failure happened while SENDING — once the
            # full request went out, the server may have executed it, and a
            # replay could run it twice.
            replay_safe = (
                idempotent if idempotent is not None else method in self._IDEMPOTENT
            )
            if not reused or (sent and not replay_safe):
                raise
            # The replay must not land on ANOTHER possibly-stale idle
            # socket: acquire fresh.
            conn = self._pool.acquire(self._acquire_timeout(budget), fresh=True)
            try:
                self._apply_timeout(conn, budget)
                conn.request(method, path_and_query, body=body, headers=dict(headers or {}))
                resp = conn.getresponse()
            except (OSError, http.client.HTTPException):
                self._pool.discard(conn)
                raise
        conn._tstpu_used = True
        return resp, conn

    def close(self) -> None:
        self._pool.close()
