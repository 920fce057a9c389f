"""Peer chunk cache tier: ask the owning sibling before remote storage.

Counterpart of tieredstorage_tpu/fleet/peer_cache.py, whole.

The memcache-at-Facebook shape (Nishtala et al., NSDI '13): consistent-hash
routing (fleet/ring.py) concentrates each segment's chunks in exactly one
instance's chunk cache, so a non-owner resolves a miss with ONE cheap hop to
the owner instead of a remote-storage ranged GET + detransform. The owner
serves the forwarded window through its own full chunk path (local cache,
then single-flight backend fetch), so a fleet-wide thundering herd on a hot
chunk still causes exactly one backend read — the owner's.

Layering (owner and non-owner identical):

    ChunkCache (local, per-instance)
      -> PeerChunkCache (this module: route -> forward | local)
        -> SingleFlight -> DefaultChunkManager -> remote storage

Failure semantics: forwarding is an OPTIMIZATION, never a dependency. Peer
health is a per-owner circuit breaker (utils/retry.BreakerBoard): a forward that fails
(connect/timeout/5xx/torn frame) counts a breaker failure, and after
``breaker.peer.failure.threshold`` consecutive failures (default 1) the
owner's breaker opens for ``fleet.peer.down.cooldown.ms`` — reads skip it
and fall back to the next owner / the local backend path, byte-identical
result, no error. After the cooldown the breaker goes half-open and admits
exactly ONE probing forward (concurrent readers keep falling back instead
of stampeding a recovering peer); success closes it. A 404 from the owner
(object unknown there) is a contract answer from a healthy peer — breaker
success — and falls back so the authoritative error comes from this
instance's own storage stack. Forwards propagate the ambient Deadline
(``x-deadline-ms``) and trace context (``traceparent``), and the wire is
the existing shim-wire gateway (``GET /chunk``) — no new listener, no new
protocol. The ``peer.forward`` fault-injection seam (utils/faults.py)
fires per forward attempt, before the wire.
"""

from __future__ import annotations

import contextlib
import io
import struct
import time
from typing import BinaryIO, Optional, Sequence
from urllib.parse import quote

from tieredstorage_tpu_torch.fetch.chunk_manager import ChunkManager
from tieredstorage_tpu_torch.fleet.ring import FleetRouter
from tieredstorage_tpu_torch.fleet.singleflight import SingleFlight
from tieredstorage_tpu_torch.manifest.segment_manifest import SegmentManifestV1
from tieredstorage_tpu_torch.storage.core import ObjectKey
from tieredstorage_tpu_torch.storage.httpclient import HttpClient, HttpError, NO_RETRY
from tieredstorage_tpu_torch.utils import faults, flightrecorder as flight
from tieredstorage_tpu_torch.utils.retry import (
    BreakerBoard,
    BreakerState,
    CircuitOpenException,
)
from tieredstorage_tpu_torch.utils.deadline import DEADLINE_HEADER, current_deadline
from tieredstorage_tpu_torch.utils.tracing import TRACEPARENT_HEADER, NOOP_TRACER
from tieredstorage_tpu_torch.utils.locks import new_lock, note_mutation


def encode_chunk_frames(chunks: Sequence[bytes]) -> bytes:
    """Peer-wire framing of a chunk window: u32 count, then per chunk
    u32 length | bytes (big-endian, shim-wire style). Plaintext chunks are
    variable-length (compression), so the frame carries explicit sizes."""
    out = io.BytesIO()
    out.write(struct.pack(">I", len(chunks)))
    for chunk in chunks:
        out.write(struct.pack(">I", len(chunk)))
        out.write(chunk)
    return out.getvalue()


def decode_chunk_frames(blob: bytes, *, expected: int) -> list[bytes]:
    """Inverse of encode_chunk_frames; raises ValueError on any mismatch
    (a torn/truncated peer response must fall back, not serve short bytes)."""
    view = memoryview(blob)
    if len(view) < 4:
        raise ValueError("peer chunk response truncated (no count)")
    (count,) = struct.unpack_from(">I", view, 0)
    if count != expected:
        raise ValueError(f"peer returned {count} chunks, wanted {expected}")
    offset = 4
    chunks: list[bytes] = []
    for _ in range(count):
        if len(view) - offset < 4:
            raise ValueError("peer chunk response truncated (length)")
        (length,) = struct.unpack_from(">I", view, offset)
        offset += 4
        if len(view) - offset < length:
            raise ValueError("peer chunk response truncated (body)")
        chunks.append(bytes(view[offset : offset + length]))
        offset += length
    if offset != len(view):
        raise ValueError("peer chunk response has trailing bytes")
    return chunks


class PeerChunkCache(ChunkManager):
    """ChunkManager tier that routes misses to the owning fleet sibling."""

    def __init__(
        self,
        delegate: ChunkManager,
        router: FleetRouter,
        *,
        replication: int = 2,
        forward_timeout_s: float = 2.0,
        down_cooldown_s: float = 5.0,
        breaker_threshold: int = 1,
        tracer=NOOP_TRACER,
        on_forward=None,
        time_source=time.monotonic,
    ) -> None:
        if replication < 1:
            raise ValueError(f"replication factor must be >= 1, got {replication}")
        self._delegate = delegate
        self._router = router
        #: R replica owners per key (`fleet.replication.factor`): misses try
        #: them in ring order, so the death of the first owner fails over to
        #: the second with one forward hop instead of losing the cache arc.
        self.replication = replication
        self._flight = SingleFlight(tracer=tracer)
        self.tracer = tracer
        #: Optional `(elapsed_ms)` hook per completed forward; the RSM wires
        #: it to the fleet-forward-time histogram.
        self.on_forward = on_forward
        self.forward_timeout_s = forward_timeout_s
        self.down_cooldown_s = down_cooldown_s
        self._now = time_source
        #: Per-owner breakers (the unified failure-policy plane):
        #: threshold failures open an owner for `down_cooldown_s`, then one
        #: half-open probe re-admits it. Opening emits the same
        #: `fleet.peer_down` tracing event the old cooldown dict did.
        self.breakers = BreakerBoard(
            failure_threshold=max(1, breaker_threshold),
            cooldown_s=down_cooldown_s,
            time_source=time_source,
            on_transition=self._on_breaker_transition,
        )
        self._lock = new_lock("peer_cache.PeerChunkCache._lock")
        self._clients: dict[str, HttpClient] = {}
        #: Keys this instance is currently serving AS the owner (forwarded
        #: requests pin their key so the serving path can never re-forward,
        #: even across the chunk cache's loader pool threads).
        self._pinned: dict[str, int] = {}
        # Counters (exported as fleet-metrics gauges).
        self.forwards = 0
        self.peer_hits = 0
        self.peer_misses = 0
        self.forward_failures = 0
        #: Forwards answered by a non-first owner (the replication win:
        #: requests that would have been backend reads pre-R>1).
        self.failover_hits = 0

    @property
    def delegate(self) -> ChunkManager:
        return self._delegate

    @property
    def singleflight(self) -> SingleFlight:
        return self._flight

    @property
    def router(self) -> FleetRouter:
        return self._router

    @property
    def peers_down(self) -> int:
        return self.breakers.open_count()

    def close(self) -> None:
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for client in clients:
            client.close()
        if hasattr(self._delegate, "close"):
            self._delegate.close()

    # -------------------------------------------------------------- pinning
    @contextlib.contextmanager
    def serving_locally(self, key_value: str):
        """Pin `key_value` to the local path for the duration of the block —
        the loop guard for forwarded requests. Keyed (not thread-local) so it
        holds across the chunk cache's loader pool threads."""
        with self._lock:
            self._pinned[key_value] = self._pinned.get(key_value, 0) + 1
        try:
            yield
        finally:
            with self._lock:
                count = self._pinned.get(key_value, 1) - 1
                if count <= 0:
                    self._pinned.pop(key_value, None)
                else:
                    self._pinned[key_value] = count

    def _is_pinned(self, key_value: str) -> bool:
        with self._lock:
            return key_value in self._pinned

    # ---------------------------------------------------------- peer health
    def _on_breaker_transition(
        self, peer: str, old: BreakerState, new: BreakerState
    ) -> None:
        if new is BreakerState.OPEN:
            self.tracer.event("fleet.peer_down", peer=peer, reason="breaker_open")

    def _client(self, peer: str, url: str) -> HttpClient:
        stale: Optional[HttpClient] = None
        with self._lock:
            client = self._clients.get(peer)
            if client is None or client.base_url != url:
                # Single attempt: the local backend path IS the retry, and a
                # struggling peer must not absorb backoff sleeps. The stale
                # client (peer re-ringed to a new URL) is closed OUTSIDE the
                # lock - socket teardown must not stall every other forward
                # (lock-order checker: no blocking calls under _lock).
                stale = client
                client = HttpClient(
                    url, timeout=self.forward_timeout_s, retry=NO_RETRY
                )
                self._clients[peer] = client
        if stale is not None:
            stale.close()
        return client

    # ----------------------------------------------------------------- reads
    def get_chunk(
        self, objects_key: ObjectKey, manifest: SegmentManifestV1, chunk_id: int
    ) -> BinaryIO:
        return io.BytesIO(self.get_chunks(objects_key, manifest, [chunk_id])[0])

    def get_chunks(
        self, objects_key: ObjectKey, manifest: SegmentManifestV1, chunk_ids: Sequence[int]
    ) -> list[bytes]:
        if not chunk_ids:
            return []
        # The flight wraps the WHOLE resolve (forward or backend): N
        # concurrent identical windows produce at most one forward on a
        # non-owner and exactly one backend read on the owner. Keyed by the
        # exact id list, not endpoints: windows [0,2] and [0,1,2] must not
        # share a flight (their results have different shapes).
        flight_key = f"{objects_key.value}#{','.join(map(str, chunk_ids))}"
        return self._flight.do(
            flight_key,
            lambda: self._resolve(objects_key, manifest, chunk_ids),
            what=objects_key.value,
        )

    def _resolve(
        self, objects_key: ObjectKey, manifest: SegmentManifestV1, chunk_ids: Sequence[int]
    ) -> list[bytes]:
        """Try the key's R replica owners in ring order; serve locally when
        this instance is the highest-priority reachable owner (or every
        owner is down/unreachable — forwarding is never a dependency)."""
        if not self._is_pinned(objects_key.value):
            owners = self._router.route_owners(objects_key.value, self.replication)
            for rank, (owner, url) in enumerate(owners):
                if url is None:
                    # This instance (or an address-less member) is the first
                    # live owner: the local chunk path IS the replica serve,
                    # and it warms this instance's arc copy.
                    break
                breaker = self.breakers.for_target(owner)
                try:
                    # Open = skip to the next owner; half-open admits ONE
                    # probing forward while concurrent readers fall back.
                    breaker.acquire()
                except CircuitOpenException:
                    flight.note("breaker.skipped_owners")
                    continue
                try:
                    forwarded = self._try_forward(
                        owner, url, objects_key, chunk_ids, rank=rank,
                        breaker=breaker,
                    )
                except BaseException:
                    breaker.on_neutral()  # never leak a half-open probe slot
                    raise
                if forwarded is not None:
                    return forwarded
        return self._delegate.get_chunks(objects_key, manifest, list(chunk_ids))

    def _try_forward(
        self, owner: str, url: str, objects_key: ObjectKey,
        chunk_ids: Sequence[int], *, rank: int = 0, breaker=None,
    ) -> Optional[list[bytes]]:
        """One GET /chunk against the owner; None means 'try the next owner,
        then serve locally' (miss, peer down, torn frame) — never an error.
        Every outcome settles `breaker`: failure/torn frame/5xx are breaker
        failures, a served window or a 404 (healthy contract answer) is a
        breaker success."""

        def settle_failure() -> None:
            if breaker is not None:
                breaker.on_failure()

        with self._lock:
            self.forwards += 1
            note_mutation("peer_cache.PeerChunkCache.forwards")
        self.tracer.event(
            "fleet.forward", peer=owner, key=objects_key.value,
            chunks=len(chunk_ids), rank=rank,
        )
        # The wire carries a contiguous lo-hi window; a sparse id list (the
        # cache's missing-subset can have gaps) over-fetches the covering
        # range and subselects — one round trip beats per-gap requests.
        lo, hi = chunk_ids[0], chunk_ids[-1]
        path = (
            f"/chunk?key={quote(objects_key.value, safe='')}"
            f"&chunks={lo}-{hi}"
        )
        headers: dict[str, str] = {}
        traceparent = self.tracer.current_traceparent()
        if traceparent:
            headers[TRACEPARENT_HEADER] = traceparent
        deadline = current_deadline()
        if deadline is not None:
            headers[DEADLINE_HEADER] = deadline.header_value()
        start = time.monotonic()
        try:
            # Injection seam: an `error` fault fails this hop like a
            # dead transport; `partial` tears the response body below so the
            # frame decoder must refuse it.
            torn = faults.fire("peer.forward", f"{owner}|{objects_key.value}")
            resp = self._client(owner, url).request("GET", path, headers=headers)
        except (HttpError, faults.FaultInjectedError) as e:
            with self._lock:
                self.forward_failures += 1
                note_mutation("peer_cache.PeerChunkCache.forward_failures")
            settle_failure()
            self.tracer.event(
                "fleet.forward_failed", peer=owner, reason=f"{type(e).__name__}"
            )
            return None
        elapsed_ms = (time.monotonic() - start) * 1000.0
        if resp.status == 200:
            try:
                body = faults.mutate(resp.body, torn)
                window = decode_chunk_frames(body, expected=hi - lo + 1)
            except ValueError as e:
                with self._lock:
                    self.forward_failures += 1
                    note_mutation("peer_cache.PeerChunkCache.forward_failures")
                settle_failure()
                self.tracer.event(
                    "fleet.forward_failed", peer=owner, reason=str(e)
                )
                return None
            chunks = [window[cid - lo] for cid in chunk_ids]
            if breaker is not None:
                breaker.on_success()
            with self._lock:
                self.peer_hits += 1
                note_mutation("peer_cache.PeerChunkCache.peer_hits")
                if rank > 0:
                    self.failover_hits += 1
                    note_mutation("peer_cache.PeerChunkCache.failover_hits")
            # Flight-record the peer serve (and how many owner hops it took).
            flight.note("tier.peer", len(chunks))
            if rank > 0:
                flight.note("peer.failover_hops", rank)
            if self.on_forward is not None:
                self.on_forward(elapsed_ms)
            self.tracer.event(
                "fleet.peer_hit", peer=owner, key=objects_key.value,
                chunks=len(chunks),
            )
            return chunks
        if resp.status == 404:
            # The owner cannot serve this key (not uploaded / already
            # deleted there): a contract answer from a HEALTHY peer — the
            # authoritative answer comes from the local storage stack.
            if breaker is not None:
                breaker.on_success()
            with self._lock:
                self.peer_misses += 1
                note_mutation("peer_cache.PeerChunkCache.peer_misses")
            return None
        with self._lock:
            self.forward_failures += 1
            note_mutation("peer_cache.PeerChunkCache.forward_failures")
        settle_failure()
        self.tracer.event(
            "fleet.forward_failed", peer=owner, reason=f"http {resp.status}"
        )
        return None
