"""Anti-entropy repair: converge the replicas of a ReplicatedStorageBackend.

Counterpart of tieredstorage_tpu/scrub/antientropy.py, whole; the CRC32C of
the arbitration runs on the repairer's `device` (the RSM passes the
transform backend's, `cuda:0` by default).

Quorum writes and read failover keep the *service* available through a
replica outage, but they leave the replicas themselves divergent: a write
that met quorum at 2/3 never reached the third replica, and a replica
restored from a snapshot may hold stale bytes. This daemon is the repair
leg (Dynamo §4.7 anti-entropy; the scrubber's detect-verify-repair shape
applied *across* replicas instead of within one store):

1. **Diff** — enumerate every replica by prefix (the same
   `StorageBackend.list_objects` leg the scrubber uses) and fetch + hash
   the bytes of every key that any replica holds.
2. **Arbitrate** — when versions diverge, pick the canonical copy:
   a `.log` object is verified against its manifest's ``chunkChecksums``
   (the at-rest ground truth recorded at upload under
   `scrub.checksums.enabled`, checked through `ops/crc32c.crc32c_batch` on
   the repairer's device); otherwise the majority content wins, with
   replica health order breaking ties.
3. **Repair** — copy the canonical bytes to every replica that is missing
   the key or holds a divergent version, counting repairs and emitting
   ``replication.repair`` trace events.

A pass over converged replicas reports zero diffs — the failover demo's
convergence gate. Deletion semantics: `ReplicatedStorageBackend.delete`
raises unless every replica converged, precisely so this pass cannot
resurrect a half-deleted object; a key deliberately removed everywhere is
simply absent from every listing.

Byte-level hashing reads every replicated object once per pass, throttled
by the same `TokenBucket` budget the scrubber uses; deployments with very
large stores should scope passes with `prefix`.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import io
import json
import logging
import threading
import time
from typing import Optional

from tieredstorage_tpu_torch.scrub.scrubber import LOG_SUFFIX, MANIFEST_SUFFIX
from tieredstorage_tpu_torch.storage.core import KeyNotFoundException, ObjectKey
from tieredstorage_tpu_torch.storage.replicated import ReplicatedStorageBackend, ReplicaState
from tieredstorage_tpu_torch.transform.api import DEFAULT_DEVICE, resolve_device
from tieredstorage_tpu_torch.utils.ratelimit import TokenBucket
from tieredstorage_tpu_torch.utils.tracing import NOOP_TRACER

log = logging.getLogger(__name__)


@dataclasses.dataclass
class AntiEntropyReport:
    """Work ledger of one anti-entropy pass."""

    started_at: float = 0.0
    duration_s: float = 0.0
    keys_checked: int = 0
    bytes_compared: int = 0
    missing_copies: int = 0
    divergent_keys: int = 0
    repairs: int = 0
    repair_failures: int = 0
    unreadable_replicas: int = 0

    @property
    def in_sync(self) -> bool:
        """True when the pass found zero differences (nothing to repair)."""
        return self.missing_copies == 0 and self.divergent_keys == 0

    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        out["in_sync"] = self.in_sync
        return out


class AntiEntropyRepairer:
    """Stateless per-pass engine over a ReplicatedStorageBackend, with
    cumulative counters. `device` is where the arbitration's CRC32C runs
    (`transform/api.resolve_device`: `cuda:0` unless the CPU is asked for;
    without CUDA the default raises)."""

    def __init__(
        self,
        replicated: ReplicatedStorageBackend,
        *,
        prefix: str = "",
        rate_bucket: Optional[TokenBucket] = None,
        tracer=NOOP_TRACER,
        device=DEFAULT_DEVICE,
    ) -> None:
        self._replicated = replicated
        self.prefix = prefix
        self._rate_bucket = rate_bucket
        self.tracer = tracer
        self.device = resolve_device(device)
        #: Cumulative counters.
        self.passes = 0
        self.repairs_total = 0
        self.diffs_total = 0
        self.last_report: Optional[AntiEntropyReport] = None

    # ------------------------------------------------------------------ pass
    def run_once(self) -> AntiEntropyReport:
        from tieredstorage_tpu_torch.transform.scheduler import (
            BACKGROUND,
            work_class_scope,
        )

        # Monotonic, like ScrubReport.started_at: an ordering instant on the
        # process clock, not a calendar timestamp.
        report = AntiEntropyReport(started_at=time.monotonic())
        start = time.monotonic()
        # The whole pass runs background-class: any device GCM work its
        # hashing/repair walk triggers joins the scheduler's background
        # admission class with the scrubber's, never a foreground bucket.
        with work_class_scope(BACKGROUND), self.tracer.span(
            "replication.antientropy", prefix=self.prefix
        ):
            replicas = self._replicated.replica_states
            listings = self._list_all(replicas, report)
            all_keys = sorted(set().union(*listings.values())) if listings else []
            for key in all_keys:
                self._converge_key(key, replicas, listings, report)
        report.duration_s = time.monotonic() - start
        self.passes += 1
        self.repairs_total += report.repairs
        self.diffs_total += report.missing_copies + report.divergent_keys
        self.last_report = report
        self.tracer.event(
            "replication.antientropy_complete", keys=report.keys_checked,
            repairs=report.repairs, in_sync=report.in_sync,
        )
        if not report.in_sync:
            log.warning(
                "Anti-entropy pass: %d missing cop(ies), %d divergent key(s), "
                "%d repaired", report.missing_copies, report.divergent_keys,
                report.repairs,
            )
        return report

    def _list_all(
        self, replicas: list[ReplicaState], report: AntiEntropyReport
    ) -> dict[str, set[str]]:
        listings: dict[str, set[str]] = {}
        for rep in replicas:
            try:
                listings[rep.name] = {
                    k.value for k in rep.backend.list_objects(self.prefix)
                }
            except Exception:  # noqa: BLE001 — a dark replica skips this pass
                report.unreadable_replicas += 1
                log.warning(
                    "Anti-entropy cannot list replica %s; skipping it this pass",
                    rep.name, exc_info=True,
                )
        return listings

    def _converge_key(
        self,
        key: str,
        replicas: list[ReplicaState],
        listings: dict[str, set[str]],
        report: AntiEntropyReport,
    ) -> None:
        report.keys_checked += 1
        # Health-ordered so the tie-break and the repair source prefer the
        # replica reads already trust most.
        ordered = [rep for rep in self._ordered(replicas) if rep.name in listings]
        versions: dict[bytes, list[ReplicaState]] = {}
        contents: dict[bytes, bytes] = {}
        missing: list[ReplicaState] = []
        for rep in ordered:
            if key not in listings[rep.name]:
                missing.append(rep)
                continue
            data = self._read(rep, key)
            if data is None:
                missing.append(rep)  # listed but unreadable → treat as absent
                continue
            report.bytes_compared += len(data)
            digest = hashlib.sha256(data).digest()
            versions.setdefault(digest, []).append(rep)
            contents[digest] = data
        if not versions:
            return
        if len(versions) > 1:
            report.divergent_keys += 1
        report.missing_copies += len(missing)
        canonical = self._arbitrate(key, versions, contents, ordered)
        data = contents[canonical]
        holders = {rep.name for rep in versions[canonical]}
        for rep in ordered:
            if rep.name in holders:
                continue
            reason = "missing" if rep in missing else "divergent"
            self._throttle(len(data))
            try:
                rep.backend.upload(io.BytesIO(data), ObjectKey(key))
            except Exception:  # noqa: BLE001 — one bad copy must not end the pass
                report.repair_failures += 1
                log.warning(
                    "Anti-entropy failed to repair %s on replica %s",
                    key, rep.name, exc_info=True,
                )
                continue
            report.repairs += 1
            self.tracer.event(
                "replication.repair", key=key, replica=rep.name, reason=reason,
                bytes=len(data),
            )

    def _ordered(self, replicas: list[ReplicaState]) -> list[ReplicaState]:
        return sorted(replicas, key=lambda rep: rep.health_score(), reverse=True)

    def _read(self, rep: ReplicaState, key: str) -> Optional[bytes]:
        try:
            with rep.backend.fetch(ObjectKey(key)) as stream:
                data = stream.read()
        except KeyNotFoundException:
            return None
        except Exception:  # noqa: BLE001 — unreadable copy = candidate for repair
            log.warning(
                "Anti-entropy cannot read %s from replica %s", key, rep.name,
                exc_info=True,
            )
            return None
        self._throttle(len(data))
        return data

    # ------------------------------------------------------------ arbitration
    def _arbitrate(
        self,
        key: str,
        versions: dict[bytes, list[ReplicaState]],
        contents: dict[bytes, bytes],
        ordered: list[ReplicaState],
    ) -> bytes:
        """Pick the canonical digest among divergent versions.

        `.log` objects have recorded ground truth: the manifest's
        ``chunkChecksums`` arbitrate exactly — a two-replica split
        is always a 1-1 majority tie, and checksums resolve it for the
        objects that carry the actual payload. Everything else falls back
        to majority content, then replica health order."""
        if len(versions) == 1:
            return next(iter(versions))
        if key.endswith(LOG_SUFFIX):
            checksums, chunks = self._recorded_checksums(key, ordered)
            if checksums is not None:
                verified = [
                    d for d, data in contents.items()
                    if self._matches_checksums(data, checksums, chunks)
                ]
                if len(verified) == 1:
                    self.tracer.event(
                        "replication.arbitrated", key=key, how="chunk-checksums",
                    )
                    return verified[0]
        by_rank: dict[bytes, int] = {}
        for rank, rep in enumerate(ordered):
            for digest, holders in versions.items():
                if rep in holders and digest not in by_rank:
                    by_rank[digest] = rank
        return max(
            versions,
            key=lambda d: (len(versions[d]), -by_rank.get(d, len(ordered))),
        )

    def _recorded_checksums(self, log_key: str, ordered: list[ReplicaState]):
        """(chunkChecksums, chunk list) from the segment's manifest on any
        replica, parsed without requiring the data-key decoder (checksums
        and chunk geometry are plaintext fields)."""
        from tieredstorage_tpu_torch.manifest.chunk_index import chunk_index_from_json

        manifest_key = log_key[: -len(LOG_SUFFIX)] + MANIFEST_SUFFIX
        for rep in ordered:
            try:
                with rep.backend.fetch(ObjectKey(manifest_key)) as stream:
                    obj = json.loads(stream.read())
                raw = obj.get("chunkChecksums")
                if raw is None:
                    return None, None
                blob = base64.b64decode(raw)
                checksums = [
                    int.from_bytes(blob[i : i + 4], "big")
                    for i in range(0, len(blob), 4)
                ]
                return checksums, chunk_index_from_json(obj["chunkIndex"]).chunks()
            except KeyNotFoundException:
                continue
            except Exception:  # noqa: BLE001 — an unreadable manifest can't arbitrate
                log.warning(
                    "Anti-entropy cannot use manifest %s for arbitration",
                    manifest_key, exc_info=True,
                )
                return None, None
        return None, None

    def _matches_checksums(self, data: bytes, checksums: list[int], chunks) -> bool:
        from tieredstorage_tpu_torch.ops.crc32c import crc32c_batch

        if chunks and len(data) != (
            chunks[-1].transformed_position + chunks[-1].transformed_size
        ):
            return False
        slices = [
            data[c.transformed_position : c.transformed_position + c.transformed_size]
            for c in chunks
        ]
        if len(slices) != len(checksums):
            return False
        return crc32c_batch(slices, self.device) == checksums

    def _throttle(self, n_bytes: int) -> None:
        bucket = self._rate_bucket
        if bucket is None or n_bytes <= 0:
            return
        remaining = n_bytes
        while remaining > 0:
            take = min(remaining, bucket.capacity)
            bucket.consume(take)
            remaining -= take


class AntiEntropyScheduler:
    """Daemon thread running anti-entropy passes on a fixed period (same
    survive-a-bad-pass contract as ScrubScheduler; the scrub scheduler is
    not reused because its status surface is scrubber-shaped)."""

    def __init__(self, repairer: AntiEntropyRepairer, *, interval_ms: int) -> None:
        if interval_ms < 1:
            raise ValueError("interval_ms must be >= 1")
        self.repairer = repairer
        self.interval_s = interval_ms / 1000.0
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[str] = None

    def start(self) -> "AntiEntropyScheduler":
        if self._thread is not None:
            raise RuntimeError("AntiEntropyScheduler already started")
        self._thread = threading.Thread(
            target=self._run, name="anti-entropy", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def run_now(self) -> None:
        self._wake.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=self.interval_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.repairer.run_once()
                self._last_error = None
            except Exception as e:  # noqa: BLE001 — the loop must survive a bad pass
                self._last_error = f"{type(e).__name__}: {e}"
                log.warning("Anti-entropy pass failed", exc_info=True)

    def status(self) -> dict:
        repairer = self.repairer
        out = {
            "interval_ms": int(self.interval_s * 1000),
            "passes": repairer.passes,
            "repairs_total": repairer.repairs_total,
            "diffs_total": repairer.diffs_total,
            "last_error": self._last_error,
        }
        if repairer.last_report is not None:
            out["last_pass"] = repairer.last_report.to_json()
        return out
