"""Scrubber engine: one incremental integrity pass over the object store.

Counterpart of tieredstorage_tpu/scrub/scrubber.py, without the
scrub-metrics hook (the metrics groups are not ported); the tracer is the
no-op one (utils/tracing.py) unless a caller passes another.

A pass has three stages:

1. **Enumerate** — `storage.list_objects(prefix)` builds the inventory; every
   `.rsm-manifest` key anchors a segment triple (`.log`, `.indexes`,
   manifest). Keys claimed by no manifest are orphans (left behind by a
   crashed upload whose rollback never ran, or by manual meddling).
2. **Verify** — each manifest's chunk index is cross-checked against the
   store: the `.log` object is stream-fetched in contiguous chunk batches
   (storage IO throttled through a `TokenBucket` so scrubbing never starves
   foreground fetches), every batch is CRC32C-verified against the manifest's
   `chunkChecksums` through the batched tree (`ops/crc32c.crc32c_batch`, on
   the transform backend's device, or on `device` for a host backend; small
   groups on the host table), and
   transformed segments additionally round-trip
   detransform (AES-GCM tag check / decompress) — byte-identical coverage to
   a real fetch, without a consumer in the loop. The detransform runs under
   the BACKGROUND work class (`transform/scheduler.py`): its device windows
   join the shared scheduler's background admission class rather than racing
   foreground fetch decrypts. Size drift is caught structurally: short reads
   inside the chunk walk, range probes past the expected end.
3. **Repair** — corrupt/missing objects are re-uploaded from a supplied
   local segment source (`repair_source`) when one is available, orphans are
   deleted, and every corrupt object is pushed through the chunk-manager
   quarantine hook so broker fetch storms can't hammer it meanwhile.

Everything observed lands in a `ScrubReport` findings ledger and the
scrubber's cumulative `*_total` counters.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import BinaryIO, Callable, Optional

from tieredstorage_tpu_torch.manifest.segment_manifest import SegmentManifestV1, manifest_from_json
from tieredstorage_tpu_torch.storage.core import (
    BytesRange,
    InvalidRangeException,
    KeyNotFoundException,
    ObjectKey,
    StorageBackend,
    StorageBackendException,
)
from tieredstorage_tpu_torch.transform.api import DEFAULT_DEVICE, checksum_device
from tieredstorage_tpu_torch.utils.ratelimit import TokenBucket
from tieredstorage_tpu_torch.utils.streams import read_exactly
from tieredstorage_tpu_torch.utils.tracing import NOOP_TRACER

log = logging.getLogger(__name__)

MANIFEST_SUFFIX = ".rsm-manifest"
LOG_SUFFIX = ".log"
INDEXES_SUFFIX = ".indexes"

#: Finding kinds (the ledger's vocabulary).
CORRUPT_CHUNK = "corrupt-chunk"
MISSING_OBJECT = "missing-object"
TRUNCATED_OBJECT = "truncated-object"
OVERSIZED_OBJECT = "oversized-object"
ORPHAN_OBJECT = "orphan-object"
MANIFEST_UNREADABLE = "manifest-unreadable"

#: Kinds a `repair_source` re-upload can heal.
_REUPLOADABLE = (CORRUPT_CHUNK, MISSING_OBJECT, TRUNCATED_OBJECT, OVERSIZED_OBJECT)


@dataclasses.dataclass
class ScrubFinding:
    kind: str
    key: str
    detail: str = ""
    chunk_id: Optional[int] = None
    repaired: bool = False

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ScrubReport:
    """Findings ledger + work accounting of one scrub pass."""

    started_at: float = 0.0
    duration_s: float = 0.0
    objects_listed: int = 0
    manifests: int = 0
    chunks_verified: int = 0
    bytes_scanned: int = 0
    findings: list[ScrubFinding] = dataclasses.field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.findings

    @property
    def repaired(self) -> int:
        return sum(1 for f in self.findings if f.repaired)

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.kind] = out.get(f.kind, 0) + 1
        return out

    def to_json(self) -> dict:
        return {
            "started_at": self.started_at,
            "duration_s": self.duration_s,
            "objects_listed": self.objects_listed,
            "manifests": self.manifests,
            "chunks_verified": self.chunks_verified,
            "bytes_scanned": self.bytes_scanned,
            "clean": self.clean,
            "repaired": self.repaired,
            "counts": self.counts(),
            "findings": [f.to_json() for f in self.findings],
        }


class Scrubber:
    """Stateless per-pass engine; counters accumulate across passes."""

    def __init__(
        self,
        storage: StorageBackend,
        *,
        prefix: str = "",
        transform_backend=None,
        data_key_decoder: Optional[Callable[[str], bytes]] = None,
        rate_bucket: Optional[TokenBucket] = None,
        batch_chunks: int = 16,
        repair_enabled: bool = False,
        repair_source: Optional[Callable[[ObjectKey], Optional[BinaryIO]]] = None,
        quarantine: Optional[Callable[[ObjectKey, str], None]] = None,
        verify_transforms: bool = True,
        tracer=NOOP_TRACER,
        device=DEFAULT_DEVICE,
    ) -> None:
        if batch_chunks < 1:
            raise ValueError("batch_chunks must be >= 1")
        #: Where the CRC32C verification runs (api.checksum_device).
        self._crc_device = checksum_device(transform_backend, device)
        self._storage = storage
        self.prefix = prefix
        self._transform_backend = transform_backend
        self._data_key_decoder = data_key_decoder
        self._rate_bucket = rate_bucket
        self._batch_chunks = batch_chunks
        self.repair_enabled = repair_enabled
        self.repair_source = repair_source
        self._quarantine = quarantine
        self._verify_transforms = verify_transforms
        self.tracer = tracer
        #: Cumulative counters across passes.
        self.passes = 0
        self.findings_total = 0
        self.corrupt_chunks_total = 0
        self.orphans_total = 0
        self.missing_objects_total = 0
        self.repairs_total = 0
        self.bytes_scanned_total = 0
        self.chunks_verified_total = 0
        self.last_report: Optional[ScrubReport] = None

    # ------------------------------------------------------------------ pass
    def scrub_once(self) -> ScrubReport:
        # Monotonic: started_at orders passes and feeds duration math; it is
        # an instant on the process clock, not a calendar timestamp.
        report = ScrubReport(started_at=time.monotonic())
        start = time.monotonic()
        with self.tracer.span("scrub.pass", prefix=self.prefix):
            inventory = [k.value for k in self._storage.list_objects(self.prefix)]
            report.objects_listed = len(inventory)
            present = set(inventory)
            claimed: set[str] = set()
            for manifest_key in (k for k in inventory if k.endswith(MANIFEST_SUFFIX)):
                report.manifests += 1
                stem = manifest_key[: -len(MANIFEST_SUFFIX)]
                log_key = stem + LOG_SUFFIX
                indexes_key = stem + INDEXES_SUFFIX
                claimed.update((manifest_key, log_key, indexes_key))
                with self.tracer.span("scrub.segment", key=stem):
                    manifest = self._load_manifest(manifest_key, report)
                    if manifest is None:
                        continue
                    self._verify_log(log_key, manifest, present, report)
                    self._verify_indexes(indexes_key, manifest, present, report)
            for key in inventory:
                if key not in claimed:
                    self._orphan(key, report)
        report.duration_s = time.monotonic() - start
        self._account(report)
        return report

    def _account(self, report: ScrubReport) -> None:
        self.passes += 1
        self.findings_total += len(report.findings)
        self.bytes_scanned_total += report.bytes_scanned
        self.chunks_verified_total += report.chunks_verified
        self.repairs_total += report.repaired
        for f in report.findings:
            if f.kind == CORRUPT_CHUNK:
                self.corrupt_chunks_total += 1
            elif f.kind == ORPHAN_OBJECT:
                self.orphans_total += 1
            elif f.kind == MISSING_OBJECT:
                self.missing_objects_total += 1
        self.last_report = report
        if report.findings:
            log.warning(
                "Scrub pass found %d finding(s): %s (%d repaired)",
                len(report.findings), report.counts(), report.repaired,
            )
        self.tracer.event(
            "scrub.pass_complete", findings=len(report.findings),
            bytes=report.bytes_scanned, chunks=report.chunks_verified,
        )

    # ------------------------------------------------------------- manifests
    def _load_manifest(
        self, manifest_key: str, report: ScrubReport
    ) -> Optional[SegmentManifestV1]:
        try:
            with self._storage.fetch(ObjectKey(manifest_key)) as stream:
                text = stream.read()
            self._throttle(len(text))
            report.bytes_scanned += len(text)
            return manifest_from_json(text, data_key_decoder=self._data_key_decoder)
        except Exception as e:  # noqa: BLE001 — any unreadable manifest is a finding
            self._finding(
                report,
                ScrubFinding(MANIFEST_UNREADABLE, manifest_key, f"{type(e).__name__}: {e}"),
            )
            return None

    # ------------------------------------------------------------ log object
    def _verify_log(
        self,
        log_key: str,
        manifest: SegmentManifestV1,
        present: set[str],
        report: ScrubReport,
    ) -> None:
        index = manifest.chunk_index
        expected_size = index.total_transformed_size
        key = ObjectKey(log_key)
        if log_key not in present:
            self._finding(
                report,
                ScrubFinding(MISSING_OBJECT, log_key, "log object absent from inventory"),
                repair_key=key,
            )
            return
        findings_before = len(report.findings)
        if index.original_file_size > 0 and expected_size > 0:
            chunks = index.chunks()
            for i in range(0, len(chunks), self._batch_chunks):
                if not self._verify_batch(
                    key, manifest, chunks[i : i + self._batch_chunks], report
                ):
                    break
        # Structural size probe: one byte past the expected end must be
        # unsatisfiable; a successful read means the object grew.
        if self._object_extends_past(key, expected_size):
            self._finding(
                report,
                ScrubFinding(
                    OVERSIZED_OBJECT, log_key,
                    f"object extends past the manifest's {expected_size} bytes",
                ),
            )
        self._maybe_repair(key, report, findings_before)

    def _verify_batch(self, key, manifest, chunks, report: ScrubReport) -> bool:
        """Fetch + verify one contiguous chunk window; False stops the walk."""
        batch_bytes = sum(c.transformed_size for c in chunks)
        self._throttle(batch_bytes)
        with self.tracer.span(
            "scrub.verify_batch", key=key.value, chunks=len(chunks), bytes=batch_bytes,
        ):
            whole = BytesRange.of(
                chunks[0].transformed_position,
                chunks[-1].transformed_position + chunks[-1].transformed_size - 1,
            )
            stored: list[bytes] = []
            try:
                with self._storage.fetch(key, whole) as stream:
                    for c in chunks:
                        stored.append(read_exactly(stream, c.transformed_size))
            except KeyNotFoundException:
                self._finding(
                    report,
                    ScrubFinding(MISSING_OBJECT, key.value, "log object vanished mid-scrub"),
                )
                return False
            except (EOFError, InvalidRangeException) as e:
                got = sum(len(b) for b in stored)
                self._finding(
                    report,
                    ScrubFinding(
                        TRUNCATED_OBJECT, key.value,
                        f"short read in chunks {chunks[0].id}..{chunks[-1].id}: {e}",
                        chunk_id=chunks[len(stored)].id if len(stored) < len(chunks) else None,
                    ),
                    quarantine_reason="truncated object",
                )
                report.bytes_scanned += got
                return False
            report.bytes_scanned += batch_bytes
            report.chunks_verified += len(chunks)
            bad = self._verify_checksums(key, manifest, chunks, stored, report)
            self._verify_detransform(key, manifest, chunks, stored, bad, report)
        return True

    def _verify_checksums(
        self, key, manifest, chunks, stored, report: ScrubReport
    ) -> set[int]:
        """CRC32C every fetched chunk against the manifest's recorded values
        (batched through the log-tree on the transform backend's device);
        returns bad chunk ids."""
        recorded = manifest.chunk_checksums
        if not recorded:
            return set()
        from tieredstorage_tpu_torch.ops.crc32c import crc32c_batch

        got = crc32c_batch(stored, self._crc_device)
        bad: set[int] = set()
        for c, crc in zip(chunks, got):
            want = recorded[c.id] if c.id < len(recorded) else None
            if crc != want:
                bad.add(c.id)
                self._finding(
                    report,
                    ScrubFinding(
                        CORRUPT_CHUNK, key.value,
                        f"CRC32C mismatch: stored {crc:#010x}, manifest "
                        f"{'absent' if want is None else f'{want:#010x}'}",
                        chunk_id=c.id,
                    ),
                    quarantine_reason=f"CRC32C mismatch on chunk {c.id}",
                )
        return bad

    def _verify_detransform(
        self, key, manifest, chunks, stored, already_bad: set[int], report: ScrubReport
    ) -> None:
        """GCM-tag / decompress round-trip for transformed segments: the same
        failure a real fetch would hit, caught before any consumer does.
        The device work runs under the BACKGROUND work class: with
        cross-request batching enabled, verification windows join the
        scheduler's background admission class (paced by
        ``scrub.rate.bytes`` scheduler-side, bounded-age starvation
        watchdog) instead of racing foreground fetch decrypts for the
        device — and a device failure mid-scrub wakes background waiters
        only, never a latency-class fetch."""
        if (
            not self._verify_transforms
            or self._transform_backend is None
            or (not manifest.compression and manifest.encryption is None)
        ):
            return
        from tieredstorage_tpu_torch.transform.api import DetransformOptions
        from tieredstorage_tpu_torch.transform.scheduler import (
            BACKGROUND,
            work_class_scope,
        )

        opts = DetransformOptions.from_manifest(manifest)
        clean = [(c, b) for c, b in zip(chunks, stored) if c.id not in already_bad]
        if not clean:
            return
        try:
            with work_class_scope(BACKGROUND):
                self._transform_backend.detransform([b for _, b in clean], opts)
            return
        except Exception:  # noqa: BLE001 — isolate the culprit chunk below
            pass
        for c, b in clean:
            try:
                with work_class_scope(BACKGROUND):
                    self._transform_backend.detransform([b], opts)
            except Exception as e:  # noqa: BLE001 — per-chunk verdict
                self._finding(
                    report,
                    ScrubFinding(
                        CORRUPT_CHUNK, key.value,
                        f"detransform failed: {type(e).__name__}: {e}",
                        chunk_id=c.id,
                    ),
                    quarantine_reason=f"detransform failure on chunk {c.id}",
                )

    # --------------------------------------------------------------- indexes
    def _verify_indexes(
        self,
        indexes_key: str,
        manifest: SegmentManifestV1,
        present: set[str],
        report: ScrubReport,
    ) -> None:
        expected = manifest.segment_indexes.total_size
        key = ObjectKey(indexes_key)
        if indexes_key not in present:
            if expected == 0:
                return  # all indexes empty → no object is correct
            self._finding(
                report,
                ScrubFinding(MISSING_OBJECT, indexes_key, "indexes object absent"),
                repair_key=key,
            )
            return
        findings_before = len(report.findings)
        self._throttle(expected)
        try:
            with self._storage.fetch(key) as stream:
                blob = stream.read()
        except KeyNotFoundException:
            self._finding(
                report,
                ScrubFinding(MISSING_OBJECT, indexes_key, "indexes object vanished mid-scrub"),
            )
            return
        report.bytes_scanned += len(blob)
        if len(blob) != expected:
            kind = TRUNCATED_OBJECT if len(blob) < expected else OVERSIZED_OBJECT
            self._finding(
                report,
                ScrubFinding(
                    kind, indexes_key,
                    f"indexes object is {len(blob)} bytes, manifest says {expected}",
                ),
            )
        self._maybe_repair(key, report, findings_before)

    # --------------------------------------------------------------- orphans
    def _orphan(self, key: str, report: ScrubReport) -> None:
        finding = ScrubFinding(ORPHAN_OBJECT, key, "claimed by no manifest")
        if self.repair_enabled:
            try:
                self._storage.delete(ObjectKey(key))
                finding.repaired = True
            except StorageBackendException as e:
                finding.detail += f"; cleanup failed: {e}"
        self._finding(report, finding)

    # --------------------------------------------------------------- helpers
    def _finding(
        self,
        report: ScrubReport,
        finding: ScrubFinding,
        *,
        quarantine_reason: Optional[str] = None,
        repair_key: Optional[ObjectKey] = None,
    ) -> None:
        report.findings.append(finding)
        self.tracer.event(
            "scrub.finding", kind=finding.kind, key=finding.key,
            chunk_id=finding.chunk_id,
        )
        if quarantine_reason is not None and self._quarantine is not None:
            try:
                self._quarantine(ObjectKey(finding.key), f"scrub: {quarantine_reason}")
            except Exception:  # noqa: BLE001 — quarantine must not fail the pass
                log.warning("Quarantine hook failed for %s", finding.key, exc_info=True)
        if repair_key is not None:
            finding.repaired = self._reupload(repair_key)

    def _maybe_repair(self, key: ObjectKey, report: ScrubReport, findings_before: int) -> None:
        """Re-upload a damaged object once per pass; marks the findings that
        triggered it repaired on success."""
        damaged = [
            f for f in report.findings[findings_before:]
            if f.kind in _REUPLOADABLE and f.key == key.value
        ]
        if not damaged:
            return
        if self._reupload(key):
            for f in damaged:
                f.repaired = True

    def _reupload(self, key: ObjectKey) -> bool:
        if not self.repair_enabled or self.repair_source is None:
            return False
        try:
            source = self.repair_source(key)
        except Exception:  # noqa: BLE001 — a broken source must not fail the pass
            log.warning("Repair source failed for %s", key, exc_info=True)
            return False
        if source is None:
            return False
        try:
            with source:
                self._storage.upload(source, key)
            self.tracer.event("scrub.repair", key=key.value)
            log.info("Scrub repaired %s by re-upload", key)
            return True
        except StorageBackendException:
            log.warning("Scrub re-upload failed for %s", key, exc_info=True)
            return False

    def _object_extends_past(self, key: ObjectKey, size: int) -> bool:
        try:
            with self._storage.fetch(key, BytesRange.of(size, size)) as stream:
                return bool(stream.read(1))
        except (InvalidRangeException, KeyNotFoundException):
            return False
        except StorageBackendException:
            return False

    def _throttle(self, n_bytes: int) -> None:
        """Consume scrub STORAGE-IO budget (ranged fetches, index reads);
        batches larger than the bucket capacity are drained in
        capacity-sized slices so big windows still pace correctly
        (TokenBucket.consume clamps single requests at capacity). Device
        GCM work is NOT throttled here: with cross-request batching
        enabled, verification windows are paced by the device scheduler's
        background admission class instead (the rsm wiring maps
        ``scrub.rate.bytes`` onto both)."""
        bucket = self._rate_bucket
        if bucket is None:
            return
        remaining = n_bytes
        while remaining > 0:
            take = min(remaining, bucket.capacity)
            bucket.consume(take)
            remaining -= take
