"""Convergent recovery sweeper: the reconciliation half of the lifecycle.

Counterpart of tieredstorage_tpu/scrub/sweeper.py, whole.  The upload intent
journal (storage/lifecycle.py) names what a crash *may*
have stranded; this module makes the store converge back to exactly the
manifest-reachable set.  On startup (`lifecycle.sweep.on.start`) and on a
paced period (SweepScheduler, the ScrubScheduler shape), a pass reconciles
three sources of truth:

1. **Store listing** — ``list_objects(prefix)``, the same walk the scrubber
   does.
2. **Manifest reachability** — every present ``.rsm-manifest`` protects
   itself and the ``.log``/``.indexes`` keys it references.  Manifest-last
   upload is the sole commit point, so "reachable from a present manifest"
   IS "committed".
3. **The journal** — pending upload intents whose owning operation is no
   longer running name keys a crash (or a failed rollback cleanup)
   stranded — deletable immediately, no grace needed: the journal proves
   no commit happened.  Pending tombstones name keys a crashed/retried
   delete must still remove.  Entries whose txn is still IN FLIGHT (the
   copy/delete is running right now in this process — see
   ``UploadIntentJournal.release``) are untouchable: the sweeper neither
   resolves them nor considers their keys, because a paced sweep racing a
   live upload would otherwise delete objects whose manifest is about to
   land, leaving a committed manifest over missing keys.

Verdicts per pass:

* **Orphans** — data objects reachable from no manifest.  Journal-named
  orphans (of non-in-flight intents) are deleted in the FIRST sweep after
  a crash ("zero permanent orphans after one recovery sweep").  Orphans
  the journal does not name (ANOTHER broker's in-flight upload on the
  shared prefix, a foreign journal's crash) must out-wait a grace window
  measured from when THIS sweeper first saw them — object stores expose
  no portable mtime, so first-seen is the clock.  The grace window is the
  ONLY thing protecting a peer's in-progress upload, so it must exceed
  the slowest end-to-end segment upload (``lifecycle.grace.ms``
  documents and defaults accordingly).
* **Quarantined manifests** — a manifest that is unreadable or references a
  missing object is quarantined: never served (the RSM refuses it), counted,
  surfaced as gauges.  The quarantine set is recomputed every pass, so a
  healed segment (the broker's retried copy re-uploads the triple)
  un-quarantines automatically.  Quarantined manifests are NEVER deleted.
* **Tombstone completion/GC** — keys named by a pending tombstone are
  deleted *only while manifest-unreachable*; once every named key is gone
  the tombstone is GC'd (``commit_delete``).  If the manifest itself still
  exists (a delete crashed before its manifest-first phase), the tombstone
  stays pending until the broker's retried delete removes the manifest —
  the sweeper never widens its own license.

**One-sidedness invariant**: the sweeper may only ever delete
manifest-UNreachable objects.  Structurally enforced: every deletion funnels through
``_delete_orphan``, which re-checks the protected set and refuses — raising
``SweeperInvariantError`` and counting ``invariant_blocks_total`` instead
of deleting — if a protected key ever reaches it.  A seeded adversarial
test (tests/test_torch_lifecycle.py) hammers randomized store/journal
states against the invariant.

The ``lifecycle.sweep`` fault-plane site fires at pass entry so fault runs
can fail whole passes and assert the scheduler survives.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from tieredstorage_tpu_torch.scrub.scrubber import (
    INDEXES_SUFFIX,
    LOG_SUFFIX,
    MANIFEST_SUFFIX,
)
from tieredstorage_tpu_torch.storage.core import (
    KeyNotFoundException,
    ObjectKey,
    StorageBackend,
    StorageBackendException,
)
from tieredstorage_tpu_torch.storage.lifecycle import DELETE, UPLOAD, UploadIntentJournal
from tieredstorage_tpu_torch.utils import faults
from tieredstorage_tpu_torch.utils.locks import new_lock, note_mutation
from tieredstorage_tpu_torch.utils.tracing import NOOP_TRACER

log = logging.getLogger(__name__)


class SweeperInvariantError(AssertionError):
    """A deletion of a manifest-reachable object was attempted (and refused)."""


@dataclass
class SweepReport:
    """One pass's ledger (JSON-shaped for status endpoints and tools)."""

    started_at: float = 0.0
    duration_s: float = 0.0
    objects_listed: int = 0
    manifests_checked: int = 0
    orphans_deleted: List[str] = field(default_factory=list)
    orphans_pending: List[str] = field(default_factory=list)
    quarantined: List[str] = field(default_factory=list)
    tombstones_completed: int = 0
    journal_resolved: int = 0
    delete_failures: List[str] = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "duration_s": round(self.duration_s, 6),
            "objects_listed": self.objects_listed,
            "manifests_checked": self.manifests_checked,
            "orphans_deleted": list(self.orphans_deleted),
            "orphans_pending": list(self.orphans_pending),
            "quarantined": list(self.quarantined),
            "tombstones_completed": self.tombstones_completed,
            "journal_resolved": self.journal_resolved,
            "delete_failures": list(self.delete_failures),
        }


class RecoverySweeper:
    """Reconcile journal + store listing against manifest reachability."""

    def __init__(
        self,
        storage: StorageBackend,
        journal: Optional[UploadIntentJournal] = None,
        *,
        prefix: str = "",
        grace_s: float = 300.0,
        manifest_loader: Optional[Callable[[str], object]] = None,
        tracer=NOOP_TRACER,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._storage = storage
        self._journal = journal
        self.prefix = prefix
        self.grace_s = grace_s
        #: Loads + parses a manifest by key value; returning the manifest
        #: object (with segment_indexes) or raising.  The RSM wires its own
        #: decoder-aware loader; standalone use falls back to raw-read
        #: (reachability needs only *readability*, not decryption).
        self._manifest_loader = manifest_loader or self._read_manifest_raw
        self.tracer = tracer
        self._clock = clock
        self._lock = new_lock("sweeper.RecoverySweeper._lock")
        #: Orphan candidate → monotonic instant this sweeper first saw it.
        self._first_seen: Dict[str, float] = {}
        #: len(_first_seen) snapshotted at the end of each pass so gauges
        #: and status() never block behind a sweep holding the pass lock.
        self._orphans_pending_count = 0
        #: Manifest keys quarantined by the LAST pass (recomputed per pass).
        self._quarantined: frozenset = frozenset()
        # Cumulative counters (gauge suppliers read these).
        self.sweeps = 0
        self.orphans_deleted_total = 0
        self.tombstones_gcd_total = 0
        self.quarantines_total = 0
        self.journal_resolved_total = 0
        self.invariant_blocks_total = 0
        self.sweep_failures_total = 0
        self.last_report: Optional[SweepReport] = None

    # ---------------------------------------------------------------- queries
    def is_quarantined(self, key_value: str) -> bool:
        return key_value in self._quarantined

    @property
    def quarantined_manifests(self) -> frozenset:
        return self._quarantined

    @property
    def orphans_pending(self) -> int:
        """Orphan candidates inside their grace window, as of the end of
        the last pass.  Deliberately lock-free: a sweep holds the pass
        lock across the store listing and per-key deletes, and metrics
        gauges / status endpoints must not block for that long."""
        return self._orphans_pending_count

    # ------------------------------------------------------------------- pass
    def sweep_once(self) -> SweepReport:
        """One reconciliation pass; raises on listing failure (the
        scheduler counts and survives), converges on everything else."""
        with self._lock:
            try:
                report = self._sweep_locked()
            except Exception:
                self.sweep_failures_total += 1
                raise
            self.sweeps += 1
            note_mutation("sweeper.RecoverySweeper.sweeps")
            self.last_report = report
            return report

    def _sweep_locked(self) -> SweepReport:
        report = SweepReport(started_at=self._clock())
        start = self._clock()
        faults.fire("lifecycle.sweep", self.prefix)
        with self.tracer.span("lifecycle.sweep", prefix=self.prefix):
            inventory = [k.value for k in self._storage.list_objects(self.prefix)]
            report.objects_listed = len(inventory)
            present = set(inventory)
            protected = self._protected_set(present, report)
            self._reconcile_journal(present, protected, report)
            self._sweep_orphans(present, protected, report)
            # Second reconciliation so an intent whose stranded keys this
            # very pass just deleted resolves NOW, not one period later.
            self._reconcile_journal(present, protected, report)
        report.duration_s = self._clock() - start
        if report.orphans_deleted or report.quarantined:
            log.warning(
                "Recovery sweep: deleted %d orphan(s), quarantined %d "
                "manifest(s), %d pending grace",
                len(report.orphans_deleted), len(report.quarantined),
                len(report.orphans_pending),
            )
        self.tracer.event(
            "lifecycle.sweep_complete",
            orphans_deleted=len(report.orphans_deleted),
            quarantined=len(report.quarantined),
        )
        return report

    # ------------------------------------------------------------ reachability
    def _protected_set(self, present: set, report: SweepReport) -> set:
        """Everything a present manifest reaches — the set this sweeper may
        NEVER delete.  A quarantined manifest still protects its keys: the
        broker's retried copy heals in place, and deleting a sick
        segment's surviving half would destroy repair evidence."""
        protected: set = set()
        quarantined_now: set = set()
        for manifest_key in (k for k in present if k.endswith(MANIFEST_SUFFIX)):
            report.manifests_checked += 1
            stem = manifest_key[: -len(MANIFEST_SUFFIX)]
            log_key = stem + LOG_SUFFIX
            indexes_key = stem + INDEXES_SUFFIX
            protected.update((manifest_key, log_key, indexes_key))
            try:
                manifest = self._manifest_loader(manifest_key)
            except Exception as e:  # noqa: BLE001 — unreadable → quarantine
                quarantined_now.add(manifest_key)
                report.quarantined.append(manifest_key)
                log.warning("Quarantining unreadable manifest %s: %s",
                            manifest_key, e)
                continue
            missing = []
            if log_key not in present:
                missing.append(log_key)
            indexes_size = getattr(
                getattr(manifest, "segment_indexes", None), "total_size", 0
            )
            if indexes_size and indexes_key not in present:
                missing.append(indexes_key)
            if missing:
                quarantined_now.add(manifest_key)
                report.quarantined.append(manifest_key)
                log.warning(
                    "Quarantining manifest %s: references missing %s",
                    manifest_key, missing,
                )
        newly = quarantined_now - self._quarantined
        self.quarantines_total += len(newly)
        self._quarantined = frozenset(quarantined_now)
        note_mutation("sweeper.RecoverySweeper._quarantined")
        return protected

    def _read_manifest_raw(self, manifest_key: str):
        """Fallback loader: reachability only needs the object to be
        readable JSON-bearing bytes; returns a size-less stub."""
        with self._storage.fetch(ObjectKey(manifest_key)) as stream:
            stream.read()
        return None

    # ---------------------------------------------------------------- journal
    def _reconcile_journal(
        self, present: set, protected: set, report: SweepReport
    ) -> None:
        if self._journal is None:
            return
        for entry in self._journal.pending():
            if entry.inflight:
                # The owning copy/delete is running RIGHT NOW in this
                # process.  Its outcome is not ours to decide: committing
                # it early double-counts, rolling it back un-names an
                # upload whose first byte merely hasn't landed yet, and
                # finishing its delete races the owner.  The owner (or
                # its release() + a later pass) resolves it.
                continue
            manifest_keys = [k for k in entry.keys if k.endswith(MANIFEST_SUFFIX)]
            if entry.kind == UPLOAD:
                if any(k in present for k in manifest_keys):
                    # Crash (or failed best-effort append) AFTER the
                    # manifest landed: the segment committed; re-record it.
                    self._journal.commit(entry.txn)
                    self.journal_resolved_total += 1
                    report.journal_resolved += 1
                elif not any(k in present for k in entry.keys):
                    # Nothing stranded (rollback record was lost, or the
                    # crash predated the first byte): resolve the intent.
                    self._journal.rollback(entry.txn)
                    self.journal_resolved_total += 1
                    report.journal_resolved += 1
            elif entry.kind == DELETE:
                remaining = [k for k in entry.keys if k in present]
                if not remaining:
                    self._journal.commit_delete(entry.txn)
                    self.tombstones_gcd_total += 1
                    report.tombstones_completed += 1
                    report.journal_resolved += 1
                else:
                    # Finish the delete — but ONLY the manifest-unreachable
                    # part; a still-present manifest means the delete's
                    # manifest-first phase never ran, and completing it is
                    # the broker's retried delete's job, not ours.
                    deletable = [k for k in remaining if k not in protected]
                    for key in deletable:
                        self._delete_orphan(key, present, protected, report)
                    if deletable and not any(
                        k in present for k in entry.keys
                    ):
                        self._journal.commit_delete(entry.txn)
                        self.tombstones_gcd_total += 1
                        report.tombstones_completed += 1
                        report.journal_resolved += 1

    def _journal_key_sets(self) -> tuple:
        """``(named, inflight)`` key sets from the pending journal.
        ``named`` keys belong to resolved-from-our-side intents (the
        owning operation is no longer running) — deletable without grace:
        OUR journal proves no commit happened.  ``inflight`` keys belong
        to operations running right now in this process — untouchable,
        not even grace-tracked (a key in both sets, e.g. a retried copy
        of a previously-stranded segment, counts as in flight)."""
        if self._journal is None:
            return set(), set()
        named: set = set()
        inflight: set = set()
        for entry in self._journal.pending():
            (inflight if entry.inflight else named).update(entry.keys)
        return named - inflight, inflight

    # ---------------------------------------------------------------- orphans
    def _sweep_orphans(
        self, present: set, protected: set, report: SweepReport
    ) -> None:
        named, inflight = self._journal_key_sets()
        now = self._clock()
        candidates = [
            k for k in present
            if k not in protected and not k.endswith(MANIFEST_SUFFIX)
            and k not in inflight
        ]
        # Drop first-seen tracking for keys that stopped being candidates
        # (committed by a late manifest, deleted by their writer, or
        # claimed by a new in-flight operation).
        candidate_set = set(candidates)
        for stale in [k for k in self._first_seen if k not in candidate_set]:
            del self._first_seen[stale]
        note_mutation("sweeper.RecoverySweeper._first_seen")
        for key in sorted(candidates):
            if key in named:
                self._delete_orphan(key, present, protected, report)
                self._first_seen.pop(key, None)
                continue
            first = self._first_seen.setdefault(key, now)
            if now - first >= self.grace_s:
                self._delete_orphan(key, present, protected, report)
                self._first_seen.pop(key, None)
            else:
                report.orphans_pending.append(key)
        self._orphans_pending_count = len(self._first_seen)

    def _delete_orphan(
        self, key: str, present: set, protected: set, report: SweepReport
    ) -> None:
        """THE deletion chokepoint — re-checks one-sidedness before every
        delete.  Nothing else in this class calls ``storage.delete``."""
        if key in protected or key.endswith(MANIFEST_SUFFIX):
            self.invariant_blocks_total += 1
            raise SweeperInvariantError(
                f"refusing to delete manifest-reachable object {key!r}"
            )
        try:
            self._storage.delete(ObjectKey(key))
        except KeyNotFoundException:
            pass  # already gone — converged
        except StorageBackendException as e:
            report.delete_failures.append(key)
            log.warning("Sweeper failed to delete orphan %s: %s", key, e)
            return
        present.discard(key)
        self.orphans_deleted_total += 1
        report.orphans_deleted.append(key)


STOPPED, IDLE, SWEEPING = 0, 1, 2
_STATE_NAMES = {STOPPED: "stopped", IDLE: "idle", SWEEPING: "sweeping"}


class SweepScheduler:
    """Paced recovery sweeps on a daemon thread (the ScrubScheduler shape:
    jittered first pass, run_now() wake, a failed pass never kills the
    loop)."""

    def __init__(
        self,
        sweeper: RecoverySweeper,
        *,
        interval_ms: int,
        jitter_seed: Optional[int] = None,
    ) -> None:
        import random
        import threading

        if interval_ms < 1:
            raise ValueError("interval_ms must be >= 1")
        self.sweeper = sweeper
        self.interval_s = interval_ms / 1000.0
        self._initial_delay_s = random.Random(jitter_seed).uniform(
            0.0, self.interval_s
        )
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = None
        self._state = STOPPED
        self._last_error: Optional[str] = None

    def start(self) -> "SweepScheduler":
        import threading

        if self._thread is not None:
            raise RuntimeError("SweepScheduler already started")
        self._state = IDLE
        self._thread = threading.Thread(
            target=self._run, name="lifecycle-sweeper", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        self._state = STOPPED

    def run_now(self) -> None:
        """Skip the current sleep; the next sweep starts immediately."""
        self._wake.set()

    def _run(self) -> None:
        delay = self._initial_delay_s
        while not self._stop.is_set():
            self._wake.wait(timeout=delay)
            self._wake.clear()
            if self._stop.is_set():
                return
            self._state = SWEEPING
            try:
                self.sweeper.sweep_once()
                self._last_error = None
            except Exception as e:  # noqa: BLE001 — the loop must survive a bad pass
                self._last_error = f"{type(e).__name__}: {e}"
                log.warning("Recovery sweep failed", exc_info=True)
            finally:
                self._state = IDLE
            delay = self.interval_s

    @property
    def state_code(self) -> int:
        return self._state

    def status(self) -> dict:
        sweeper = self.sweeper
        out = {
            "state": _STATE_NAMES[self._state],
            "interval_ms": int(self.interval_s * 1000),
            "sweeps": sweeper.sweeps,
            "orphans_deleted_total": sweeper.orphans_deleted_total,
            "orphans_pending": sweeper.orphans_pending,
            "tombstones_gcd_total": sweeper.tombstones_gcd_total,
            "quarantined_manifests": sorted(sweeper.quarantined_manifests),
            "quarantines_total": sweeper.quarantines_total,
            "journal_resolved_total": sweeper.journal_resolved_total,
            "invariant_blocks_total": sweeper.invariant_blocks_total,
            "sweep_failures_total": sweeper.sweep_failures_total,
            "last_error": self._last_error,
        }
        if sweeper.last_report is not None:
            out["last_pass"] = sweeper.last_report.to_json()
        return out
