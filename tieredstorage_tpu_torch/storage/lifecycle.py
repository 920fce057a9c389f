"""Upload intent journal: the durable half of crash-consistent lifecycle.

Counterpart of tieredstorage_tpu/storage/lifecycle.py, whole, with the same
records: a journal either package writes replays in the other to the same
state.  Retries make *transient* faults survivable; this module makes the
segment lifecycle survive the process dying mid-operation.  The journal
is a tiny append-only JSONL WAL that records *intent* before the first byte
of a segment upload (or delete) touches the object store, and records the
outcome when the operation finishes:

``{"rec": "begin",     "txn": N, "segment": ..., "keys": [...]}``
    Appended (and fsynced) BEFORE ``_storage_upload`` consumes any bytes.
    Names exactly the object keys a crash may strand.
``{"rec": "stage",     "txn": N, "stage": "log-uploaded" | "indexes-uploaded"}``
    Progress marks between the triple's uploads — purely diagnostic; the
    recovery sweeper never trusts them over the store listing.
``{"rec": "commit",    "txn": N}``
    The manifest landed.  Manifest-last stays the SOLE commit point: the
    journal never redefines commit, it only names what an uncommitted crash
    may have left behind.
``{"rec": "rollback",  "txn": N}``
    In-process orphan cleanup already deleted the partial triple.
``{"rec": "tombstone", "txn": N, "segment": ..., "keys": [...]}``
    Delete intent, fsynced before the first delete — a retried or
    crash-interrupted ``delete_log_segment_data`` converges because the
    sweeper finishes what the tombstone names (manifest-unreachable keys
    only) and GCs the tombstone once every named key is gone.
``{"rec": "tombstone-commit", "txn": N}``
    The triple is fully deleted.

Durability policy: records that *gate* store mutations (``begin``,
``tombstone``) are critical — an append failure fails the operation before
any store byte moves, so the store can never hold state the journal does not
name.  Outcome records (``commit``, ``stage``, ``rollback``,
``tombstone-commit``) are best-effort: by the time they are written the
store already reflects the outcome, so a failed append must NOT fail the
(already durable) operation — it leaves the entry pending and the recovery
sweeper re-derives the outcome from manifest reachability on its next pass
(a pending upload whose manifest exists is simply re-committed).  Failed
best-effort appends are still visible: ``append_failures_total`` counts
them (no failure is swallowed invisibly).

Replay tolerates a torn trailing line (the crash artifact of dying
mid-append); torn records are counted, never fatal.  ``compact()`` rewrites
the file with only the still-pending entries via a temp file +
``os.replace`` so the journal stays small across long uptimes.

**In-flight tracking** (process-local, never persisted): ``begin_upload``/
``begin_delete`` mark their txn *in flight* until the owning operation
returns — ``commit``/``rollback``/``commit_delete`` clear it, and the RSM's
copy/delete paths call ``release(txn)`` in a ``finally`` so a txn left
pending by a failed rollback cleanup is still released.  A pending entry
whose txn is in flight belongs to an operation running RIGHT NOW in this
process; the recovery sweeper must neither resolve it nor touch its keys
(a paced sweep racing a live upload would otherwise delete objects the
copy is about to commit).  Entries rebuilt by replay are never in flight —
the process that began them is dead.

The ``lifecycle.journal`` fault-plane site (utils/faults.py) fires before
every append, so fault runs can fail/stall journaling without touching the
store.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from tieredstorage_tpu_torch.utils import faults
from tieredstorage_tpu_torch.utils.locks import new_lock, note_mutation

log = logging.getLogger(__name__)

#: Rewrite threshold: when the file grows past this many bytes AND most of
#: it is resolved history, append() triggers an inline compaction.
DEFAULT_COMPACT_BYTES = 1 << 20

UPLOAD = "upload"
DELETE = "delete"

#: Stage marks recorded between the triple's uploads (diagnostic only).
STAGE_LOG_UPLOADED = "log-uploaded"
STAGE_INDEXES_UPLOADED = "indexes-uploaded"


class JournalAppendError(RuntimeError):
    """A critical journal append (begin/tombstone) could not be made durable."""


@dataclass
class JournalEntry:
    """One pending transaction: an upload intent or a delete tombstone."""

    txn: int
    kind: str  # UPLOAD | DELETE
    segment: str
    keys: List[str]
    stage: Optional[str] = None
    #: The owning operation is running right now in THIS process (snapshot
    #: taken by pending()); such entries are untouchable to the sweeper.
    inflight: bool = False

    def to_json(self) -> dict:
        return {
            "txn": self.txn,
            "kind": self.kind,
            "segment": self.segment,
            "keys": list(self.keys),
            "stage": self.stage,
            "inflight": self.inflight,
        }


@dataclass
class _Counters:
    appends_total: int = 0
    append_failures_total: int = 0
    torn_records_total: int = 0
    compactions_total: int = 0
    commits_total: int = 0
    rollbacks_total: int = 0
    tombstones_total: int = 0
    tombstone_commits_total: int = 0
    replayed_entries: int = 0
    extra: dict = field(default_factory=dict)


class UploadIntentJournal:
    """Durable WAL of segment lifecycle intents (see module docstring).

    Thread-safe: RSM copy/delete threads and the sweeper thread append and
    resolve concurrently under one named lock.  All file writes happen
    under the lock; fsync latency is bounded (records are < 1 KiB) and
    dwarfed by the segment upload the record guards.
    """

    def __init__(
        self, path: Path, *, compact_bytes: int = DEFAULT_COMPACT_BYTES
    ) -> None:
        self.path = Path(path)
        self.compact_bytes = compact_bytes
        self._lock = new_lock("lifecycle.UploadIntentJournal._lock")
        self._pending: Dict[int, JournalEntry] = {}
        #: Txns whose owning operation is running in this process (see the
        #: module docstring); never persisted, never populated by replay.
        self._inflight: set = set()
        self._next_txn = 1
        self._c = _Counters()
        self._closed = False
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._replay()
        # Opened AFTER replay so a compaction during replay doesn't race a
        # stale handle; line-buffered append, fsynced per critical record.
        self._fh = open(self.path, "a", encoding="utf-8")

    # ---------------------------------------------------------------- intents
    def begin_upload(self, segment: str, keys: List[str]) -> int:
        """Record upload intent; MUST be called before the first uploaded
        byte.  Raises JournalAppendError if the record cannot be made
        durable — the copy then fails while the store is still clean."""
        with self._lock:
            txn = self._next_txn
            self._next_txn += 1
            note_mutation("lifecycle.UploadIntentJournal._next_txn")
            entry = JournalEntry(txn, UPLOAD, segment, list(keys))
            self._append(
                {"rec": "begin", "txn": txn, "segment": segment,
                 "keys": list(keys)},
                critical=True,
            )
            self._pending[txn] = entry
            self._inflight.add(txn)
            note_mutation("lifecycle.UploadIntentJournal._pending")
            return txn

    def stage(self, txn: int, stage: str) -> None:
        """Mark upload progress (best-effort, diagnostic)."""
        with self._lock:
            entry = self._pending.get(txn)
            if entry is None:
                return
            entry.stage = stage
            self._append({"rec": "stage", "txn": txn, "stage": stage},
                         critical=False)

    def commit(self, txn: int) -> None:
        """The manifest landed: the transaction is durable in the store."""
        with self._lock:
            if self._pending.pop(txn, None) is None:
                return
            self._inflight.discard(txn)
            note_mutation("lifecycle.UploadIntentJournal._pending")
            self._c.commits_total += 1
            self._append({"rec": "commit", "txn": txn}, critical=False)
            self._maybe_compact()

    def rollback(self, txn: int) -> None:
        """In-process cleanup deleted the partial triple; nothing strands."""
        with self._lock:
            if self._pending.pop(txn, None) is None:
                return
            self._inflight.discard(txn)
            note_mutation("lifecycle.UploadIntentJournal._pending")
            self._c.rollbacks_total += 1
            self._append({"rec": "rollback", "txn": txn}, critical=False)
            self._maybe_compact()

    def begin_delete(self, segment: str, keys: List[str]) -> int:
        """Record a delete tombstone; MUST precede the first store delete."""
        with self._lock:
            txn = self._next_txn
            self._next_txn += 1
            note_mutation("lifecycle.UploadIntentJournal._next_txn")
            entry = JournalEntry(txn, DELETE, segment, list(keys))
            self._append(
                {"rec": "tombstone", "txn": txn, "segment": segment,
                 "keys": list(keys)},
                critical=True,
            )
            self._c.tombstones_total += 1
            self._pending[txn] = entry
            self._inflight.add(txn)
            note_mutation("lifecycle.UploadIntentJournal._pending")
            return txn

    def commit_delete(self, txn: int) -> None:
        """Every key the tombstone names is gone; GC the tombstone."""
        with self._lock:
            if self._pending.pop(txn, None) is None:
                return
            self._inflight.discard(txn)
            note_mutation("lifecycle.UploadIntentJournal._pending")
            self._c.tombstone_commits_total += 1
            self._append({"rec": "tombstone-commit", "txn": txn},
                         critical=False)
            self._maybe_compact()

    def release(self, txn: int) -> None:
        """The operation owning ``txn`` has returned (committed, rolled
        back, or failed with its entry left pending): clear the in-flight
        mark so the recovery sweeper may act on whatever it left behind.
        Called from a ``finally`` on the RSM copy/delete paths; idempotent,
        a no-op for resolved or unknown txns.  Appends nothing — in-flight
        is process-local state, meaningless across restarts."""
        with self._lock:
            self._inflight.discard(txn)
            note_mutation("lifecycle.UploadIntentJournal._inflight")

    # ---------------------------------------------------------------- queries
    def pending(self) -> List[JournalEntry]:
        with self._lock:
            return [
                JournalEntry(e.txn, e.kind, e.segment, list(e.keys), e.stage,
                             inflight=e.txn in self._inflight)
                for e in self._pending.values()
            ]

    def pending_uploads(self) -> List[JournalEntry]:
        return [e for e in self.pending() if e.kind == UPLOAD]

    def pending_tombstones(self) -> List[JournalEntry]:
        return [e for e in self.pending() if e.kind == DELETE]

    @property
    def pending_upload_count(self) -> int:
        with self._lock:
            return sum(1 for e in self._pending.values() if e.kind == UPLOAD)

    @property
    def pending_tombstone_count(self) -> int:
        with self._lock:
            return sum(1 for e in self._pending.values() if e.kind == DELETE)

    @property
    def appends_total(self) -> int:
        return self._c.appends_total

    @property
    def append_failures_total(self) -> int:
        return self._c.append_failures_total

    @property
    def torn_records_total(self) -> int:
        return self._c.torn_records_total

    @property
    def compactions_total(self) -> int:
        return self._c.compactions_total

    @property
    def commits_total(self) -> int:
        return self._c.commits_total

    @property
    def rollbacks_total(self) -> int:
        return self._c.rollbacks_total

    @property
    def tombstones_total(self) -> int:
        return self._c.tombstones_total

    @property
    def tombstone_commits_total(self) -> int:
        return self._c.tombstone_commits_total

    def status(self) -> dict:
        with self._lock:
            return {
                "path": str(self.path),
                "pending_uploads": sum(
                    1 for e in self._pending.values() if e.kind == UPLOAD
                ),
                "pending_tombstones": sum(
                    1 for e in self._pending.values() if e.kind == DELETE
                ),
                "inflight": len(self._inflight),
                "appends_total": self._c.appends_total,
                "append_failures_total": self._c.append_failures_total,
                "torn_records_total": self._c.torn_records_total,
                "compactions_total": self._c.compactions_total,
                "commits_total": self._c.commits_total,
                "rollbacks_total": self._c.rollbacks_total,
                "tombstones_total": self._c.tombstones_total,
                "tombstone_commits_total": self._c.tombstone_commits_total,
            }

    # -------------------------------------------------------------- internals
    def _append(self, record: dict, *, critical: bool) -> None:
        """Append one JSONL record; fsync.  Critical failures raise
        JournalAppendError (the guarded store mutation must not proceed);
        best-effort failures are counted and logged — the sweeper
        re-derives the lost outcome from manifest reachability."""
        self._c.appends_total += 1
        note_mutation("lifecycle.UploadIntentJournal._c")
        try:
            faults.fire("lifecycle.journal", record.get("rec", ""))
            self._fh.write(json.dumps(record, sort_keys=True) + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())
        except Exception as e:
            self._c.append_failures_total += 1
            if critical:
                raise JournalAppendError(
                    f"journal append failed for {record.get('rec')}: {e}"
                ) from e
            log.warning(
                "Best-effort journal append failed (%s txn=%s); the recovery "
                "sweeper will re-derive the outcome",
                record.get("rec"), record.get("txn"), exc_info=True,
            )

    def _replay(self) -> None:
        """Rebuild pending state from the file; torn trailing data (a crash
        mid-append) is tolerated and counted.  Runs under the lock (only
        from __init__, but the counters' guard must be uniform)."""
        with self._lock:
            self._replay_locked()

    def _replay_locked(self) -> None:
        if not self.path.exists():
            return
        raw = self.path.read_bytes()
        for line in raw.split(b"\n"):
            if not line.strip():
                continue
            try:
                rec = json.loads(line.decode("utf-8"))
                kind = rec["rec"]
                txn = int(rec["txn"])
            except (ValueError, KeyError, UnicodeDecodeError):
                self._c.torn_records_total += 1
                continue
            if kind == "begin":
                self._pending[txn] = JournalEntry(
                    txn, UPLOAD, str(rec.get("segment", "")),
                    [str(k) for k in rec.get("keys", [])],
                )
            elif kind == "tombstone":
                # Replay only rebuilds pending state; tombstones_total was
                # already counted by the begin_delete that wrote the record
                # (re-counting here would skew the metric on every restart
                # or compact-then-replay cycle).
                self._pending[txn] = JournalEntry(
                    txn, DELETE, str(rec.get("segment", "")),
                    [str(k) for k in rec.get("keys", [])],
                )
            elif kind == "stage":
                entry = self._pending.get(txn)
                if entry is not None:
                    entry.stage = str(rec.get("stage"))
            elif kind in ("commit", "rollback", "tombstone-commit"):
                self._pending.pop(txn, None)
            else:
                self._c.torn_records_total += 1
                continue
            self._next_txn = max(self._next_txn, txn + 1)
        self._c.replayed_entries = len(self._pending)
        if self._pending:
            log.info(
                "Lifecycle journal replay: %d pending entrie(s) "
                "(a prior process may have crashed mid-operation)",
                len(self._pending),
            )

    def _maybe_compact(self) -> None:
        """Inline compaction once the file outgrows compact_bytes (called
        under the lock after an entry resolves)."""
        try:
            if self.path.stat().st_size < self.compact_bytes:
                return
        except OSError:
            return
        self._compact_locked()

    def compact(self) -> None:
        """Rewrite the journal with only the pending entries."""
        with self._lock:
            self._compact_locked()

    def _compact_locked(self) -> None:
        tmp = self.path.with_suffix(self.path.suffix + ".compact")
        try:
            with open(tmp, "w", encoding="utf-8") as out:
                for entry in self._pending.values():
                    rec = "begin" if entry.kind == UPLOAD else "tombstone"
                    out.write(json.dumps(
                        {"rec": rec, "txn": entry.txn,
                         "segment": entry.segment, "keys": list(entry.keys)},
                        sort_keys=True,
                    ) + "\n")
                out.flush()
                os.fsync(out.fileno())
            self._fh.close()
            os.replace(tmp, self.path)
            self._fh = open(self.path, "a", encoding="utf-8")
            self._c.compactions_total += 1
        except OSError:
            log.warning("Journal compaction failed; keeping the long file",
                        exc_info=True)
            try:
                tmp.unlink(missing_ok=True)
            except OSError:
                pass
            if self._fh.closed:
                self._fh = open(self.path, "a", encoding="utf-8")

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            note_mutation("lifecycle.UploadIntentJournal._closed")
            try:
                self._fh.close()
            except OSError:  # pragma: no cover — close failure is terminal anyway
                pass

    def __enter__(self) -> "UploadIntentJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
