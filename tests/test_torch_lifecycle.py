"""The port's crash-consistent lifecycle: the upload intent journal, the
recovery sweeper and their RSM wiring, against the JAX twins.

The JAX package's journal and sweeper cases run against the port's modules
(storage/lifecycle.py, scrub/sweeper.py). Then parity with no tolerance: a
journal written by either package (begin, stage, commit, rollback,
tombstone, a torn last line) replays in the other to the same pending
entries, next txn and counters; ``compact()`` writes the same file; both
sweepers give the same reports and final listing over the same store,
journal and clock. Last, the crash drill on the port's RSM (the in-process
kill is a BaseException raised from the upload seam, which escapes the
rollback's ``except Exception``), and across packages both ways: one
package's RSM dies at upload 3, the other's startup sweep deletes exactly
the two stranded objects, and the retried copy reads back through the
first.
"""

from __future__ import annotations

import io
import json
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest

from tieredstorage_tpu import metadata as jax_metadata
from tieredstorage_tpu.manifest import segment_manifest as jax_segment_manifest
from tieredstorage_tpu.rsm import RemoteStorageManager as JaxRemoteStorageManager
from tieredstorage_tpu.scrub import sweeper as jax_sweeper
from tieredstorage_tpu.storage import lifecycle as jax_lifecycle
from tieredstorage_tpu.storage import memory as jax_memory
from tieredstorage_tpu.storage.core import ObjectKey as JaxObjectKey
from tieredstorage_tpu.utils import faults as jax_faults
from tieredstorage_tpu_torch import metadata
from tieredstorage_tpu_torch.errors import RemoteStorageException
from tieredstorage_tpu_torch.manifest import segment_manifest
from tieredstorage_tpu_torch.rsm import RemoteStorageManager
from tieredstorage_tpu_torch.scrub import sweeper as port_sweeper
from tieredstorage_tpu_torch.scrub.sweeper import (
    RecoverySweeper,
    SweeperInvariantError,
    SweepScheduler,
)
from tieredstorage_tpu_torch.storage import lifecycle as port_lifecycle
from tieredstorage_tpu_torch.storage import memory as port_memory
from tieredstorage_tpu_torch.storage.core import ObjectKey, StorageBackendException
from tieredstorage_tpu_torch.storage.lifecycle import (
    DELETE,
    STAGE_INDEXES_UPLOADED,
    STAGE_LOG_UPLOADED,
    UPLOAD,
    JournalAppendError,
    UploadIntentJournal,
)
from tieredstorage_tpu_torch.storage.memory import InMemoryStorage
from tieredstorage_tpu_torch.utils import faults
from tieredstorage_tpu_torch.utils.faults import FaultPlane


@pytest.fixture(autouse=True)
def _pristine_plane():
    prior = faults.install(None)
    jax_prior = jax_faults.install(None)
    try:
        yield
    finally:
        faults.install(prior)
        jax_faults.install(jax_prior)


KEYS = ["t/s1.log", "t/s1.indexes", "t/s1.rsm-manifest"]


def reopen(path):
    return UploadIntentJournal(path)


class TestIntentRoundTrip:
    def test_begin_is_durable_before_return(self, tmp_path):
        path = tmp_path / "wal" / "journal.jsonl"
        with UploadIntentJournal(path) as j:
            txn = j.begin_upload("seg-1", KEYS)
            # The intent must be replayable from DISK at this instant — a
            # kill -9 here is the exact scenario the journal exists for.
            with reopen(path) as fresh:
                (entry,) = fresh.pending()
                assert entry.txn == txn
                assert entry.kind == UPLOAD
                assert entry.keys == KEYS

    def test_commit_resolves(self, tmp_path):
        path = tmp_path / "j.wal"
        with UploadIntentJournal(path) as j:
            txn = j.begin_upload("seg-1", KEYS)
            j.commit(txn)
            assert j.pending() == []
            assert j.commits_total == 1
        with reopen(path) as fresh:
            assert fresh.pending() == []

    def test_rollback_resolves(self, tmp_path):
        path = tmp_path / "j.wal"
        with UploadIntentJournal(path) as j:
            txn = j.begin_upload("seg-1", KEYS)
            j.rollback(txn)
            assert j.pending() == []
            assert j.rollbacks_total == 1

    def test_stage_marks_survive_replay(self, tmp_path):
        path = tmp_path / "j.wal"
        with UploadIntentJournal(path) as j:
            txn = j.begin_upload("seg-1", KEYS)
            j.stage(txn, STAGE_LOG_UPLOADED)
            j.stage(txn, STAGE_INDEXES_UPLOADED)
        with reopen(path) as fresh:
            (entry,) = fresh.pending()
            assert entry.stage == STAGE_INDEXES_UPLOADED

    def test_tombstone_round_trip(self, tmp_path):
        path = tmp_path / "j.wal"
        with UploadIntentJournal(path) as j:
            txn = j.begin_delete("seg-1", KEYS)
            assert j.pending_tombstone_count == 1
        with reopen(path) as fresh:
            (entry,) = fresh.pending_tombstones()
            assert entry.kind == DELETE and entry.keys == KEYS
            fresh.commit_delete(entry.txn)
            assert fresh.pending() == []
        with reopen(path) as again:
            assert again.pending() == []

    def test_txn_ids_monotonic_across_restarts(self, tmp_path):
        path = tmp_path / "j.wal"
        with UploadIntentJournal(path) as j:
            t1 = j.begin_upload("a", KEYS)
            j.commit(t1)
        with reopen(path) as j2:
            t2 = j2.begin_upload("b", KEYS)
            assert t2 > t1

    def test_resolving_unknown_txn_is_noop(self, tmp_path):
        with UploadIntentJournal(tmp_path / "j.wal") as j:
            j.commit(999)
            j.rollback(999)
            j.commit_delete(999)
            j.stage(999, STAGE_LOG_UPLOADED)
            assert j.commits_total == 0 and j.rollbacks_total == 0


class TestInflight:
    """In-flight tracking: begin marks the txn as owned by a running
    operation; commit/rollback/commit_delete/release clear it; replay
    never marks (the process that began the txn is dead)."""

    def test_begin_marks_inflight_and_release_clears(self, tmp_path):
        with UploadIntentJournal(tmp_path / "j.wal") as j:
            txn = j.begin_upload("seg-1", KEYS)
            (entry,) = j.pending()
            assert entry.inflight
            j.release(txn)
            (entry,) = j.pending()
            assert not entry.inflight  # still pending, no longer owned
            j.release(txn)  # idempotent
            j.release(999)  # unknown txn: no-op

    def test_resolution_clears_inflight(self, tmp_path):
        with UploadIntentJournal(tmp_path / "j.wal") as j:
            j.commit(j.begin_upload("u", KEYS))
            j.rollback(j.begin_upload("r", KEYS))
            j.commit_delete(j.begin_delete("d", KEYS))
            assert j.status()["inflight"] == 0

    def test_replayed_entries_are_not_inflight(self, tmp_path):
        path = tmp_path / "j.wal"
        with UploadIntentJournal(path) as j:
            j.begin_upload("seg-u", KEYS)
            j.begin_delete("seg-d", KEYS)
        with reopen(path) as fresh:
            assert fresh.status()["inflight"] == 0
            assert all(not e.inflight for e in fresh.pending())

    def test_replay_does_not_recount_tombstones(self, tmp_path):
        path = tmp_path / "j.wal"
        with UploadIntentJournal(path) as j:
            j.begin_delete("seg-d", KEYS)
            assert j.tombstones_total == 1
        # begin_delete already counted it; a pending tombstone surviving
        # a restart (or a compact-then-reopen cycle) must not count again.
        with reopen(path) as fresh:
            assert fresh.tombstones_total == 0
            assert fresh.pending_tombstone_count == 1
            fresh.compact()
        with reopen(path) as again:
            assert again.tombstones_total == 0
            assert again.pending_tombstone_count == 1


class TestCrashArtifacts:
    def test_torn_trailing_line_is_tolerated(self, tmp_path):
        path = tmp_path / "j.wal"
        with UploadIntentJournal(path) as j:
            j.begin_upload("seg-1", KEYS)
        # Simulate dying mid-append: garbage half-record at the tail.
        with open(path, "ab") as fh:
            fh.write(b'{"rec": "beg')
        with reopen(path) as fresh:
            assert fresh.torn_records_total == 1
            (entry,) = fresh.pending()  # the durable intent survived
            assert entry.keys == KEYS

    def test_unknown_record_kind_counts_as_torn(self, tmp_path):
        path = tmp_path / "j.wal"
        path.write_text(json.dumps({"rec": "wat", "txn": 1}) + "\n")
        with UploadIntentJournal(path) as j:
            assert j.torn_records_total == 1
            assert j.pending() == []

    def test_missing_file_is_a_fresh_journal(self, tmp_path):
        with UploadIntentJournal(tmp_path / "sub" / "dir" / "j.wal") as j:
            assert j.pending() == []
            j.begin_upload("seg", KEYS)


class TestCompaction:
    def test_compact_keeps_only_pending(self, tmp_path):
        path = tmp_path / "j.wal"
        with UploadIntentJournal(path) as j:
            for i in range(50):
                j.commit(j.begin_upload(f"seg-{i}", KEYS))
            keep = j.begin_upload("keeper", KEYS)
            size_before = path.stat().st_size
            j.compact()
            assert path.stat().st_size < size_before
            assert j.compactions_total == 1
            (entry,) = j.pending()
            assert entry.txn == keep
        with reopen(path) as fresh:
            (entry,) = fresh.pending()
            assert entry.txn == keep and entry.keys == KEYS

    def test_inline_compaction_bounds_the_file(self, tmp_path):
        path = tmp_path / "j.wal"
        with UploadIntentJournal(path, compact_bytes=2048) as j:
            for i in range(200):
                j.commit(j.begin_upload(f"seg-{i}", KEYS))
            assert j.compactions_total >= 1
            assert path.stat().st_size < 2048 + 1024


class TestKindFidelity:
    """The UPLOAD/DELETE kind split must survive every view
    (pending_uploads / pending_tombstones / status) AND a
    compact-then-replay cycle; inline compaction must fire at EXACTLY
    compact_bytes. A flipped comparison in any of these silently
    misclassifies what a crash stranded."""

    def test_views_and_status_split_uploads_from_tombstones(self, tmp_path):
        # Deliberately ASYMMETRIC counts (2 vs 1): a flipped kind
        # comparison then produces the wrong number, not a mirror image.
        with UploadIntentJournal(tmp_path / "j.wal") as j:
            j.begin_upload("seg-u1", KEYS)
            j.begin_upload("seg-u2", KEYS)
            j.begin_delete("seg-d", KEYS)
            assert sorted(e.segment for e in j.pending_uploads()) == [
                "seg-u1", "seg-u2",
            ]
            assert [e.segment for e in j.pending_tombstones()] == ["seg-d"]
            status = j.status()
            assert status["pending_uploads"] == 2
            assert status["pending_tombstones"] == 1

    def test_compaction_preserves_kinds_across_replay(self, tmp_path):
        path = tmp_path / "j.wal"
        with UploadIntentJournal(path) as j:
            j.begin_upload("seg-u", KEYS)
            j.begin_delete("seg-d", KEYS)
            j.commit(j.begin_upload("resolved", KEYS))
            j.compact()
        with reopen(path) as fresh:
            assert [e.segment for e in fresh.pending_uploads()] == ["seg-u"]
            assert [e.segment for e in fresh.pending_tombstones()] == ["seg-d"]

    def test_inline_compaction_triggers_at_exact_threshold(self, tmp_path):
        def run(base, compact_bytes):
            base.mkdir()
            with UploadIntentJournal(
                base / "j.wal", compact_bytes=compact_bytes
            ) as j:
                j.begin_upload("pending", KEYS)
                j.commit(j.begin_upload("resolved", KEYS))
                return j.compactions_total, (base / "j.wal").stat().st_size

        # Dry run with an unreachable threshold: measure the file size at
        # the moment the post-resolve bound check runs.
        compactions, size = run(tmp_path / "dry", 1 << 30)
        assert compactions == 0
        # At EXACTLY that size the bound is crossed (size < compact_bytes
        # is false): the inline compaction must fire, not wait one more.
        compactions, _ = run(tmp_path / "exact", size)
        assert compactions == 1


class TestAppendFailurePolicy:
    def test_critical_append_failure_raises_and_strands_nothing(self, tmp_path):
        path = tmp_path / "j.wal"
        with UploadIntentJournal(path) as j:
            faults.install(FaultPlane.parse("lifecycle.journal:error@1"))
            with pytest.raises(JournalAppendError):
                j.begin_upload("seg-1", KEYS)
            faults.install(None)
            assert j.pending() == []
            assert j.append_failures_total == 1
            # The journal recovers for the retried copy.
            txn = j.begin_upload("seg-1", KEYS)
            assert txn >= 1

    def test_best_effort_commit_failure_is_swallowed_but_visible(self, tmp_path):
        path = tmp_path / "j.wal"
        with UploadIntentJournal(path) as j:
            txn = j.begin_upload("seg-1", KEYS)
            faults.install(FaultPlane.parse("lifecycle.journal:error@1"))
            j.commit(txn)  # must NOT raise: the manifest already landed
            faults.install(None)
            assert j.append_failures_total == 1
            # In-memory state resolved; only the FILE lost the record —
            # exactly what the sweeper re-derives from the store.
            assert j.pending() == []
        with reopen(path) as fresh:
            (entry,) = fresh.pending()  # replay sees the lost commit
            assert entry.txn == txn

    def test_tombstone_append_failure_raises(self, tmp_path):
        with UploadIntentJournal(tmp_path / "j.wal") as j:
            faults.install(FaultPlane.parse("lifecycle.journal:error@1"))
            with pytest.raises(JournalAppendError):
                j.begin_delete("seg-1", KEYS)


class TestConcurrency:
    def test_parallel_begins_get_unique_txns(self, tmp_path):
        with UploadIntentJournal(tmp_path / "j.wal") as j:
            txns: list[int] = []
            lock = threading.Lock()

            def worker(i: int) -> None:
                t = j.begin_upload(f"seg-{i}", KEYS)
                with lock:
                    txns.append(t)

            threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert len(set(txns)) == 16
            assert j.pending_upload_count == 16


# ------------------------------------------------------------------ sweeper
class TestOneSidedness:
    """The proof obligation: the sweeper may only ever delete
    manifest-UNreachable objects."""

    def _store_with(self, objects):
        store = InMemoryStorage()
        store.configure({})
        for key, blob in objects.items():
            store.upload(io.BytesIO(blob), ObjectKey(key))
        return store

    def _manifest_blob(self, indexes_size=10):
        return json.dumps({"segment_indexes_total": indexes_size}).encode()

    def _loader(self, store):
        class _M:
            class segment_indexes:
                total_size = 10
        def load(key):
            with store.fetch(ObjectKey(key)) as s:
                json.loads(s.read())  # unreadable JSON → raises → quarantine
            return _M
        return load

    def test_seeded_adversarial_random_states(self):
        import random

        rng = random.Random(0xC0FFEE)
        for trial in range(30):
            objects = {}
            committed_reachable = set()
            journal_named = []
            for i in range(rng.randint(1, 12)):
                stem = f"p/seg-{trial}-{i}"
                triple = [stem + ".log", stem + ".indexes",
                          stem + ".rsm-manifest"]
                shape = rng.random()
                if shape < 0.5:
                    # Committed: manifest + whatever data survived.
                    objects[triple[2]] = self._manifest_blob()
                    committed_reachable.add(triple[2])
                    for k in triple[:2]:
                        if rng.random() < 0.8:
                            objects[k] = b"d" * rng.randint(1, 64)
                            committed_reachable.add(k)
                else:
                    # Stranded: data only, no manifest.
                    for k in triple[:2]:
                        if rng.random() < 0.8:
                            objects[k] = b"d" * rng.randint(1, 64)
                    if rng.random() < 0.5:
                        journal_named.append((stem, triple))
            store = self._store_with(objects)
            journal = None
            if journal_named:
                import tempfile
                from pathlib import Path

                tmp = tempfile.mkdtemp(prefix="adv-journal-")
                journal = UploadIntentJournal(Path(tmp) / "j.wal")
                for stem, triple in journal_named:
                    journal.begin_upload(stem, triple)
                # The stranded states model a CRASHED prior process:
                # reopen so the intents are replayed (not in flight).
                journal.close()
                journal = UploadIntentJournal(Path(tmp) / "j.wal")
            sweeper = RecoverySweeper(
                store, journal, prefix="p/", grace_s=0.0,
                manifest_loader=self._loader(store),
            )
            sweeper.sweep_once()
            sweeper.sweep_once()  # a second pass must change nothing more
            left = {k.value for k in store.list_objects("p/")}
            # EVERY manifest-reachable object survived...
            assert committed_reachable <= left, f"trial {trial} deleted reachable"
            # ...and with zero grace, ONLY the reachable set survived.
            assert left == committed_reachable, f"trial {trial} kept orphans"
            assert sweeper.invariant_blocks_total == 0
            if journal is not None:
                assert journal.pending() == []
                journal.close()

    def test_chokepoint_refuses_protected_keys(self):
        store = self._store_with({"p/a.log": b"x", "p/a.rsm-manifest": b"{}"})
        sweeper = RecoverySweeper(store, None, prefix="p/", grace_s=0.0,
                                  manifest_loader=lambda k: None)
        from tieredstorage_tpu_torch.scrub.sweeper import SweepReport

        with pytest.raises(SweeperInvariantError):
            sweeper._delete_orphan(
                "p/a.log", {"p/a.log"}, {"p/a.log"}, SweepReport()
            )
        with pytest.raises(SweeperInvariantError):
            sweeper._delete_orphan(
                "p/a.rsm-manifest", {"p/a.rsm-manifest"}, set(), SweepReport()
            )
        assert sweeper.invariant_blocks_total == 2
        assert {k.value for k in store.list_objects("p/")} == {
            "p/a.log", "p/a.rsm-manifest",
        }


class TestGraceWindow:
    def test_unnamed_orphan_outwaits_grace(self):
        store = InMemoryStorage()
        store.configure({})
        store.upload(io.BytesIO(b"x"), ObjectKey("p/foreign.log"))
        now = [1000.0]
        sweeper = RecoverySweeper(
            store, None, prefix="p/", grace_s=60.0,
            manifest_loader=lambda k: None, clock=lambda: now[0],
        )
        r1 = sweeper.sweep_once()
        assert r1.orphans_deleted == [] and r1.orphans_pending == ["p/foreign.log"]
        assert sweeper.orphans_pending == 1
        now[0] += 30.0
        assert sweeper.sweep_once().orphans_deleted == []  # still in grace
        now[0] += 31.0
        r3 = sweeper.sweep_once()
        assert r3.orphans_deleted == ["p/foreign.log"]
        assert sweeper.orphans_pending == 0
        assert [k.value for k in store.list_objects("p/")] == []

    def test_late_manifest_rescues_candidate(self):
        """An in-flight upload from ANOTHER writer: its data keys enter the
        grace ledger, then its manifest lands — the candidate must leave
        the ledger untouched."""
        store = InMemoryStorage()
        store.configure({})
        store.upload(io.BytesIO(b"x"), ObjectKey("p/s.log"))
        now = [0.0]
        sweeper = RecoverySweeper(
            store, None, prefix="p/", grace_s=60.0,
            manifest_loader=lambda k: None, clock=lambda: now[0],
        )
        sweeper.sweep_once()
        store.upload(io.BytesIO(b"{}"), ObjectKey("p/s.rsm-manifest"))
        now[0] += 120.0
        report = sweeper.sweep_once()
        assert report.orphans_deleted == []
        assert sweeper.orphans_pending == 0
        assert {k.value for k in store.list_objects("p/")} == {
            "p/s.log", "p/s.rsm-manifest",
        }


class TestLiveTransactions:
    """A pending journal entry whose txn is still IN FLIGHT (the copy or
    delete is running right now in this process) is untouchable: the
    sweeper must neither delete its keys — no-grace or grace path — nor
    resolve the txn.  ``release()`` (called by the RSM in a ``finally``)
    hands whatever is left pending back to the sweeper."""

    KEYS = ["p/s.log", "p/s.indexes", "p/s.rsm-manifest"]

    def _sweeper(self, store, journal, grace_s=0.0):
        return RecoverySweeper(store, journal, prefix="p/", grace_s=grace_s,
                               manifest_loader=lambda k: None)

    def test_live_upload_keys_survive_a_zero_grace_sweep(self, tmp_path):
        store = InMemoryStorage()
        store.configure({})
        store.upload(io.BytesIO(b"x"), ObjectKey("p/s.log"))  # mid-upload
        journal = UploadIntentJournal(tmp_path / "j.wal")
        txn = journal.begin_upload("s", self.KEYS)
        sweeper = self._sweeper(store, journal)
        report = sweeper.sweep_once()
        assert report.orphans_deleted == []
        assert journal.pending_upload_count == 1  # NOT resolved
        # The copy finishes: indexes + manifest land, commit — nothing of
        # the now-committed segment was destroyed by the racing sweep.
        store.upload(io.BytesIO(b"y"), ObjectKey("p/s.indexes"))
        store.upload(io.BytesIO(b"{}"), ObjectKey("p/s.rsm-manifest"))
        journal.commit(txn)
        sweeper.sweep_once()
        assert {k.value for k in store.list_objects("p/")} == set(self.KEYS)
        journal.close()

    def test_live_txn_with_no_keys_is_not_rolled_back(self, tmp_path):
        store = InMemoryStorage()
        store.configure({})
        journal = UploadIntentJournal(tmp_path / "j.wal")
        txn = journal.begin_upload("s", self.KEYS)  # first byte not landed
        sweeper = self._sweeper(store, journal)
        sweeper.sweep_once()
        # Resolving a live intent would un-name the upload's keys: a crash
        # right after would strand them behind the grace window, and the
        # owner's later commit() would be a silent counter no-op.
        assert journal.pending_upload_count == 1
        assert sweeper.journal_resolved_total == 0
        journal.release(txn)  # the copy failed and returned
        sweeper.sweep_once()
        assert journal.pending() == []  # nothing stranded: resolved now
        journal.close()

    def test_release_enables_no_grace_deletion(self, tmp_path):
        store = InMemoryStorage()
        store.configure({})
        for k in self.KEYS[:2]:
            store.upload(io.BytesIO(b"x"), ObjectKey(k))
        journal = UploadIntentJournal(tmp_path / "j.wal")
        txn = journal.begin_upload("s", self.KEYS)
        sweeper = self._sweeper(store, journal, grace_s=3600.0)
        assert sweeper.sweep_once().orphans_deleted == []  # in flight
        journal.release(txn)  # copy failed AND its rollback cleanup failed
        report = sweeper.sweep_once()  # journal-named: no grace wait
        assert sorted(report.orphans_deleted) == sorted(self.KEYS[:2])
        assert journal.pending() == []
        journal.close()

    def test_live_tombstone_is_not_finished_by_the_sweeper(self, tmp_path):
        store = InMemoryStorage()
        store.configure({})
        for k in self.KEYS[:2]:  # manifest-first phase already ran
            store.upload(io.BytesIO(b"x"), ObjectKey(k))
        journal = UploadIntentJournal(tmp_path / "j.wal")
        txn = journal.begin_delete("s", self.KEYS)
        sweeper = self._sweeper(store, journal)
        report = sweeper.sweep_once()
        assert report.orphans_deleted == []
        assert report.tombstones_completed == 0
        assert journal.pending_tombstone_count == 1
        journal.release(txn)  # the delete returned (partial failure)
        sweeper.sweep_once()
        assert list(store.list_objects("p/")) == []
        assert journal.pending_tombstone_count == 0
        journal.close()


class TestStatusReads:
    def test_orphans_pending_is_lock_free_during_a_sweep(self):
        """Gauges and status() read orphans_pending while a pass holds the
        sweeper lock across the listing and deletes; the read must come
        from the end-of-pass snapshot, never block behind the pass."""
        import threading

        store = InMemoryStorage()
        store.configure({})
        store.upload(io.BytesIO(b"{}"), ObjectKey("p/a.rsm-manifest"))
        reads: list = []

        def loader(key):  # runs mid-pass, sweeper lock held
            t = threading.Thread(
                target=lambda: reads.append(sweeper.orphans_pending)
            )
            t.start()
            t.join(timeout=5.0)
            assert not t.is_alive(), "orphans_pending blocked behind the sweep"
            return None

        sweeper = RecoverySweeper(store, None, prefix="p/", grace_s=60.0,
                                  manifest_loader=loader)
        sweeper.sweep_once()
        assert reads == [0]


class TestSchedulerAndFaults:
    def test_sweep_fault_site_counts_and_recovers(self):
        store = InMemoryStorage()
        store.configure({})
        sweeper = RecoverySweeper(store, None, prefix="p/",
                                  manifest_loader=lambda k: None)
        faults.install(FaultPlane.parse("lifecycle.sweep:error@1"))
        with pytest.raises(Exception):
            sweeper.sweep_once()
        assert sweeper.sweep_failures_total == 1
        sweeper.sweep_once()  # healed
        faults.install(None)
        assert sweeper.sweeps == 1

    def test_scheduler_paces_and_survives_failures(self):
        store = InMemoryStorage()
        store.configure({})
        sweeper = RecoverySweeper(store, None, prefix="p/",
                                  manifest_loader=lambda k: None)
        sched = SweepScheduler(sweeper, interval_ms=30_000, jitter_seed=0)
        sched.start()
        with pytest.raises(RuntimeError):
            sched.start()
        sched.run_now()
        deadline = __import__("time").monotonic() + 5.0
        while sweeper.sweeps == 0 and __import__("time").monotonic() < deadline:
            __import__("time").sleep(0.01)
        assert sweeper.sweeps >= 1
        status = sched.status()
        assert status["state"] in ("idle", "sweeping")
        assert status["sweeps"] >= 1
        sched.stop()
        assert sched.status()["state"] == "stopped"


class TestMutationBoundaries:
    """Exact-boundary pins: the grace window is INCLUSIVE at grace_s, a
    failed orphan delete keeps its tombstone PENDING (committing it would
    leak the orphan forever), and the scheduler accepts its documented
    1 ms floor. Each pins a comparison a mutation flip would invert."""

    def test_grace_boundary_is_inclusive(self):
        store = InMemoryStorage()
        store.configure({})
        store.upload(io.BytesIO(b"x"), ObjectKey("p/edge.log"))
        now = [500.0]
        sweeper = RecoverySweeper(
            store, None, prefix="p/", grace_s=60.0,
            manifest_loader=lambda k: None, clock=lambda: now[0],
        )
        first = sweeper.sweep_once()
        assert first.orphans_pending == ["p/edge.log"]
        # A frozen clock also pins the duration arithmetic: end - start.
        assert first.duration_s == 0.0
        now[0] += 60.0  # EXACTLY the window, not one tick past it
        report = sweeper.sweep_once()
        assert report.orphans_deleted == ["p/edge.log"]

    def test_failed_orphan_delete_keeps_tombstone_pending(self, tmp_path):
        store = InMemoryStorage()
        store.configure({})
        keys = ["p/s.log", "p/s.indexes", "p/s.rsm-manifest"]
        for k in keys[:2]:  # the delete's manifest-first phase already ran
            store.upload(io.BytesIO(b"x"), ObjectKey(k))
        journal = UploadIntentJournal(tmp_path / "j.wal")
        txn = journal.begin_delete("s", keys)
        journal.release(txn)  # the interrupted delete is not in flight
        real_delete = store.delete

        def flaky_delete(key):
            if key.value.endswith(".indexes"):
                raise StorageBackendException("injected delete outage")
            real_delete(key)

        store.delete = flaky_delete
        sweeper = RecoverySweeper(
            store, journal, prefix="p/", grace_s=0.0,
            manifest_loader=lambda k: None,
        )
        report = sweeper.sweep_once()
        # .log went; .indexes survived its failed delete — the tombstone
        # must stay pending so the next sweep retries it.
        assert "p/s.indexes" in report.delete_failures
        assert journal.pending_tombstone_count == 1
        assert sweeper.tombstones_gcd_total == 0
        store.delete = real_delete
        sweeper.sweep_once()  # healed: the retry converges and GCs
        assert journal.pending_tombstone_count == 0
        assert sweeper.tombstones_gcd_total == 1
        assert list(store.list_objects("p/")) == []

    def test_scheduler_accepts_the_1ms_floor(self):
        store = InMemoryStorage()
        store.configure({})
        sweeper = RecoverySweeper(store, None, prefix="p/",
                                  manifest_loader=lambda k: None)
        assert SweepScheduler(sweeper, interval_ms=1).interval_s == 0.001
        with pytest.raises(ValueError):
            SweepScheduler(sweeper, interval_ms=0)


# ------------------------------------------------------------------ parity
PKGS = {"port": port_lifecycle, "jax": jax_lifecycle}


def _journal_state(j) -> dict:
    status = j.status()
    status.pop("path")
    return {
        "pending": [e.to_json() for e in j.pending()],
        "next_txn": j._next_txn,
        "status": status,
        "replayed": j._c.replayed_entries,
    }


def _write_history(mod, path, rng) -> None:
    """A seeded lifecycle history: begins, stages, commits, rollbacks,
    tombstones and their commits, left with some entries pending."""
    with mod.UploadIntentJournal(path) as j:
        open_txns: list = []
        for i in range(40):
            op = int(rng.integers(0, 6))
            keys = [f"t/seg-{i}.log", f"t/seg-{i}.indexes", f"t/seg-{i}.rsm-manifest"]
            if op <= 1 or not open_txns:
                open_txns.append(("u", j.begin_upload(f"seg-{i}", keys)))
            elif op == 2:
                open_txns.append(("d", j.begin_delete(f"seg-{i}", keys)))
            else:
                kind, txn = open_txns.pop(int(rng.integers(0, len(open_txns))))
                if kind == "d":
                    j.commit_delete(txn)
                elif op == 3:
                    j.stage(txn, mod.STAGE_LOG_UPLOADED)
                    j.stage(txn, mod.STAGE_INDEXES_UPLOADED)
                    open_txns.append((kind, txn))
                elif op == 4:
                    j.commit(txn)
                else:
                    j.rollback(txn)
    with open(path, "ab") as fh:
        fh.write(b'{"rec": "commit", "tx')  # a torn last line


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_journal_written_by_one_package_replays_equal_in_the_other(tmp_path, writer, seed):
    path = tmp_path / "journal.jsonl"
    _write_history(PKGS[writer], path, np.random.default_rng(seed))
    copies = {}
    for name in PKGS:
        copies[name] = tmp_path / f"{name}.jsonl"
        shutil.copyfile(path, copies[name])
    states = {}
    for name, mod in PKGS.items():
        with mod.UploadIntentJournal(copies[name]) as j:
            states[name] = _journal_state(j)
    assert states["port"] == states["jax"]
    assert states["port"]["status"]["torn_records_total"] == 1
    assert states["port"]["pending"], "the seeded history should leave entries pending"


@pytest.mark.parametrize("seed", [0, 3])
def test_compact_writes_the_same_file_in_both_packages(tmp_path, seed):
    path = tmp_path / "journal.jsonl"
    _write_history(port_lifecycle, path, np.random.default_rng(seed))
    written = {}
    for name, mod in PKGS.items():
        target = tmp_path / f"{name}.jsonl"
        shutil.copyfile(path, target)
        with mod.UploadIntentJournal(target) as j:
            j.compact()
        written[name] = target.read_bytes()
    assert written["port"] == written["jax"]
    assert written["port"].count(b"\n") == len(
        port_lifecycle.UploadIntentJournal(tmp_path / "port.jsonl").pending())


def test_journal_records_are_byte_equal(tmp_path):
    """The same operations append the same bytes in both packages."""
    files = {}
    for name, mod in PKGS.items():
        path = tmp_path / f"{name}.jsonl"
        with mod.UploadIntentJournal(path) as j:
            t1 = j.begin_upload("seg-a", ["a.log", "a.indexes", "a.rsm-manifest"])
            j.stage(t1, mod.STAGE_LOG_UPLOADED)
            j.commit(t1)
            t2 = j.begin_delete("seg-b", ["b.log"])
            j.commit_delete(t2)
            j.rollback(j.begin_upload("seg-c", ["c.log"]))
        files[name] = path.read_bytes()
    assert files["port"] == files["jax"]


def _manifest_bytes(mod) -> bytes:
    from tieredstorage_tpu_torch.manifest.chunk_index import FixedSizeChunkIndex
    from tieredstorage_tpu_torch.manifest.segment_indexes import IndexType, SegmentIndexesV1Builder

    builder = SegmentIndexesV1Builder()
    for index_type in IndexType:
        builder.add(index_type, 8)
    manifest = segment_manifest.SegmentManifestV1(
        chunk_index=FixedSizeChunkIndex(64, 256, 64, 64),
        segment_indexes=builder.build(), compression=False,
    )
    return segment_manifest.manifest_to_json(manifest).encode()


def _sweep_twice(pkg, objects: dict, journal_path: Path, later: dict):
    mem_mod, sweeper_mod, lifecycle_mod, manifest_mod, key_cls = pkg
    store = mem_mod.InMemoryStorage()
    store.configure({})
    for key, blob in objects.items():
        store.upload(io.BytesIO(blob), key_cls(key))
    journal = lifecycle_mod.UploadIntentJournal(journal_path)
    now = [1000.0]

    def loader(key):
        with store.fetch(key_cls(key)) as stream:
            return manifest_mod.manifest_from_json(stream.read())

    sweeper = sweeper_mod.RecoverySweeper(
        store, journal, prefix="p/", grace_s=60.0, manifest_loader=loader,
        clock=lambda: now[0],
    )
    reports = [sweeper.sweep_once().to_json()]
    for key, blob in later.items():
        store.upload(io.BytesIO(blob), key_cls(key))
    now[0] += 61.0
    reports.append(sweeper.sweep_once().to_json())
    for r in reports:
        r.pop("duration_s")
    counters = {k: getattr(sweeper, k) for k in (
        "sweeps", "orphans_deleted_total", "tombstones_gcd_total", "quarantines_total",
        "journal_resolved_total", "invariant_blocks_total", "sweep_failures_total",
        "orphans_pending")}
    listing = sorted(k.value for k in store.list_objects("p/"))
    state = _journal_state(journal)
    journal.close()
    return reports, counters, listing, sorted(sweeper.quarantined_manifests), state


def test_sweepers_give_equal_reports_and_listings(tmp_path):
    """One store state in both packages: a committed triple, a stranded
    segment the journal names, orphans that out-wait the grace window, an
    orphan first seen inside it, a 17-byte manifest and a tombstone."""
    manifest = _manifest_bytes(segment_manifest)
    objects = {
        "p/ok.log": b"L" * 256, "p/ok.indexes": b"I" * 40, "p/ok.rsm-manifest": manifest,
        "p/crashed.log": b"x" * 99, "p/crashed.indexes": b"y" * 9,
        "p/foreign-1.log": b"f" * 7, "p/foreign-2.indexes": b"g" * 5,
        "p/torn.log": b"t" * 256, "p/torn.indexes": b"u" * 40,
        "p/torn.rsm-manifest": manifest[:17],
        "p/gone.log": b"d" * 3,
    }
    base = tmp_path / "journal.jsonl"
    with UploadIntentJournal(base) as j:
        j.begin_upload("crashed", ["p/crashed.log", "p/crashed.indexes", "p/crashed.rsm-manifest"])
        j.begin_upload("ok", ["p/ok.log", "p/ok.indexes", "p/ok.rsm-manifest"])
        j.begin_delete("gone", ["p/gone.log", "p/gone.indexes", "p/gone.rsm-manifest"])
    later = {"p/late.log": b"z" * 11}
    results = {}
    for name, pkg in (
        ("port", (port_memory, port_sweeper, port_lifecycle, segment_manifest, ObjectKey)),
        ("jax", (jax_memory, jax_sweeper, jax_lifecycle, jax_segment_manifest, JaxObjectKey)),
    ):
        path = tmp_path / f"{name}.jsonl"
        shutil.copyfile(base, path)
        results[name] = _sweep_twice(pkg, objects, path, later)
    assert results["port"] == results["jax"]
    reports, counters, listing, quarantined, state = results["port"]
    assert sorted(reports[0]["orphans_deleted"]) == [
        "p/crashed.indexes", "p/crashed.log", "p/gone.log"]
    assert sorted(reports[1]["orphans_deleted"]) == ["p/foreign-1.log", "p/foreign-2.indexes"]
    assert reports[1]["orphans_pending"] == ["p/late.log"]
    assert quarantined == ["p/torn.rsm-manifest"]
    assert listing == sorted(
        ["p/late.log", "p/ok.indexes", "p/ok.log", "p/ok.rsm-manifest",
         "p/torn.indexes", "p/torn.log", "p/torn.rsm-manifest"])
    assert state["pending"] == []


# --------------------------------------------------------------- RSM drills
class SimulatedKill(BaseException):
    """Escapes ``except Exception``: the in-process SIGKILL stand-in."""


@pytest.fixture(scope="module")
def rsa_keys(tmp_path_factory):
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files

    return generate_key_pair_pem_files(tmp_path_factory.mktemp("keys"), prefix="lifecycle")


LIFECYCLE = {
    "lifecycle.enabled": True,
    "lifecycle.sweep.interval.ms": 3_600_000,  # paced sweeps dormant
    "lifecycle.grace.ms": 3_600_000,  # only journal-named deletions
    "storage.overwrite.enabled": True,
}


def _rsm(kind: str, tmp_path: Path, rsa_keys, extra=None):
    from tests.test_torch_rsm import _configs

    store = tmp_path / "store"
    store.mkdir(exist_ok=True)
    cls = {"port": "tieredstorage_tpu_torch", "jax": "tieredstorage_tpu"}[kind]
    configs = _configs(store, rsa_keys, f"{cls}.storage.filesystem.FileSystemStorage", {
        **LIFECYCLE, "lifecycle.journal.path": str(tmp_path / "journal.jsonl"),
        **(extra or {}),
    })
    if kind == "port":
        configs["transform.device"] = "cpu"
        rsm = RemoteStorageManager()
    else:
        rsm = JaxRemoteStorageManager()
    rsm.configure(configs)
    return rsm


def _listing(tmp_path: Path) -> list[str]:
    store = tmp_path / "store"
    return sorted(str(p.relative_to(store)) for p in store.rglob("*") if p.is_file())


def _kill_on_upload(rsm, n: int) -> None:
    real = rsm._storage.upload
    calls = {"n": 0}

    def dying(stream, key):
        calls["n"] += 1
        if calls["n"] == n:
            raise SimulatedKill(f"kill -9 during upload #{n} ({key})")
        return real(stream, key)

    rsm._storage.upload = dying


def _segment(tmp_path: Path, mod, name: str):
    from tests.test_torch_rsm import _write_segment

    root = tmp_path / name
    root.mkdir(exist_ok=True)
    return _write_segment(root, mod, seed=11)


@pytest.mark.parametrize("kill_call,stranded", [(2, [".log"]), (3, [".indexes", ".log"])],
                         ids=["after-log", "after-indexes"])
def test_one_sweep_recovers_a_kill_mid_copy(tmp_path, rsa_keys, kill_call, stranded):
    md, sd, contents = _segment(tmp_path, metadata, "seg")
    rsm = _rsm("port", tmp_path, rsa_keys)
    _kill_on_upload(rsm, kill_call)
    with pytest.raises(SimulatedKill):
        rsm.copy_log_segment_data(md, sd)
    assert sorted(p.rsplit(".", 1)[1] for p in _listing(tmp_path)) == [
        s[1:] for s in stranded]
    assert rsm.lifecycle_journal.pending_upload_count == 1
    rsm.sweep_scheduler.stop()

    restarted = _rsm("port", tmp_path, rsa_keys)
    sweeper = restarted.recovery_sweeper
    assert sweeper.sweeps == 1 and sweeper.orphans_deleted_total == len(stranded)
    assert _listing(tmp_path) == []
    assert restarted.lifecycle_journal.pending_upload_count == 0
    restarted.copy_log_segment_data(md, sd)
    assert len(_listing(tmp_path)) == 3
    with restarted.fetch_log_segment(md, 0) as stream:
        assert stream.read() == contents["log"]
    status = restarted.lifecycle_status()
    assert status["journal"]["commits_total"] == 1
    assert status["sweeper"]["orphans_deleted_total"] == len(stranded)
    restarted.delete_log_segment_data(md)
    assert restarted.lifecycle_journal.pending_tombstone_count == 0
    assert restarted.lifecycle_journal.tombstone_commits_total == 1
    assert _listing(tmp_path) == []
    restarted.close()


def test_truncated_manifest_is_quarantined_then_healed(tmp_path, rsa_keys):
    md, sd, contents = _segment(tmp_path, metadata, "seg")
    rsm = _rsm("port", tmp_path, rsa_keys)
    rsm.copy_log_segment_data(md, sd)
    [manifest] = (tmp_path / "store").rglob("*.rsm-manifest")
    manifest.write_bytes(manifest.read_bytes()[:17])
    report = rsm.recovery_sweeper.sweep_once()
    assert report.quarantined == [str(manifest.relative_to(tmp_path / "store"))]
    assert report.orphans_deleted == []
    assert len(_listing(tmp_path)) == 3
    with pytest.raises(RemoteStorageException, match="quarantine"):
        rsm.fetch_segment_manifest(md)
    with pytest.raises(RemoteStorageException, match="quarantine"):
        rsm.fetch_log_segment(md, 0, 10)
    rsm.copy_log_segment_data(md, sd)  # the broker's retried copy heals it
    assert rsm.recovery_sweeper.sweep_once().quarantined == []
    with rsm.fetch_log_segment(md, 0) as stream:
        assert stream.read() == contents["log"]
    rsm.close()


def test_intent_append_failure_fails_the_copy_before_any_byte(tmp_path, rsa_keys):
    md, sd, _ = _segment(tmp_path, metadata, "seg")
    rsm = _rsm("port", tmp_path, rsa_keys, {"faults.spec": ["lifecycle.journal:error@1"]})
    with pytest.raises(RemoteStorageException, match="journal append failed") as info:
        rsm.copy_log_segment_data(md, sd)
    assert isinstance(info.value.__cause__, JournalAppendError)
    assert _listing(tmp_path) == []
    rsm.copy_log_segment_data(md, sd)  # the plane's rule fired once
    assert len(_listing(tmp_path)) == 3
    rsm.close()


def test_failed_rollback_cleanup_is_converged_by_the_sweeper(tmp_path, rsa_keys):
    md, sd, _ = _segment(tmp_path, metadata, "seg")
    rsm = _rsm("port", tmp_path, rsa_keys, {"faults.spec": ["storage.write:error@3"]})

    def broken_delete(keys, *, total=None):
        raise RemoteStorageException("cleanup outage")

    rsm._delete_keys = broken_delete
    with pytest.raises(RemoteStorageException, match="Failed to copy"):
        rsm.copy_log_segment_data(md, sd)
    assert len(_listing(tmp_path)) == 2
    pending = rsm.lifecycle_journal.pending()
    assert len(pending) == 1 and not pending[0].inflight
    report = rsm.recovery_sweeper.sweep_once()
    assert len(report.orphans_deleted) == 2
    assert _listing(tmp_path) == [] and rsm.lifecycle_journal.pending() == []
    rsm.close()


def test_lifecycle_requires_a_journal_path(tmp_path, rsa_keys):
    from tests.test_torch_rsm import _configs
    from tieredstorage_tpu_torch.config.configdef import ConfigException

    configs = _configs(tmp_path, rsa_keys, "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
                       {"transform.device": "cpu", "lifecycle.enabled": True})
    with pytest.raises(ConfigException, match="lifecycle.journal.path"):
        RemoteStorageManager().configure(configs)
    bare = RemoteStorageManager()
    bare.configure({k: v for k, v in configs.items() if k != "lifecycle.enabled"})
    with pytest.raises(RemoteStorageException, match="not enabled"):
        bare.lifecycle_status()
    assert bare.lifecycle_journal is None and bare.recovery_sweeper is None
    bare.close()


@pytest.mark.parametrize("crasher,recoverer", [("jax", "port"), ("port", "jax")])
def test_crash_recovery_across_packages(tmp_path, rsa_keys, crasher, recoverer):
    """One package's RSM dies at upload 3 (the manifest); the other's
    startup sweep over the same journal and store deletes exactly the two
    stranded objects; its retried copy reads back through the first."""
    mods = {"port": metadata, "jax": jax_metadata}
    segs = {k: _segment(tmp_path, m, f"seg-{k}") for k, m in mods.items()}
    dying = _rsm(crasher, tmp_path, rsa_keys)
    _kill_on_upload(dying, 3)
    with pytest.raises(SimulatedKill):
        dying.copy_log_segment_data(*segs[crasher][:2])
    assert len(_listing(tmp_path)) == 2
    dying.sweep_scheduler.stop()
    dying.lifecycle_journal.close()

    survivor = _rsm(recoverer, tmp_path, rsa_keys)
    assert survivor.recovery_sweeper.orphans_deleted_total == 2
    from tieredstorage_tpu_torch.object_key import ObjectKeyFactory, Suffix

    factory = ObjectKeyFactory("test/", False)
    assert sorted(survivor.recovery_sweeper.last_report.orphans_deleted) == sorted(
        factory.key(segs["port"][0], s).value for s in (Suffix.LOG, Suffix.INDEXES))
    assert _listing(tmp_path) == []
    assert survivor.lifecycle_journal.pending_upload_count == 0
    md, sd, contents = segs[recoverer]
    survivor.copy_log_segment_data(md, sd)
    survivor.close()

    reader = _rsm(crasher, tmp_path, rsa_keys)
    assert reader.recovery_sweeper.last_report.orphans_deleted == []
    with reader.fetch_log_segment(segs[crasher][0], 0) as stream:
        assert stream.read() == contents["log"]
    reader.delete_log_segment_data(segs[crasher][0])
    assert _listing(tmp_path) == []
    reader.close()
