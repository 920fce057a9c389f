"""The port's lock witness (tieredstorage_tpu_torch/utils/locks.py): the
JAX package's cases run against the port's module, the production locks of
the port's lifecycle and fault planes feed the witness, and one seeded
acquisition script gives both packages' witnesses the same edges and the
same violations.

The module-global witness is swapped for a fresh instance per test: these
tests create violations on purpose and must not leak them into it.
"""

from __future__ import annotations

import threading

import pytest

from tieredstorage_tpu.utils import locks as jax_locks
from tieredstorage_tpu_torch.utils import locks
from tieredstorage_tpu_torch.utils.locks import (
    LockOrderViolation,
    LockWitness,
    new_condition,
    new_lock,
    new_rlock,
    witness_enabled,
)


@pytest.fixture
def fresh_witness(monkeypatch):
    w = LockWitness()
    monkeypatch.setattr(locks, "_WITNESS", w)
    monkeypatch.setenv(locks.ENV_FLAG, "1")
    return w


# ------------------------------------------------------------ disabled mode
class TestDisabled:
    def test_factories_return_raw_primitives(self, monkeypatch):
        monkeypatch.delenv(locks.ENV_FLAG, raising=False)
        assert type(new_lock("x")) is type(threading.Lock())
        assert type(new_rlock("x")) is type(threading.RLock())
        cond = new_condition("x")
        assert type(cond) is threading.Condition
        assert type(cond._lock) is type(threading.RLock())  # no wrapper inside

    def test_flag_values(self, monkeypatch):
        for off in ("", "0", "false", "no"):
            monkeypatch.setenv(locks.ENV_FLAG, off)
            assert not witness_enabled()
        for on in ("1", "true", "raise", "strict"):
            monkeypatch.setenv(locks.ENV_FLAG, on)
            assert witness_enabled()

    def test_disabled_records_nothing(self, monkeypatch):
        monkeypatch.delenv(locks.ENV_FLAG, raising=False)
        before = len(locks.witness().edges())
        a, b = new_lock("t.A"), new_lock("t.B")
        with a:
            with b:
                pass
        assert len(locks.witness().edges()) == before


# ------------------------------------------------------------- order record
class TestOrderRecording:
    def test_nested_acquire_records_edge(self, fresh_witness):
        a, b = new_lock("t.A"), new_lock("t.B")
        with a:
            with b:
                pass
        assert fresh_witness.edges() == [("t.A", "t.B")]
        assert fresh_witness.violations == []

    def test_same_order_twice_is_one_edge(self, fresh_witness):
        a, b = new_lock("t.A"), new_lock("t.B")
        for _ in range(3):
            with a, b:
                pass
        assert fresh_witness.edges() == [("t.A", "t.B")]

    def test_chain_records_transitive_pairs(self, fresh_witness):
        a, b, c = new_lock("t.A"), new_lock("t.B"), new_lock("t.C")
        with a, b, c:
            pass
        assert set(fresh_witness.edges()) == {
            ("t.A", "t.B"), ("t.A", "t.C"), ("t.B", "t.C"),
        }

    def test_release_unwinds_held_stack(self, fresh_witness):
        a, b = new_lock("t.A"), new_lock("t.B")
        with a:
            pass
        with b:  # A no longer held: must NOT record A -> B
            pass
        assert fresh_witness.edges() == []

    def test_reentrant_rlock_is_not_an_edge(self, fresh_witness):
        r = new_rlock("t.R")
        with r:
            with r:
                pass
        assert fresh_witness.edges() == []
        assert fresh_witness.violations == []

    def test_same_name_siblings_are_not_an_edge(self, fresh_witness):
        # Two instances of one class share a node (class granularity).
        a1, a2 = new_lock("t.A"), new_lock("t.A")
        with a1:
            with a2:
                pass
        assert fresh_witness.edges() == []

    def test_lock_names(self, fresh_witness):
        with new_lock("t.A"):
            with new_lock("t.B"):
                pass
        assert fresh_witness.lock_names() == {"t.A", "t.B"}


# ----------------------------------------------------------- cycle detection
class TestCycleDetection:
    def test_two_lock_cycle_fires(self, fresh_witness):
        a, b = new_lock("t.A"), new_lock("t.B")
        with a:
            with b:
                pass
        done = []

        def other():
            with b:
                with a:
                    pass
            done.append(True)

        t = threading.Thread(target=other)
        t.start()
        t.join()
        assert done == [True]  # record mode: no raise in the worker
        assert len(fresh_witness.violations) == 1
        assert "t.A" in fresh_witness.violations[0]
        assert "t.B" in fresh_witness.violations[0]
        with pytest.raises(LockOrderViolation):
            fresh_witness.assert_dag()

    def test_three_lock_cycle_fires(self, fresh_witness):
        a, b, c = new_lock("t.A"), new_lock("t.B"), new_lock("t.C")
        with a:
            with b:
                pass
        with b:
            with c:
                pass
        with c:
            with a:
                pass
        assert len(fresh_witness.violations) == 1
        with pytest.raises(LockOrderViolation):
            fresh_witness.assert_dag()

    def test_diamond_is_not_a_cycle(self, fresh_witness):
        a, b, c, d = (new_lock(f"t.{n}") for n in "ABCD")
        with a, b, d:
            pass
        with a, c, d:
            pass
        assert fresh_witness.violations == []
        fresh_witness.assert_dag()

    def test_raise_mode_raises_and_does_not_leak(self, fresh_witness, monkeypatch):
        monkeypatch.setenv(locks.ENV_FLAG, "raise")
        a, b = new_lock("t.A"), new_lock("t.B")
        with a:
            with b:
                pass
        with b:
            with pytest.raises(LockOrderViolation):
                with a:
                    pass
        # The inner lock must have been released despite the raise.
        assert a.acquire(timeout=1)
        a.release()

    def test_reset_clears_graph_and_violations(self, fresh_witness):
        a, b = new_lock("t.A"), new_lock("t.B")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        assert fresh_witness.violations
        fresh_witness.reset()
        assert fresh_witness.edges() == []
        assert fresh_witness.violations == []
        fresh_witness.assert_dag()


# ---------------------------------------------------------------- condition
class TestWitnessedCondition:
    def test_condition_wait_notify_roundtrip(self, fresh_witness):
        cond = new_condition("t.C")
        hits = []

        def consumer():
            with cond:
                while not hits:
                    cond.wait(timeout=5)
                hits.append("consumed")

        t = threading.Thread(target=consumer)
        t.start()
        with cond:
            hits.append("produced")
            cond.notify()
        t.join(timeout=5)
        assert not t.is_alive()
        assert hits == ["produced", "consumed"]
        assert fresh_witness.violations == []

    def test_condition_under_outer_lock_records_edge(self, fresh_witness):
        outer = new_lock("t.Outer")
        cond = new_condition("t.C")
        with outer:
            with cond:
                pass
        assert ("t.Outer", "t.C") in fresh_witness.edges()

    def test_wait_releases_for_ordering_purposes(self, fresh_witness):
        # After wait() wakes, the condition lock is re-acquired; a lock taken
        # by the SAME thread after wait must still see the cond as held.
        cond = new_condition("t.C")
        inner = new_lock("t.I")
        with cond:
            cond.wait(timeout=0.01)  # times out, reacquires
            with inner:
                pass
        assert ("t.C", "t.I") in fresh_witness.edges()


# ----------------------------------------------------- production factories
class TestProductionWiring:
    def test_production_locks_are_witnessed_under_flag(self, fresh_witness, tmp_path):
        from tieredstorage_tpu_torch.storage.lifecycle import UploadIntentJournal
        from tieredstorage_tpu_torch.utils.faults import FaultPlane
        from tieredstorage_tpu_torch.utils.locks import _WitnessedLock

        journal = UploadIntentJournal(tmp_path / "j.wal")
        plane = FaultPlane.parse("storage.read:error@2")
        assert isinstance(journal._lock, _WitnessedLock)
        assert journal._lock.name == "lifecycle.UploadIntentJournal._lock"
        assert isinstance(plane._lock, _WitnessedLock)
        assert plane._lock.name == "faults.FaultPlane._lock"
        txn = journal.begin_upload("seg", ["k.log"])
        journal.commit(txn)
        plane.fire("storage.read", "k")
        journal.close()
        assert {"lifecycle.UploadIntentJournal._lock",
                "faults.FaultPlane._lock"} <= fresh_witness.acquired_names()
        assert fresh_witness.violations == []

    def test_sweeper_locks_feed_the_witness(self, fresh_witness):
        from tieredstorage_tpu_torch.scrub.sweeper import RecoverySweeper
        from tieredstorage_tpu_torch.storage.memory import InMemoryStorage

        store = InMemoryStorage()
        store.configure({})
        RecoverySweeper(store, None, prefix="p/", grace_s=0.0).sweep_once()
        assert "sweeper.RecoverySweeper._lock" in fresh_witness.acquired_names()
        assert fresh_witness.violations == []


# ------------------------------------------------------------- race witness
class TestRaceWitness:
    """RaceWitness: sampled held-lock/thread recording at
    mutation sites, the new_unguarded declaration, and zero work disabled."""

    @pytest.fixture
    def fresh_race(self, fresh_witness, monkeypatch):
        race = locks.RaceWitness(witness=fresh_witness)
        monkeypatch.setattr(locks, "_RACE_WITNESS", race)
        return race

    def test_disabled_note_mutation_records_nothing(self, monkeypatch):
        monkeypatch.delenv(locks.ENV_FLAG, raising=False)
        race = locks.RaceWitness()
        monkeypatch.setattr(locks, "_RACE_WITNESS", race)
        locks.note_mutation("mod.C.count")
        assert race.counts == {}

    def test_disabled_new_unguarded_is_passthrough(self, monkeypatch):
        monkeypatch.delenv(locks.ENV_FLAG, raising=False)
        race = locks.RaceWitness()
        monkeypatch.setattr(locks, "_RACE_WITNESS", race)
        marker = object()
        assert locks.new_unguarded("mod.C.x", marker) is marker
        assert race.unguarded_names == set()

    def test_records_innermost_held_lock(self, fresh_race):
        lock = new_lock("mod.C._lock")
        with lock:
            locks.note_mutation("mod.C.count")
        locks.note_mutation("mod.C.count")  # outside any lock
        assert fresh_race.held_at["mod.C.count"] == {"mod.C._lock", None}
        assert fresh_race.counts["mod.C.count"] == 2

    def test_innermost_wins_with_nesting(self, fresh_race):
        outer, inner = new_lock("mod.A._mu"), new_lock("mod.B._mu")
        with outer:
            with inner:
                locks.note_mutation("mod.B.count")
        assert fresh_race.held_at["mod.B.count"] == {"mod.B._mu"}

    def test_threads_recorded_per_site(self, fresh_race):
        locks.note_mutation("mod.C.count")
        t = threading.Thread(
            target=lambda: locks.note_mutation("mod.C.count"), daemon=True
        )
        t.start()
        t.join()
        assert len(fresh_race.threads_at["mod.C.count"]) == 2

    def test_sampling_thins_observations_not_counts(
        self, fresh_witness, monkeypatch
    ):
        monkeypatch.setenv(locks.SAMPLE_ENV, "3")
        race = locks.RaceWitness(witness=fresh_witness)
        lock = new_lock("mod.C._lock")
        for i in range(7):
            if i % 2:
                with lock:
                    race.note_mutation("mod.C.count")
            else:
                race.note_mutation("mod.C.count")
        assert race.counts["mod.C.count"] == 7
        # Only mutations 0, 3, 6 were sampled (0 and 6 unlocked, 3 locked).
        assert race.held_at["mod.C.count"] == {None, "mod.C._lock"}

    def test_new_unguarded_registers_when_enabled(self, fresh_race):
        assert locks.new_unguarded("mod.C.count", 5) == 5
        assert "mod.C.count" in fresh_race.unguarded_names

    def test_snapshot_and_reset(self, fresh_race):
        lock = new_lock("mod.C._lock")
        with lock:
            locks.note_mutation("mod.C.count")
        snap = fresh_race.snapshot()
        assert snap["sites"]["mod.C.count"]["held"] == ["mod.C._lock"]
        assert snap["sites"]["mod.C.count"]["mutations"] == 1
        fresh_race.reset()
        assert fresh_race.snapshot() == {"sites": {}, "unguarded_names": []}

    def test_acquired_names_tracked_even_without_edges(self, fresh_witness):
        lone = new_lock("mod.C._only")
        with lone:
            pass
        assert "mod.C._only" in fresh_witness.acquired_names()
        assert fresh_witness.lock_names() == set()  # no nested pair: no edge

    def test_held_names_snapshot(self, fresh_witness):
        a, b = new_lock("mod.A._mu"), new_lock("mod.B._mu")
        with a:
            with b:
                assert fresh_witness.held_names() == ["mod.A._mu", "mod.B._mu"]
        assert fresh_witness.held_names() == []

    def test_production_hooks_feed_the_race_witness(self, fresh_race, tmp_path):
        """The journal's pending-set mutation is a hooked site: it must be
        recorded under the journal's lock."""
        from tieredstorage_tpu_torch.storage.lifecycle import UploadIntentJournal

        journal = UploadIntentJournal(tmp_path / "j.wal")
        journal.commit(journal.begin_upload("seg", ["k.log"]))
        journal.close()
        assert fresh_race.held_at["lifecycle.UploadIntentJournal._pending"] == {
            "lifecycle.UploadIntentJournal._lock"
        }


# ----------------------------------------------------------------- parity
def _run_script(mod, script):
    """Run `script` (a list of lock-name stacks, each acquired outermost
    first on a thread of its own, one after another) against `mod`'s
    factories; returns the witness's edges and violations."""
    locks_by_name = {}

    def lock(name):
        if name not in locks_by_name:
            locks_by_name[name] = mod.new_lock(name)
        return locks_by_name[name]

    for stack in script:
        def body(stack=stack):
            held = []
            try:
                for name in stack:
                    lk = lock(name)
                    lk.acquire()
                    held.append(lk)
            finally:
                for lk in reversed(held):
                    lk.release()

        t = threading.Thread(target=body)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    w = mod.witness()
    return w.edges(), list(w.violations), sorted(w.acquired_names())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_script_gives_both_witnesses_the_same_violations(monkeypatch, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    names = [f"mod.C{i}._lock" for i in range(6)]
    script = [
        [names[int(k)] for k in rng.choice(6, size=int(rng.integers(1, 5)), replace=False)]
        for _ in range(12)
    ]
    results = []
    for mod in (locks, jax_locks):
        monkeypatch.setattr(mod, "_WITNESS", mod.LockWitness())
        monkeypatch.setenv(mod.ENV_FLAG, "1")
        results.append(_run_script(mod, script))
    assert results[0] == results[1]
    if seed == 0:
        assert results[0][1], "the seeded script should close at least one cycle"
