"""The port's replicated storage against the JAX package's.

The same seeded fault sequence drives both packages' ReplicatedStorageBackend
over in-memory children: a wrapper fails chosen calls of chosen replicas
with the package's StorageBackendException. Outcomes, stored objects and the
`failovers` / `quorum_failures` counters must be equal. Then quorum writes,
rollback, failover within a deadline, probing and the reflective config on
the port alone.
"""

from __future__ import annotations

import io
import time

import numpy as np
import pytest

from tieredstorage_tpu.storage import core as jax_core
from tieredstorage_tpu.storage import memory as jax_memory
from tieredstorage_tpu.storage import replicated as jax_replicated
from tieredstorage_tpu_torch.storage import core, memory, replicated
from tieredstorage_tpu_torch.storage.core import (
    KeyNotFoundException,
    ObjectKey,
    StorageBackendException,
)
from tieredstorage_tpu_torch.storage.memory import InMemoryStorage
from tieredstorage_tpu_torch.storage.replicated import (
    AllReplicasFailedException,
    HealthProber,
    QuorumWriteException,
    ReplicatedStorageBackend,
    ReplicaState,
)
from tieredstorage_tpu_torch.utils.deadline import (
    Deadline,
    DeadlineExceededException,
    deadline_scope,
)

KEY = ObjectKey("topic/partition/00000000000000000000-abc.log")
PORT = (core, memory, replicated)
JAX = (jax_core, jax_memory, jax_replicated)


def _flaky(pkg, fail_calls: set):
    """An in-memory child of `pkg` whose n-th call (counted over upload,
    fetch, delete and list) raises the package's StorageBackendException
    when n is in `fail_calls`."""
    core_mod, memory_mod, _ = pkg

    class Flaky(memory_mod.InMemoryStorage):
        calls = 0

        def _tick(self, op):
            self.calls += 1
            if self.calls in fail_calls:
                raise core_mod.StorageBackendException(f"injected {op} failure")

        def upload(self, stream, key):
            self._tick("upload")
            return super().upload(stream, key)

        def fetch(self, key, byte_range=None):
            self._tick("fetch")
            return super().fetch(key, byte_range)

        def delete(self, key):
            self._tick("delete")
            super().delete(key)

        def list_objects(self, prefix=""):
            self._tick("list")
            return super().list_objects(prefix)

    return Flaky()


def _drive(pkg, seed: int, n_ops: int = 40):
    """One seeded sequence of uploads, fetches, deletes and listings through
    a 3-replica store with write quorum 2; returns what each op gave."""
    core_mod, _, rep_mod = pkg
    rng = np.random.default_rng(seed)
    fails = [set(int(x) for x in rng.choice(np.arange(1, 3 * n_ops), n_ops // 3, replace=False))
             for _ in range(3)]
    children = [(f"r{i}", _flaky(pkg, fails[i])) for i in range(3)]
    rep = rep_mod.ReplicatedStorageBackend(children, write_quorum=2)
    keys = [core_mod.ObjectKey(f"seg/{i}.log") for i in range(4)]
    out = []
    try:
        for _ in range(n_ops):
            op = rng.choice(["upload", "upload", "fetch", "fetch", "fetch", "delete", "list"])
            key = keys[int(rng.integers(0, len(keys)))]
            try:
                if op == "upload":
                    data = rng.bytes(int(rng.integers(0, 64)))
                    out.append((op, rep.upload(io.BytesIO(data), key)))
                elif op == "fetch":
                    with rep.fetch(key) as s:
                        out.append((op, s.read()))
                elif op == "delete":
                    rep.delete(key)
                    out.append((op, None))
                else:
                    out.append((op, [k.value for k in rep.list_objects("seg/")]))
            except core_mod.StorageBackendException as e:
                out.append((op, type(e).__name__, str(e)))
        stored = [sorted(child.keys()) for _, child in children]
        return out, stored, rep.failovers, rep.quorum_failures, [
            (s.name, s.errors) for s in rep.replica_states]
    finally:
        rep.close()


@pytest.fixture
def latency_blind(monkeypatch):
    """Read order from errors alone: wall-clock latency noise must not
    reorder replicas differently in the two packages' runs."""
    for cls in (ReplicaState, jax_replicated.ReplicaState):
        monkeypatch.setattr(cls, "LATENCY_SCALE_MS", 1e12)


@pytest.mark.parametrize("seed", range(6))
def test_fault_sequence_outcomes_and_counters_equal_jax(seed, latency_blind):
    ours, theirs = _drive(PORT, seed), _drive(JAX, seed)
    assert ours == theirs
    assert len(ours[0]) == 40


def test_some_seed_exercises_failover_and_quorum_failure(latency_blind):
    """The seeds above are not vacuous: together they fail over and miss a
    quorum."""
    results = [_drive(PORT, seed) for seed in range(6)]
    assert sum(r[2] for r in results) > 0
    assert sum(r[3] for r in results) > 0


def mem() -> InMemoryStorage:
    b = InMemoryStorage()
    b.configure({})
    return b


def _down() -> InMemoryStorage:
    """A child whose every call fails."""
    return _flaky(PORT, set(range(1, 1000)))


class TestQuorumWrites:
    def test_default_quorum_is_all_replicas(self):
        assert ReplicatedStorageBackend([(f"r{i}", mem()) for i in range(3)]).write_quorum == 3

    def test_sub_quorum_rolls_back_and_raises(self):
        good = mem()
        rep = ReplicatedStorageBackend([("good", good), ("down", _down())], write_quorum=2)
        with pytest.raises(QuorumWriteException, match="successful copies rolled back"):
            rep.upload(io.BytesIO(b"payload"), KEY)
        assert good.keys() == []
        assert rep.quorum_failures == 1

    def test_met_quorum_succeeds_with_replica_down(self):
        good = mem()
        rep = ReplicatedStorageBackend([("good", good), ("down", _down())], write_quorum=1)
        assert rep.upload(io.BytesIO(b"payload"), KEY) == 7
        assert good.object(KEY.value) == b"payload"
        assert rep.quorum_failures == 0

    def test_quorum_larger_than_replicas_rejected(self):
        with pytest.raises(ValueError):
            ReplicatedStorageBackend([("a", mem())], write_quorum=2)

    def test_delete_converges_or_raises(self):
        rep = ReplicatedStorageBackend([("ok", mem()), ("flaky", _flaky(PORT, {2}))])
        rep.upload(io.BytesIO(b"x"), KEY)
        with pytest.raises(StorageBackendException, match="failed on 1/2 replicas"):
            rep.delete(KEY)
        rep.delete(KEY)
        for state in rep.replica_states:
            with pytest.raises(KeyNotFoundException):
                state.backend.fetch(KEY)


class TestReadFailover:
    def test_contract_answers_win_over_replica_errors(self):
        rep = ReplicatedStorageBackend([("down", _down()), ("ok", mem())])
        with pytest.raises(KeyNotFoundException):
            rep.fetch(ObjectKey("no/such/key"))

    def test_key_only_on_secondary_is_served(self):
        a, b = mem(), mem()
        rep = ReplicatedStorageBackend([("a", a), ("b", b)])
        b.upload(io.BytesIO(b"only-on-b"), KEY)
        with rep.fetch(KEY) as s:
            assert s.read() == b"only-on-b"
        assert rep.failovers == 1

    def test_all_replicas_down_raises_aggregate(self):
        rep = ReplicatedStorageBackend([("a", _down()), ("b", _down())])
        with pytest.raises(AllReplicasFailedException):
            rep.fetch(KEY)

    def test_failover_hook_fires(self):
        down = _flaky(PORT, set(range(2, 1000)))  # the upload lands, fetches fail
        ok = mem()
        # Each child takes the object itself, so the replicated store has no
        # latency history: an upload through it, slower on "down" under a
        # loaded host, could rank "ok" first and leave no failover to hook.
        for child in (down, ok):
            child.upload(io.BytesIO(b"x"), KEY)
        rep = ReplicatedStorageBackend([("down", down), ("ok", ok)])
        wins: list[float] = []
        rep.on_failover = wins.append
        with rep.fetch(KEY) as s:
            assert s.read() == b"x"
        assert len(wins) == 1 and wins[0] >= 0.0
        assert rep.read_fetchers()[0] is not down  # the failed replica sorts last

    def test_expired_deadline_stops_failover(self):
        rep = ReplicatedStorageBackend([("down", _flaky(PORT, set(range(2, 1000)))),
                                        ("ok", mem())])
        rep.upload(io.BytesIO(b"x"), KEY)
        with deadline_scope(Deadline.after(-1.0)), pytest.raises(DeadlineExceededException):
            rep.fetch(KEY)


class TestHealth:
    def test_errors_lower_the_score(self):
        state = ReplicaState("a", mem())
        healthy = state.health_score()
        for _ in range(5):
            state.record(ok=False, latency_ms=1.0)
        assert state.health_score() < healthy

    def test_prober_marks_dark_replica(self):
        rep = ReplicatedStorageBackend([("dark", _down()), ("lit", mem())])
        prober = HealthProber(rep.replica_states, 3600.0)
        prober.probe_once()
        prober.probe_once()
        health = rep.replica_health()
        assert health["lit"] > health["dark"]
        dark = next(s for s in rep.replica_states if s.name == "dark")
        assert dark.probes == 2 and dark.probe_failures == 2

    def test_prober_thread_runs_and_stops(self):
        rep = ReplicatedStorageBackend([("a", mem()), ("b", mem())], probe_interval_s=0.01)
        try:
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and not all(
                    s.probes >= 2 for s in rep.replica_states):
                time.sleep(0.01)
            assert all(s.probes >= 2 for s in rep.replica_states)
        finally:
            rep.close()
        assert rep.prober is None


class TestReflectiveConfig:
    def test_configure_builds_children_from_config(self, tmp_path):
        rep = ReplicatedStorageBackend()
        rep.configure({
            "replication.replicas": "a,b",
            "replication.replica.a.backend.class":
                "tieredstorage_tpu_torch.storage.memory.InMemoryStorage",
            "replication.replica.b.backend.class":
                "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
            "replication.replica.b.root": str(tmp_path),
            "replication.replica.b.overwrite.enabled": True,
            "replication.write.quorum": 2,
            "replication.probe.interval.ms": None,
        })
        rep.upload(io.BytesIO(b"abc"), KEY)
        assert rep.write_quorum == 2 and rep.prober is None
        assert [s.name for s in rep.replica_states] == ["a", "b"]
        with rep.fetch(KEY) as s:
            assert s.read() == b"abc"
        assert (tmp_path / KEY.value).read_bytes() == b"abc"

    @pytest.mark.parametrize("configs,match", [
        ({"replication.replicas": "a"}, "backend.class is required"),
        ({"replication.replicas": ""}, "at least one replica"),
        ({"replication.replicas": "a,a"}, "duplicates"),
    ])
    def test_bad_configs_rejected_like_jax(self, configs, match):
        for cls in (ReplicatedStorageBackend, jax_replicated.ReplicatedStorageBackend):
            with pytest.raises(ValueError, match=match):
                cls().configure(configs)

    def test_lazy_package_exports(self):
        from tieredstorage_tpu_torch import storage

        assert storage.ReplicatedStorageBackend is ReplicatedStorageBackend
        assert storage.QuorumWriteException is QuorumWriteException
        with pytest.raises(AttributeError):
            storage.NoSuchName  # noqa: B018
