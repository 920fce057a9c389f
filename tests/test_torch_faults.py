"""The port's fault plane and fault-injecting backend against the JAX twins.

The JAX package's FaultPlane cases run against the port's module
(tieredstorage_tpu_torch/utils/faults.py). Then parity with no tolerance:
for seeded rule lists over every site, kind and trigger (with ``~match`` and
the wildcard) and a seeded call sequence, both planes give the same
outcomes (error type name and message, latency draws through an injected
sleeper, ``partial`` byte counts, ``injections`` and ``snapshot()``), reject
the same bad rules, and the same holds for FaultSchedule and
FaultInjectingBackend (fired rules, delay draws, truncated and corrupted
bytes). Last, the seams this package has: ``device.launch`` in the window
batcher, ``storage.read`` on chunk windows and indexes, ``storage.write`` at
the RSM's upload chokepoint, the RSM's ``faults.spec`` and
``fault.injection.enabled`` keys, env arming at import, and the disarmed
poisoned-lock probe over those seams.

Each package keeps its own process plane; a test that installs one restores
both in a ``finally`` (the autouse fixture).
"""

from __future__ import annotations

import io
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from tieredstorage_tpu.faults import backend as jax_fault_backend
from tieredstorage_tpu.faults import schedule as jax_schedule
from tieredstorage_tpu.storage import memory as jax_memory
from tieredstorage_tpu.storage.core import ObjectKey as JaxObjectKey
from tieredstorage_tpu.utils import faults as jax_faults
from tieredstorage_tpu_torch.faults import backend as fault_backend
from tieredstorage_tpu_torch.faults import schedule
from tieredstorage_tpu_torch.storage import memory
from tieredstorage_tpu_torch.storage.core import ObjectKey, StorageBackendException
from tieredstorage_tpu_torch.utils import faults
from tieredstorage_tpu_torch.utils.faults import (
    DATA_SITES,
    ENV_FLAG,
    SEED_ENV,
    SITES,
    FaultInjectedError,
    FaultPlane,
    FaultPoint,
)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _pristine_plane():
    """Every test starts and ends with NO plane installed, in both packages."""
    prior = faults.install(None)
    jax_prior = jax_faults.install(None)
    try:
        yield
    finally:
        faults.install(prior)
        jax_faults.install(jax_prior)


class TestRuleGrammar:
    def test_minimal_rule(self):
        rule = FaultPoint.parse("storage.read:error")
        assert rule.site == "storage.read" and rule.kind == "error"
        assert rule.arg is None and rule.match is None

    def test_full_rule_round_trips_through_spec(self):
        for text in [
            "storage.read:error",
            "storage.write:latency=25",
            "storage.read:latency=10..250",
            "peer.forward:partial=7@3",
            "gossip.probe:error@every=2",
            "device.launch:flaky=4@from=2",
            "storage.read:error@p=0.5",
            "peer.forward:error~owner-b",
            "*:latency=5",
        ]:
            assert FaultPoint.parse(text).spec() == text

    def test_whitespace_tolerated(self):
        rule = FaultPoint.parse("  storage.read : latency = 10..20 @ every=3 ")
        assert rule.arg == 10 and rule.arg_hi == 20 and rule.every == 3

    @pytest.mark.parametrize("bad", [
        "bogus.site:error",          # unknown site
        "storage.read:explode",      # unknown kind
        "gossip.probe:partial",      # partial on a non-data site
        "device.launch:partial=4",
        "storage.read:error@wat=1",  # unknown trigger
        "storage.read:error@0",      # nth must be >= 1
        "storage.read:error@every=0",
        "storage.read:error@from=0",
        "storage.read:error@p=1.5",  # probability out of [0, 1]
        "storage.read:error=1..5",   # range arg on a non-latency kind
        "storage.read:latency=20..10",  # hi < lo
        "not a rule at all",
        "",
    ])
    def test_rejects(self, bad):
        with pytest.raises(ValueError):
            FaultPoint.parse(bad)

    def test_partial_allowed_on_every_data_site_and_wildcard(self):
        for site in DATA_SITES + ("*",):
            assert FaultPoint.parse(f"{site}:partial=3").kind == "partial"

    def test_plane_parse_splits_on_semicolons_and_commas(self):
        plane = FaultPlane.parse(
            "storage.read:error@2; peer.forward:latency=5, gossip.probe:error"
        )
        assert [r.site for r in plane.rules] == [
            "storage.read", "peer.forward", "gossip.probe",
        ]

    def test_plane_parse_accepts_none_sequence_and_empty(self):
        assert FaultPlane.parse(None).rules == []
        assert FaultPlane.parse("").rules == []
        plane = FaultPlane.parse(["storage.read:error", "storage.write:error"])
        assert len(plane.rules) == 2


class TestTriggers:
    def fires_at(self, spec, calls=8, site="storage.read", seed=0):
        plane = FaultPlane.parse(spec, seed=seed, sleeper=lambda s: None)
        fired = []
        for n in range(1, calls + 1):
            try:
                plane.fire(site, f"key-{n}")
            except FaultInjectedError:
                fired.append(n)
        return fired, plane

    def test_nth_fires_exactly_once(self):
        fired, _ = self.fires_at("storage.read:error@3")
        assert fired == [3]

    def test_every_fires_on_multiples(self):
        fired, _ = self.fires_at("storage.read:error@every=3", calls=9)
        assert fired == [3, 6, 9]

    def test_from_fires_from_nth_onwards(self):
        fired, _ = self.fires_at("storage.read:error@from=5")
        assert fired == [5, 6, 7, 8]

    def test_call_counters_are_per_site(self):
        plane = FaultPlane.parse("storage.read:error@2")
        plane.fire("storage.write", "k")  # does not advance storage.read
        plane.fire("storage.read", "k")
        with pytest.raises(FaultInjectedError):
            plane.fire("storage.read", "k")
        assert plane.calls("storage.read") == 2
        assert plane.calls("storage.write") == 1

    def test_probability_schedule_is_seed_deterministic(self):
        a, _ = self.fires_at("storage.read:error@p=0.4", calls=60, seed=7)
        b, _ = self.fires_at("storage.read:error@p=0.4", calls=60, seed=7)
        assert a == b and 0 < len(a) < 60

    def test_flaky_errors_then_heals(self):
        fired, plane = self.fires_at("storage.read:flaky=3", calls=8)
        assert fired == [1, 2, 3]
        assert plane.snapshot()["fired"] == {"storage.read:flaky": 3}

    def test_flaky_default_window_is_ten(self):
        fired, _ = self.fires_at("storage.read:flaky", calls=12)
        assert fired == list(range(1, 11))

    def test_explicit_trigger_gates_the_flaky_window(self):
        fired, _ = self.fires_at("storage.read:flaky=6@every=2", calls=10)
        assert fired == [2, 4, 6]  # even calls only, and none past the heal


class TestKindsAndMatching:
    def test_error_is_a_storage_backend_exception_with_context(self):
        plane = FaultPlane.parse("peer.forward:error")
        with pytest.raises(FaultInjectedError) as err:
            plane.fire("peer.forward", "http://owner-b")
        assert isinstance(err.value, StorageBackendException)
        assert err.value.site == "peer.forward"
        assert err.value.key == "http://owner-b"
        assert err.value.rule == "peer.forward:error"

    def test_latency_sleeps_outside_the_lock_via_injected_sleeper(self):
        slept: list[float] = []
        plane = FaultPlane.parse(
            "storage.read:latency=40", sleeper=slept.append
        )
        plane.fire("storage.read", "k")
        assert slept == [pytest.approx(0.040)]

    def test_latency_default_is_ten_ms(self):
        slept: list[float] = []
        plane = FaultPlane.parse("storage.read:latency", sleeper=slept.append)
        plane.fire("storage.read", "k")
        assert slept == [pytest.approx(0.010)]

    def test_latency_range_draws_within_bounds_deterministically(self):
        def draws(seed):
            slept: list[float] = []
            plane = FaultPlane.parse(
                "storage.read:latency=10..250", seed=seed,
                sleeper=slept.append,
            )
            for _ in range(20):
                plane.fire("storage.read", "k")
            return slept

        first = draws(3)
        assert all(0.010 <= s <= 0.250 for s in first)
        assert first == draws(3)
        assert len(set(first)) > 1  # actually drawing, not a constant

    def test_partial_returns_data_rules_and_mutate_truncates(self):
        plane = FaultPlane.parse("storage.read:partial=3")
        rules = plane.fire("storage.read", "k")
        assert len(rules) == 1
        assert FaultPlane.mutate(b"abcdef", rules) == b"abc"

    def test_partial_default_keeps_half(self):
        plane = FaultPlane.parse("peer.forward:partial")
        rules = plane.fire("peer.forward", "k")
        assert FaultPlane.mutate(b"abcdef", rules) == b"abc"

    def test_partial_never_grows_the_payload(self):
        plane = FaultPlane.parse("storage.read:partial=99")
        rules = plane.fire("storage.read", "k")
        assert FaultPlane.mutate(b"abc", rules) == b"abc"

    def test_match_gates_on_key_substring(self):
        plane = FaultPlane.parse("storage.read:error~segment-7")
        plane.fire("storage.read", "chaos/segment-3.log")  # no match: clean
        with pytest.raises(FaultInjectedError):
            plane.fire("storage.read", "chaos/segment-7.log")

    def test_wildcard_site_fires_everywhere(self):
        plane = FaultPlane.parse("*:error")
        for site in SITES:
            with pytest.raises(FaultInjectedError):
                plane.fire(site, "k")

    def test_snapshot_shape(self):
        plane = FaultPlane.parse("storage.read:error@1")
        with pytest.raises(FaultInjectedError):
            plane.fire("storage.read", "k1")
        plane.fire("storage.read", "k2")
        snap = plane.snapshot()
        assert snap["rules"] == ["storage.read:error@1"]
        assert snap["calls"] == {"storage.read": 2}
        assert snap["injections"] == 1
        assert snap["fired"] == {"storage.read:error": 1}
        assert plane.injections == [("storage.read", "error", "k1")]


class _PoisonLock:
    def __enter__(self):
        raise AssertionError("disabled fault plane acquired a lock")

    def __exit__(self, *exc):  # pragma: no cover — never entered
        return False


class TestModuleSeamAndArming:
    def test_install_returns_prior_and_fire_delegates(self):
        plane = FaultPlane.parse("storage.read:error")
        assert faults.install(plane) is None
        assert faults.enabled()
        assert faults.plane() is plane
        with pytest.raises(FaultInjectedError):
            faults.fire("storage.read", "k")
        assert faults.install(None) is plane
        assert not faults.enabled()

    def test_disabled_fire_is_zero_work(self):
        """The LockWitness pattern: a plane whose lock
        is poisoned proves the seam DOES go through the lock while
        installed — and touches nothing at all once uninstalled."""
        plane = FaultPlane.parse("storage.read:error")
        plane._lock = _PoisonLock()
        faults.install(plane)
        with pytest.raises(AssertionError):
            faults.fire("storage.read", "k")
        faults.install(None)
        assert faults.fire("storage.read", "k") is None  # one None check
        assert faults.mutate(b"abc", None) == b"abc"
        assert faults.mutate(b"abc", []) == b"abc"

    def test_env_arming(self, monkeypatch):
        monkeypatch.setenv(ENV_FLAG, "storage.read:error@2; gossip.probe:latency=1")
        monkeypatch.setenv(SEED_ENV, "77")
        faults._arm_from_env()
        plane = faults.plane()
        assert plane is not None
        assert [r.spec() for r in plane.rules] == [
            "storage.read:error@2", "gossip.probe:latency=1",
        ]

    @pytest.mark.parametrize("off", ["", "0", "false", "no"])
    def test_env_off_values_do_not_arm(self, monkeypatch, off):
        monkeypatch.setenv(ENV_FLAG, off)
        faults._arm_from_env()
        assert faults.plane() is None

    def test_env_bad_seed_falls_back_to_zero(self, monkeypatch):
        monkeypatch.setenv(ENV_FLAG, "storage.read:error")
        monkeypatch.setenv(SEED_ENV, "not-a-number")
        faults._arm_from_env()
        assert faults.plane() is not None


# ------------------------------------------------------------------ parity
KINDS_BY_SITE = {
    site: ["error", "latency", "flaky"] + (["partial"] if site in DATA_SITES else [])
    for site in SITES
}


def _seeded_spec(rng) -> list[str]:
    """A seeded rule list: every site and kind, each trigger form, range
    latencies, ``~match`` gates and the wildcard site."""
    rules = []
    triggers = ["", "@{n}", "@every={k}", "@from={n}", "@p=0.{d}"]
    for site in SITES + ("*",):
        for kind in KINDS_BY_SITE.get(site, ["error", "latency", "partial", "flaky"]):
            if rng.random() < 0.45:
                continue
            arg = ""
            if kind == "latency":
                lo = int(rng.integers(1, 20))
                arg = f"={lo}..{lo + int(rng.integers(0, 40))}" if rng.random() < 0.5 else f"={lo}"
            elif kind in ("partial", "flaky") and rng.random() < 0.7:
                arg = f"={int(rng.integers(1, 12))}"
            trig = triggers[int(rng.integers(0, len(triggers)))].format(
                n=int(rng.integers(1, 6)), k=int(rng.integers(1, 4)), d=int(rng.integers(1, 9)))
            match = f"~seg-{int(rng.integers(0, 3))}" if rng.random() < 0.3 else ""
            rules.append(f"{site}:{kind}{arg}{trig}{match}")
    return rules


def _drive_plane(mod, spec, seed, calls):
    slept = []
    plane = mod.FaultPlane.parse(spec, seed=seed, sleeper=slept.append)
    outcomes = []
    for site, key, data in calls:
        try:
            rules = plane.fire(site, key)
        except mod.FaultInjectedError as e:
            outcomes.append(("error", type(e).__name__, str(e), e.site, e.key, e.rule))
            continue
        torn = mod.mutate(data, rules)
        outcomes.append(("ok", len(rules), len(torn), torn == data[: len(torn)]))
    return outcomes, slept, plane.injections, plane.snapshot(), [r.spec() for r in plane.rules]


@pytest.mark.parametrize("seed", range(8))
def test_planes_give_equal_outcomes_on_a_seeded_sequence(seed):
    rng = np.random.default_rng(seed)
    spec = _seeded_spec(rng)
    calls = [
        (SITES[int(rng.integers(0, len(SITES)))], f"topic/seg-{int(rng.integers(0, 3))}.log",
         rng.bytes(int(rng.integers(0, 64))))
        for _ in range(120)
    ]
    port = _drive_plane(faults, spec, seed, calls)
    jax = _drive_plane(jax_faults, spec, seed, calls)
    assert port == jax
    assert port[2], "the seeded sequence should inject something"


@pytest.mark.parametrize("bad", [
    "bogus.site:error", "storage.read:explode", "gossip.probe:partial",
    "device.launch:partial=4", "lifecycle.journal:partial", "storage.read:error@wat=1",
    "storage.read:error@0", "storage.read:error@every=0", "storage.read:error@from=0",
    "storage.read:error@p=1.5", "storage.read:error=1..5", "storage.read:latency=20..10",
    "STORAGE.read:error", "storage.read error", "not a rule at all", "",
])
def test_both_planes_reject_the_same_rules(bad):
    with pytest.raises(ValueError) as port_err:
        FaultPoint.parse(bad)
    with pytest.raises(ValueError) as jax_err:
        jax_faults.FaultPoint.parse(bad)
    assert str(port_err.value) == str(jax_err.value)


def _seeded_schedule(rng) -> list[str]:
    rules = []
    for op in ("upload", "fetch", "delete", "list", "*"):
        for action in ("raise", "key-not-found", "delay", "truncate", "corrupt"):
            if action in ("truncate", "corrupt") and op not in ("fetch", "*"):
                continue
            if rng.random() < 0.55:
                continue
            arg = ""
            if action == "delay":
                lo = int(rng.integers(1, 10))
                arg = f"={lo}..{lo + int(rng.integers(0, 30))}" if rng.random() < 0.6 else f"={lo}"
            elif action in ("truncate", "corrupt") and rng.random() < 0.7:
                arg = f"={int(rng.integers(0, 40))}"
            trig = ["", f"@{int(rng.integers(1, 6))}", f"@every={int(rng.integers(1, 4))}",
                    f"@from={int(rng.integers(1, 6))}", f"@p=0.{int(rng.integers(1, 9))}"][
                int(rng.integers(0, 5))]
            rules.append(f"{op}:{action}{arg}{trig}")
    return rules


def _drive_backend(pkg, spec, seed, ops, monkeypatch):
    mem_mod, backend_mod, schedule_mod, key_cls = pkg
    slept = []
    monkeypatch.setattr(backend_mod.time, "sleep", slept.append)
    inner = mem_mod.InMemoryStorage()
    inner.configure({})
    sched = schedule_mod.FaultSchedule.parse(spec, seed=seed)
    b = backend_mod.FaultInjectingBackend(inner, sched)
    out = []
    for op, name, data in ops:
        key = key_cls(name)
        try:
            if op == "upload":
                out.append(("ok", b.upload(io.BytesIO(data), key)))
            elif op == "fetch":
                with b.fetch(key) as s:
                    out.append(("ok", s.read()))
            elif op == "delete":
                b.delete(key)
                out.append(("ok", None))
            else:
                out.append(("ok", sorted(k.value for k in b.list_objects("t/"))))
        except Exception as e:  # noqa: BLE001 - the outcome is compared
            out.append(("error", type(e).__name__, str(e).replace("tieredstorage_tpu_torch", "tieredstorage_tpu")))
    return out, slept, sched.injections, [sched.calls(o) for o in ("upload", "fetch", "delete", "list")]


@pytest.mark.parametrize("seed", range(6))
def test_fault_injecting_backends_equal_on_a_seeded_sequence(seed, monkeypatch):
    rng = np.random.default_rng(100 + seed)
    spec = _seeded_schedule(rng)
    ops = []
    for _ in range(80):
        op = ("upload", "fetch", "fetch", "delete", "list")[int(rng.integers(0, 5))]
        ops.append((op, f"t/{int(rng.integers(0, 4))}", rng.bytes(int(rng.integers(1, 48)))))
    port = _drive_backend((memory, fault_backend, schedule, ObjectKey), spec, seed, ops, monkeypatch)
    jax = _drive_backend((jax_memory, jax_fault_backend, jax_schedule, JaxObjectKey),
                         spec, seed, ops, monkeypatch)
    assert port == jax
    assert port[2], "the seeded sequence should inject something"


@pytest.mark.parametrize("bad", [
    "upload", "upload:explode", "chmod:raise", "upload:raise@whenever",
    "upload:corrupt@1", "fetch:raise@p=1.5", "fetch:raise@every=0",
    "delete:truncate", "fetch:raise=1..4", "fetch:delay=9..2",
])
def test_both_schedules_reject_the_same_rules(bad):
    with pytest.raises(ValueError) as port_err:
        schedule.FaultSchedule.parse(bad)
    with pytest.raises(ValueError) as jax_err:
        jax_schedule.FaultSchedule.parse(bad)
    assert str(port_err.value) == str(jax_err.value)


def test_fault_injected_error_is_the_ports_backend_exception():
    from tieredstorage_tpu_torch.faults import FaultInjectedException
    from tieredstorage_tpu_torch.utils.retry import Outcome, RetryPolicy

    assert issubclass(FaultInjectedError, StorageBackendException)
    assert issubclass(FaultInjectedException, StorageBackendException)
    err = FaultInjectedError("device.launch", "background", "device.launch:flaky=1")
    assert RetryPolicy().classify(err) is Outcome.RETRYABLE


def test_env_arms_the_port_plane_at_import():
    env = {**os.environ, ENV_FLAG: "storage.read:error@2; device.launch:flaky=1",
           SEED_ENV: "5", "PYTHONPATH": str(REPO)}
    code = ("from tieredstorage_tpu_torch.utils import faults; p = faults.plane(); "
            "print([r.spec() for r in p.rules]); "
            "import sys; assert 'jax' not in sys.modules")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['storage.read:error@2', 'device.launch:flaky=1']"


# ------------------------------------------------------------------- seams
def _chain(exc):
    out = []
    while exc is not None and exc not in out:
        out.append(exc)
        exc = exc.__cause__ or exc.__context__
    return out


def test_device_launch_flaky_retries_from_the_untouched_input():
    """A merged flush under ``device.launch:flaky=1``: the first attempt
    fails before staging, the retry runs from the packed input, and every
    caller gets the bytes an unbatched decrypt gives."""
    from tests.test_torch_batcher import (
        DK,
        cpu_backend,
        join_all,
        make_window,
        parked,
        parse_wire,
        submit_in_thread,
        wait_queued,
    )

    backend = cpu_backend()
    b = parked(backend, wait_ms=50, launch_attempts=2, launch_backoff_s=0.0)
    windows = [make_window(700 + i, [4096, 1000 + 7 * i]) for i in range(3)]
    unbatched = [backend._decrypt_window(DK, *parse_wire(w)) for _, w in windows]
    plane = faults.FaultPlane.parse("device.launch:flaky=1")
    faults.install(plane)
    jobs = [submit_in_thread(b, w) for _, w in windows]
    wait_queued(b, 3)
    assert b.flush_now() == 1
    join_all(jobs)
    assert [box for _, box in jobs] == [[u, None] for u in unbatched]
    assert [box[0] for _, box in jobs] == [p for p, _ in windows]
    assert b.launch_retries == 1 == plane.fired[("device.launch", "flaky")]
    assert plane.injections == [("device.launch", "flaky", "latency")]
    assert (b.launch_failures, b.launches) == (0, 1)


def test_device_launch_match_gates_on_the_work_class():
    from tests.test_torch_batcher import (
        join_all,
        make_window,
        parked,
        submit_in_thread,
        wait_queued,
    )
    from tieredstorage_tpu_torch.transform.scheduler import BACKGROUND

    b = parked(wait_ms=50, launch_attempts=1, launch_backoff_s=0.0)
    plane = faults.FaultPlane.parse("device.launch:error~background")
    faults.install(plane)
    (fg_plain, fg), (_, bg) = make_window(710, [512]), make_window(711, [512])
    jobs = [submit_in_thread(b, fg), submit_in_thread(b, bg, BACKGROUND)]
    wait_queued(b, 2)
    assert b.flush_now() == 2
    join_all(jobs)
    assert jobs[0][1] == [fg_plain, None]
    assert isinstance(jobs[1][1][1], FaultInjectedError)
    assert plane.injections == [("device.launch", "error", "background")]


@pytest.fixture(scope="module")
def rsa_keys(tmp_path_factory):
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files

    return generate_key_pair_pem_files(tmp_path_factory.mktemp("keys"), prefix="faults")


def _rsm(store, rsa_keys, extra=None):
    from tests.test_torch_rsm import _configs
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager

    rsm = RemoteStorageManager()
    rsm.configure(_configs(store, rsa_keys, "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
                           {"transform.device": "cpu", **(extra or {})}))
    return rsm


@pytest.fixture
def copied(tmp_path, rsa_keys):
    """A segment copied by a fault-free port RSM: (store, md, contents)."""
    from tests.test_torch_rsm import _write_segment
    from tieredstorage_tpu_torch import metadata

    store = tmp_path / "store"
    store.mkdir()
    md, sd, contents = _write_segment(tmp_path, metadata, seed=3)
    writer = _rsm(store, rsa_keys)
    writer.copy_log_segment_data(md, sd)
    writer.close()
    return store, md, contents


def test_torn_chunk_read_is_refused_and_quarantined(copied, rsa_keys):
    from tieredstorage_tpu_torch.transform.api import AuthenticationError

    store, md, contents = copied
    rsm = _rsm(store, rsa_keys, {"faults.spec": ["storage.read:partial=3@1"]})
    plane = faults.plane()
    assert plane is not None and [r.spec() for r in plane.rules] == ["storage.read:partial=3@1"]
    with pytest.raises(Exception) as info:
        with rsm.fetch_log_segment(md, 0, 99) as stream:
            stream.read()
    assert any(isinstance(c, AuthenticationError) for c in _chain(info.value))
    assert plane.injections[0][0:2] == ("storage.read", "partial")
    assert plane.injections[0][2].endswith(".log")
    inner = rsm._innermost_chunk_manager(rsm._chunk_manager)
    assert inner.quarantined_keys == 1
    rsm.close()
    faults.install(None)
    fresh = _rsm(store, rsa_keys)
    with fresh.fetch_log_segment(md, 0) as stream:
        assert stream.read() == contents["log"]
    fresh.close()


def test_torn_index_read_is_refused(copied, rsa_keys):
    from tieredstorage_tpu_torch.manifest.segment_indexes import IndexType
    from tieredstorage_tpu_torch.transform.api import AuthenticationError

    store, md, contents = copied
    rsm = _rsm(store, rsa_keys, {"faults.spec": ["storage.read:partial=20~indexes"]})
    with pytest.raises(Exception) as info:
        rsm.fetch_index(md, IndexType.OFFSET)
    assert any(isinstance(c, AuthenticationError) for c in _chain(info.value))
    assert faults.plane().injections[0][2].endswith(".indexes")
    rsm.close()


def test_corrupt_schedule_refuses_a_chunk_fetch(copied, rsa_keys):
    """``fetch:corrupt@2`` in a fresh RSM: fetch 1 is the manifest, so the
    corrupted fetch is the chunk window's."""
    from tieredstorage_tpu_torch.faults import FaultInjectingBackend
    from tieredstorage_tpu_torch.transform.api import AuthenticationError

    store, md, _ = copied
    rsm = _rsm(store, rsa_keys, {"fault.injection.enabled": True,
                                 "fault.schedule": ["fetch:corrupt@2"]})
    assert isinstance(rsm._storage, FaultInjectingBackend)
    with pytest.raises(Exception) as info:
        with rsm.fetch_log_segment(md, 0, 99) as stream:
            stream.read()
    assert any(isinstance(c, AuthenticationError) for c in _chain(info.value))
    [(op, action, key)] = rsm._fault_schedule.injections
    assert (op, action) == ("fetch", "corrupt") and key.endswith(".log")
    rsm.close()


@pytest.mark.parametrize("nth", [1, 2, 3])
def test_storage_write_fault_fails_the_copy_and_rolls_back(tmp_path, rsa_keys, nth):
    from tests.test_torch_rsm import _write_segment
    from tieredstorage_tpu_torch import metadata
    from tieredstorage_tpu_torch.errors import RemoteStorageException

    store = tmp_path / "store"
    store.mkdir()
    md, sd, _ = _write_segment(tmp_path, metadata, seed=4)
    rsm = _rsm(store, rsa_keys, {"faults.spec": [f"storage.write:error@{nth}"]})
    with pytest.raises(RemoteStorageException) as info:
        rsm.copy_log_segment_data(md, sd)
    assert isinstance(info.value.__cause__, FaultInjectedError)
    assert faults.plane().calls("storage.write") == nth
    assert [p for p in store.rglob("*") if p.is_file()] == []
    rsm.close()


class _PoisonPlane(FaultPlane):
    def fire(self, site, key=""):
        raise AssertionError(f"disarmed seam {site} reached the plane")


def test_disarmed_seams_do_no_work(copied, rsa_keys, tmp_path):
    """A poisoned plane proves the seams reach the plane while installed;
    once uninstalled, an RSM copy, a chunk fetch, an index fetch and a
    merged batcher launch run without touching it (the seams are one None
    check, no lock)."""
    from tests.test_torch_batcher import (
        join_all,
        make_window,
        parked,
        submit_in_thread,
        wait_queued,
    )
    from tests.test_torch_rsm import _write_segment
    from tieredstorage_tpu_torch import metadata
    from tieredstorage_tpu_torch.manifest.segment_indexes import IndexType

    store, md, contents = copied
    poison = _PoisonPlane([])
    poison._lock = _PoisonLock()
    faults.install(poison)
    rsm = _rsm(store, rsa_keys)
    with pytest.raises(Exception) as info:
        with rsm.fetch_log_segment(md, 0, 99) as stream:
            stream.read()
    assert any("disarmed seam storage.read" in str(c) for c in _chain(info.value))
    rsm.close()
    faults.install(None)
    rsm = _rsm(store, rsa_keys, {"transform.batch.enabled": True})
    with rsm.fetch_log_segment(md, 0) as stream:
        assert stream.read() == contents["log"]
    assert rsm.fetch_index(md, IndexType.TIMESTAMP).read() == contents["time"]
    rsm.delete_log_segment_data(md)
    md2, sd2, _ = _write_segment(tmp_path, metadata, seed=5)
    rsm.copy_log_segment_data(md2, sd2)
    rsm.close()
    b = parked(wait_ms=50, launch_attempts=1)
    plain, wire = make_window(720, [900])
    job = submit_in_thread(b, wire)
    wait_queued(b, 1)
    assert b.flush_now() == 1
    join_all([job])
    assert job[1] == [plain, None]


def test_fault_injecting_backend_configures_reflectively(tmp_path):
    """`storage.backend.class` = FaultInjectingBackend with
    `fault.delegate.class`: the schedule applies, every other key reaches
    the delegate."""
    from tieredstorage_tpu_torch.faults import FaultInjectedException, FaultInjectingBackend
    from tieredstorage_tpu_torch.storage.filesystem import FileSystemStorage

    b = FaultInjectingBackend()
    b.configure({
        "fault.delegate.class": "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
        "fault.schedule": "upload:raise@2", "fault.seed": 3, "root": str(tmp_path),
    })
    assert isinstance(b.delegate, FileSystemStorage)
    key = ObjectKey("a/b")
    b.upload(io.BytesIO(b"one"), key)
    with pytest.raises(FaultInjectedException):
        b.upload(io.BytesIO(b"two"), ObjectKey("a/c"))
    assert (tmp_path / "a" / "b").read_bytes() == b"one"
    with pytest.raises(ValueError, match="fault.delegate.class"):
        FaultInjectingBackend().configure({})
