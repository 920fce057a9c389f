"""The failure policy through both RSMs, configured from one dict.

Every key of the slice is on — the breaker, the retry budget, the default
deadline, hedging, admission and the SLO engine — over a filesystem store
wrapped in one `fault.schedule`. The same script of copies and reads gives
the same outcome per call in both packages; the resilience, retry-metrics
and slo-metrics groups hold the same names and the same deterministic
values (a gauge of a process-wide counter is held against its own
package's counter); `slo_status()` has the same keys; a fetch under an
expired deadline fails before any storage call; and a segment written by
either package reads back byte for byte through the other. The slice's
configuration keys have JAX's definitions.
"""

from __future__ import annotations

import pytest

from tests.test_torch_rsm import CHUNK, SEGMENT_SIZE, _configs, _write_segment
from tieredstorage_tpu import metadata as jax_metadata
from tieredstorage_tpu.config.configdef import ConfigException as JaxConfigException
from tieredstorage_tpu.rsm import RemoteStorageManager as JaxRemoteStorageManager
from tieredstorage_tpu.utils import deadline as jax_deadline
from tieredstorage_tpu.utils import retry as jax_retry
from tieredstorage_tpu_torch import metadata
from tieredstorage_tpu_torch.config.configdef import ConfigException
from tieredstorage_tpu_torch.rsm import RemoteStorageManager
from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files
from tieredstorage_tpu_torch.utils import deadline as port_deadline
from tieredstorage_tpu_torch.utils import retry as port_retry

#: One dict with every key of the slice on. The hedge delay is long and the
#: breaker's cooldown outlasts the test, so no outcome depends on timing.
SLICE = {
    "breaker.enabled": True,
    "breaker.failure.threshold": 3,
    "breaker.cooldown.ms": 600_000,
    "deadline.default.ms": 60_000,
    "hedge.enabled": True,
    "hedge.delay.ms": 30_000,
    "hedge.delay.min.samples": 1_000,
    "hedge.budget.percent": 10,
    "retry.budget.enabled": True,
    "retry.budget.percent": 50,
    "retry.budget.capacity": 2,
    "retry.budget.max.attempts": 3,
    "retry.budget.backoff.ms": 1,
    "admission.enabled": True,
    "admission.max.concurrent": 3,
    "admission.max.queue": 1,
    "admission.queue.timeout.ms": 20,
    "admission.retry.after.ms": 1_500,
    "slo.enabled": True,
    "slo.window.short.ms": 60_000,
    "slo.window.long.ms": 600_000,
    "slo.fetch.latency.threshold.ms": 60_000,
    "slo.fetch.latency.objective.percent": 95,
    "slo.error.rate.objective.percent": 90,
    "slo.shed.rate.max.percent": 20,
    "slo.cache.hit.floor.percent": 0,
}
#: The store fails fetch 4 (retried under the budget), fetch 7 and 8 (one
#: call's retries: the budget then runs dry), then every fetch from the 12th.
SCHEDULE = ["fetch:raise@4", "fetch:raise@7", "fetch:raise@8", "fetch:raise@from=12"]

PACKAGES = {
    "port": (RemoteStorageManager, metadata, port_deadline, port_retry,
             "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
             {"transform.device": "cpu"}),
    "jax": (JaxRemoteStorageManager, jax_metadata, jax_deadline, jax_retry,
            "tieredstorage_tpu.storage.filesystem.FileSystemStorage", {}),
}


@pytest.fixture(scope="module")
def keys(tmp_path_factory):
    return generate_key_pair_pem_files(tmp_path_factory.mktemp("keys"), prefix="policy")


def _rsm(package, store, keys, schedule):
    cls, _, _, _, backend_class, extra = PACKAGES[package]
    rsm = cls()
    rsm.configure(_configs(store, keys, backend_class, {
        **SLICE, **extra, "fault.injection.enabled": True, "fault.schedule": schedule,
    }))
    return rsm


def _outcome(fn) -> object:
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome is the datum
        chain = []
        while e is not None:
            chain.append(type(e).__name__)
            e = e.__cause__
        return tuple(chain)


def _drive(package, root, keys) -> dict:
    _, mod, deadline, _, _, _ = PACKAGES[package]
    store = root / "store"
    store.mkdir()
    rsm = _rsm(package, store, keys, SCHEDULE)
    md, sd, contents = _write_segment(root, mod)
    log = contents["log"]
    calls = []

    def read(start, end=None):
        with rsm.fetch_log_segment(md, start, end) as stream:
            got = stream.read()
        stop = SEGMENT_SIZE if end is None else end + 1
        assert got == log[start:stop]
        return len(got)

    schedule = rsm._fault_schedule
    calls.append(_outcome(lambda: rsm.copy_log_segment_data(md, sd)))
    for start, end in ((0, None), (0, 99), (CHUNK - 5, 2 * CHUNK + 10),
                       (SEGMENT_SIZE - 300, None), (3 * CHUNK, 3 * CHUNK + 1),
                       (0, None), (CHUNK, CHUNK + 1), (0, 5)):
        calls.append(_outcome(lambda: read(start, end)))
        calls.append((schedule.calls("fetch"), rsm._breaker.state.name))
    # An expired deadline fails at the entry: no storage call, no breaker
    # accounting, and this package's counter moves by one.
    before = (schedule.calls("fetch"), deadline.exceeded_total(), rsm._breaker.fast_fails)
    with deadline.deadline_scope(deadline.Deadline.after(-1.0)):
        calls.append(_outcome(lambda: rsm.fetch_log_segment(md, 0, 99)))
    after = (schedule.calls("fetch"), deadline.exceeded_total(), rsm._breaker.fast_fails)
    assert after == (before[0], before[1] + 1, before[2])
    # Admission as a service boundary drives it: three run, one queues and
    # times out, then a release frees a slot.
    admission = rsm.admission
    shed = []
    for i in range(4):
        try:
            admission.acquire(f"r{i}")
        except Exception as e:  # noqa: BLE001 — the shed is the datum
            shed.append((type(e).__name__, str(e), e.retry_after_s))
    admission.release()
    calls.append(shed)
    status = rsm.slo_status()
    values = {str(n): rsm.metrics.registry.value(n) for n in rsm.metrics.registry.metric_names}
    return {"rsm": rsm, "calls": calls, "status": status, "values": values,
            "injections": len(schedule.injections)}


@pytest.fixture(scope="module")
def driven(tmp_path_factory, keys):
    out = {p: _drive(p, tmp_path_factory.mktemp(p), keys) for p in PACKAGES}
    yield out
    for rec in out.values():
        rec["rsm"].close()


def test_outcome_per_call_equals_jax(driven):
    assert driven["port"]["calls"] == driven["jax"]["calls"]
    assert driven["port"]["injections"] == driven["jax"]["injections"]
    calls = driven["port"]["calls"]
    outcomes = [c for c in calls if isinstance(c, tuple) and isinstance(c[0], str)]
    assert outcomes[0] == ("ok", None)  # the copy
    # The lazy stream raises the store's errors as they are: the injected
    # failure that exhausts the budget, then the open breaker's fast fail.
    assert ("FaultInjectedException",) in outcomes
    assert ("CircuitOpenException",) in outcomes
    assert ("DeadlineExceededException",) in outcomes
    assert driven["port"]["rsm"]._breaker.opens == 1
    assert calls[-1] == [(
        "AdmissionRejectedException", "queued 20 ms without a slot: r3 shed", 1.5,
    )]


#: Groups of this slice, and the gauges among them that read process-wide
#: state (each held against its own package's counter below).
GROUPS = ("resilience-metrics:", "retry-metrics:", "slo-metrics:")
PROCESS_WIDE = {
    "resilience-metrics:deadline-exceeded-total",
    "retry-metrics:faults-armed",
    "retry-metrics:faults-seam-calls-total",
    "retry-metrics:faults-injections-total",
}
#: Depend on wall-clock windows (burn rates) or on the process-wide deadline
#: counter (the fetch-errors objective): compared within each package.
TIMED = ("slo-burn-rate-", "{slo=fetch-errors}")


def _slice_values(rec):
    return {n: v for n, v in rec["values"].items() if n.startswith(GROUPS)}


def test_group_names_equal_jax(driven):
    names = {p: sorted(_slice_values(rec)) for p, rec in driven.items()}
    assert names["port"] == names["jax"]
    for name in ("resilience-metrics:breaker-opens-total", "resilience-metrics:hedges-launched-total",
                 "resilience-metrics:retry-budget-spent-total",
                 "resilience-metrics:admission-shed-total",
                 "retry-metrics:breaker-storage-opens-total",
                 "slo-metrics:slo-compliance{slo=shed-rate}"):
        assert name in names["port"], name


def test_deterministic_values_equal_jax(driven):
    values = {}
    for package, rec in driven.items():
        _, _, deadline, retry, _, _ = PACKAGES[package]
        got = _slice_values(rec)
        assert got.pop("resilience-metrics:deadline-exceeded-total") <= deadline.exceeded_total()
        ledger = retry.ledger()
        for name in [n for n in got if n.startswith("retry-metrics:retry-")
                     and not n.startswith("retry-metrics:retry-backoff")]:
            site, field = _ledger_field(name)
            value = got.pop(name)
            if field == "amplification":
                assert value >= 1.0
            else:
                assert value <= ledger.value(site, field)
        for name in PROCESS_WIDE - {"resilience-metrics:deadline-exceeded-total"}:
            got.pop(name)
        values[package] = {n: v for n, v in got.items() if not any(t in n for t in TIMED)}
    assert values["port"] == values["jax"]
    port = values["port"]
    assert port["resilience-metrics:breaker-state"] == 2.0
    assert port["retry-metrics:breaker-storage-opens-total"] == 1.0
    assert port["resilience-metrics:hedges-launched-total"] == 0.0
    assert port["resilience-metrics:admission-shed-total"] == 1.0


def _ledger_field(name: str):
    stem = name[len("retry-metrics:retry-"):]
    for field, suffix in (("attempts", "-attempts-total"), ("retries", "-retries-total"),
                          ("giveups", "-giveups-total"), ("backoff_ms", "-backoff-ms-total"),
                          ("amplification", "-amplification")):
        if stem.endswith(suffix):
            return stem[: -len(suffix)].replace("-", "."), field
    raise AssertionError(name)


def test_slo_status_keys_equal_jax(driven):
    port, jax = driven["port"]["status"], driven["jax"]["status"]
    assert sorted(port) == sorted(jax)
    assert sorted(port["specs"]) == sorted(jax["specs"]) == [
        "fetch-errors", "fetch-latency", "shed-rate"]
    for name in port["specs"]:
        assert sorted(port["specs"][name]) == sorted(jax["specs"][name])
    for name in ("fetch-latency", "shed-rate"):
        p, j = port["specs"][name], jax["specs"][name]
        assert {k: v for k, v in p.items() if not k.startswith("burn")} == \
            {k: v for k, v in j.items() if not k.startswith("burn")}
    assert port["specs"]["shed-rate"]["samples"] == 4.0
    assert port["specs"]["shed-rate"]["good"] == 3.0


def test_no_storage_call_under_an_expired_deadline_in_either(driven):
    """Checked inside the drive for both packages; here the fetch outcome:
    the entry raises the deadline itself, not a wrapped storage error."""
    for rec in driven.values():
        assert ("DeadlineExceededException",) in rec["calls"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_segments_cross_read_with_the_policy_on(tmp_path, keys, writer):
    store = tmp_path / "store"
    store.mkdir()
    reader = "jax" if writer == "port" else "port"
    schedule = ["fetch:delay=1@every=3"]
    w = _rsm(writer, store, keys, schedule)
    r = _rsm(reader, store, keys, schedule)
    try:
        md_w, sd, contents = _write_segment(tmp_path, PACKAGES[writer][1])
        w.copy_log_segment_data(md_w, sd)
        md_r, _, _ = _write_segment(tmp_path, PACKAGES[reader][1])
        with r.fetch_log_segment(md_r, 0) as stream:
            assert stream.read() == contents["log"]
        with r.fetch_log_segment(md_r, CHUNK - 5, 2 * CHUNK + 10) as stream:
            assert stream.read() == contents["log"][CHUNK - 5: 2 * CHUNK + 11]
        assert r.hedger.primaries >= 2 and r._breaker.state.name == "CLOSED"
    finally:
        w.close()
        r.close()


# ---------------------------------------------------------------- config
#: One value each key accepts and one its validator refuses (None: the type
#: accepts every value of it).
KEY_PROBES = {
    "breaker.enabled": (True, None), "breaker.failure.threshold": (1, 0),
    "breaker.cooldown.ms": (1, 0), "deadline.default.ms": (1, 0),
    "hedge.enabled": (True, None), "hedge.delay.ms": (1, 0),
    "hedge.delay.min.samples": (1, 0), "hedge.budget.percent": (100, 101),
    "retry.budget.enabled": (True, None), "retry.budget.percent": (1, 0),
    "retry.budget.capacity": (1, 0), "retry.budget.max.attempts": (1, 0),
    "retry.budget.backoff.ms": (1, 0), "admission.enabled": (True, None),
    "admission.max.concurrent": (1, 0), "admission.max.queue": (0, -1),
    "admission.queue.timeout.ms": (1, 0), "admission.retry.after.ms": (1, 0),
    "slo.enabled": (True, None), "slo.window.short.ms": (1, 0),
    "slo.window.long.ms": (1, 0), "slo.fetch.latency.threshold.ms": (1, 0),
    "slo.fetch.latency.objective.percent": (99, 100),
    "slo.error.rate.objective.percent": (1, 0), "slo.shed.rate.max.percent": (99, 100),
    "slo.cache.hit.floor.percent": (0, 100),
}


def test_probes_cover_every_key_of_the_slice():
    assert sorted(KEY_PROBES) == sorted(SLICE)


@pytest.mark.parametrize("key", sorted(KEY_PROBES))
def test_slice_keys_have_jax_definitions(key):
    from tieredstorage_tpu.config.rsm_config import _base_def as jax_base_def
    from tieredstorage_tpu_torch.config.rsm_config import NOT_YET_PORTED, _base_def

    assert key not in NOT_YET_PORTED
    port, jax = _base_def().keys[key], jax_base_def().keys[key]
    assert (port.type, port.default, port.importance, port.doc) == \
        (jax.type, jax.default, jax.importance, jax.doc)
    assert getattr(port.validator, "description", None) == \
        getattr(jax.validator, "description", None)
    good, bad = KEY_PROBES[key]
    for validator in (port.validator, jax.validator):
        if validator is not None:
            validator(key, good)
    if bad is not None:
        with pytest.raises(ConfigException) as port_err:
            port.validator(key, bad)
        with pytest.raises(JaxConfigException) as jax_err:
            jax.validator(key, bad)
        assert str(port_err.value) == str(jax_err.value)


def test_slo_window_check_has_the_jax_message(tmp_path, keys):
    messages = []
    for package, exc in (("port", ConfigException), ("jax", JaxConfigException)):
        cls, _, _, _, backend_class, extra = PACKAGES[package]
        with pytest.raises(exc) as err:
            cls().configure(_configs(tmp_path, keys, backend_class, {
                **extra, "slo.window.short.ms": 5_000, "slo.window.long.ms": 5_000}))
        messages.append(str(err.value))
    assert messages[0] == messages[1]
