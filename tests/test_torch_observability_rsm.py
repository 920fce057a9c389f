"""The observability plane through both RSMs on one seeded segment.

The port runs with transform.device=cpu; the JAX RSM with its TPU backend
(JAX on the CPU), the counterpart of the port's CUDA backend, so both
record the backend's stage spans and GCM window notes. Copy, whole fetch,
ranged read, fetch_index and delete give the same metric names (the
`retry-metrics` group included), the same deterministic counters (that
group's gauges read the process-wide retry ledger and fault plane, so they
are left out of the values), the same exposition series, the same span
names per operation (the port's own spans of its window path and store
uploads aside, tests/torch_span_parity.py) and the same flight note keys; over the S3 emulator
the backends' request metrics count the same requests per operation. The
11 configuration keys of the plane have JAX's types, defaults and
validator errors.
"""

from __future__ import annotations

import json
import re

import pytest

from tests.emulators.s3_emulator import S3Emulator
from tests.test_torch_rsm import CHUNK, SEGMENT_SIZE, _configs, _write_segment
from tests.test_torch_storage_contract import S3_CREDENTIALS, s3_configs
from tests.torch_span_parity import PORT_ONLY_SPANS, shared_tree
from tieredstorage_tpu import metadata as jax_metadata
from tieredstorage_tpu.manifest.segment_indexes import IndexType as JaxIndexType
from tieredstorage_tpu.metrics.prometheus import render as jax_render
from tieredstorage_tpu.rsm import RemoteStorageManager as JaxRemoteStorageManager
from tieredstorage_tpu.utils import deadline as jax_deadline
from tieredstorage_tpu_torch import metadata
from tieredstorage_tpu_torch.config.configdef import ConfigException
from tieredstorage_tpu_torch.errors import RemoteStorageException
from tieredstorage_tpu_torch.manifest.segment_indexes import IndexType
from tieredstorage_tpu_torch.metrics.prometheus import render as port_render
from tieredstorage_tpu_torch.rsm import RemoteStorageManager
from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files
from tieredstorage_tpu_torch.utils import deadline as port_deadline

#: Groups whose gauges read process-wide state (the retry ledger, the fault
#: plane): other tests in the same process move them.
PROCESS_WIDE_GROUPS = ("retry-metrics",)
OBSERVED = {"tracing.enabled": True, "flight.enabled": True, "timeline.enabled": True}
OPERATIONS = ("copy", "fetch", "ranged", "index", "delete")


@pytest.fixture(scope="module")
def keys(tmp_path_factory):
    return generate_key_pair_pem_files(tmp_path_factory.mktemp("keys"), prefix="obs")


def _port_configs(store, keys, extra=None):
    return _configs(store, keys, "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
                    {"transform.device": "cpu", **OBSERVED, **(extra or {})})


def _jax_configs(store, keys, extra=None):
    return _configs(store, keys, "tieredstorage_tpu.storage.filesystem.FileSystemStorage", {
        "transform.backend.class": "tieredstorage_tpu.transform.tpu.TpuTransformBackend",
        **OBSERVED, **(extra or {}),
    })


def _drive(rsm, mod, index_type, root, configs):
    """Copy, fetch, ranged read, fetch_index and delete of one segment;
    each operation's spans are collected separately. The ranged read is
    drained under an outer flight record so the lazy chunk transfer lands
    on it (as a server's request record would cover it)."""
    rsm.configure(configs)
    md, sd, contents = _write_segment(root, mod)
    spans = {}

    def op(name, fn):
        rsm.tracer.clear()
        fn()
        spans[name] = rsm.tracer.spans()

    op("copy", lambda: rsm.copy_log_segment_data(md, sd))

    def fetch():
        with rsm.fetch_log_segment(md, 0) as s:
            assert s.read() == contents["log"]

    def ranged():
        with rsm.flight_recorder.request("ranged.read", trace_id="ranged-1"):
            with rsm.fetch_log_segment(md, CHUNK - 5, 2 * CHUNK + 10) as s:
                assert s.read() == contents["log"][CHUNK - 5: 2 * CHUNK + 11]

    op("fetch", fetch)
    op("ranged", ranged)
    op("index", lambda: rsm.fetch_index(md, index_type.OFFSET).read())
    op("delete", lambda: rsm.delete_log_segment_data(md))
    return spans


@pytest.fixture(scope="module")
def driven(tmp_path_factory, keys):
    out = {}
    for name, cls, mod, index_type, configs in (
        ("jax", JaxRemoteStorageManager, jax_metadata, JaxIndexType, _jax_configs),
        ("port", RemoteStorageManager, metadata, IndexType, _port_configs),
    ):
        root = tmp_path_factory.mktemp(name)
        store = root / "store"
        store.mkdir()
        rsm = cls()
        spans = _drive(rsm, mod, index_type, root, configs(store, keys))
        out[name] = (rsm, spans)
    yield out
    for rsm, _ in out.values():
        rsm.close()


def test_metric_names_equal_jax(driven):
    names = {k: sorted(str(m) for m in rsm.metrics.registry.metric_names)
             for k, (rsm, _) in driven.items()}
    assert names["port"] == names["jax"]
    assert "remote-storage-manager-metrics:segment-copy-time-ms" in names["port"]
    assert "retry-metrics:retry-storage-fetch-attempts-total" in names["port"]


#: Snapshot families whose values do not depend on timing.
_DETERMINISTIC = re.compile(
    r"(-total|-bytes-total|-resident|-size-total|-weight-total|-enabled|"
    r"-recorded-total|-evicted-total|-occupancy|-dropped-spans|-recorded-spans|-ms)(\{|$)"
)
_TIMED = re.compile(r"(time-ms|load-time-total-ns|-ms-total)(\{|$)")
#: Gauges of a process-wide counter: other RSMs in the same process move them.
_PROCESS_WIDE = "resilience-metrics:deadline-exceeded-total"


def test_deterministic_counters_equal_jax(driven):
    values = {}
    for k, (rsm, _) in driven.items():
        snap = rsm.metrics.snapshot()
        values[k] = {
            n: v for n, v in snap.items()
            if _DETERMINISTIC.search(n) and not n.startswith(PROCESS_WIDE_GROUPS)
            and not (_TIMED.search(n) and not n.endswith("-time-ms")) and n != _PROCESS_WIDE
        }
        assert snap[_PROCESS_WIDE] == float(
            (jax_deadline if k == "jax" else port_deadline).exceeded_total())
    assert values["port"] == values["jax"]
    port = values["port"]
    rsm_group = "remote-storage-manager-metrics"
    # One copy, one delete; three objects uploaded; two reads requested.
    assert port[f"{rsm_group}:segment-copy-time-ms"] == 1.0
    assert port[f"{rsm_group}:object-upload-total"] == 3.0
    assert port[f"{rsm_group}:segment-delete-total"] == 1.0
    assert port[f"{rsm_group}:segment-fetch-requested-bytes-total"] == SEGMENT_SIZE + (CHUNK + 16)
    assert port[f"{rsm_group}:remote-fetch-time-ms"] == 2.0


def _series(text):
    out = set()
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        out.add(re.match(r"[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})?", line).group(0))
    return out


def test_exposition_series_equal_jax(driven):
    texts = {
        "jax": jax_render([driven["jax"][0].metrics.registry]),
        "port": port_render([driven["port"][0].metrics.registry]),
    }
    assert _series(texts["port"]) == _series(texts["jax"])
    for line in texts["port"].splitlines():
        assert line.startswith("#") or re.fullmatch(
            r"[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+", line
        ), line


#: The port's own spans each operation records (`transform.device=cpu`, an
#: encrypted segment, compression off): reads wait on decrypt windows and
#: assemble no wire chunks.
_WINDOW = {"gcm.context", "transform.stage", "transform.launch", "transform.wait"}
PORT_OWN = {
    "copy": _WINDOW | {"transform.assemble", "storage.upload"},
    "fetch": _WINDOW,
    "ranged": _WINDOW,
    "index": _WINDOW,
    "delete": set(),
}


@pytest.mark.parametrize("operation", OPERATIONS)
def test_span_names_per_operation_equal_jax(driven, operation):
    port = driven["port"][1][operation]
    jax = [(s.name, s.depth) for s in driven["jax"][1][operation]]
    assert shared_tree(port) == jax
    assert jax
    assert {s.name for s in port} & PORT_ONLY_SPANS == PORT_OWN[operation]


def test_ranged_read_flight_notes_equal_jax(driven):
    records = {k: rsm.flight_recorder.find("ranged-1") for k, (rsm, _) in driven.items()}
    port, jax = records["port"], records["jax"]
    assert sorted(port.counters) == sorted(jax.counters)
    assert [s[0] for s in port.stages] == [s[0] for s in jax.stages]
    for key in ("tier.backend", "gcm.windows", "gcm.dispatches"):
        assert port.counters[key] == jax.counters[key], key
    assert driven["port"][0].flight_status(trace="ranged-1")["slowest"][0]["tiers"] == {"backend": 3.0}


def test_flight_records_of_every_operation(driven):
    names = {k: sorted(r.name for r in rsm.flight_recorder.slowest()) for k, (rsm, _) in driven.items()}
    assert names["port"] == names["jax"]
    assert names["port"] == sorted([
        "rsm.copy_log_segment_data", "rsm.fetch_log_segment", "ranged.read",
        "rsm.fetch_index", "rsm.delete_log_segment_data",
    ])


def test_status_payloads_refuse_when_disabled_as_jax(tmp_path, keys):
    messages = []
    for name, cls, configs in (
        ("jax", JaxRemoteStorageManager, _jax_configs), ("port", RemoteStorageManager, _port_configs),
    ):
        store = tmp_path / name
        store.mkdir()
        rsm = cls()
        conf = {k: v for k, v in configs(store, keys).items() if k not in OBSERVED}
        rsm.configure(conf)
        for call in (rsm.flight_status, rsm.timeline_status):
            with pytest.raises(Exception) as err:
                call()
            messages.append((name, type(err.value).__name__, str(err.value)))
        rsm.close()
    assert [m[1:] for m in messages[2:]] == [m[1:] for m in messages[:2]]
    assert all(m[1] == RemoteStorageException.__name__ for m in messages)


def test_close_writes_the_chrome_trace(tmp_path, keys):
    store = tmp_path / "store"
    store.mkdir()
    path = tmp_path / "traces" / "rsm.json"
    rsm = RemoteStorageManager()
    _drive(rsm, metadata, IndexType, tmp_path, _port_configs(
        store, keys, {"tracing.export.path": str(path)}))
    rsm.close()
    doc = json.loads(path.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    # _drive clears the ring before each operation: the delete is what is left.
    assert {"rsm.delete_log_segment_data", "storage.delete_keys"} <= names
    assert doc["otherData"] == {"dropped_spans": 0}


def test_timeline_status_is_served(driven):
    status = driven["port"][0].timeline_status()
    assert status["enabled"] is True and status["launches_recorded"] == 0


# ------------------------------------------------------- request metrics
@pytest.fixture(scope="module")
def s3():
    emu = S3Emulator(credentials=S3_CREDENTIALS).start()
    yield emu
    emu.stop()


def test_s3_request_metric_counts_equal_jax(s3, keys, tmp_path):
    counts = {}
    for name, cls, mod, index_type, package in (
        ("jax", JaxRemoteStorageManager, jax_metadata, JaxIndexType, "tieredstorage_tpu"),
        ("port", RemoteStorageManager, metadata, IndexType, "tieredstorage_tpu_torch"),
    ):
        configs = {
            "storage.backend.class": f"{package}.storage.s3:S3Storage",
            **{f"storage.{k}": v for k, v in s3_configs(s3.endpoint).items()},
            "chunk.size": CHUNK, "key.prefix": f"{name}/",
        }
        if name == "port":
            configs["transform.device"] = "cpu"
        rsm = cls()
        (tmp_path / name).mkdir()
        _drive(rsm, mod, index_type, tmp_path / name, configs)
        collector = rsm._storage.metrics
        assert rsm._storage.client.http.observer == collector.observe
        snap = collector.registry.snapshot()
        counts[name] = {k: v for k, v in snap.items() if k.endswith("-requests-total")
                        or k.endswith("-errors-total") or k.endswith("-time-ms")}
        rsm.close()
    assert counts["port"] == counts["jax"]
    assert counts["port"]["s3-client-metrics:get-object-requests-total"] >= 3


# ---------------------------------------------------------------- config
PLANE_KEYS = {
    # key: (a value the key accepts, one its validator refuses or None)
    "tracing.enabled": (True, None),
    "tracing.jax.profiler.enabled": (True, None),
    "tracing.max.spans": (1, 0),
    "tracing.export.path": ("/t.json", " "),
    "flight.enabled": (True, None),
    "flight.ring.size": (4096, 4097),
    "timeline.enabled": (True, None),
    "timeline.ring.size": (65536, 0),
    "metrics.num.samples": (1, 0),
    "metrics.sample.window.ms": (1, 0),
    "metrics.recording.level": ("debug", "TRACE"),
}


@pytest.mark.parametrize("key", sorted(PLANE_KEYS))
def test_plane_keys_have_jax_types_defaults_and_errors(key):
    from tieredstorage_tpu.config.configdef import ConfigException as JaxConfigException
    from tieredstorage_tpu.config.rsm_config import _base_def as jax_base_def
    from tieredstorage_tpu_torch.config.rsm_config import NOT_YET_PORTED, _base_def

    assert key not in NOT_YET_PORTED
    port, jax = _base_def().keys[key], jax_base_def().keys[key]
    assert (port.type, port.default, port.importance) == (jax.type, jax.default, jax.importance)
    assert getattr(port.validator, "description", None) == getattr(jax.validator, "description", None)
    good, bad = PLANE_KEYS[key]
    for validator in (port.validator, jax.validator):
        if validator is not None:
            validator(key, good)
    if bad is not None:
        with pytest.raises(ConfigException) as port_err:
            port.validator(key, bad)
        with pytest.raises(JaxConfigException) as jax_err:
            jax.validator(key, bad)
        assert str(port_err.value) == str(jax_err.value)


def test_not_yet_ported_lists_only_the_failure_policy_and_fleet_keys():
    from tieredstorage_tpu.config.rsm_config import _base_def as jax_base_def
    from tieredstorage_tpu_torch.config.rsm_config import NOT_YET_PORTED, _base_def

    assert not set(PLANE_KEYS) & NOT_YET_PORTED
    assert NOT_YET_PORTED <= set(jax_base_def().keys)
    assert not NOT_YET_PORTED & set(_base_def().keys)
    # The failure policy, the sidecar and the fleet (with its breaker and
    # retry keys) are ported: no key is left, and the port defines every
    # key of the JAX package's configuration.
    assert NOT_YET_PORTED == frozenset()
    assert set(jax_base_def().keys) == set(_base_def().keys)
    assert {"fleet.enabled", "breaker.peer.failure.threshold",
            "breaker.gossip.failure.threshold", "retry.gossip.probe.attempts"} <= \
        set(_base_def().keys)
