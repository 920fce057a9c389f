"""RemoteStorageManager configuration schema.

Counterpart of tieredstorage_tpu/config/rsm_config.py, with every key of the
JAX package's configuration:
`storage.*` (with the required `storage.backend.class`), `key.prefix`,
`key.prefix.mask`, `chunk.size`, `compression.*`, `encryption.*` (keyring
with the two-phase `encryption.key.pairs.<id>.*` define),
`custom.metadata.fields.include`, `upload.rate.limit.bytes.per.second`,
`retry.launch.*` (the window batcher's launch retry), `tracing.*`,
`flight.*`, `timeline.*` and `metrics.*` (the observability plane),
`breaker.*`, `retry.budget.*`, `deadline.default.ms`, `hedge.*`,
`admission.*` and `slo.*` (the failure policy), `sidecar.*` (the
sidecar's pools), `fleet.*`, `breaker.peer.*`, `breaker.gossip.*` and
`retry.gossip.probe.attempts` (the fleet), `scrub.*` (the
scrubber, its scheduler and the upload checksums), `fault.*` and `faults.*`
(the fault-injecting backend and the fault plane), `lifecycle.*` (the
intent journal and the recovery sweeper), `replication.antientropy.*`
(anti-entropy repair of a replicated store), `transform.backend.class`
(default: this package's CudaTransformBackend) and the `transform.*` subtree
its backend reads, and the fetch plane's keys, which their own modules parse:
`fetch.chunk.cache.*`, `fetch.manifest.cache.*`, `fetch.indexes.cache.*`
(config/cache_config.py), `fetch.chunk.cache.class`, `cache.device.*` and
`readahead.*` (fetch/factory.py). A key named in `NOT_YET_PORTED` raises
a ConfigException naming it as not yet ported: a setting is never ignored
silently.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

from tieredstorage_tpu_torch.config.configdef import (
    ConfigDef,
    ConfigException,
    ConfigKey,
    in_range,
    non_empty_string,
    null_or,
    parseable_by,
    subset_with_prefix,
)

INT_MAX = 2**31 - 1

STORAGE_PREFIX = "storage."
TRANSFORM_PREFIX = "transform."
FETCH_CHUNK_CACHE_PREFIX = "fetch.chunk.cache."
FETCH_INDEXES_CACHE_PREFIX = "fetch.indexes.cache."
FETCH_MANIFEST_CACHE_PREFIX = "fetch.manifest.cache."

#: Keys of the JAX package's configuration that this package has not ported
#: (a key named here is refused, never ignored). Every key is ported.
NOT_YET_PORTED: frozenset = frozenset()


def _parse_fleet_instances(value) -> None:
    from tieredstorage_tpu_torch.fleet.ring import parse_instances

    parse_instances(value)


_valid_fleet_instances = parseable_by(
    _parse_fleet_instances, "fleet members 'name[=http://host:port]'"
)


def _codec_id(name: str, value) -> None:
    import warnings

    from tieredstorage_tpu_torch.transform.api import THUFF, TLZHUFF, ZSTD

    if value not in (ZSTD, THUFF, TLZHUFF):
        raise ConfigException(
            f"Invalid value {value!r} for configuration {name}: "
            f"must be one of [{ZSTD!r}, {THUFF!r}, {TLZHUFF!r}]"
        )
    if value == TLZHUFF:
        # Demoted behind tpu-huff-v1 in the JAX package, with the same
        # warning: still supported for reading existing manifests; new
        # uploads should use tpu-huff-v1.
        warnings.warn(
            f"{TLZHUFF!r} is deprecated as a configured codec: its device LZ "
            f"stage is two orders of magnitude slower than every alternative "
            f"(BENCH_r05). Use {THUFF!r} (device) or {ZSTD!r} (host) instead; "
            f"existing {TLZHUFF!r} segments remain readable.",
            DeprecationWarning,
            stacklevel=2,
        )


_codec_id.description = "[zstd, tpu-huff-v1, tpu-lzhuff-v1]"


def _parse_fault_rules(value) -> None:
    from tieredstorage_tpu_torch.faults.schedule import FaultSchedule

    FaultSchedule.parse(value)


_valid_fault_schedule = parseable_by(
    _parse_fault_rules, "fault rules 'op:action[=arg][@trigger]'"
)


def _parse_fault_spec(value) -> None:
    from tieredstorage_tpu_torch.utils.faults import FaultPlane

    FaultPlane.parse(value)


_valid_fault_spec = parseable_by(
    _parse_fault_spec, "fault rules 'site:kind[=arg][@trigger][~match]'"
)


def _valid_recording_level(name: str, value) -> None:
    if str(value).upper() not in ("INFO", "DEBUG"):
        raise ConfigException(
            f"Invalid value {value!r} for configuration {name}: must be INFO or DEBUG"
        )


_valid_recording_level.description = "[INFO, DEBUG]"


def _base_def() -> ConfigDef:
    d = ConfigDef()
    d.define(ConfigKey(
        "storage.backend.class", "class", importance="high",
        doc="The storage backend implementation class.",
    ))
    d.define(ConfigKey(
        "transform.backend.class", "class",
        default="tieredstorage_tpu_torch.transform.cuda.CudaTransformBackend",
        importance="high",
        doc="The transform backend implementation class (the CUDA backend, "
            "whose transform.device selects the GPU or the CPU).",
    ))
    d.define(ConfigKey(
        "key.prefix", "string", default="", validator=None, importance="high",
        doc="The object storage path prefix.",
    ))
    d.define(ConfigKey(
        "key.prefix.mask", "bool", default=False, importance="low",
        doc="Whether to mask the prefix in logs.",
    ))
    d.define(ConfigKey(
        "chunk.size", "int", validator=in_range(1, INT_MAX // 2), importance="high",
        doc="Segment files are chunked into chunks of this size, transformed "
            "chunk-wise, and range-fetched chunk-wise.",
    ))
    d.define(ConfigKey(
        "compression.enabled", "bool", default=False, importance="high",
        doc="Whether to compress chunks before storing.",
    ))
    d.define(ConfigKey(
        "compression.heuristic.enabled", "bool", default=False, importance="high",
        doc="Only compress segments whose first record batch is not already "
            "compressed (requires compression.enabled).",
    ))
    d.define(ConfigKey(
        "compression.codec", "string", default="zstd", importance="medium",
        validator=_codec_id,
        doc="Compression codec id recorded in the manifest: 'zstd' "
            "(reference-compatible) or 'tpu-huff-v1' (order-0 device codec, "
            "the preferred device choice). 'tpu-lzhuff-v1' (device LZ + "
            "Huffman) is DEPRECATED — demoted behind tpu-huff-v1 in the JAX "
            "package after its benchmark (BENCH_r05) measured it two orders "
            "of magnitude slower on both compress and ranged fetch; "
            "configuring it emits a DeprecationWarning, existing segments "
            "remain readable.",
    ))
    d.define(ConfigKey(
        "encryption.enabled", "bool", default=False, importance="high",
        doc="Whether to encrypt chunks with per-segment AES-256-GCM data keys.",
    ))
    d.define(ConfigKey(
        "encryption.key.pair.id", "string", default=None, validator=non_empty_string,
        importance="high",
        doc="The active RSA key-encryption-key pair id.",
    ))
    d.define(ConfigKey(
        "encryption.key.pairs", "list", default=[], importance="high",
        doc="The list of RSA key pair ids in the keyring.",
    ))
    d.define(ConfigKey(
        "custom.metadata.fields.include", "list", default=[], importance="low",
        doc="Custom metadata fields to persist with the broker "
            "(REMOTE_SIZE, OBJECT_PREFIX, OBJECT_KEY).",
    ))
    d.define(ConfigKey(
        "fault.injection.enabled", "bool", default=False, importance="low",
        doc="Wrap the storage backend in a FaultInjectingBackend executing "
            "fault.schedule (chaos/soak runs only; never enable in "
            "production).",
    ))
    d.define(ConfigKey(
        "fault.schedule", "list", default=[], validator=_valid_fault_schedule,
        importance="low",
        doc="Deterministic fault rules 'op:action[=arg][@trigger]' with op in "
            "[upload, fetch, delete, list, *], action in [raise, key-not-found, "
            "delay, truncate, corrupt], trigger '@N' (Nth call), '@every=K', "
            "'@from=N' (every call from the Nth onward — a hard failure that "
            "starts mid-run and never recovers), "
            "or '@p=P' (seeded probability). delay accepts a jittered range "
            "'delay=lo..hi' (uniform seeded draw per firing, in ms) for "
            "realistic tail-latency distributions. E.g. 'upload:raise@3, "
            "fetch:corrupt=7@1, fetch:delay=10..250@p=0.2'.",
    ))
    d.define(ConfigKey(
        "fault.seed", "long", default=0, importance="low",
        doc="Seed for probabilistic fault triggers (deterministic for a "
            "given seed and call sequence).",
    ))
    d.define(ConfigKey(
        "upload.rate.limit.bytes.per.second", "int", default=None,
        validator=null_or(in_range(1024 * 1024, INT_MAX)),
        importance="medium",
        doc="Upper bound on segment upload bytes/s per manager instance.",
    ))
    d.define(ConfigKey(
        "retry.launch.attempts", "int", default=2,
        validator=in_range(1, None), importance="low",
        doc="Attempts per merged GCM launch of the window batcher (including "
            "the first) before it fails that class's waiters. A retry starts "
            "again from the packed input, which no launch writes; classes "
            "never share a launch, so a failure stays inside its class.",
    ))
    d.define(ConfigKey(
        "retry.launch.backoff.ms", "long", default=5,
        validator=in_range(0, None), importance="low",
        doc="Base backoff (ms) before a merged-launch re-dispatch; the "
            "actual sleep is decorrelated-jitter up to 4x this value.",
    ))
    d.define(ConfigKey(
        "faults.spec", "list", default=[], validator=_valid_fault_spec,
        importance="low",
        doc="Fault-plane rules 'site:kind[=arg][@trigger][~match]' "
            "(utils/faults.py) armed at RSM configure time — the same "
            "grammar as the TSTPU_FAULTS env var. site in [storage.read, "
            "storage.write, peer.forward, gossip.probe, device.launch, "
            "lifecycle.journal, lifecycle.sweep, *]; "
            "kind in [error, latency, partial, flaky]; trigger '@N', "
            "'@every=K', '@from=N', '@p=P'; '~match' restricts to keys "
            "containing the substring. Empty (the default) installs "
            "nothing: every seam's fire() stays a single attribute read.",
    ))
    d.define(ConfigKey(
        "faults.seed", "long", default=0, importance="low",
        doc="Seed for the fault plane's probabilistic triggers and latency "
            "ranges (deterministic for a given seed and call sequence).",
    ))
    d.define(ConfigKey(
        "replication.antientropy.enabled", "bool", default=False, importance="medium",
        doc="Run the background anti-entropy repairer when the storage "
            "backend is a ReplicatedStorageBackend: periodic passes diff "
            "the replicas by prefix, arbitrate divergent copies (manifest "
            "chunkChecksums for .log objects, majority/health otherwise), "
            "and copy missing/divergent objects back toward quorum.",
    ))
    d.define(ConfigKey(
        "replication.antientropy.interval.ms", "long", default=600_000,
        validator=in_range(1, None), importance="medium",
        doc="Period between anti-entropy passes.",
    ))
    d.define(ConfigKey(
        "replication.antientropy.rate.bytes", "int", default=8 * 1024 * 1024,
        validator=null_or(in_range(16 * 1024, INT_MAX)), importance="low",
        doc="Anti-entropy read/copy budget in bytes/s (token bucket) so "
            "replica diffing never starves foreground traffic; null "
            "disables throttling.",
    ))
    d.define(ConfigKey(
        "scrub.enabled", "bool", default=False, importance="medium",
        doc="Run the background integrity scrubber (scrub/): periodic "
            "passes enumerate stored objects, cross-check them against "
            "manifests, verify chunk CRC32C / GCM round-trips, and "
            "quarantine or repair what fails.",
    ))
    d.define(ConfigKey(
        "scrub.interval.ms", "long", default=300_000,
        validator=in_range(1, None), importance="medium",
        doc="Period between scrub passes; the first pass starts after a "
            "random jitter in [0, interval) so restarting fleets don't "
            "synchronize their scrub load.",
    ))
    d.define(ConfigKey(
        "scrub.rate.bytes", "int", default=8 * 1024 * 1024,
        validator=null_or(in_range(16 * 1024, INT_MAX)), importance="medium",
        doc="Scrub budget in bytes/s so scrubbing never starves foreground "
            "fetches; null disables throttling. Paces both halves of a "
            "pass: storage-IO walks through a host token bucket, and — "
            "when cross-request batching runs — device GCM verification "
            "through the window scheduler's background admission class.",
    ))
    d.define(ConfigKey(
        "scrub.repair.enabled", "bool", default=False, importance="medium",
        doc="Let the scrubber heal what it can: orphan objects are deleted, "
            "corrupt/missing objects are re-uploaded when a repair source "
            "is wired (Scrubber.repair_source).",
    ))
    d.define(ConfigKey(
        "scrub.checksums.enabled", "bool", default=False, importance="medium",
        doc="Record CRC32C of every transformed chunk in the manifest "
            "(chunkChecksums) at upload, giving scrub passes at-rest ground "
            "truth without detransforming. Adds one batched CRC pass per "
            "upload window (ops/crc32c), on the transform device.",
    ))
    d.define(ConfigKey(
        "lifecycle.enabled", "bool", default=False, importance="medium",
        doc="Arm the crash-consistent segment lifecycle plane: "
            "an upload intent journal (storage/lifecycle.py) records "
            "{segment, expected keys} before the first uploaded byte and "
            "marks commit when the manifest lands; delete tombstones make "
            "retried/crash-interrupted deletes converge; the recovery "
            "sweeper (scrub/sweeper.py) reconciles journal + store listing "
            "against manifest reachability on startup and on a paced "
            "period. Requires lifecycle.journal.path.",
    ))
    d.define(ConfigKey(
        "lifecycle.journal.path", "string", default=None,
        validator=non_empty_string, importance="medium",
        doc="Filesystem path of the upload intent journal (append-only "
            "JSONL WAL, fsynced per intent record, compacted in place). "
            "Must survive process restarts — put it next to the broker's "
            "log dirs, NOT on tmpfs. Required when lifecycle.enabled.",
    ))
    d.define(ConfigKey(
        "lifecycle.sweep.interval.ms", "long", default=300_000,
        validator=in_range(1, None), importance="medium",
        doc="Period between recovery sweeps; the first scheduled sweep "
            "starts after a random jitter in [0, interval) so restarting "
            "fleets don't synchronize their listing load.",
    ))
    d.define(ConfigKey(
        "lifecycle.sweep.on.start", "bool", default=True, importance="medium",
        doc="Run one synchronous recovery sweep during configure(), before "
            "serving — the crash-recovery path: anything the journal names "
            "as stranded by a previous process is deleted in this first "
            "sweep (zero permanent orphans after one sweep).",
    ))
    d.define(ConfigKey(
        "lifecycle.grace.ms", "long", default=14_400_000,
        validator=in_range(0, None), importance="medium",
        doc="Grace window for orphan candidates the journal does NOT name "
            "(another broker's in-flight upload on the fleet-shared "
            "prefix, a foreign journal's crash): deleted only after "
            "staying manifest-unreachable this long past the sweeper "
            "first seeing them. MUST comfortably exceed the slowest "
            "end-to-end segment upload (.log + .indexes + manifest) any "
            "fleet member can perform — the sweeper lists the shared "
            "prefix, so a peer's uncommitted objects are protected ONLY "
            "by this window, and a too-small value lets a sweep delete "
            "them mid-upload (cross-process data loss: the peer's "
            "manifest then lands referencing missing keys). The default "
            "is 4 hours; values under 10 minutes are warned about at "
            "startup. This process's own in-flight uploads are exempt "
            "via the journal's in-flight tracking, and journal-named "
            "orphans of finished operations need no grace — the journal "
            "proves no commit happened.",
    ))
    d.define(ConfigKey(
        "breaker.enabled", "bool", default=False, importance="medium",
        doc="Wrap the storage backend in a circuit breaker: after "
            "breaker.failure.threshold consecutive backend failures, calls "
            "fail fast until a half-open probe succeeds after "
            "breaker.cooldown.ms.",
    ))
    d.define(ConfigKey(
        "breaker.failure.threshold", "int", default=5,
        validator=in_range(1, None), importance="medium",
        doc="Consecutive storage failures that open the circuit breaker.",
    ))
    d.define(ConfigKey(
        "breaker.cooldown.ms", "long", default=30_000,
        validator=in_range(1, None), importance="medium",
        doc="How long the breaker stays open before allowing a half-open "
            "probe request through.",
    ))
    d.define(ConfigKey(
        "deadline.default.ms", "long", default=None,
        validator=null_or(in_range(1, None)), importance="medium",
        doc="Default end-to-end deadline installed at the RSM/gateway entry "
            "when the caller did not propagate one (x-deadline-ms header / "
            "gRPC metadata). Every layer clamps its waiting to the remaining "
            "budget and expired requests fail fast with "
            "DeadlineExceededException before touching the network; null "
            "means unconstrained.",
    ))
    d.define(ConfigKey(
        "hedge.enabled", "bool", default=False, importance="medium",
        doc="Hedge straggling chunk fetches: after hedge.delay (the observed "
            "chunk-fetch p95, or hedge.delay.ms until enough samples exist) "
            "issue a second identical ranged GET and take the first success; "
            "the loser is cancelled/discarded. Extra load is capped by "
            "hedge.budget.percent.",
    ))
    d.define(ConfigKey(
        "hedge.delay.ms", "long", default=50,
        validator=in_range(1, None), importance="medium",
        doc="Static hedge delay fallback (ms) used until the chunk-fetch "
            "latency histogram holds hedge.delay.min.samples observations, "
            "after which the observed p95 drives the delay.",
    ))
    d.define(ConfigKey(
        "hedge.delay.min.samples", "int", default=50,
        validator=in_range(1, None), importance="low",
        doc="Chunk-fetch histogram observations required before the hedge "
            "delay switches from the static hedge.delay.ms to the observed "
            "p95.",
    ))
    d.define(ConfigKey(
        "hedge.budget.percent", "int", default=10,
        validator=in_range(1, 100), importance="medium",
        doc="Hedge token bucket: earn percent/100 tokens per primary chunk "
            "fetch, spend one per hedge — hedged requests never exceed this "
            "percentage of primary traffic, so hedging self-limits under a "
            "systemic slowdown instead of doubling the load.",
    ))
    d.define(ConfigKey(
        "retry.budget.enabled", "bool", default=False, importance="medium",
        doc="Budget storage-layer retries with a per-backend token bucket "
            "(earn on success, spend on retry) so an outage cannot amplify "
            "into a retry storm; composes with the circuit breaker (each "
            "retry re-takes the breaker gate).",
    ))
    d.define(ConfigKey(
        "retry.budget.percent", "int", default=10,
        validator=in_range(1, 100), importance="medium",
        doc="Tokens earned per successful storage call, as a percentage: "
            "long-run retries are capped at percent/100 of successes (+ the "
            "fixed retry.budget.capacity allowance), bounding the "
            "cluster-wide retry amplification factor at 1 + percent/100.",
    ))
    d.define(ConfigKey(
        "retry.budget.capacity", "int", default=10,
        validator=in_range(1, None), importance="low",
        doc="Retry token bucket capacity (and initial balance): the fixed "
            "allowance that lets cold starts and short blips retry before "
            "any successes have been banked.",
    ))
    d.define(ConfigKey(
        "retry.budget.max.attempts", "int", default=3,
        validator=in_range(1, None), importance="low",
        doc="Per-call attempt ceiling for budgeted storage retries "
            "(including the first attempt).",
    ))
    d.define(ConfigKey(
        "retry.budget.backoff.ms", "long", default=10,
        validator=in_range(1, None), importance="low",
        doc="Base backoff (ms) between budgeted storage retries; the actual "
            "sleep is full-jitter exponential and always fits the remaining "
            "end-to-end deadline, or the retry is abandoned.",
    ))
    d.define(ConfigKey(
        "breaker.peer.failure.threshold", "int", default=1,
        validator=in_range(1, None), importance="low",
        doc="Consecutive failed forwards that open a peer's circuit breaker "
            "(per-owner, fleet/peer_cache.py). The default 1 keeps the "
            "historical mark-down-on-first-failure behavior; the breaker "
            "re-admits a single half-open probe forward after "
            "fleet.peer.down.cooldown.ms.",
    ))
    d.define(ConfigKey(
        "breaker.gossip.failure.threshold", "int", default=2,
        validator=in_range(1, None), importance="low",
        doc="Consecutive failed probe ROUNDS (retries included) that open a "
            "gossip member's breaker. Refusing members are deprioritized in "
            "probe-target selection — never silenced: if every candidate is "
            "refusing the agent falls back to plain round-robin so the "
            "failure detector keeps running.",
    ))
    d.define(ConfigKey(
        "retry.gossip.probe.attempts", "int", default=2,
        validator=in_range(1, None), importance="low",
        doc="Attempts per gossip probe round trip (including the first). "
            "Backoff between attempts uses decorrelated jitter seeded per "
            "instance id, so a partitioned fleet does not retry its probes "
            "in lockstep.",
    ))
    d.define(ConfigKey(
        "admission.enabled", "bool", default=False, importance="medium",
        doc="Gate the sidecar boundaries (HTTP gateway + gRPC service) with "
            "an admission controller: at most admission.max.concurrent "
            "requests execute, admission.max.queue more wait, and the rest "
            "are shed at entry with 429 + Retry-After / RESOURCE_EXHAUSTED "
            "before the request body is read.",
    ))
    d.define(ConfigKey(
        "admission.max.concurrent", "int", default=64,
        validator=in_range(1, None), importance="medium",
        doc="Concurrent requests executing past the admission gate.",
    ))
    d.define(ConfigKey(
        "admission.max.queue", "int", default=128,
        validator=in_range(0, None), importance="medium",
        doc="Bounded admission queue depth; a request arriving with the "
            "queue full is shed immediately (0 disables queuing entirely).",
    ))
    d.define(ConfigKey(
        "admission.queue.timeout.ms", "long", default=1_000,
        validator=in_range(1, None), importance="low",
        doc="Longest a request waits in the admission queue before being "
            "shed (queuing longer than the caller's patience just wastes "
            "both ends' resources).",
    ))
    d.define(ConfigKey(
        "admission.retry.after.ms", "long", default=1_000,
        validator=in_range(1, None), importance="low",
        doc="Backoff hint returned with shed requests (HTTP Retry-After "
            "header, gRPC retry-after trailer), rounded up to whole "
            "seconds on the HTTP side.",
    ))
    d.define(ConfigKey(
        "sidecar.grpc.max.workers", "int", default=8,
        validator=in_range(1, None), importance="low",
        doc="Thread pool size of the gRPC sidecar server (was hardcoded at "
            "8). Size to the expected broker fetch parallelism; admission "
            "control sheds what the pool cannot absorb.",
    ))
    d.define(ConfigKey(
        "sidecar.http.max.workers", "int", default=32,
        validator=in_range(1, None), importance="low",
        doc="Bounded worker pool of the HTTP shim-wire gateway. Connections "
            "are accepted eagerly but handled by at most this many threads; "
            "excess connections queue in the executor instead of spawning "
            "an unbounded thread per connection. Size to the expected "
            "broker fetch parallelism plus fleet peer traffic; admission "
            "control sheds what the pool cannot absorb.",
    ))
    d.define(ConfigKey(
        "fleet.enabled", "bool", default=False, importance="medium",
        doc="Run this sidecar as a member of a gateway fleet: segment object "
            "keys route to owner instances on a consistent-hash ring "
            "(fleet/ring.py), non-owner chunk misses are resolved with one "
            "hop to the owner's chunk cache over the shim-wire GET /chunk "
            "route before falling back to remote storage, and concurrent "
            "duplicate fetches coalesce to one backend read. Requires "
            "fleet.instance.id.",
    ))
    d.define(ConfigKey(
        "fleet.instance.id", "string", default=None,
        validator=non_empty_string, importance="medium",
        doc="This instance's name on the fleet ring (must be unique across "
            "the fleet and stable across restarts — the ring is derived "
            "from names, so renaming an instance moves its keys).",
    ))
    d.define(ConfigKey(
        "fleet.instances", "list", default=[],
        validator=_valid_fleet_instances, importance="medium",
        doc="Static fleet membership: entries 'name=http://host:port' (a "
            "routable peer gateway) or bare 'name' (address unknown — "
            "typically this instance itself). Every member must configure "
            "the same list so all rings agree. Empty means a solo ring "
            "until FleetRouter.set_membership / --fleet-peers supplies "
            "addresses (ports are often only known after gateways bind).",
    ))
    d.define(ConfigKey(
        "fleet.vnodes", "int", default=64,
        validator=in_range(1, 4096), importance="low",
        doc="Virtual nodes per instance on the consistent-hash ring; more "
            "vnodes smooth per-instance ownership toward 1/N at the cost "
            "of a larger (static) ring table.",
    ))
    d.define(ConfigKey(
        "fleet.forward.timeout.ms", "long", default=2_000,
        validator=in_range(1, None), importance="low",
        doc="Socket timeout for one peer GET /chunk forward; the ambient "
            "end-to-end deadline clamps it further. A forward that times "
            "out marks the peer down and the read falls back to remote "
            "storage.",
    ))
    d.define(ConfigKey(
        "fleet.peer.down.cooldown.ms", "long", default=5_000,
        validator=in_range(1, None), importance="low",
        doc="How long a peer stays marked down after a failed forward "
            "(reads route straight to remote storage meanwhile); the next "
            "forward after the cooldown is the health probe.",
    ))
    d.define(ConfigKey(
        "fleet.replication.factor", "int", default=2,
        validator=in_range(1, 16), importance="medium",
        doc="Replica owners per segment key: the R distinct ring successors "
            "of the key's hash. Non-owner misses try the owners in ring "
            "order (first-owner preference keeps the hot arc concentrated; "
            "a dead first owner fails over to the next with one forward "
            "hop), so a hard-killed instance loses no cache tier. 1 "
            "restores single-owner routing.",
    ))
    d.define(ConfigKey(
        "fleet.gossip.enabled", "bool", default=False, importance="medium",
        doc="Run the SWIM-style gossip membership daemon (fleet/gossip.py): "
            "periodic probes over the shim-wire gateway (POST /fleet/gossip) "
            "carry membership deltas, unreachable members degrade "
            "alive -> suspect -> dead, and each agreed view is applied to "
            "the ring as an epoch-numbered membership. fleet.instances "
            "becomes the SEED set only. Requires fleet.enabled and the "
            "HTTP gateway.",
    ))
    d.define(ConfigKey(
        "fleet.gossip.interval.ms", "long", default=1_000,
        validator=in_range(10, None), importance="low",
        doc="Gossip protocol period: one probe/exchange per period, and the "
            "unit the suspect/dead thresholds are counted in.",
    ))
    d.define(ConfigKey(
        "fleet.gossip.probe.timeout.ms", "long", default=750,
        validator=in_range(1, None), importance="low",
        doc="Socket timeout for one gossip probe round trip; keep it below "
            "fleet.gossip.interval.ms so a wedged peer cannot stall the "
            "protocol period.",
    ))
    d.define(ConfigKey(
        "fleet.gossip.suspect.periods", "int", default=3,
        validator=in_range(1, None), importance="low",
        doc="Protocol periods without hearing from a member before it is "
            "marked SUSPECT (still in the ring — suspicion is refutable by "
            "an incarnation bump, so a slow member does not thrash keys).",
    ))
    d.define(ConfigKey(
        "fleet.gossip.dead.periods", "int", default=3,
        validator=in_range(1, None), importance="low",
        doc="Protocol periods a member stays SUSPECT without refutation "
            "before it is declared DEAD and removed from the ring (bounded "
            "key movement: only the dead member's arcs move).",
    ))
    d.define(ConfigKey(
        "slo.enabled", "bool", default=False, importance="medium",
        doc="Run the SLO engine (metrics/slo.py): declarative objectives "
            "over the existing latency histograms and counters (fetch "
            "latency vs the deadline budget, fetch error rate, admission "
            "shed rate, chunk-cache hit floor) with SRE-workbook two-window "
            "burn-rate computation, error-budget gauges in the slo-metrics "
            "group, and verdicts on the gateway's GET /slo route.",
    ))
    d.define(ConfigKey(
        "slo.window.short.ms", "long", default=60_000,
        validator=in_range(1, None), importance="low",
        doc="Short burn-rate window: the fast-to-clear half of the "
            "multiwindow alert (an incident that stops burning stops "
            "alerting within this window).",
    ))
    d.define(ConfigKey(
        "slo.window.long.ms", "long", default=600_000,
        validator=in_range(1, None), importance="low",
        doc="Long burn-rate window: the significance half of the "
            "multiwindow alert. Must be greater than slo.window.short.ms.",
    ))
    d.define(ConfigKey(
        "slo.fetch.latency.threshold.ms", "long", default=None,
        validator=null_or(in_range(1, None)), importance="medium",
        doc="Latency an individual chunk fetch must beat to count as a "
            "good event for the fetch-latency SLO. Null derives it from "
            "deadline.default.ms (the budget the caller actually "
            "experiences); if both are null the fetch-latency spec is "
            "skipped.",
    ))
    d.define(ConfigKey(
        "slo.fetch.latency.objective.percent", "int", default=99,
        validator=in_range(1, 99), importance="medium",
        doc="Fraction of chunk fetches (percent) that must beat the "
            "latency threshold: 99 gates the p99 against the budget. "
            "Capped at 99 because a 100% objective leaves a zero error "
            "budget no finite burn rate can be computed against.",
    ))
    d.define(ConfigKey(
        "slo.error.rate.objective.percent", "int", default=99,
        validator=in_range(1, 99), importance="medium",
        doc="Fraction of chunk fetches (percent) that must complete "
            "without a request-visible failure (detransform corruption or "
            "deadline expiry).",
    ))
    d.define(ConfigKey(
        "slo.shed.rate.max.percent", "int", default=5,
        validator=in_range(1, 99), importance="low",
        doc="Admission sheds tolerated as a percentage of gated requests "
            "(the shed-rate SLO objective is 100 minus this). Only wired "
            "when admission.enabled is.",
    ))
    d.define(ConfigKey(
        "slo.cache.hit.floor.percent", "int", default=0,
        validator=in_range(0, 99), importance="low",
        doc="Minimum chunk-cache hit rate (percent) the cache-tier SLO "
            "enforces; 0 disables the spec (cold stores legitimately run "
            "at 0% for a while).",
    ))
    d.define(ConfigKey(
        "tracing.enabled", "bool", default=False, importance="low",
        doc="Record spans around RSM operations and the fetch, storage, "
            "scrub and lifecycle stages below them (utils/tracing.py); "
            "summaries are exposed via RemoteStorageManager.tracer.",
    ))
    d.define(ConfigKey(
        "tracing.jax.profiler.enabled", "bool", default=False, importance="low",
        doc="Forward tracing spans into torch.profiler record_function "
            "ranges so they appear next to the CUDA kernels in a "
            "torch.profiler (Kineto) trace. Kineto keeps such a range only "
            "on the profiler session's own thread; spans recorded on other "
            "threads (the broker's copier and reader pools) reach a profile "
            "through utils.tracing.merge_profiler_trace instead. The key "
            "keeps the JAX package's name (requires tracing.enabled).",
    ))
    d.define(ConfigKey(
        "tracing.max.spans", "int", default=10_000,
        validator=in_range(1, None), importance="low",
        doc="Capacity of the tracer's span ring buffer; once full the oldest "
            "spans are evicted (counted by the tracer-dropped-spans metric) "
            "so long soak runs keep the newest spans.",
    ))
    d.define(ConfigKey(
        "tracing.export.path", "string", default=None,
        validator=non_empty_string, importance="low",
        doc="Write the recorded spans as Chrome trace-event JSON to this "
            "path on close() (loadable in Perfetto / chrome://tracing).",
    ))
    d.define(ConfigKey(
        "flight.enabled", "bool", default=False, importance="medium",
        doc="Arm the per-request flight recorder (utils/flightrecorder.py): "
            "every RSM operation records its cache-tier outcomes (chunk "
            "cache / device hot tier / backend), replica-failover activity, "
            "GCM window accounting and the deadline budget remaining at "
            "each stage; the slowest and failed requests are retained in a "
            "bounded ring (RemoteStorageManager.flight_status), and latency "
            "histograms attach the records' trace ids as bucket exemplars. "
            "Disabled is zero-work.",
    ))
    d.define(ConfigKey(
        "flight.ring.size", "int", default=64,
        validator=in_range(1, 4096), importance="low",
        doc="Requests retained by the flight recorder: the N slowest "
            "completed requests (a fast request never evicts a slow one) "
            "plus the N most recent failed ones.",
    ))
    d.define(ConfigKey(
        "timeline.enabled", "bool", default=False, importance="medium",
        doc="Arm the device-scheduler timeline ring (metrics/timeline.py): "
            "every merged GCM launch records its scheduler context (work "
            "class, bucket shape, rows/bytes, waiter count, queued age, "
            "launch begin/end, occupancy, per-class queue depths, and the "
            "waiting requests' flight-recorder trace ids), served by "
            "RemoteStorageManager.timeline_status and exportable as "
            "Chrome-trace/Perfetto JSON with flow edges joining flight "
            "records to the launches that served them (the gcm.batch:<id> "
            "stage markers). Disabled is zero-work.",
    ))
    d.define(ConfigKey(
        "timeline.ring.size", "int", default=512,
        validator=in_range(1, 65536), importance="low",
        doc="Scheduler events retained by the timeline ring, strict FIFO "
            "with explicit eviction accounting (recency matters here, not "
            "extremes — the flight recorder keeps the slowest, the "
            "timeline keeps the latest).",
    ))
    d.define(ConfigKey(
        "metrics.num.samples", "int", default=2, validator=in_range(1, None), importance="low",
        doc="Number of samples for metrics computation.",
    ))
    d.define(ConfigKey(
        "metrics.sample.window.ms", "long", default=30_000, validator=in_range(1, None),
        importance="low", doc="Metrics sample window.",
    ))
    d.define(ConfigKey(
        "metrics.recording.level", "string", default="INFO",
        validator=_valid_recording_level,
        importance="low", doc="Metrics recording level (INFO, DEBUG).",
    ))
    return d


def _check_ported(props: Mapping[str, Any]) -> None:
    for name in props:
        if name in NOT_YET_PORTED:
            raise ConfigException(
                f"Configuration {name} is not yet ported to tieredstorage_tpu_torch"
            )


class RemoteStorageManagerConfig:
    def __init__(self, props: Mapping[str, Any]):
        _check_ported(props)
        self._props = dict(props)
        self._values = _base_def().parse(props)
        self._validate_cross_keys()
        self._key_pair_paths = self._parse_key_pairs()

    def _validate_cross_keys(self) -> None:
        if self.compression_heuristic_enabled and not self.compression_enabled:
            raise ConfigException(
                "compression.enabled must be enabled if compression.heuristic.enabled is"
            )
        if self._values["fleet.enabled"] and not self._values["fleet.instance.id"]:
            raise ConfigException(
                "fleet.instance.id must be provided if fleet.enabled is"
            )
        if self._values["fleet.gossip.enabled"] and not self._values["fleet.enabled"]:
            raise ConfigException(
                "fleet.enabled must be enabled if fleet.gossip.enabled is"
            )
        if self._values["slo.window.short.ms"] >= self._values["slo.window.long.ms"]:
            raise ConfigException(
                "slo.window.short.ms must be less than slo.window.long.ms "
                "(the multiwindow burn-rate alert needs distinct windows)"
            )
        if self.encryption_enabled:
            if not self._values["encryption.key.pair.id"]:
                raise ConfigException(
                    "encryption.key.pair.id must be provided if encryption is enabled"
                )
            if not self._values["encryption.key.pairs"]:
                raise ConfigException(
                    "encryption.key.pairs must be provided if encryption is enabled"
                )

    def _parse_key_pairs(self) -> dict[str, tuple[str, str]]:
        """Two-phase dynamic define: each id in `encryption.key.pairs`
        requires `encryption.key.pairs.<id>.public.key.file` and
        `...private.key.file`."""
        if not self.encryption_enabled:
            return {}
        paths: dict[str, tuple[str, str]] = {}
        for key_id in self._values["encryption.key.pairs"]:
            pub = self._props.get(f"encryption.key.pairs.{key_id}.public.key.file")
            priv = self._props.get(f"encryption.key.pairs.{key_id}.private.key.file")
            if not pub or not priv:
                raise ConfigException(
                    f"Both public and private key files must be provided for key pair {key_id!r}"
                )
            paths[key_id] = (str(pub), str(priv))
        active = self._values["encryption.key.pair.id"]
        if active not in paths:
            raise ConfigException(
                f"Encryption key {active!r} must be provided in encryption.key.pairs"
            )
        return paths

    # --- accessors ---
    def raw_props(self) -> dict[str, Any]:
        return dict(self._props)

    @property
    def storage_backend_class(self) -> type:
        return self._values["storage.backend.class"]

    def storage_configs(self) -> dict[str, Any]:
        return subset_with_prefix(self._props, STORAGE_PREFIX)

    @property
    def transform_backend_class(self) -> type:
        return self._values["transform.backend.class"]

    def transform_configs(self) -> dict[str, Any]:
        """The `transform.`-prefixed subtree handed to the backend's
        `configure()` (prefix stripped; transform/cuda.py `_definition`)."""
        return {
            k: v for k, v in subset_with_prefix(self._props, TRANSFORM_PREFIX).items()
            if k != "backend.class"
        }

    @property
    def key_prefix(self) -> str:
        return self._values["key.prefix"]

    @property
    def key_prefix_mask(self) -> bool:
        return self._values["key.prefix.mask"]

    @property
    def chunk_size(self) -> int:
        return self._values["chunk.size"]

    @property
    def compression_enabled(self) -> bool:
        return self._values["compression.enabled"]

    @property
    def compression_heuristic_enabled(self) -> bool:
        return self._values["compression.heuristic.enabled"]

    @property
    def compression_codec(self) -> str:
        return self._values["compression.codec"]

    @property
    def encryption_enabled(self) -> bool:
        return self._values["encryption.enabled"]

    @property
    def encryption_key_pair_id(self) -> Optional[str]:
        return self._values["encryption.key.pair.id"]

    @property
    def encryption_key_pair_paths(self) -> dict[str, tuple[str, str]]:
        return dict(self._key_pair_paths)

    @property
    def custom_metadata_fields_include(self) -> list[str]:
        return list(self._values["custom.metadata.fields.include"])

    @property
    def upload_rate_limit(self) -> Optional[int]:
        return self._values["upload.rate.limit.bytes.per.second"]

    @property
    def retry_launch_attempts(self) -> int:
        return self._values["retry.launch.attempts"]

    @property
    def retry_launch_backoff_ms(self) -> int:
        return self._values["retry.launch.backoff.ms"]

    @property
    def scrub_enabled(self) -> bool:
        return self._values["scrub.enabled"]

    @property
    def scrub_interval_ms(self) -> int:
        return self._values["scrub.interval.ms"]

    @property
    def scrub_rate_bytes(self) -> Optional[int]:
        return self._values["scrub.rate.bytes"]

    @property
    def scrub_repair_enabled(self) -> bool:
        return self._values["scrub.repair.enabled"]

    @property
    def scrub_checksums_enabled(self) -> bool:
        return self._values["scrub.checksums.enabled"]

    @property
    def fault_injection_enabled(self) -> bool:
        return self._values["fault.injection.enabled"]

    @property
    def fault_schedule(self) -> list[str]:
        return self._values["fault.schedule"]

    @property
    def fault_seed(self) -> int:
        return self._values["fault.seed"]

    @property
    def faults_spec(self) -> list[str]:
        return self._values["faults.spec"]

    @property
    def faults_seed(self) -> int:
        return self._values["faults.seed"]

    @property
    def replication_antientropy_enabled(self) -> bool:
        return self._values["replication.antientropy.enabled"]

    @property
    def replication_antientropy_interval_ms(self) -> int:
        return self._values["replication.antientropy.interval.ms"]

    @property
    def replication_antientropy_rate_bytes(self) -> Optional[int]:
        return self._values["replication.antientropy.rate.bytes"]

    @property
    def lifecycle_enabled(self) -> bool:
        return self._values["lifecycle.enabled"]

    @property
    def lifecycle_journal_path(self) -> Optional[str]:
        return self._values["lifecycle.journal.path"]

    @property
    def lifecycle_sweep_interval_ms(self) -> int:
        return self._values["lifecycle.sweep.interval.ms"]

    @property
    def lifecycle_sweep_on_start(self) -> bool:
        return self._values["lifecycle.sweep.on.start"]

    @property
    def lifecycle_grace_ms(self) -> int:
        return self._values["lifecycle.grace.ms"]

    @property
    def breaker_enabled(self) -> bool:
        return self._values["breaker.enabled"]

    @property
    def breaker_failure_threshold(self) -> int:
        return self._values["breaker.failure.threshold"]

    @property
    def breaker_cooldown_ms(self) -> int:
        return self._values["breaker.cooldown.ms"]

    @property
    def deadline_default_ms(self) -> Optional[int]:
        return self._values["deadline.default.ms"]

    @property
    def hedge_enabled(self) -> bool:
        return self._values["hedge.enabled"]

    @property
    def hedge_delay_ms(self) -> int:
        return self._values["hedge.delay.ms"]

    @property
    def hedge_delay_min_samples(self) -> int:
        return self._values["hedge.delay.min.samples"]

    @property
    def hedge_budget_percent(self) -> int:
        return self._values["hedge.budget.percent"]

    @property
    def retry_budget_enabled(self) -> bool:
        return self._values["retry.budget.enabled"]

    @property
    def retry_budget_percent(self) -> int:
        return self._values["retry.budget.percent"]

    @property
    def retry_budget_capacity(self) -> int:
        return self._values["retry.budget.capacity"]

    @property
    def retry_budget_max_attempts(self) -> int:
        return self._values["retry.budget.max.attempts"]

    @property
    def retry_budget_backoff_ms(self) -> int:
        return self._values["retry.budget.backoff.ms"]

    @property
    def breaker_peer_failure_threshold(self) -> int:
        return self._values["breaker.peer.failure.threshold"]

    @property
    def breaker_gossip_failure_threshold(self) -> int:
        return self._values["breaker.gossip.failure.threshold"]

    @property
    def retry_gossip_probe_attempts(self) -> int:
        return self._values["retry.gossip.probe.attempts"]

    @property
    def admission_enabled(self) -> bool:
        return self._values["admission.enabled"]

    @property
    def admission_max_concurrent(self) -> int:
        return self._values["admission.max.concurrent"]

    @property
    def admission_max_queue(self) -> int:
        return self._values["admission.max.queue"]

    @property
    def admission_queue_timeout_ms(self) -> int:
        return self._values["admission.queue.timeout.ms"]

    @property
    def admission_retry_after_ms(self) -> int:
        return self._values["admission.retry.after.ms"]

    @property
    def sidecar_grpc_max_workers(self) -> int:
        return self._values["sidecar.grpc.max.workers"]

    @property
    def sidecar_http_max_workers(self) -> int:
        return self._values["sidecar.http.max.workers"]

    @property
    def fleet_enabled(self) -> bool:
        return self._values["fleet.enabled"]

    @property
    def fleet_instance_id(self) -> Optional[str]:
        return self._values["fleet.instance.id"]

    @property
    def fleet_instances(self) -> list[str]:
        return self._values["fleet.instances"]

    @property
    def fleet_vnodes(self) -> int:
        return self._values["fleet.vnodes"]

    @property
    def fleet_forward_timeout_ms(self) -> int:
        return self._values["fleet.forward.timeout.ms"]

    @property
    def fleet_peer_down_cooldown_ms(self) -> int:
        return self._values["fleet.peer.down.cooldown.ms"]

    @property
    def fleet_replication_factor(self) -> int:
        return self._values["fleet.replication.factor"]

    @property
    def fleet_gossip_enabled(self) -> bool:
        return self._values["fleet.gossip.enabled"]

    @property
    def fleet_gossip_interval_ms(self) -> int:
        return self._values["fleet.gossip.interval.ms"]

    @property
    def fleet_gossip_probe_timeout_ms(self) -> int:
        return self._values["fleet.gossip.probe.timeout.ms"]

    @property
    def fleet_gossip_suspect_periods(self) -> int:
        return self._values["fleet.gossip.suspect.periods"]

    @property
    def fleet_gossip_dead_periods(self) -> int:
        return self._values["fleet.gossip.dead.periods"]

    @property
    def slo_enabled(self) -> bool:
        return self._values["slo.enabled"]

    @property
    def slo_window_short_ms(self) -> int:
        return self._values["slo.window.short.ms"]

    @property
    def slo_window_long_ms(self) -> int:
        return self._values["slo.window.long.ms"]

    @property
    def slo_fetch_latency_threshold_ms(self) -> Optional[int]:
        return self._values["slo.fetch.latency.threshold.ms"]

    @property
    def slo_fetch_latency_objective_percent(self) -> int:
        return self._values["slo.fetch.latency.objective.percent"]

    @property
    def slo_error_rate_objective_percent(self) -> int:
        return self._values["slo.error.rate.objective.percent"]

    @property
    def slo_shed_rate_max_percent(self) -> int:
        return self._values["slo.shed.rate.max.percent"]

    @property
    def slo_cache_hit_floor_percent(self) -> int:
        return self._values["slo.cache.hit.floor.percent"]

    @property
    def tracing_enabled(self) -> bool:
        return self._values["tracing.enabled"]

    @property
    def tracing_jax_profiler_enabled(self) -> bool:
        return self._values["tracing.jax.profiler.enabled"]

    @property
    def tracing_max_spans(self) -> int:
        return self._values["tracing.max.spans"]

    @property
    def tracing_export_path(self) -> Optional[str]:
        return self._values["tracing.export.path"]

    @property
    def flight_enabled(self) -> bool:
        return self._values["flight.enabled"]

    @property
    def flight_ring_size(self) -> int:
        return self._values["flight.ring.size"]

    @property
    def timeline_enabled(self) -> bool:
        return self._values["timeline.enabled"]

    @property
    def timeline_ring_size(self) -> int:
        return self._values["timeline.ring.size"]

    @property
    def metrics_num_samples(self) -> int:
        return self._values["metrics.num.samples"]

    @property
    def metrics_sample_window_ms(self) -> int:
        return self._values["metrics.sample.window.ms"]

    @property
    def metrics_recording_level(self) -> str:
        return str(self._values["metrics.recording.level"]).upper()

    def fetch_indexes_cache_configs(self) -> dict[str, Any]:
        return subset_with_prefix(self._props, FETCH_INDEXES_CACHE_PREFIX)

    def fetch_manifest_cache_configs(self) -> dict[str, Any]:
        return subset_with_prefix(self._props, FETCH_MANIFEST_CACHE_PREFIX)
