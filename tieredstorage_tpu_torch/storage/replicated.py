"""Replicated multi-backend storage: quorum writes, health-probed failover.

Counterpart of tieredstorage_tpu/storage/replicated.py; the
RSM hands it its tracer and the failover-time hook (`on_failover`), and
publishes its counters as the replication-metrics gauges. A replica whose
backend chain holds an OPEN circuit breaker (a child wrapped in
storage/resilient.py's `ResilientStorageBackend`) scores 0 and is read
last, as in the JAX package; without a breaker the score is latency and
error rate alone.

`ReplicatedStorageBackend` composes N child backends (any mix of
memory/filesystem/S3/GCS/Azure) behind the ordinary `StorageBackend`
contract, Dynamo-style (DeCandia et al., SOSP 2007; KIP-405 deployments
replicating across object stores):

- **Writes fan out concurrently** to every replica and succeed at a
  configurable write quorum (`replication.write.quorum`, default all).
  A sub-quorum write **rolls back** the replicas that did succeed before
  raising, so the RSM's upload orphan-cleanup invariant (zero partial
  objects after a failed copy) holds per replica, not just per store.
- **Reads go to the healthiest replica first** — health is an EWMA of
  observed latency and error rate, fed by live traffic and by a cheap
  background prober (`replication.probe.interval.ms`, a one-key
  `list_objects` head call), and consults the replica's circuit breaker
  (an OPEN breaker floors the score) — and **fail over** to the next
  replica on exception, within whatever remains of the caller's
  end-to-end deadline. A contract answer (key-not-found / invalid-range)
  from a healthy replica does not win over another replica that can
  actually serve the bytes: divergent replicas are consulted before the
  contract answer is surfaced.
- **Replica-aware hedging**: `read_fetchers()` exposes the health-ordered
  children so `fetch/hedge.py` can race a straggling primary against a
  *distinct* replica instead of doubling load on the same one.

Anti-entropy repair (scrub/antientropy.py: diffing replicas by prefix and
copying missing/divergent objects back toward quorum) reuses this backend's
replica states.

Configured reflectively as ``storage.backend.class`` with::

    storage.replication.replicas=a,b
    storage.replication.replica.a.backend.class=...FileSystemStorage
    storage.replication.replica.a.root=/mnt/a
    storage.replication.replica.b.backend.class=...S3Storage
    storage.replication.replica.b.s3.bucket.name=...
    storage.replication.write.quorum=2
    storage.replication.probe.interval.ms=30000

or composed programmatically: ``ReplicatedStorageBackend([b1, b2], ...)``.
"""

from __future__ import annotations

import io
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import BinaryIO, Callable, Mapping, Optional, Sequence, Union

from tieredstorage_tpu_torch.config.configdef import (
    ConfigDef,
    ConfigKey,
    in_range,
    null_or,
    subset_with_prefix,
)
from tieredstorage_tpu_torch.storage.core import (
    BytesRange,
    InvalidRangeException,
    KeyNotFoundException,
    ObjectKey,
    StorageBackend,
    StorageBackendException,
    load_backend_class,
)
from tieredstorage_tpu_torch.utils.deadline import (
    DeadlineExceededException,
    current_deadline,
    deadline_scope,
    remaining_s,
)
from tieredstorage_tpu_torch.utils.locks import new_lock
from tieredstorage_tpu_torch.utils.tracing import NOOP_TRACER

log = logging.getLogger(__name__)

REPLICATION_PREFIX = "replication."


class QuorumWriteException(StorageBackendException):
    """A fan-out write reached fewer replicas than the write quorum; the
    successful copies were rolled back before this was raised."""


class AllReplicasFailedException(StorageBackendException):
    """Every replica failed the call with a backend error (no replica gave
    even a contract answer)."""


def _definition() -> ConfigDef:
    d = ConfigDef()
    d.define(ConfigKey(
        "replication.replicas", "list", default=[], importance="high",
        doc="Replica names. Each name <n> requires "
            "replication.replica.<n>.backend.class plus that backend's own "
            "keys under the replication.replica.<n>. prefix (passed through "
            "with the prefix stripped). Any mix of backends works, and each "
            "child may itself be a FaultInjectingBackend or sit behind its "
            "own resilience wrapper.",
    ))
    d.define(ConfigKey(
        "replication.write.quorum", "int", default=None,
        validator=null_or(in_range(1, None)), importance="high",
        doc="Replicas a write must reach to succeed (null = all). A "
            "sub-quorum write deletes the copies that did land and raises, "
            "so a failed upload leaves zero orphans on the surviving "
            "replicas.",
    ))
    d.define(ConfigKey(
        "replication.probe.interval.ms", "long", default=30_000,
        validator=null_or(in_range(1, None)), importance="medium",
        doc="Period of the background health prober: one cheap "
            "list_objects head call per replica feeds the latency/error "
            "EWMA that orders reads. Null disables probing (health is then "
            "driven by live traffic only).",
    ))
    return d


class ReplicaState:
    """Health bookkeeping for one child backend.

    The score combines an error-rate EWMA and a latency EWMA (both fed by
    live calls and by the prober) and consults the replica's circuit
    breaker when one is wired anywhere in its delegate chain: an OPEN
    breaker floors the score, so reads route around a tripped replica
    without waiting for its error EWMA to catch up."""

    #: EWMA smoothing factor (weight of the newest observation).
    ALPHA = 0.3
    #: Latency that halves the health score (ms).
    LATENCY_SCALE_MS = 50.0

    def __init__(self, name: str, backend: StorageBackend) -> None:
        self.name = name
        self.backend = backend
        self._lock = new_lock("replicated.ReplicaState._lock")
        self._latency_ms: Optional[float] = None
        self._error_rate = 0.0
        #: Cumulative counters.
        self.errors = 0
        self.probes = 0
        self.probe_failures = 0

    def record(self, ok: bool, latency_ms: Optional[float] = None) -> None:
        with self._lock:
            a = self.ALPHA
            self._error_rate = (1 - a) * self._error_rate + a * (0.0 if ok else 1.0)
            if not ok:
                self.errors += 1
            if latency_ms is not None:
                self._latency_ms = (
                    latency_ms if self._latency_ms is None
                    else (1 - a) * self._latency_ms + a * latency_ms
                )

    def _breaker_open(self) -> bool:
        b = self.backend
        while b is not None:
            breaker = getattr(b, "breaker", None)
            state_code = getattr(breaker, "state_code", None)
            if state_code is not None and state_code == 2:  # BreakerState.OPEN
                return True
            b = getattr(b, "delegate", None)
        return False

    def health_score(self) -> float:
        """(0, 1]: 1 = fast and error-free; an OPEN breaker floors it."""
        if self._breaker_open():
            return 0.0
        with self._lock:
            latency = self._latency_ms or 0.0
            availability = 1.0 - self._error_rate
        return max(0.001, availability / (1.0 + latency / self.LATENCY_SCALE_MS))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ReplicaState({self.name}, health={self.health_score():.3f})"


class HealthProber:
    """Daemon thread issuing one cheap head probe per replica per period.

    The probe is `list_objects(prefix)` truncated after the first key —
    every backend serves it from a single page (or a single directory
    walk step), so it measures reachability + first-byte latency without
    moving object bytes."""

    def __init__(
        self,
        replicas: Sequence[ReplicaState],
        interval_s: float,
        *,
        prefix: str = "",
        tracer=NOOP_TRACER,
    ) -> None:
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self._replicas = list(replicas)
        self.interval_s = interval_s
        self.prefix = prefix
        self.tracer = tracer
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HealthProber":
        if self._thread is not None:
            raise RuntimeError("HealthProber already started")
        self._thread = threading.Thread(
            target=self._run, name="replica-prober", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def probe_once(self) -> None:
        """One probe round; public so tests and tools can drive it inline."""
        for rep in self._replicas:
            start = time.monotonic()
            try:
                next(iter(rep.backend.list_objects(self.prefix)), None)
            except Exception as e:  # noqa: BLE001 — any failure marks the replica
                rep.probes += 1
                rep.probe_failures += 1
                rep.record(ok=False, latency_ms=(time.monotonic() - start) * 1000.0)
                self.tracer.event(
                    "replication.probe_failed", replica=rep.name,
                    error=type(e).__name__,
                )
            else:
                rep.probes += 1
                rep.record(ok=True, latency_ms=(time.monotonic() - start) * 1000.0)

    def _run(self) -> None:
        while not self._stop.wait(timeout=self.interval_s):
            self.probe_once()


class ReplicatedStorageBackend(StorageBackend):
    """N child backends behind one StorageBackend contract.

    See the module docstring for semantics. Thread-safe: fan-out uploads
    run on a private pool, health state is lock-protected per replica."""

    def __init__(
        self,
        replicas: Optional[Sequence[Union[StorageBackend, tuple[str, StorageBackend]]]] = None,
        *,
        write_quorum: Optional[int] = None,
        probe_interval_s: Optional[float] = None,
        probe_prefix: str = "",
        tracer=NOOP_TRACER,
    ) -> None:
        self._replicas: list[ReplicaState] = []
        if replicas:
            for i, rep in enumerate(replicas):
                name, backend = rep if isinstance(rep, tuple) else (f"r{i}", rep)
                self._replicas.append(ReplicaState(name, backend))
        self._write_quorum = write_quorum
        self._probe_interval_s = probe_interval_s
        self._probe_prefix = probe_prefix
        self.tracer = tracer
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = new_lock("replicated.ReplicatedStorageBackend._pool_lock")
        self._prober: Optional[HealthProber] = None
        #: Optional `(elapsed_ms)` hook, called on each failover.
        self.on_failover: Optional[Callable[[float], None]] = None
        #: Cumulative counters.
        self.failovers = 0
        self.quorum_failures = 0
        self._counter_lock = new_lock("replicated.ReplicatedStorageBackend._counter_lock")
        self._validate_quorum()
        if self._replicas and self._probe_interval_s:
            self.start_prober()

    # ------------------------------------------------------------------ setup
    def configure(self, configs: Mapping[str, object]) -> None:
        values = _definition().parse(configs)
        names = [str(n) for n in values["replication.replicas"]]
        if not names:
            raise ValueError(
                "replication.replicas must name at least one replica"
            )
        if len(set(names)) != len(names):
            raise ValueError(f"replication.replicas has duplicates: {names}")
        self._replicas = []
        for name in names:
            prefix = f"replication.replica.{name}."
            child_configs = subset_with_prefix(configs, prefix)
            class_path = child_configs.pop("backend.class", None)
            if not class_path:
                raise ValueError(
                    f"replication.replica.{name}.backend.class is required"
                )
            backend = load_backend_class(str(class_path))()
            backend.configure(child_configs)
            self._replicas.append(ReplicaState(name, backend))
        self._write_quorum = values["replication.write.quorum"]
        interval_ms = values["replication.probe.interval.ms"]
        self._probe_interval_s = interval_ms / 1000.0 if interval_ms else None
        self._validate_quorum()
        if self._probe_interval_s:
            self.start_prober()

    def _validate_quorum(self) -> None:
        if (
            self._write_quorum is not None
            and self._replicas
            and self._write_quorum > len(self._replicas)
        ):
            raise ValueError(
                f"replication.write.quorum={self._write_quorum} exceeds the "
                f"{len(self._replicas)} configured replicas"
            )

    def start_prober(self) -> None:
        if self._prober is not None or not self._probe_interval_s:
            return
        self._prober = HealthProber(
            self._replicas, self._probe_interval_s,
            prefix=self._probe_prefix, tracer=self.tracer,
        ).start()

    def close(self) -> None:
        if self._prober is not None:
            self._prober.stop()
            self._prober = None
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)

    # ------------------------------------------------------------- accessors
    @property
    def replica_states(self) -> list[ReplicaState]:
        return list(self._replicas)

    @property
    def prober(self) -> Optional[HealthProber]:
        return self._prober

    @property
    def write_quorum(self) -> int:
        return self._write_quorum or len(self._replicas)

    def replica_health(self) -> dict[str, float]:
        return {rep.name: rep.health_score() for rep in self._replicas}

    def read_fetchers(self) -> list[StorageBackend]:
        """Health-ordered children, for replica-aware hedging: a hedge
        issued against `read_fetchers()[1]` races a DISTINCT replica
        instead of re-hammering the straggler."""
        return [rep.backend for rep in self._by_health()]

    def _by_health(self) -> list[ReplicaState]:
        # Quantized so sub-hundredth score noise (e.g. a few hundred µs of
        # latency EWMA difference between healthy replicas) does not flap the
        # read order; the stable sort keeps configuration order for ties, so
        # the first-listed replica stays the preferred primary until health
        # meaningfully diverges.
        return sorted(
            self._replicas,
            key=lambda rep: round(rep.health_score(), 2),
            reverse=True,
        )

    def _executor(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=max(2, len(self._replicas)),
                    thread_name_prefix="replica-write",
                )
            return self._pool

    # ---------------------------------------------------------------- writes
    def upload(self, input_stream: BinaryIO, key: ObjectKey) -> int:
        """Concurrent fan-out write; quorum or rollback.

        The source stream is read ONCE and each replica gets its own
        buffer, so a child that consumes/half-consumes its stream cannot
        starve its siblings."""
        if not self._replicas:
            raise StorageBackendException("No replicas configured")
        data = input_stream.read()
        deadline = current_deadline()

        def write_one(rep: ReplicaState) -> int:
            start = time.monotonic()
            try:
                with deadline_scope(deadline):
                    n = rep.backend.upload(io.BytesIO(data), key)
            except Exception:
                rep.record(ok=False, latency_ms=(time.monotonic() - start) * 1000.0)
                raise
            rep.record(ok=True, latency_ms=(time.monotonic() - start) * 1000.0)
            return n

        pool = self._executor()
        futures = {pool.submit(write_one, rep): rep for rep in self._replicas}
        succeeded: list[ReplicaState] = []
        failures: list[tuple[ReplicaState, BaseException]] = []
        size = len(data)
        for future, rep in futures.items():
            try:
                size = future.result()
                succeeded.append(rep)
            except Exception as e:  # noqa: BLE001 — tallied against the quorum
                failures.append((rep, e))
        quorum = self.write_quorum
        if len(succeeded) < quorum:
            self._rollback(succeeded, key)
            with self._counter_lock:
                self.quorum_failures += 1
            self.tracer.event(
                "storage.quorum_failure", key=key.value,
                succeeded=len(succeeded), quorum=quorum,
                failed=[rep.name for rep, _ in failures],
            )
            detail = "; ".join(
                f"{rep.name}: {type(e).__name__}: {e}" for rep, e in failures
            )
            raise QuorumWriteException(
                f"Write of {key} reached {len(succeeded)}/{len(self._replicas)} "
                f"replicas, quorum is {quorum} ({detail}); successful copies "
                "rolled back"
            ) from (failures[0][1] if failures else None)
        if failures:
            log.warning(
                "Write of %s missed %d replica(s) but met quorum %d: %s",
                key, len(failures), quorum,
                ", ".join(rep.name for rep, _ in failures),
            )
        return size

    def _rollback(self, succeeded: Sequence[ReplicaState], key: ObjectKey) -> None:
        """Delete the sub-quorum copies; best-effort (the upload already
        failed — rollback failures are logged, not raised)."""
        for rep in succeeded:
            try:
                rep.backend.delete(key)
            except Exception:  # noqa: BLE001 — rollback is best-effort
                log.warning(
                    "Sub-quorum rollback failed to delete %s from replica %s",
                    key, rep.name, exc_info=True,
                )

    def delete(self, key: ObjectKey) -> None:
        """Fan-out delete; must converge on EVERY replica.

        Missing keys are fine (deletion is idempotent), but any replica
        that *fails* the delete keeps its copy — raising here lets the
        caller's idempotent retry (rsm._delete_keys sweep) converge
        instead of leaving a copy the anti-entropy pass would faithfully
        resurrect onto the other replicas."""
        if not self._replicas:
            raise StorageBackendException("No replicas configured")
        failures: list[tuple[ReplicaState, BaseException]] = []
        for rep in self._replicas:
            start = time.monotonic()
            try:
                rep.backend.delete(key)
            except KeyNotFoundException:
                rep.record(ok=True)
            except Exception as e:  # noqa: BLE001 — swept, then surfaced as one
                rep.record(ok=False, latency_ms=(time.monotonic() - start) * 1000.0)
                failures.append((rep, e))
            else:
                rep.record(ok=True, latency_ms=(time.monotonic() - start) * 1000.0)
        if failures:
            detail = "; ".join(
                f"{rep.name}: {type(e).__name__}: {e}" for rep, e in failures
            )
            raise StorageBackendException(
                f"Delete of {key} failed on {len(failures)}/"
                f"{len(self._replicas)} replicas: {detail}"
            ) from failures[0][1]

    # ----------------------------------------------------------------- reads
    def fetch(self, key: ObjectKey, byte_range: Optional[BytesRange] = None) -> BinaryIO:
        """Healthiest replica first, failing over within the deadline.

        Contract answers are only surfaced once every replica has been
        consulted (a key can be missing on a stale replica but present on
        another); precedence on total failure is
        invalid-range > key-not-found > last backend error."""
        return self._read_failover(
            "fetch", lambda backend: backend.fetch(key, byte_range), key=key.value
        )

    def list_objects(self, prefix: str = ""):
        # Materialized so a mid-iteration page failure fails over instead of
        # escaping after the healthy-looking iterator was already returned.
        return iter(self._read_failover(
            "list", lambda backend: list(backend.list_objects(prefix)), key=prefix
        ))

    def _read_failover(self, op: str, call, *, key: str):
        if not self._replicas:
            raise StorageBackendException("No replicas configured")
        ordered = self._by_health()
        start = time.monotonic()
        not_found: Optional[KeyNotFoundException] = None
        invalid_range: Optional[InvalidRangeException] = None
        last_error: Optional[StorageBackendException] = None
        attempts = 0
        for rep in ordered:
            if attempts:
                budget = remaining_s()
                if budget is not None and budget <= 0:
                    raise DeadlineExceededException(
                        f"Deadline expired after {attempts} replica "
                        f"attempt(s) for {op} of {key}"
                    )
            attempts += 1
            t0 = time.monotonic()
            try:
                result = call(rep.backend)
            except KeyNotFoundException as e:
                rep.record(ok=True, latency_ms=(time.monotonic() - t0) * 1000.0)
                not_found = e
                continue
            except InvalidRangeException as e:
                rep.record(ok=True, latency_ms=(time.monotonic() - t0) * 1000.0)
                invalid_range = e
                continue
            except DeadlineExceededException:
                # Caller impatience, not replica failure: stop failing over.
                raise
            except Exception as e:  # noqa: BLE001 — fail over to the next replica
                rep.record(ok=False, latency_ms=(time.monotonic() - t0) * 1000.0)
                last_error = (
                    e if isinstance(e, StorageBackendException)
                    else StorageBackendException(f"{op} failed on {rep.name}: {e}")
                )
                self.tracer.event(
                    "storage.replica_error", op=op, replica=rep.name,
                    key=key, error=type(e).__name__,
                )
                continue
            rep.record(ok=True, latency_ms=(time.monotonic() - t0) * 1000.0)
            if attempts > 1:
                elapsed_ms = (time.monotonic() - start) * 1000.0
                with self._counter_lock:
                    self.failovers += 1
                self.tracer.event(
                    "storage.failover", op=op, key=key, to_replica=rep.name,
                    attempts=attempts,
                )
                if self.on_failover is not None:
                    self.on_failover(elapsed_ms)
            return result
        if invalid_range is not None:
            raise invalid_range
        if not_found is not None:
            raise not_found
        raise AllReplicasFailedException(
            f"All {len(ordered)} replicas failed {op} of {key}"
        ) from last_error

    def __str__(self) -> str:
        names = ",".join(rep.name for rep in self._replicas)
        return f"ReplicatedStorageBackend{{replicas=[{names}], quorum={self.write_quorum}}}"
