"""Work-class-aware device scheduler: ONE GCM queue for fetch, encrypt, scrub.

Counterpart of tieredstorage_tpu/transform/batcher.py, whole, without the
planes this package has not ported (the flight recorder, `utils/locks`
witnesses, the metrics groups): `on_flush` and `timeline` stay as hook
attributes, None unless a caller sets them. `_launch_once` is the fault
plane's `device.launch` seam (utils/faults.py), keyed by work class.

A window of the fetch path is one packed launch per request; under many
concurrent consumers that is many small launches, each paying the per-launch
floor. `WindowBatcher` coalesces *concurrent* windows that share a data key
into one merged varlen launch, the continuous-batching shape (Orca, OSDI
'22), with Clockwork-style (OSDI '20) work classes so every device consumer
— fetch decrypts, encrypt windows of concurrent copies, scrub verification —
shares the one queue under the policy of transform/scheduler.py:

- `CudaTransformBackend._decrypt_batch` routes eligible windows here
  (`transform.batch.enabled`); each caller blocks while its rows ride a
  SHARED packed ``uint8[B, n_bytes + 16]`` launch and gets its own rows of
  the one output buffer back. `transform_windows` routes encrypt windows
  through `submit_encrypt` / `_EncryptHandle.wait` — asynchronous, so the
  `pipeline.depth` overlap is kept.
- Grouping is by ``(work_class, direction, data_key, aad,
  bucket_max_bytes(max_size))``; merged row counts are padded up a
  power-of-two ladder (`bucket_rows`), the JAX package's packed layout.
  Classes (and directions) never share a merged launch: a launch failure in
  a background scrub flush wakes background waiters only.
- The flush policy is deadline- and class-aware: a bucket flushes when its
  queued windows or bytes reach the caps, when its oldest waiter aged past
  its class bound (`wait_ms`; `background_max_age_ms` for background, the
  starvation watchdog), or when the tightest waiter's remaining deadline
  minus the observed launch p95 reaches the floor. Due buckets launch in
  scheduler order: latency first, then weighted deficit.
- Per-class admission: a class with a byte rate (`set_class_rate`; the RSM
  maps `scrub.rate.bytes` onto background) accrues launch budget.
- Single-waiter fast path: a foreground submit that finds the batcher idle
  dispatches inline through the ordinary window path (zero added latency,
  and the hot tier's retention hook, which a merged buffer never feeds).
  Background submits always queue.
- Per-row error isolation: decrypt tags are verified per caller after the
  merged launch; a forged row fails its own request only. A waiter whose
  deadline expired before launch fails fast and never joins the pack.

A merged flush packs its rows into one host buffer that no launch writes,
and lands the output in a second: a retried launch (`retry.launch.*`)
starts again from the untouched input. Launches run on the flusher thread,
inside `torch.cuda.device(backend.device)`, on the default stream; the
calling threads' `ops.gcm.thread_dispatches()` stay 0 for merged launches
(`thread_evidence` is what shows which launch a request shared), while the
process-wide `device_dispatches()` counts them.
"""

from __future__ import annotations

import dataclasses
import hmac
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from tieredstorage_tpu_torch.security.aes import IV_SIZE, TAG_SIZE
from tieredstorage_tpu_torch.transform.scheduler import (
    BACKGROUND,
    DEFAULT_BACKGROUND_MAX_AGE_MS,
    DEFAULT_SHARES,
    LATENCY,
    THROUGHPUT,
    WORK_CLASSES,
    admission_defer_s,
    admission_refill,
    class_max_age_ms,
    current_work_class,
    flush_priority,
    is_speculative,
    validate_work_class,
)
from tieredstorage_tpu_torch.utils import faults
from tieredstorage_tpu_torch.utils.retry import RetryPolicy, call_with_retry


class BatcherStoppedError(RuntimeError):
    """A window was submitted to (or stranded in) a stopped batcher."""


def bucket_rows(n: int) -> int:
    """Round a merged row count up to a power of two (min 8): the JAX
    package's row ladder, kept for the parity of the packed layout and of
    `DispatchStats`. Padding rows are zero-filled one-block GCM rows."""
    if n < 1:
        raise ValueError(f"row count must be >= 1, got {n}")
    return 1 << max(3, (n - 1).bit_length())


@dataclasses.dataclass
class _PendingWindow:
    """One caller's window, queued for a shared launch. Mutated by the
    submitting thread before enqueue and by the flusher after dequeue; the
    per-entry Event is the happens-before edge between them."""

    payloads: list
    sizes: list
    ivs: np.ndarray
    tags: Optional[list]  # None on the encrypt direction (nothing to verify)
    n_bytes: int
    enqueued_at: float
    deadline_at: Optional[float]
    work_class: str = LATENCY
    decrypt: bool = True
    event: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: Optional[list] = None
    error: Optional[BaseException] = None
    batch_id: int = 0
    occupancy: int = 0
    added_wait_ms: float = 0.0
    #: Trace id of the submitting request (None: the flight recorder is
    #: not ported); passed to `on_flush` beside the occupancy.
    trace_id: Optional[str] = None


class _EncryptHandle:
    """An in-flight encrypt window: resolve with ``wait()``. Either an
    inline dispatch (the staged window of ``_encrypt_dispatch``, finished
    through the ordinary ``_encrypt_finish``) or a queued entry riding a
    merged flush — callers hold ``pipeline.depth`` of these without
    blocking, so coalescing never costs a copy its overlap."""

    __slots__ = ("_batcher", "_staged", "_entry")

    def __init__(self, batcher, staged=None, entry=None) -> None:
        self._batcher = batcher
        self._staged = staged
        self._entry = entry

    def wait(self) -> list:
        """Block until this window's wire chunks (IV || ct || tag) exist."""
        if self._staged is not None:
            return self._batcher._backend._encrypt_finish(self._staged)
        return self._batcher._await_entry(self._entry)


class WindowBatcher:
    """Coalesces concurrent GCM windows into shared packed launches, one
    work class per launch.

    One daemon flusher thread owns the device queue; submitting threads
    block on their entry's event. All shared state mutates under the one
    ``_cond``; the flush itself runs OUTSIDE the lock so staging and launch
    never serialize submitters.
    """

    #: Flush when the oldest waiter's remaining deadline minus the observed
    #: launch p95 drops to this floor (ms).
    DEADLINE_FLOOR_MS = 5.0
    #: Launch-duration samples retained for the p95 estimate.
    LAUNCH_SAMPLES = 64
    #: Liveness-backstop slack past a waiter's own deadline: the flusher's
    #: fail-fast (not a spurious wait timeout) reports deadline expiry.
    WAIT_GRACE_S = 60.0

    #: Optional flush hook ``(occupancy, added_wait_ms_list, work_class,
    #: batch_id, trace_ids)``.
    on_flush: Optional[Callable] = None
    #: Optional scheduler timeline (``record_flush`` / ``record_expired``);
    #: the timeline plane is not ported, so nothing sets it here.
    timeline = None

    def __init__(
        self,
        backend,
        *,
        wait_ms: float = 2.0,
        max_windows: int = 16,
        max_bytes: int = 64 << 20,
        background_max_age_ms: float = DEFAULT_BACKGROUND_MAX_AGE_MS,
        class_shares: Optional[dict] = None,
        launch_attempts: int = 2,
        launch_backoff_s: float = 0.005,
        time_source: Callable[[], float] = time.monotonic,
    ) -> None:
        if wait_ms < 0:
            raise ValueError(f"wait_ms must be >= 0, got {wait_ms}")
        if max_windows < 2:
            raise ValueError(f"max_windows must be >= 2, got {max_windows}")
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        if background_max_age_ms < 0:
            raise ValueError(
                f"background_max_age_ms must be >= 0, got {background_max_age_ms}"
            )
        self._backend = backend
        self.wait_ms = float(wait_ms)
        self.max_windows = int(max_windows)
        self.max_bytes = int(max_bytes)
        self.background_max_age_ms = float(background_max_age_ms)
        self.class_shares = dict(DEFAULT_SHARES)
        for cls, share in (class_shares or {}).items():
            validate_work_class(cls)
            if share <= 0:
                raise ValueError(f"share for {cls!r} must be > 0, got {share}")
            self.class_shares[cls] = float(share)
        self._now = time_source
        # One bounded re-dispatch before a merged launch fails its waiters;
        # each attempt starts again from the packed input, which no launch
        # writes.
        self.set_launch_retry(launch_attempts, launch_backoff_s)
        #: The ONE guard of every shared field below; doubles as the
        #: flusher's wakeup condition.
        self._cond = threading.Condition()
        #: bucket key (work_class, decrypt, data_key, aad, bucket_bytes)
        #: -> queued entries. One class + one direction per merged launch.
        self._buckets: dict[tuple, list[_PendingWindow]] = {}
        self._launch_s: list[float] = []
        self._inflight = 0
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self._tls = threading.local()
        self._batch_seq = 0
        #: Deficit-fair-share accounting: bytes each class launched.
        self._served_bytes = {cls: 0 for cls in WORK_CLASSES}
        #: Per-class admission (set_class_rate): bytes/s rate, burst cap,
        #: current allowance, and the last refill instant.
        self._class_rate: dict[str, float] = {}
        self._class_burst: dict[str, float] = {}
        self._class_allowance: dict[str, float] = {}
        self._class_refill_at: dict[str, float] = {}
        self.windows_submitted = 0
        self.fast_path_windows = 0
        self.batched_windows = 0
        self.launches = 0
        self.expired_windows = 0
        self.launch_failures = 0
        #: Merged launches that needed the bounded re-dispatch.
        self.launch_retries = 0
        #: Per-class counters: windows that rode a merged flush, merged
        #: launches, and the summed added queue wait.
        self.class_flushed_windows = {cls: 0 for cls in WORK_CLASSES}
        self.class_launches = {cls: 0 for cls in WORK_CLASSES}
        self.class_added_wait_ms = {cls: 0.0 for cls in WORK_CLASSES}
        #: Speculative-rows ledger: windows/bytes submitted under a
        #: ``speculative_scope`` (readahead bets), kept apart from the class
        #: counters so predicted background work is told from demanded.
        self.speculative_windows = 0
        self.speculative_bytes = 0

    # --------------------------------------------------------------- lifecycle
    def start(self) -> "WindowBatcher":
        """Spawn the flusher daemon (idempotent)."""
        with self._cond:
            if self._thread is not None:
                return self
            self._stopped = False
            self._thread = threading.Thread(
                target=self._run, name="gcm-window-batcher", daemon=True
            )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the flusher and drain any stranded waiters."""
        with self._cond:
            self._stopped = True
            thread = self._thread
            self._thread = None
            self._cond.notify_all()
        if thread is not None:
            thread.join(timeout=30)
        self.flush_now()

    @property
    def mean_occupancy(self) -> float:
        """Coalesced windows per shared launch (fast-path dispatches are
        occupancy-1 by definition and excluded)."""
        with self._cond:
            return self.batched_windows / self.launches if self.launches else 0.0

    def set_launch_retry(self, attempts: int, backoff_s: float) -> None:
        """Rebuild the launch retry policy (`retry.launch.*`): the RSM wires
        this after the backend's configure() built the batcher, since the
        policy keys live at the RSM level, not in the transform.* subtree."""
        backoff = max(0.0, float(backoff_s))
        self._launch_policy = RetryPolicy(
            max_attempts=max(1, int(attempts)),
            base_backoff_s=backoff,
            max_backoff_s=backoff * 4.0,
            retryable=(Exception,),
        )

    def set_class_rate(
        self, work_class: str, rate_bytes: Optional[float],
        burst_bytes: Optional[float] = None,
    ) -> None:
        """Admit ``work_class`` launches at ``rate_bytes``/s (burst cap
        defaults to one second of rate, like ``TokenBucket``); None clears
        the rate (unlimited). The RSM maps ``scrub.rate.bytes`` here."""
        validate_work_class(work_class)
        with self._cond:
            if rate_bytes is None or rate_bytes <= 0:
                self._class_rate.pop(work_class, None)
                self._class_burst.pop(work_class, None)
                self._class_allowance.pop(work_class, None)
                self._class_refill_at.pop(work_class, None)
            else:
                self._class_rate[work_class] = float(rate_bytes)
                self._class_burst[work_class] = float(
                    rate_bytes if burst_bytes is None else burst_bytes
                )
                self._class_allowance[work_class] = self._class_burst[work_class]
                self._class_refill_at[work_class] = self._now()
            self._cond.notify()

    def class_queued(self) -> dict[str, int]:
        """Currently queued windows per class."""
        out = {cls: 0 for cls in WORK_CLASSES}
        with self._cond:
            for key, entries in self._buckets.items():
                out[key[0]] += len(entries)
        return out

    def thread_evidence(self) -> tuple[int, float, int]:
        """This THREAD's cumulative (coalesced windows, occupancy sum, last
        batch id). Thread-local: only the submitting thread writes its own
        cell."""
        t = self._tls
        return (
            getattr(t, "windows", 0),
            getattr(t, "occupancy_sum", 0.0),
            getattr(t, "last_batch_id", 0),
        )

    # ------------------------------------------------------------------ submit
    def _admit_locked(self, work_class: str, n_bytes: int) -> bool:
        """Count a submit (callers hold ``_cond``) and decide the fast path:
        only a foreground window that finds the batcher idle takes it."""
        if self._stopped:
            raise BatcherStoppedError("WindowBatcher is stopped")
        self.windows_submitted += 1
        if is_speculative():
            self.speculative_windows += 1
            self.speculative_bytes += n_bytes
        fast = work_class != BACKGROUND and not self._buckets and self._inflight == 0
        if fast:
            self._inflight += 1
            self.fast_path_windows += 1
        return fast

    def _release_inflight(self) -> None:
        with self._cond:
            self._inflight -= 1
            if self._buckets:
                self._cond.notify()

    def submit(self, enc, payloads, sizes, ivs, tags) -> list:
        """Decrypt one window, coalescing with concurrent submitters.

        Blocks until the window's rows came back from a (possibly shared)
        launch; returns the plaintext chunks or raises this CALLER's error
        only (``AuthenticationError`` on its own rows,
        ``DeadlineExceededException`` when its budget expired in queue).
        The work class is the thread's ambient ``work_class_scope``
        (default ``latency`` — the fetch path)."""
        work_class = current_work_class() or LATENCY
        with self._cond:
            fast = self._admit_locked(work_class, sum(sizes))
        if fast:
            # While this inline launch runs, new arrivals queue behind
            # `_inflight` and coalesce.
            try:
                return self._backend._decrypt_window(enc, payloads, sizes, ivs, tags)
            finally:
                self._release_inflight()
        entry = self._enqueue(enc, payloads, sizes, ivs, tags, work_class, decrypt=True)
        return self._await_entry(entry)

    def submit_encrypt(self, chunks, opts) -> _EncryptHandle:
        """Encrypt one window, coalescing with CONCURRENT copies.

        Asynchronous: returns a handle immediately (resolve with
        ``wait()``). An idle batcher dispatches inline (``_inflight`` held
        only across the asynchronous dispatch, so a single pipelined copy
        never queues); concurrent copies merge into one shared varlen
        launch with byte-identical wire output. The work class is the
        thread's ambient scope (default ``throughput`` — the upload path)."""
        work_class = current_work_class() or THROUGHPUT
        backend = self._backend
        with self._cond:
            fast = self._admit_locked(work_class, sum(len(c) for c in chunks))
        if fast:
            try:
                staged = backend._encrypt_dispatch(chunks, opts)
            finally:
                self._release_inflight()
            return _EncryptHandle(self, staged=staged)
        sizes = [len(c) for c in chunks]
        ivs = backend._make_ivs(len(chunks), opts)
        entry = self._enqueue(
            opts.encryption, chunks, sizes, ivs, None, work_class, decrypt=False
        )
        return _EncryptHandle(self, entry=entry)

    def _enqueue(
        self, enc, payloads, sizes, ivs, tags, work_class: str, *, decrypt: bool
    ) -> _PendingWindow:
        """Queue one window under its class+direction bucket and wake the
        flusher; the flusher owns the entry from here."""
        from tieredstorage_tpu_torch.ops import gcm as gcm_ops
        from tieredstorage_tpu_torch.utils import deadline as deadline_util

        now = self._now()
        remaining = deadline_util.remaining_s()
        entry = _PendingWindow(
            payloads=list(payloads),
            sizes=list(sizes),
            ivs=ivs,
            tags=None if tags is None else list(tags),
            n_bytes=sum(sizes),
            enqueued_at=now,
            deadline_at=None if remaining is None else now + remaining,
            work_class=work_class,
            decrypt=decrypt,
        )
        key = (
            work_class,
            decrypt,
            bytes(enc.data_key),
            bytes(enc.aad),
            gcm_ops.bucket_max_bytes(max(sizes)),
        )
        with self._cond:
            if self._stopped:
                raise BatcherStoppedError("WindowBatcher is stopped")
            self._buckets.setdefault(key, []).append(entry)
            self._cond.notify_all()
        return entry

    def _await_entry(self, entry: _PendingWindow) -> list:
        """Wait out a queued entry's flush; raises this caller's error
        only. The timeout is a liveness backstop (deadline expiry is
        enforced by the flusher's fail-fast)."""
        if not entry.event.wait(timeout=self._wait_timeout_s(entry)):
            raise BatcherStoppedError(
                "batched window was never flushed (flusher dead?)"
            )
        if entry.batch_id:
            t = self._tls
            t.windows = getattr(t, "windows", 0) + 1
            t.occupancy_sum = getattr(t, "occupancy_sum", 0.0) + entry.occupancy
            t.last_batch_id = entry.batch_id
        if entry.error is not None:
            raise entry.error
        return entry.result

    def _wait_timeout_s(self, entry: _PendingWindow) -> Optional[float]:
        """A queued waiter's liveness backstop: its remaining deadline
        budget plus ``WAIT_GRACE_S`` (None = wait indefinitely for an
        unconstrained caller)."""
        if entry.deadline_at is None:
            return None
        return max(0.0, entry.deadline_at - self._now()) + self.WAIT_GRACE_S

    # ----------------------------------------------------------- flush policy
    def _launch_p95_s(self) -> float:
        """p95 of recent launch wall times (0 before the first sample) —
        callers must hold ``_cond``."""
        if not self._launch_s:
            return 0.0
        ordered = sorted(self._launch_s)
        return ordered[int(0.95 * (len(ordered) - 1))]

    def _admission_ready_at_locked(
        self, work_class: str, need_bytes: int, now: float
    ) -> float:
        """When the class admission budget covers ``need_bytes`` (clamped
        at the burst/flush caps, so oversized backlogs admit in paced
        slices) — callers hold ``_cond``. Refills the allowance to ``now``."""
        rate = self._class_rate.get(work_class)
        if rate is None:
            return now
        burst = self._class_burst[work_class]
        elapsed = max(0.0, now - self._class_refill_at[work_class])
        self._class_allowance[work_class] = admission_refill(
            self._class_allowance[work_class], rate, burst, elapsed
        )
        self._class_refill_at[work_class] = now
        need = min(need_bytes, burst, self.max_bytes)
        return now + admission_defer_s(self._class_allowance[work_class], need, rate)

    def _flush_order(self, key: tuple) -> tuple:
        return flush_priority(
            key[0],
            self._served_bytes[key[0]],
            self.class_shares[key[0]],
            self._buckets[key][0].enqueued_at,
        )

    def _due_keys_locked(self, now: float) -> tuple[list, Optional[float]]:
        """(bucket keys due to flush now — scheduler order, seconds until
        the next one is).

        A bucket is due when: queued windows >= ``max_windows``; queued
        bytes >= ``max_bytes``; the oldest waiter aged past its CLASS
        bound; or the tightest waiter's remaining deadline minus the launch
        p95 is at the ``DEADLINE_FLOOR_MS`` floor. A class with an
        admission rate is additionally deferred until its byte budget
        covers the flush."""
        due: list = []
        next_wake: Optional[float] = None
        p95 = self._launch_p95_s()
        floor_s = self.DEADLINE_FLOOR_MS / 1000.0
        for key, entries in self._buckets.items():
            work_class = key[0]
            queued_bytes = sum(e.n_bytes for e in entries)
            if len(entries) >= self.max_windows or queued_bytes >= self.max_bytes:
                wake = now
            else:
                age_s = class_max_age_ms(
                    work_class, self.wait_ms, self.background_max_age_ms
                ) / 1000.0
                wake = entries[0].enqueued_at + age_s
                deadlines = [e.deadline_at for e in entries if e.deadline_at is not None]
                if deadlines:
                    wake = min(wake, min(deadlines) - p95 - floor_s)
            wake = max(
                wake, self._admission_ready_at_locked(work_class, queued_bytes, now)
            )
            if wake <= now:
                due.append(key)
            elif next_wake is None or wake < next_wake:
                next_wake = wake
        due.sort(key=self._flush_order)
        timeout = None if next_wake is None else max(0.0, next_wake - now)
        return due, timeout

    def _take_locked(self, key: tuple) -> list:
        """Pop a bucket's oldest entries up to the windows/bytes caps
        (callers hold ``_cond``); the remainder stays queued and due. Taken
        bytes land in the class's deficit account and draw down its
        admission allowance (which may go negative: the debt defers the
        next flush, standard token-bucket pacing)."""
        entries = self._buckets.get(key)
        take: list = []
        total = 0
        while entries and len(take) < self.max_windows and total < self.max_bytes:
            e = entries.pop(0)
            take.append(e)
            total += e.n_bytes
        if not entries:
            self._buckets.pop(key, None)
        if take:
            work_class = key[0]
            self._served_bytes[work_class] += total
            if work_class in self._class_rate:
                self._class_allowance[work_class] -= total
        return take

    def _run(self) -> None:
        """Flusher daemon: wait for a due bucket, take a capped batch,
        flush outside the lock, in scheduler order (latency first)."""
        while True:
            with self._cond:
                if self._stopped:
                    return
                due, timeout = self._due_keys_locked(self._now())
                if not due:
                    self._cond.wait(timeout)
                    continue
                groups = [(key, self._take_locked(key)) for key in due]
                self._inflight += 1
            try:
                for key, entries in groups:
                    self._flush_group(key, entries)
            finally:
                with self._cond:
                    self._inflight -= 1

    def flush_now(self) -> int:
        """Flush every queued window synchronously on the calling thread
        (tests and the ``stop`` drain), in capped batches and scheduler
        order, ignoring admission (a drain must terminate); returns the
        number of flushes."""
        flushes = 0
        while True:
            with self._cond:
                keys = sorted(self._buckets.keys(), key=self._flush_order)
                groups = [(key, self._take_locked(key)) for key in keys]
            if not groups:
                return flushes
            for key, entries in groups:
                if entries:
                    self._flush_group(key, entries)
                    flushes += 1

    # ------------------------------------------------------------------ flush
    def _on_launch_retry(self, attempt: int, delay_s: float, exc: BaseException) -> None:
        with self._cond:
            self.launch_retries += 1

    def _launch_once(
        self, ctx, packed: torch.Tensor, out_host: torch.Tensor, decrypt: bool,
        work_class: str,
    ):
        """One stage + launch attempt of a merged flush, replay-safe: the
        launch reads ``packed`` and never writes it; its output lands in
        ``out_host``. ``device.launch`` is the fault-injection seam (keyed by
        work class), before the stage. Returns the CUDA event that marks
        ``out_host`` ready (None on the CPU, where the launch writes
        ``out_host`` in place)."""
        faults.fire("device.launch", work_class)
        backend = self._backend
        if backend.device.type == "cuda":
            with torch.cuda.device(backend.device):
                staged = backend._stage_packed(packed)
                _, ready = backend._launch_packed(ctx, out_host, staged, True, decrypt=decrypt)
            return ready
        # The CPU launch decrypts its staged buffer in place, so stage a
        # copy: a retry then starts again from the untouched input.
        out_host.copy_(packed)
        staged = backend._stage_packed(out_host)
        backend._launch_packed(ctx, out_host, staged, True, decrypt=decrypt)
        return None

    def _flush_group(self, key: tuple, entries: list) -> None:
        """ONE shared launch for a bucket's queued windows: merge rows into
        one packed buffer, stage + launch through the owning backend
        (DispatchStats intact), then demultiplex per caller — per-row tag
        verification on decrypt, wire assembly (IV || ct || tag) on
        encrypt. The bucket key carries ONE work class and ONE direction,
        so a failure here wakes that class's waiters only."""
        from tieredstorage_tpu_torch.ops import gcm as gcm_ops
        from tieredstorage_tpu_torch.transform.api import AuthenticationError
        from tieredstorage_tpu_torch.utils.deadline import DeadlineExceededException

        work_class, decrypt = key[0], key[1]
        now = self._now()
        live: list[_PendingWindow] = []
        expired = 0
        for e in entries:
            if e.deadline_at is not None and e.deadline_at <= now:
                # Fail fast WITHOUT poisoning the batch: the expired waiter
                # never joins the pack.
                e.error = DeadlineExceededException(
                    "deadline expired while queued for a batched GCM launch"
                )
                e.event.set()
                expired += 1
            else:
                live.append(e)
        if expired:
            with self._cond:
                self.expired_windows += expired
            tl = self.timeline
            if tl is not None:
                tl.record_expired(work_class, expired, now)
        if not live:
            return

        backend = self._backend
        try:
            ctx = gcm_ops.make_varlen_context(key[2], key[3], key[4])
            n_bytes = ctx.max_bytes
            rows = sum(len(e.sizes) for e in live)
            shape = (bucket_rows(rows), n_bytes + TAG_SIZE)
            pinned = backend.device.type == "cuda"
            packed = backend._staging.acquire(shape, pinned)
            out_host = backend._staging.acquire(shape, pinned)
            pk = packed.numpy()
            r = 0
            for e in live:
                for i, p in enumerate(e.payloads):
                    pk[r, : e.sizes[i]] = np.frombuffer(p, np.uint8)
                    pk[r, e.sizes[i] : n_bytes] = 0  # varlen GHASH needs a zero tail
                    pk[r, n_bytes : n_bytes + IV_SIZE] = e.ivs[i]
                    r += 1
                pk[r - len(e.sizes) : r, n_bytes + IV_SIZE :] = (
                    np.asarray(e.sizes, dtype="<u4").view(np.uint8).reshape(-1, 4)
                )
            # Row-ladder padding: one 16-byte zero block per dummy row
            # (zero-length rows are excluded by the varlen contract).
            pk[rows:] = 0
            pk[rows:, n_bytes + IV_SIZE] = 16
            t0 = self._now()
            ready = call_with_retry(
                lambda: self._launch_once(ctx, packed, out_host, decrypt, work_class),
                policy=self._launch_policy,
                site="device.launch",
                on_retry=self._on_launch_retry,
            )
            if ready is not None:
                ready.synchronize()
            host = out_host.numpy()
            launch_s = self._now() - t0
        except BaseException as exc:  # noqa: BLE001 - every waiter must wake
            with self._cond:
                self.launch_failures += 1
            for e in live:
                e.error = exc
                e.event.set()
            return
        backend._note_batched_fetch()
        for e in live:
            backend._note_batched_window(e.n_bytes)

        occupancy = len(live)
        with self._cond:
            self._batch_seq += 1
            batch_id = self._batch_seq
            self.launches += 1
            self.batched_windows += occupancy
            self.class_launches[work_class] += 1
            self.class_flushed_windows[work_class] += occupancy
            self._launch_s.append(launch_s)
            if len(self._launch_s) > self.LAUNCH_SAMPLES:
                del self._launch_s[0]

        added_waits: list[float] = []
        r = 0
        for e in live:
            n = len(e.sizes)
            if decrypt:
                bad = [
                    i
                    for i in range(n)
                    if not hmac.compare_digest(host[r + i, n_bytes:].tobytes(), e.tags[i])
                ]
                if bad:
                    # Per-row error isolation: one forged row fails ITS
                    # request; batch-mates still get their plaintext.
                    e.error = AuthenticationError(f"GCM tag mismatch on chunks {bad}")
                else:
                    e.result = [host[r + i, : e.sizes[i]].tobytes() for i in range(n)]
            else:
                e.result = [
                    e.ivs[i].tobytes()
                    + host[r + i, : e.sizes[i]].tobytes()
                    + host[r + i, n_bytes:].tobytes()
                    for i in range(n)
                ]
            r += n
            e.batch_id = batch_id
            e.occupancy = occupancy
            e.added_wait_ms = max(0.0, (t0 - e.enqueued_at) * 1000.0)
            added_waits.append(e.added_wait_ms)
            e.event.set()
        # The event of the output buffer has completed and every caller's
        # rows were copied out: both buffers may serve the next flush.
        backend._staging.release(packed)
        backend._staging.release(out_host)
        with self._cond:
            self.class_added_wait_ms[work_class] += sum(added_waits)
        tl = self.timeline
        if tl is not None:
            tl.record_flush(
                batch_id=batch_id,
                work_class=work_class,
                decrypt=decrypt,
                bucket_bytes=key[4],
                rows=rows,
                n_bytes=sum(e.n_bytes for e in live),
                occupancy=occupancy,
                queued_age_ms=max(0.0, (t0 - min(e.enqueued_at for e in live)) * 1000.0),
                begin_s=t0,
                end_s=t0 + launch_s,
                queue_depths=self.class_queued(),
                trace_ids=[e.trace_id for e in live],
            )
        hook = self.on_flush
        if hook is not None:
            hook(occupancy, added_waits, work_class, batch_id, [e.trace_id for e in live])
