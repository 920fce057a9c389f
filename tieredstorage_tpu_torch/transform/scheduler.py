"""Work classes for the device GCM queue: the scheduling half of the batcher.

Counterpart of tieredstorage_tpu/transform/scheduler.py, whole. The window
batcher (transform/batcher.py) reads these classes; the fetch tiers tag
their work with them (chunk_cache.py, readahead.py), and the scrubber runs
under BACKGROUND.

The window batcher coalesces the decrypt path; this module makes
the one device queue *work-class-aware* so every GCM consumer — foreground
fetch decrypts, encrypt windows coalesced across concurrent produces, and
the scrubber's verification walks — shares the device under an explicit
policy instead of racing for it. The model is continuous batching (Orca,
OSDI '22) extended with Clockwork's (OSDI '20) predictable-latency
discipline: background work may keep the device busy, but it must never
bite a foreground waiter's deadline.

Three classes, strictly ranked for flush ordering, weighted for fair
share among equals:

- ``latency`` — deadline-carrying fetch decrypts (the default for the
  decrypt path). Out-ranks everything at every flush decision.
- ``throughput`` — produce/upload encrypt windows (the default for the
  encrypt path): bulk work that wants occupancy, not the lowest latency.
- ``background`` — scrub / anti-entropy verification windows: paced by a
  per-class admission budget (the scheduler-side replacement for the
  scrubber's host token bucket) and guaranteed forward progress by a
  bounded max queue age (the starvation watchdog).

Everything here is PURE host logic on explicit arguments: the callers own
the clock and the mutable
state, all of it guarded by the batcher's one condition. The thread-local
scope below is the only stateful piece — it tags the *submitting* thread,
the same ambient-context idiom as ``utils.deadline.deadline_scope``.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator, Optional

#: The three work classes, rank order = flush order among due buckets.
LATENCY = "latency"
THROUGHPUT = "throughput"
BACKGROUND = "background"
WORK_CLASSES = (LATENCY, THROUGHPUT, BACKGROUND)

#: Strict priority rank: lower flushes first when both are due.
CLASS_RANK = {LATENCY: 0, THROUGHPUT: 1, BACKGROUND: 2}

#: Weighted fair shares for the deficit ordering among non-latency
#: classes: per byte served, a share-8 class falls behind 8x slower than
#: a share-1 class, so throughput work drains ~8x faster than background
#: when both are continuously backlogged.
DEFAULT_SHARES = {LATENCY: 8, THROUGHPUT: 4, BACKGROUND: 1}

#: Default starvation-watchdog bound (ms): the max age a background
#: bucket may sit queued under sustained foreground pressure before it
#: must flush (admission budget permitting) — forward progress is a
#: guarantee, not a hope. `transform.batch.background.max.age.ms`.
DEFAULT_BACKGROUND_MAX_AGE_MS = 50.0

_tls = threading.local()


def validate_work_class(work_class: str) -> str:
    if work_class not in CLASS_RANK:
        raise ValueError(
            f"unknown work class {work_class!r}; expected one of {WORK_CLASSES}"
        )
    return work_class


def current_work_class() -> Optional[str]:
    """The work class scoped on this thread, or None when unscoped (the
    caller picks its path's default: decrypt=latency, encrypt=throughput)."""
    return getattr(_tls, "work_class", None)


@contextmanager
def work_class_scope(work_class: str) -> Iterator[str]:
    """Tag every GCM submit on this thread with ``work_class`` (nestable;
    the innermost scope wins — the scrubber wraps its verification walks
    in ``work_class_scope(BACKGROUND)`` so its device windows join the
    background admission class instead of racing foreground fetches)."""
    validate_work_class(work_class)
    prev = current_work_class()
    _tls.work_class = work_class
    try:
        yield work_class
    finally:
        _tls.work_class = prev


def is_speculative() -> bool:
    """True when this thread is inside a ``speculative_scope`` — the work
    it submits is a readahead *bet*, not demanded data. The batcher reads
    this at submit time to keep a separate speculative-rows ledger, so
    background occupancy from prediction is attributable in metrics."""
    return bool(getattr(_tls, "speculative", False))


@contextmanager
def speculative_scope() -> Iterator[None]:
    """Tag every GCM submit on this thread as speculative (nestable,
    same save/restore discipline as ``work_class_scope``). Readahead
    wraps its window loads in ``work_class_scope(BACKGROUND)`` +
    ``speculative_scope()``: the former decides *when* the device runs
    the work, the latter only *labels* it for accounting."""
    prev = is_speculative()
    _tls.speculative = True
    try:
        yield
    finally:
        _tls.speculative = prev


def class_max_age_ms(
    work_class: str, wait_ms: float, background_max_age_ms: float
) -> float:
    """The max queue age before a class's bucket must flush: foreground
    classes use the batcher's coalescing window (``wait_ms``); background
    uses the starvation-watchdog bound — longer (it tolerates wait in
    exchange for occupancy) but BOUNDED, so sustained foreground pressure
    can never park a scrub window forever."""
    if work_class == BACKGROUND:
        return background_max_age_ms
    return wait_ms


def flush_priority(
    work_class: str, served_bytes: float, share: float, oldest_enqueued_at: float
) -> tuple:
    """Sort key ordering DUE buckets for flush: latency strictly first
    (it out-ranks queued throughput/background work at every flush
    decision), then weighted deficit — ascending bytes-served-per-share,
    so the class furthest below its fair share launches next — with the
    strict rank and FIFO age as ties."""
    validate_work_class(work_class)
    rank = CLASS_RANK[work_class]
    deficit = served_bytes / share if share > 0 else float("inf")
    return (0 if work_class == LATENCY else 1, deficit, rank, oldest_enqueued_at)


def admission_refill(
    allowance: float, rate_bytes: float, burst_bytes: float, elapsed_s: float
) -> float:
    """Accrue admission budget at ``rate_bytes``/s over ``elapsed_s``,
    capped at ``burst_bytes`` (the token-bucket accrual, relocated into
    the scheduler so the budget gates *launch admission* instead of
    sleeping a host thread). Debt (a negative allowance left by a
    watchdog-forced flush) pays down before new budget accrues."""
    if elapsed_s < 0:
        raise ValueError(f"elapsed_s must be >= 0, got {elapsed_s}")
    return min(burst_bytes, allowance + rate_bytes * elapsed_s)


def admission_defer_s(allowance: float, need_bytes: float, rate_bytes: float) -> float:
    """Seconds until the class allowance covers ``need_bytes`` (0 = admit
    now). The caller clamps ``need_bytes`` at the burst cap, so a bucket
    larger than one refill is admitted in paced slices instead of never."""
    if rate_bytes <= 0:
        return 0.0
    if allowance >= need_bytes:
        return 0.0
    return (need_bytes - allowance) / rate_bytes
