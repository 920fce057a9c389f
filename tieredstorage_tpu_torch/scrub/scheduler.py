"""ScrubScheduler: incremental background passes on a jittered period.

Counterpart of tieredstorage_tpu/scrub/scheduler.py, whole.

A daemon thread sleeps `interval_ms` between passes (first pass after a
seeded random jitter in [0, interval) so a fleet of managers restarting
together doesn't synchronize its scrub load against the object store), runs
`Scrubber.scrub_once()`, and keeps the latest report for `status()` (the
RSM's `scrub_status()`). Foreground impact is bounded by the Scrubber's
TokenBucket and the batcher's background admission class
(`scrub.rate.bytes`), not by the scheduler.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Optional

from tieredstorage_tpu_torch.scrub.scrubber import Scrubber

log = logging.getLogger(__name__)

STOPPED, IDLE, SCRUBBING = 0, 1, 2
_STATE_NAMES = {STOPPED: "stopped", IDLE: "idle", SCRUBBING: "scrubbing"}


class ScrubScheduler:
    def __init__(
        self,
        scrubber: Scrubber,
        *,
        interval_ms: int,
        jitter_seed: Optional[int] = None,
    ) -> None:
        if interval_ms < 1:
            raise ValueError("interval_ms must be >= 1")
        self.scrubber = scrubber
        self.interval_s = interval_ms / 1000.0
        self._initial_delay_s = random.Random(jitter_seed).uniform(0.0, self.interval_s)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._state = STOPPED
        self._last_error: Optional[str] = None
        self._next_run_at: Optional[float] = None

    # ---------------------------------------------------------------- control
    def start(self) -> "ScrubScheduler":
        if self._thread is not None:
            raise RuntimeError("ScrubScheduler already started")
        self._state = IDLE
        self._thread = threading.Thread(
            target=self._run, name="scrub-scheduler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        self._state = STOPPED

    def run_now(self) -> None:
        """Skip the current sleep; the next pass starts immediately."""
        self._wake.set()

    # ------------------------------------------------------------------ loop
    def _run(self) -> None:
        delay = self._initial_delay_s
        while not self._stop.is_set():
            self._next_run_at = time.monotonic() + delay
            self._wake.wait(timeout=delay)
            self._wake.clear()
            if self._stop.is_set():
                return
            self._state = SCRUBBING
            try:
                self.scrubber.scrub_once()
                self._last_error = None
            except Exception as e:  # noqa: BLE001 — the loop must survive a bad pass
                self._last_error = f"{type(e).__name__}: {e}"
                log.warning("Scrub pass failed", exc_info=True)
            finally:
                self._state = IDLE
            delay = self.interval_s

    # ---------------------------------------------------------------- status
    @property
    def state_code(self) -> int:
        return self._state

    def status(self) -> dict:
        """JSON-shaped status of the scheduler and its scrubber's counters."""
        scrubber = self.scrubber
        out = {
            "state": _STATE_NAMES[self._state],
            "interval_ms": int(self.interval_s * 1000),
            "passes": scrubber.passes,
            "findings_total": scrubber.findings_total,
            "corrupt_chunks_total": scrubber.corrupt_chunks_total,
            "orphans_total": scrubber.orphans_total,
            "missing_objects_total": scrubber.missing_objects_total,
            "repairs_total": scrubber.repairs_total,
            "bytes_scanned_total": scrubber.bytes_scanned_total,
            "chunks_verified_total": scrubber.chunks_verified_total,
            "last_error": self._last_error,
        }
        if self._state != STOPPED and self._next_run_at is not None and self._state == IDLE:
            out["next_pass_in_s"] = round(max(0.0, self._next_run_at - time.monotonic()), 3)
        if scrubber.last_report is not None:
            last = scrubber.last_report.to_json()
            del last["findings"]  # summary only; full ledgers live in reports
            out["last_pass"] = last
        return out
