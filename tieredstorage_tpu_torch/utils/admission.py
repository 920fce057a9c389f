"""Admission control: bounded concurrency + bounded queue at the entry point.

Counterpart of tieredstorage_tpu/utils/admission.py. A service that accepts
unlimited concurrent work shows overload as ever-growing queues, memory
growth, and every request timing out together — the congestion-collapse
shape. DAGOR ("Overload Control for Scaling WeChat Microservices", SOSP 2018)
is explicit that shedding must happen at the *entry* of the service, before
any real work, and that rejected callers must be told to back off.

``AdmissionController`` is that gate: at most ``max_concurrent`` requests
execute, at most ``max_queue`` more wait (bounded, with a wait deadline),
and everything beyond that is shed immediately with
``AdmissionRejectedException`` carrying a Retry-After hint — a boundary
translates it to HTTP 429 + ``Retry-After`` or gRPC ``RESOURCE_EXHAUSTED``.
The RSM builds the controller (``admission.*``) and publishes its gauges;
the caller at the service boundary acquires and releases around each
request. Counters are plain ints exported as resilience gauges; ``on_wait``
feeds the admission-wait-time histogram.

Per-tenant fair share: callers that identify a tenant are additionally
subject to a fair-share rule AT SATURATION — while no slot is free, a tenant
already holding at least ``ceil(max_concurrent / active_tenants)`` slots is
shed immediately instead of queuing, so one greedy tenant flooding the gate
cannot starve polite ones out of the bounded queue (DAGOR's user-fairness
property). Under light load the rule is inert: any tenant may use every
slot while nobody else wants them. Requests without a tenant behave exactly
as before.
"""

from __future__ import annotations

import math
import time
from collections import Counter
from typing import Callable, Optional
from tieredstorage_tpu_torch.utils.locks import new_condition


class AdmissionRejectedException(Exception):
    """The request was shed at the entry gate; retry after `retry_after_s`."""

    def __init__(self, message: str, retry_after_s: float) -> None:
        super().__init__(message)
        self.retry_after_s = retry_after_s


class AdmissionController:
    def __init__(
        self,
        max_concurrent: int,
        max_queue: int,
        *,
        queue_timeout_s: float = 1.0,
        retry_after_s: float = 1.0,
        on_wait: Optional[Callable[[float], None]] = None,
    ) -> None:
        if max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        if max_queue < 0:
            raise ValueError("max_queue must be >= 0")
        self._max_concurrent = max_concurrent
        self._max_queue = max_queue
        self._queue_timeout_s = queue_timeout_s
        self.retry_after_s = retry_after_s
        self.on_wait = on_wait
        self._cond = new_condition("admission.AdmissionController._cond")
        #: Requests currently executing / currently queued (gauges).
        self.active = 0
        self.queued = 0
        #: Cumulative admissions and sheds (gauges).
        self.admitted_total = 0
        self.shed_total = 0
        #: Per-tenant slot occupancy and fair-share sheds (fleet mode).
        self._tenant_active: Counter = Counter()
        self.tenant_sheds: Counter = Counter()

    def _fair_share(self) -> int:
        """Slots one tenant may hold while the gate is saturated: an equal
        split of the concurrency limit across tenants currently holding
        slots (at least 1 so a lone tenant is never zeroed)."""
        tenants = max(1, len(self._tenant_active))
        return max(1, math.ceil(self._max_concurrent / tenants))

    def tenant_active(self, tenant: str) -> int:
        with self._cond:
            return self._tenant_active.get(tenant, 0)

    def acquire(self, what: str = "", tenant: Optional[str] = None) -> None:
        """Admit or shed. Blocks at most `queue_timeout_s` in the bounded
        queue; raises AdmissionRejectedException when the queue is full,
        the wait times out, or — with a `tenant` — the tenant is over its
        fair share while the gate is saturated. Pair with release(tenant=)
        in a finally block."""
        start = time.monotonic()
        with self._cond:
            if self.active < self._max_concurrent:
                self._admit(tenant)
                return
            if tenant is not None and self._tenant_active[tenant] >= self._fair_share():
                # Saturated AND this tenant already holds its share: shed
                # without queuing so the bounded queue stays available to
                # tenants under their share.
                self.shed_total += 1
                self.tenant_sheds[tenant] += 1
                raise AdmissionRejectedException(
                    f"tenant {tenant!r} over fair share "
                    f"({self._tenant_active[tenant]}/{self._fair_share()} slots, "
                    f"{self.active} active): {what or 'request'} shed",
                    self.retry_after_s,
                )
            if self.queued >= self._max_queue:
                self.shed_total += 1
                if tenant is not None:
                    self.tenant_sheds[tenant] += 1
                raise AdmissionRejectedException(
                    f"admission queue full ({self.active} active, "
                    f"{self.queued} queued): {what or 'request'} shed",
                    self.retry_after_s,
                )
            self.queued += 1
            try:
                deadline = start + self._queue_timeout_s
                while self.active >= self._max_concurrent:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        self.shed_total += 1
                        if tenant is not None:
                            self.tenant_sheds[tenant] += 1
                        raise AdmissionRejectedException(
                            f"queued {self._queue_timeout_s * 1000:.0f} ms without "
                            f"a slot: {what or 'request'} shed",
                            self.retry_after_s,
                        )
                    self._cond.wait(remaining)
                self._admit(tenant)
            finally:
                self.queued -= 1
        if self.on_wait is not None:
            self.on_wait((time.monotonic() - start) * 1000.0)

    def _admit(self, tenant: Optional[str]) -> None:
        self.active += 1
        self.admitted_total += 1
        if tenant is not None:
            self._tenant_active[tenant] += 1

    def release(self, tenant: Optional[str] = None) -> None:
        with self._cond:
            self.active -= 1
            if tenant is not None:
                self._tenant_active[tenant] -= 1
                if self._tenant_active[tenant] <= 0:
                    del self._tenant_active[tenant]
            self._cond.notify()
