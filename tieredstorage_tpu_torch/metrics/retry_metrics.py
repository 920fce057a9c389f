"""The ``retry-metrics`` group: the failure-policy plane made observable.

Counterpart of tieredstorage_tpu/metrics/retry_metrics.py: the same group,
gauge names and histogram. One policy layer owns backoff everywhere
(utils/retry.py), so one metrics group shows its behaviour everywhere:

- per-site ledger gauges — attempts / retries / give-ups / summed backoff
  and the derived *amplification factor* (attempts per originating call);
- a process-wide ``retry-backoff-time-ms`` histogram fed by the ledger's
  ``on_backoff`` hook (every sleep the retry loop schedules, any seam);
- breaker gauges — the storage breaker's state and transition counters, and
  per-target *board* aggregates (opened / half-opened / closed transitions,
  currently-refusing and known-target counts) for the callers that keep a
  board;
- fault-plane gauges — armed flag, per-site calls seen, and injections
  fired, read live so a plane installed mid-run is visible.

Registered by the RSM next to the resilience metrics; every supplier is a
closure over live objects, so scraping is always current with no recording
hooks inside the policy plane itself.
"""

from __future__ import annotations

from typing import Mapping, Optional

from tieredstorage_tpu_torch.metrics.core import Histogram, MetricName, MetricsRegistry
from tieredstorage_tpu_torch.utils import faults as faults_mod
from tieredstorage_tpu_torch.utils import retry as retry_mod

RETRY_METRIC_GROUP = "retry-metrics"

#: The seam sites the ledger gauges are pre-registered for (gauge names
#: must exist before traffic does; the ledger itself is lazy).
LEDGER_SITES = (
    "storage.upload",
    "storage.fetch",
    "storage.delete",
    "storage.list",
    "peer.forward",
    "gossip.probe",
    "device.launch",
)


def register_retry_metrics(
    registry: MetricsRegistry,
    *,
    ledger: Optional[retry_mod.RetryLedger] = None,
    breakers: Optional[Mapping[str, retry_mod.CircuitBreaker]] = None,
    boards: Optional[Mapping[str, retry_mod.BreakerBoard]] = None,
) -> None:
    """Publish the retry ledger, breakers/boards, and fault plane."""
    led = ledger if ledger is not None else retry_mod.ledger()

    def gauge(name: str, supplier, description: str = "") -> None:
        registry.add_gauge(
            MetricName.of(name, RETRY_METRIC_GROUP, description), supplier
        )

    for site in LEDGER_SITES:
        slug = site.replace(".", "-")
        gauge(f"retry-{slug}-attempts-total",
              lambda s=site: led.value(s, "attempts"),
              f"Attempts the retry loop made at the {site} seam "
              "(first tries included)")
        gauge(f"retry-{slug}-retries-total",
              lambda s=site: led.value(s, "retries"),
              f"Attempts beyond a call's first at the {site} seam")
        gauge(f"retry-{slug}-giveups-total",
              lambda s=site: led.value(s, "giveups"),
              f"Calls at the {site} seam that exhausted the policy "
              "(attempt cap, retry gate, or deadline budget)")
        gauge(f"retry-{slug}-backoff-ms-total",
              lambda s=site: led.value(s, "backoff_ms"),
              f"Summed backoff (ms) slept before retries at the {site} seam")
        gauge(f"retry-{slug}-amplification",
              lambda s=site: led.amplification(s),
              f"Attempts per originating call at the {site} seam (1.0 = "
              "no retries; the chaos matrix gates this at the policy cap)")

    backoff = registry.sensor("retry.backoff").ensure_stats(lambda: [
        (
            MetricName.of(
                "retry-backoff-time-ms", RETRY_METRIC_GROUP,
                "Every backoff the retry loop sleeps, any seam (ms, "
                "log-scale buckets)",
            ),
            Histogram(),
        ),
    ])
    led.on_backoff = backoff.record

    for name, breaker in (breakers or {}).items():
        gauge(f"breaker-{name}-state",
              lambda b=breaker: float(b.state_code),
              f"{name} breaker state (0=closed, 1=half-open, 2=open)")
        gauge(f"breaker-{name}-opens-total",
              lambda b=breaker: float(b.opens),
              f"Times the {name} breaker opened")
        gauge(f"breaker-{name}-half-opens-total",
              lambda b=breaker: float(b.half_opens),
              f"Times the {name} breaker admitted a half-open probe")
        gauge(f"breaker-{name}-closes-total",
              lambda b=breaker: float(b.closes),
              f"Times the {name} breaker re-closed after a probe succeeded")
        gauge(f"breaker-{name}-fast-fails-total",
              lambda b=breaker: float(b.fast_fails),
              f"Calls the {name} breaker refused without touching the "
              "target")

    for name, board in (boards or {}).items():
        gauge(f"breaker-board-{name}-opened-total",
              lambda b=board: float(b.opened),
              f"Breaker open transitions across all {name} targets")
        gauge(f"breaker-board-{name}-half-opened-total",
              lambda b=board: float(b.half_opened),
              f"Half-open probe admissions across all {name} targets")
        gauge(f"breaker-board-{name}-closed-total",
              lambda b=board: float(b.closed),
              f"Breaker re-close transitions across all {name} targets")
        gauge(f"breaker-board-{name}-open",
              lambda b=board: float(b.open_count()),
              f"{name} targets currently refusing calls")
        gauge(f"breaker-board-{name}-known",
              lambda b=board: float(b.known_count()),
              f"{name} targets a breaker has been created for")

    # Fault-plane gauges read the module-level plane LIVE: a plane
    # installed after registration (TSTPU_FAULTS, a test) is visible
    # without re-wiring.
    def _plane_stat(field: str) -> float:
        plane = faults_mod.plane()
        if plane is None:
            return 0.0
        snap = plane.snapshot()
        if field == "calls":
            return float(sum(snap["calls"].values()))
        return float(snap["injections"])

    gauge("faults-armed",
          lambda: 1.0 if faults_mod.enabled() else 0.0,
          "Whether a fault plane is installed (TSTPU_FAULTS / faults.spec)")
    gauge("faults-seam-calls-total",
          lambda: _plane_stat("calls"),
          "I/O-seam calls the fault plane has evaluated")
    gauge("faults-injections-total",
          lambda: _plane_stat("injections"),
          "Faults the plane actually fired (error/latency/partial/flaky)")
