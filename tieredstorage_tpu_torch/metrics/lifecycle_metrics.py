"""Lifecycle observability: `lifecycle-metrics` supplier gauges.

Counterpart of tieredstorage_tpu/metrics/lifecycle_metrics.py.

Same pattern as scrub/metrics.py: the UploadIntentJournal and
RecoverySweeper keep plain counters; this module publishes them as gauges
so the Prometheus exporter serves `lifecycle_metrics_*` series.  The
quarantine and pending-orphan gauges are the surface to alert on: a non-zero `lifecycle-quarantined-manifests` means segments exist
that the RSM is refusing to serve.
"""

from __future__ import annotations

from tieredstorage_tpu_torch.metrics.core import MetricName, MetricsRegistry

LIFECYCLE_METRIC_GROUP = "lifecycle-metrics"


def register_lifecycle_metrics(
    registry: MetricsRegistry, journal=None, sweeper=None, scheduler=None
) -> None:
    """Journal + sweeper counters as supplier gauges."""

    def gauge(name: str, supplier, description: str = "") -> None:
        registry.add_gauge(
            MetricName.of(name, LIFECYCLE_METRIC_GROUP, description), supplier
        )

    if journal is not None:
        gauge("lifecycle-journal-pending-uploads",
              lambda: float(journal.pending_upload_count),
              "Upload intents with no commit/rollback yet (in-flight copies "
              "plus anything a crash stranded)")
        gauge("lifecycle-journal-pending-tombstones",
              lambda: float(journal.pending_tombstone_count),
              "Delete tombstones not yet fully applied")
        gauge("lifecycle-journal-appends-total",
              lambda: float(journal.appends_total))
        gauge("lifecycle-journal-append-failures-total",
              lambda: float(journal.append_failures_total),
              "Journal appends that failed (critical ones also failed the "
              "guarded operation; best-effort ones left the entry for the "
              "sweeper)")
        gauge("lifecycle-journal-torn-records-total",
              lambda: float(journal.torn_records_total),
              "Unparseable journal lines tolerated during replay (the "
              "artifact of dying mid-append)")
        gauge("lifecycle-journal-compactions-total",
              lambda: float(journal.compactions_total))
        gauge("lifecycle-journal-commits-total",
              lambda: float(journal.commits_total))
        gauge("lifecycle-journal-rollbacks-total",
              lambda: float(journal.rollbacks_total))
    if sweeper is not None:
        gauge("lifecycle-sweeps-total", lambda: float(sweeper.sweeps))
        gauge("lifecycle-orphans-deleted-total",
              lambda: float(sweeper.orphans_deleted_total),
              "Manifest-unreachable objects the sweeper deleted")
        gauge("lifecycle-orphans-pending",
              lambda: float(sweeper.orphans_pending),
              "Orphan candidates inside their grace window")
        gauge("lifecycle-tombstones-gcd-total",
              lambda: float(sweeper.tombstones_gcd_total),
              "Delete tombstones completed and GC'd by the sweeper")
        gauge("lifecycle-quarantined-manifests",
              lambda: float(len(sweeper.quarantined_manifests)),
              "Manifests currently quarantined (unreadable or referencing "
              "missing objects) — never served while non-zero")
        gauge("lifecycle-quarantines-total",
              lambda: float(sweeper.quarantines_total),
              "Manifests ever newly quarantined across all sweeps")
        gauge("lifecycle-journal-resolved-total",
              lambda: float(sweeper.journal_resolved_total),
              "Journal entries the sweeper resolved from manifest "
              "reachability (crash-lost commits/rollbacks re-derived)")
        gauge("lifecycle-sweep-invariant-blocks-total",
              lambda: float(sweeper.invariant_blocks_total),
              "Deletions refused by the one-sidedness chokepoint (any "
              "non-zero value is a bug, by construction)")
        gauge("lifecycle-sweep-failures-total",
              lambda: float(sweeper.sweep_failures_total))
    if scheduler is not None:
        gauge("lifecycle-sweeper-state",
              lambda: float(scheduler.state_code),
              "0 = stopped, 1 = idle, 2 = sweeping")
