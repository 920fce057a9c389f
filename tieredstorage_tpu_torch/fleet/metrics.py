"""Fleet-mode observability: ring ownership, peer tier, coalescing, forwards.

Counterpart of tieredstorage_tpu/fleet/metrics.py, whole.

Group ``fleet-metrics``, same conventions as the resilience gauges
(metrics/rsm_metrics.py): components keep plain counters, this module
publishes them as supplier gauges, plus one latency family —
``fleet-forward-time`` avg/max with the log-scale ``fleet-forward-time-ms``
histogram — fed through ``FleetMetrics.record_forward`` (wired as
``PeerChunkCache.on_forward`` by the RSM).
"""

from __future__ import annotations

from tieredstorage_tpu_torch.metrics.core import (
    Avg,
    Histogram,
    Max,
    MetricName,
    MetricsRegistry,
)

FLEET_METRIC_GROUP = "fleet-metrics"


class FleetMetrics:
    """Recorder for the forward-latency family (the only non-gauge)."""

    def __init__(self, registry: MetricsRegistry) -> None:
        self.registry = registry

    def record_forward(self, ms: float) -> None:
        """One completed peer forward (request out -> framed chunks in)."""
        self.registry.sensor("fleet-forward-time").ensure_stats(lambda: [
            (MetricName.of("fleet-forward-time-avg", FLEET_METRIC_GROUP), Avg()),
            (MetricName.of("fleet-forward-time-max", FLEET_METRIC_GROUP), Max()),
            (
                MetricName.of(
                    "fleet-forward-time-ms", FLEET_METRIC_GROUP,
                    "peer forward latency histogram (ms, log-scale buckets)",
                ),
                Histogram(),
            ),
        ]).record(ms)


def register_fleet_metrics(
    registry: MetricsRegistry,
    *,
    router=None,
    peer_cache=None,
    gossip=None,
) -> None:
    """Publish fleet counters as gauges (group ``fleet-metrics``)."""

    def gauge(name: str, supplier, description: str = "", tags=None) -> None:
        registry.add_gauge(
            MetricName.of(name, FLEET_METRIC_GROUP, description, tags=tags or {}),
            supplier,
        )

    if router is not None:
        gauge("fleet-instances", lambda: float(len(router.instances)),
              "Fleet members in the current consistent-hash ring")
        gauge("fleet-vnodes", lambda: float(router.vnodes),
              "Virtual nodes per instance on the ring")
        gauge("fleet-membership-generation", lambda: float(router.generation),
              "Membership changes applied (starts at 1)")
        gauge("fleet-view-epoch", lambda: float(router.view_epoch),
              "Epoch of the last gossip-agreed membership view applied "
              "(0 = static membership only)")
        gauge(
            "fleet-local-ownership",
            lambda: float(router.local_ownership_fraction()),
            "Fraction of the hash circle owned by this instance (~1/N)",
        )
    if gossip is not None:
        from tieredstorage_tpu_torch.fleet.gossip import ALIVE, DEAD, SUSPECT

        gauge("fleet-members-alive", lambda: float(gossip.count_status(ALIVE)),
              "Members the gossip view currently believes alive")
        gauge("fleet-members-suspect", lambda: float(gossip.count_status(SUSPECT)),
              "Members under unrefuted suspicion (still in the ring)")
        gauge("fleet-members-dead", lambda: float(gossip.count_status(DEAD)),
              "Members declared dead and removed from the ring")
        gauge("fleet-gossip-periods-total", lambda: float(gossip.periods),
              "Gossip protocol periods run")
        gauge("fleet-gossip-probes-total", lambda: float(gossip.probes_sent),
              "Gossip probes sent (one per period with a live target)")
        gauge("fleet-gossip-acks-total", lambda: float(gossip.acks),
              "Gossip probes answered (response view merged)")
        gauge(
            "fleet-gossip-probe-failures-total",
            lambda: float(gossip.probe_failures),
            "Gossip probes that failed in transport (missed heartbeat)",
        )
        gauge("fleet-gossip-refutations-total", lambda: float(gossip.refutations),
              "Times this member refuted its own suspicion/obituary with "
              "an incarnation bump")
        gauge("fleet-gossip-deltas-total", lambda: float(gossip.deltas_applied),
              "Membership delta entries merged from received views")
        gauge(
            "fleet-gossip-probe-skips-total",
            lambda: float(gossip.probe_skips),
            "Probe candidates skipped because their breaker was refusing "
            "(deprioritized, not silenced)",
        )
        gauge(
            "fleet-gossip-retried-probes-total",
            lambda: float(gossip.retried_probes),
            "Probe round trips that needed at least one jittered retry",
        )
    if peer_cache is not None:
        gauge("fleet-replication-factor", lambda: float(peer_cache.replication),
              "Replica owners per segment key (ring successors tried in "
              "order on a non-owner miss)")
        gauge("fleet-forwards-total", lambda: float(peer_cache.forwards),
              "Chunk windows forwarded to their owner instance")
        gauge("fleet-peer-hits-total", lambda: float(peer_cache.peer_hits),
              "Forwards answered by the owner's chunk tier")
        gauge("fleet-failover-hits-total", lambda: float(peer_cache.failover_hits),
              "Forwards answered by a non-first replica owner (failover)")
        gauge("fleet-peer-misses-total", lambda: float(peer_cache.peer_misses),
              "Forwards the owner could not serve (local fallback)")
        gauge(
            "fleet-forward-failures-total",
            lambda: float(peer_cache.forward_failures),
            "Forwards that failed in transport (peer marked down)",
        )
        gauge("fleet-peers-down", lambda: float(peer_cache.peers_down),
              "Peers currently in the down cooldown")
        flight = peer_cache.singleflight
        gauge(
            "fleet-singleflight-leaders-total",
            lambda: float(flight.leaders),
            "Chunk windows actually resolved (one forward or backend read)",
        )
        gauge(
            "fleet-coalesced-fetches-total",
            lambda: float(flight.coalesced),
            "Concurrent duplicate fetches served by a leader's single "
            "resolve",
        )
        gauge(
            "fleet-singleflight-failures-total",
            lambda: float(flight.failures),
            "Flights whose leader failed (error shared by all joiners)",
        )
