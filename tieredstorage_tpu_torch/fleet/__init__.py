"""Fleet mode: sharded gateway instances behind consistent-hash routing.

Counterpart of tieredstorage_tpu/fleet/, whole: the same modules, names,
lock names and mutation sites.

The scale-out tier: N sidecar instances form a fleet —
``fleet/ring.py`` maps every segment object key to one owner instance on a
consistent-hash ring (virtual nodes, bounded key movement under membership
change), ``fleet/peer_cache.py`` resolves non-owner misses with one hop to
the owner's chunk cache over the shim-wire gateway (``GET /chunk``), and
``fleet/singleflight.py`` collapses concurrent duplicate fetches — local or
forwarded — to exactly one backend read. Each key has R replica owners
(``fleet.replication.factor`` ring successors, tried in order) so an
instance death loses no cache tier, and ``fleet/gossip.py`` runs SWIM-style
gossip membership (probe → suspect → dead, epoch-numbered views) so the
fleet self-organizes through joins, failures, and rolling restarts.
``fleet/metrics.py`` exports the ``fleet-metrics`` group, and
``fleet/telemetry.py`` aggregates every member's metric samples into one
fleet-wide scrape (sum/max/histogram-merge semantics per stat) over the
gateway's ``GET /fleet/telemetry`` route.
"""

from tieredstorage_tpu_torch.fleet.gossip import GossipAgent
from tieredstorage_tpu_torch.fleet.metrics import (
    FLEET_METRIC_GROUP,
    FleetMetrics,
    register_fleet_metrics,
)
from tieredstorage_tpu_torch.fleet.peer_cache import (
    PeerChunkCache,
    decode_chunk_frames,
    encode_chunk_frames,
)
from tieredstorage_tpu_torch.fleet.ring import FleetRouter, HashRing, parse_instances
from tieredstorage_tpu_torch.fleet.singleflight import SingleFlight
from tieredstorage_tpu_torch.fleet.telemetry import (
    FleetTelemetry,
    export_samples,
    merge_samples,
)

__all__ = [
    "FLEET_METRIC_GROUP",
    "FleetMetrics",
    "FleetRouter",
    "FleetTelemetry",
    "GossipAgent",
    "HashRing",
    "PeerChunkCache",
    "SingleFlight",
    "export_samples",
    "merge_samples",
    "decode_chunk_frames",
    "encode_chunk_frames",
    "parse_instances",
    "register_fleet_metrics",
]
