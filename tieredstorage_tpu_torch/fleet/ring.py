"""Consistent-hash segment routing for the gateway fleet.

Counterpart of tieredstorage_tpu/fleet/ring.py, whole.

Karger et al. ("Consistent Hashing and Random Trees", STOC '97): instances
own arcs of a fixed hash circle, keys map to the first instance point at or
after their own hash, and membership changes move only the keys on the arcs
adjacent to the joining/leaving instance — every other key keeps its owner.
Virtual nodes (``fleet.vnodes`` points per instance) smooth the arc-length
variance so ownership fractions concentrate near 1/N.

The hash is MD5 over stable text labels (``<instance>#<vnode>`` for ring
points, the raw object key for lookups), so the mapping is deterministic
across processes, restarts, and Python versions — every fleet member computes
the identical ring from the identical membership list, with no coordination
service in the loop. (MD5 here is a mixing function, not a security
boundary; routing does not authenticate anything.)

Routing granularity is the segment OBJECT KEY, not the chunk: all chunks of
one hot segment land in exactly one instance's cache, which is what makes
the peer tier (fleet/peer_cache.py) a single hop.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Mapping, Optional

from tieredstorage_tpu_torch.utils.tracing import NOOP_TRACER
from tieredstorage_tpu_torch.utils.locks import new_lock

#: Full circle size: MD5-derived points are taken mod 2^64.
_RING_BITS = 64
_RING_SIZE = 1 << _RING_BITS


def _point(label: str) -> int:
    return int.from_bytes(
        hashlib.md5(label.encode("utf-8")).digest()[:8], "big"
    )


class HashRing:
    """Immutable consistent-hash circle over a set of instance names."""

    def __init__(self, instances, vnodes: int = 64) -> None:
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        listed = list(instances)
        if not listed:
            raise ValueError("a hash ring needs at least one instance")
        names = sorted(set(listed))
        if len(names) != len(listed):
            # A duplicated name would silently halve the fleet's real
            # capacity (two "members" sharing one arc set) and desync rings
            # across members that happened to dedupe differently.
            dupes = sorted({n for n in names if listed.count(n) > 1})
            raise ValueError(f"duplicate ring instances: {', '.join(dupes)}")
        self.vnodes = vnodes
        self.instances = tuple(names)
        points: list[tuple[int, str]] = []
        for name in names:
            for v in range(vnodes):
                points.append((_point(f"{name}#{v}"), name))
        # Ties (astronomically unlikely) break by instance name so every
        # member sorts the identical ring.
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [o for _, o in points]

    def owner(self, key: str) -> str:
        """The instance owning `key`: first ring point at or after its hash,
        wrapping at the top of the circle."""
        idx = bisect.bisect_left(self._points, _point(key))
        if idx == len(self._points):
            idx = 0
        return self._owners[idx]

    def owners(self, key: str, n: int) -> list[str]:
        """The first `n` DISTINCT instances walking the circle from `key` —
        the failover preference order (owner first, then successors)."""
        start = bisect.bisect_left(self._points, _point(key))
        out: list[str] = []
        for i in range(len(self._points)):
            candidate = self._owners[(start + i) % len(self._points)]
            if candidate not in out:
                out.append(candidate)
                if len(out) == n:
                    break
        return out

    def ownership_fraction(self, instance: str) -> float:
        """Fraction of the hash circle whose keys map to `instance` (the
        ring-ownership gauge; ~1/N with enough vnodes)."""
        if instance not in self.instances:
            return 0.0
        owned = 0
        for i, owner in enumerate(self._owners):
            prev = self._points[i - 1] if i > 0 else self._points[-1] - _RING_SIZE
            if owner == instance:
                owned += self._points[i] - prev
        return owned / _RING_SIZE


def parse_instances(entries) -> dict[str, Optional[str]]:
    """``fleet.instances`` entries to {name: base_url|None}.

    Each entry is ``name=http://host:port`` (a routable peer) or a bare
    ``name`` (address unknown to this member — typically itself; the router
    never forwards to an address-less member, it serves locally)."""
    out: dict[str, Optional[str]] = {}
    for entry in entries:
        text = str(entry).strip()
        if not text:
            continue
        name, sep, url = text.partition("=")
        name = name.strip()
        if not name:
            raise ValueError(f"fleet instance entry {entry!r} has no name")
        if name in out:
            raise ValueError(f"duplicate fleet instance {name!r}")
        out[name] = url.strip() or None if sep else None
    return out


class FleetRouter:
    """Maps object keys to owner instances over a swappable HashRing.

    Membership is replaceable at runtime (``set_membership``) because
    addresses are often only known after gateways bind their ports, and
    because the fleet shrinks when an instance is declared dead; the ring is
    rebuilt atomically and the consistent-hash property bounds the keys that
    change owner to the arcs of the joining/leaving instances."""

    def __init__(
        self,
        instance_id: str,
        *,
        vnodes: int = 64,
        tracer=NOOP_TRACER,
    ) -> None:
        if not instance_id:
            raise ValueError("fleet.instance.id must be non-empty")
        self.instance_id = instance_id
        self.vnodes = vnodes
        self.tracer = tracer
        self._lock = new_lock("ring.FleetRouter._lock")
        self._peers: dict[str, Optional[str]] = {instance_id: None}
        self._ring = HashRing([instance_id], vnodes)
        #: Membership generations applied (starts at 1 for the solo ring).
        self.generation = 1
        #: Epoch of the last agreed view applied (0 = static membership
        #: only). Gossip (fleet/gossip.py) numbers its views so a delayed
        #: delivery can never roll the ring back to an older membership.
        self.view_epoch = 0

    def set_membership(
        self, peers: Mapping[str, Optional[str]], *, epoch: Optional[int] = None
    ) -> bool:
        """Replace the fleet membership with {name: base_url|None}. The
        local instance is always a member (added if absent).

        `epoch` numbers gossip-agreed views: an epoch at or below the last
        applied one is stale (a reordered delivery) and is ignored, so
        routing stays a pure function of the NEWEST agreed view. Un-numbered
        calls (bootstrap / tests / --fleet-peers) always apply. Returns
        whether the view was applied."""
        members = dict(peers)
        members.setdefault(self.instance_id, None)
        ring = HashRing(members, self.vnodes)
        with self._lock:
            if epoch is not None:
                if epoch <= self.view_epoch:
                    return False
                self.view_epoch = epoch
            self._peers = members
            self._ring = ring
            self.generation += 1
        self.tracer.event(
            "fleet.membership", instances=len(members),
            generation=self.generation, epoch=epoch if epoch is not None else 0,
        )
        return True

    def remove_instance(self, name: str) -> None:
        """Drop a dead member; its arcs redistribute to the ring successors
        (every other key keeps its owner). Removing the local instance or
        the last member is refused."""
        with self._lock:
            peers = dict(self._peers)
        if name == self.instance_id or name not in peers:
            return
        del peers[name]
        self.set_membership(peers)

    @property
    def ring(self) -> HashRing:
        with self._lock:
            return self._ring

    @property
    def peers(self) -> dict[str, Optional[str]]:
        with self._lock:
            return dict(self._peers)

    @property
    def instances(self) -> tuple[str, ...]:
        return self.ring.instances

    def owner(self, key: str) -> str:
        return self.ring.owner(key)

    def is_local(self, key: str) -> bool:
        return self.owner(key) == self.instance_id

    def route(self, key: str) -> tuple[str, Optional[str]]:
        """(owner, base_url): base_url is None when the key is locally owned
        or the owner's address is unknown (both mean: serve locally)."""
        with self._lock:
            owner = self._ring.owner(key)
            if owner == self.instance_id:
                return owner, None
            return owner, self._peers.get(owner)

    def route_owners(self, key: str, r: int) -> list[tuple[str, Optional[str]]]:
        """The R replica owners of `key` as ordered (owner, base_url) pairs —
        ring-successor preference order, one consistent (ring, peers)
        snapshot. base_url is None for the local instance and for members
        whose address is unknown (both mean: serve locally when reached)."""
        with self._lock:
            owners = self._ring.owners(key, r)
            return [
                (o, None if o == self.instance_id else self._peers.get(o))
                for o in owners
            ]

    def peer_url(self, name: str) -> Optional[str]:
        with self._lock:
            return self._peers.get(name)

    def local_ownership_fraction(self) -> float:
        return self.ring.ownership_fraction(self.instance_id)
