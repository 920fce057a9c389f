"""SWIM-style gossip membership: probe → suspect → dead, epoch-numbered views.

Counterpart of tieredstorage_tpu/fleet/gossip.py, whole.

Das et al. ("SWIM: Scalable Weakly-consistent Infection-style Process Group
Membership Protocol", DSN '02) split membership into a *failure detector*
(periodic probes, bounded detection time) and a *disseminator* (membership
deltas piggybacked on the probe traffic). This module follows that shape
over the existing shim-wire gateway — ``POST /fleet/gossip`` is both the
probe and the delta exchange, ``GET /fleet/ping`` a cheap liveness/status
read — with the van Renesse heartbeat refinement: every member bumps a
local heartbeat counter each protocol period, and heartbeats spread
epidemically with the views, so second-hand freshness keeps a member ALIVE
even between direct contacts (one probe per period stays O(1) per member).

State machine per member (all timers counted in protocol periods,
``fleet.gossip.interval.ms``):

  ALIVE    --no heartbeat advance for suspect.periods-->  SUSPECT
  SUSPECT  --no refutation for dead.periods-->            DEAD
  SUSPECT/DEAD  --incarnation bump by the member-->       ALIVE

Suspicion is REFUTABLE: a member that hears itself called suspect/dead
re-announces itself with a higher *incarnation* number, which takes
precedence over any lower-incarnation state (the rejoin path after a
``kill -9`` + restart works the same way), and a relayed heartbeat advance
at the same incarnation recovers a false suspicion without the round trip.
Precedence is total and deterministic — ``(incarnation, heartbeat, status
rank)`` with DEAD > SUSPECT > ALIVE at an equal pair — so every member
converges to the same view from any delivery order.

The ring only changes when the agreed *routing view* (non-DEAD members)
changes: each change is numbered with a local, monotonically increasing
**view epoch** and applied through ``FleetRouter.set_membership(epoch=)``,
which refuses stale epochs. SUSPECT members stay in the ring — suspicion
must not thrash keys — so key movement stays bounded to the arcs of members
actually declared dead (or newly joined), exactly the consistent-hashing
guarantee, now under dynamic membership. ``fleet.instances`` becomes the
SEED set only: it bootstraps who to probe first, after which the fleet is
self-organizing.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import random
import threading
import time
import zlib
from typing import Callable, Mapping, Optional

from tieredstorage_tpu_torch.fleet.ring import FleetRouter
from tieredstorage_tpu_torch.utils import faults
from tieredstorage_tpu_torch.utils.locks import new_lock, note_mutation
from tieredstorage_tpu_torch.utils.retry import BreakerBoard, RetryPolicy, call_with_retry
from tieredstorage_tpu_torch.utils.tracing import NOOP_TRACER

log = logging.getLogger(__name__)

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"

#: Precedence rank at EQUAL (incarnation, heartbeat): dead overrides
#: suspect overrides alive (SWIM §4.2). A higher incarnation overrides any
#: lower-incarnation state (that is what makes suspicion refutable and
#: rejoin possible), and at equal incarnation a heartbeat advance overrides
#: any staler state (the van Renesse refinement: relayed liveness evidence
#: recovers a false suspicion — or even a false obituary — without an
#: incarnation round trip). The triple is a TOTAL order, so every member
#: reaches the same fixed point from any delivery order.
_STATUS_RANK = {ALIVE: 0, SUSPECT: 1, DEAD: 2}


@dataclasses.dataclass
class Member:
    """One fleet member as this agent currently believes it to be."""

    name: str
    url: Optional[str]
    incarnation: int = 0
    status: str = ALIVE
    #: Member-local period counter, bumped by the member itself each period
    #: and spread epidemically; an advance is liveness evidence no matter
    #: how many hops it travelled.
    heartbeat: int = 0
    #: Monotonic local time of the last heartbeat advance / direct contact.
    last_heard: float = 0.0
    #: Monotonic local time the member entered SUSPECT (0 otherwise).
    suspected_at: float = 0.0

    def entry(self) -> dict:
        """The wire form of this member for a gossip payload."""
        return {
            "name": self.name,
            "url": self.url,
            "incarnation": self.incarnation,
            "status": self.status,
            "heartbeat": self.heartbeat,
        }


def _fresher(
    inc_a: int, hb_a: int, status_a: str,
    inc_b: int, hb_b: int, status_b: str,
) -> bool:
    """Does state A take precedence over state B? Total order on
    (incarnation, heartbeat, status rank) — deterministic merge from any
    delivery order, the property the convergence tests pin."""
    return (inc_a, hb_a, _STATUS_RANK[status_a]) > (
        inc_b, hb_b, _STATUS_RANK[status_b]
    )


class GossipAgent:
    """The per-instance membership daemon.

    One protocol period (`run_period`, also steppable synchronously by
    tests and drills): bump own heartbeat, age peers through
    alive→suspect→dead, apply the resulting routing view to the ring if it
    changed (epoch-numbered), then probe the next non-dead peer round-robin
    with the full view piggybacked; the probe response view is merged back.
    Inbound exchanges (`on_gossip`, wired to POST /fleet/gossip) merge the
    sender's view and answer with ours — every exchange disseminates in
    both directions.
    """

    def __init__(
        self,
        router: FleetRouter,
        *,
        interval_s: float = 1.0,
        probe_timeout_s: float = 0.75,
        suspect_periods: int = 3,
        dead_periods: int = 3,
        probe_retries: int = 1,
        breaker_threshold: int = 2,
        tracer=NOOP_TRACER,
        transport: Optional[Callable[[str, dict], dict]] = None,
        time_source=time.monotonic,
        sleeper: Callable[[float], None] = time.sleep,
    ) -> None:
        if interval_s <= 0:
            raise ValueError(f"gossip interval must be > 0, got {interval_s}")
        self._router = router
        self.instance_id = router.instance_id
        self.interval_s = interval_s
        self.probe_timeout_s = probe_timeout_s
        self.suspect_after_s = suspect_periods * interval_s
        self.dead_after_s = dead_periods * interval_s
        self.tracer = tracer
        self._now = time_source
        self._transport = transport
        self._sleep = sleeper
        # Unified failure policy: a failed probe round trip gets
        # `probe_retries` extra attempts through the shared retry loop with
        # decorrelated jitter — seeded per instance id so a partitioned
        # fleet does NOT retry its probes in lockstep — and each member gets
        # a breaker (per-target board) that deprioritizes it in probe-target
        # selection after `breaker_threshold` consecutive failed rounds.
        self._probe_policy = RetryPolicy(
            max_attempts=1 + max(0, probe_retries),
            base_backoff_s=interval_s / 100.0,
            max_backoff_s=interval_s / 10.0,
            retryable=(Exception,),
        )
        self._jitter = random.Random(zlib.crc32(self.instance_id.encode("utf-8")))
        self.breakers = BreakerBoard(
            failure_threshold=max(1, breaker_threshold),
            cooldown_s=self.suspect_after_s,
            time_source=time_source,
        )
        self._lock = new_lock("gossip.GossipAgent._lock")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._clients: dict[str, object] = {}
        self._members: dict[str, Member] = {}
        self._probe_order: list[str] = []
        self._probe_idx = 0
        #: The routing view (non-DEAD members) last applied to the ring.
        self._applied_view: dict[str, Optional[str]] = {}
        #: Local view-epoch counter; bumped once per applied view change.
        self.epoch = 0
        # Counters (exported as fleet-metrics gauges).
        self.periods = 0
        self.probes_sent = 0
        self.acks = 0
        self.probe_failures = 0
        self.refutations = 0
        self.deltas_applied = 0
        self.period_errors = 0
        #: Probe candidates skipped because their breaker was refusing.
        self.probe_skips = 0
        #: Probe round trips that needed at least one retry attempt.
        self.retried_probes = 0
        self.seed(router.peers)

    # ------------------------------------------------------------- lifecycle
    def seed(self, peers: Mapping[str, Optional[str]]) -> None:
        """(Re)seed membership from {name: url|None} — the static
        ``fleet.instances`` list or ``--fleet-peers``. Known members keep
        their state (a reseed must not resurrect the dead); new ones start
        ALIVE with a fresh grace period."""
        now = self._now()
        with self._lock:
            for name, url in dict(peers).items():
                known = self._members.get(name)
                if known is None:
                    self._members[name] = Member(
                        name=name, url=url, last_heard=now
                    )
                elif url is not None:
                    known.url = url
            if self.instance_id not in self._members:
                self._members[self.instance_id] = Member(
                    name=self.instance_id, url=None, last_heard=now
                )
            self._applied_view = self._routing_view_locked()
            note_mutation("gossip.GossipAgent._members")

    @property
    def self_url(self) -> Optional[str]:
        """This instance's advertised gateway URL (from the seed set; the
        address peers will gossip onward for us)."""
        with self._lock:
            me = self._members.get(self.instance_id)
            return me.url if me is not None else None

    def set_self_url(self, url: str) -> None:
        """Advertise `url` as this instance's gateway (deployments that only
        know their port after bind)."""
        with self._lock:
            self._members[self.instance_id].url = url
            note_mutation("gossip.GossipAgent._members")

    def start(self) -> "GossipAgent":
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="fleet-gossip", daemon=True
                )
                self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            thread = self._thread
            self._thread = None
            clients = list(self._clients.values())
            self._clients.clear()
        if thread is not None:
            thread.join(timeout=5)
        for client in clients:
            client.close()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.run_period()
            except Exception:
                # The daemon must survive any single bad period (a peer
                # speaking garbage, a transport bug): count it loudly and
                # keep the failure detector running.
                with self._lock:
                    self.period_errors += 1
                    note_mutation("gossip.GossipAgent.period_errors")
                log.warning("gossip period failed", exc_info=True)
            self._stop.wait(self.interval_s)

    # ------------------------------------------------------------ the period
    def run_period(self) -> None:
        """One protocol period: heartbeat, age, re-ring, probe."""
        now = self._now()
        with self._lock:
            self.periods += 1
            me = self._members[self.instance_id]
            me.heartbeat += 1
            me.last_heard = now
            note_mutation("gossip.GossipAgent._members")
            transitions = self._age_members_locked(now)
            target = self._next_probe_target_locked()
            payload = self._view_payload_locked()
        for name, status in transitions:
            self.tracer.event("fleet.gossip.transition", member=name, status=status)
        self._apply_view_if_changed()
        if target is not None:
            self._probe(target, payload)

    def _age_members_locked(self, now: float) -> list[tuple[str, str]]:
        transitions: list[tuple[str, str]] = []
        for member in self._members.values():
            if member.name == self.instance_id or member.status == DEAD:
                continue
            if (
                member.status == ALIVE
                and now - member.last_heard > self.suspect_after_s
            ):
                member.status = SUSPECT
                member.suspected_at = now
                transitions.append((member.name, SUSPECT))
            elif (
                member.status == SUSPECT
                and now - member.suspected_at > self.dead_after_s
            ):
                member.status = DEAD
                transitions.append((member.name, DEAD))
        if transitions:
            note_mutation("gossip.GossipAgent._members")
        return transitions

    def _next_probe_target_locked(self) -> Optional[Member]:
        candidates = sorted(
            m.name for m in self._members.values()
            if m.name != self.instance_id and m.status != DEAD and m.url
        )
        if not candidates:
            return None
        if candidates != self._probe_order:
            self._probe_order = candidates
        # Breaker-aware selection: members whose breaker is refusing (opened
        # by consecutive failed probe rounds, still cooling down) are
        # DEPRIORITIZED, not silenced — skip them round-robin, but if every
        # candidate is refusing fall back to plain round-robin so the
        # failure detector keeps probing (breakers must never blind it).
        # `refusing` is a non-destructive read: the half-open probe slot is
        # only consumed by on_failure/on_success after the round completes.
        for _ in range(len(self._probe_order)):
            self._probe_idx = (self._probe_idx + 1) % len(self._probe_order)
            name = self._probe_order[self._probe_idx]
            if not self.breakers.for_target(name).refusing:
                return self._members[name]
            self.probe_skips += 1
            note_mutation("gossip.GossipAgent.probe_skips")
        self._probe_idx = (self._probe_idx + 1) % len(self._probe_order)
        return self._members[self._probe_order[self._probe_idx]]

    def _on_probe_retry(
        self, attempt: int, delay_s: float, exc: BaseException
    ) -> None:
        with self._lock:
            self.retried_probes += 1
            note_mutation("gossip.GossipAgent.retried_probes")

    def _probe(self, target: Member, payload: dict) -> None:
        with self._lock:
            self.probes_sent += 1
            note_mutation("gossip.GossipAgent.probes_sent")
        breaker = self.breakers.for_target(target.name)
        try:
            # The shared retry loop owns the in-round retry (decorrelated
            # jitter, instance-seeded so partitioned members desynchronize);
            # the breaker is accounted per probe ROUND, not per attempt —
            # one flaky round trip that recovers on retry is a success.
            response = call_with_retry(
                lambda: self._exchange(target.url, payload),
                policy=self._probe_policy,
                site="gossip.probe",
                on_retry=self._on_probe_retry,
                rng=self._jitter,
                sleep=self._sleep,
            )
        except Exception as e:
            # A failed probe is merely a missed heartbeat refresh: the
            # age-out state machine does the declaring, never one miss.
            breaker.on_failure()
            with self._lock:
                self.probe_failures += 1
                note_mutation("gossip.GossipAgent.probe_failures")
            self.tracer.event(
                "fleet.gossip.probe_failed", member=target.name,
                reason=type(e).__name__,
            )
            return
        breaker.on_success()
        with self._lock:
            self.acks += 1
            note_mutation("gossip.GossipAgent.acks")
        self.merge(response, heard_from=target.name)

    def _exchange(self, url: str, payload: dict) -> dict:
        """One gossip round trip; the injectable seam for tests."""
        faults.fire("gossip.probe", url or "")
        if self._transport is not None:
            return self._transport(url, payload)
        client = self._client(url)
        resp = client.request(
            "POST", "/fleet/gossip",
            body=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            idempotent=False,
        )
        if resp.status != 200:
            raise GossipExchangeError(f"gossip peer answered {resp.status}")
        return json.loads(resp.body)

    def _client(self, url: str):
        from tieredstorage_tpu_torch.storage.httpclient import NO_RETRY, HttpClient

        with self._lock:
            client = self._clients.get(url)
            if client is None:
                client = HttpClient(url, timeout=self.probe_timeout_s, retry=NO_RETRY)
                self._clients[url] = client
        return client

    # ------------------------------------------------------------- the views
    def _view_payload_locked(self) -> dict:
        return {
            "from": self.instance_id,
            "epoch": self.epoch,
            "members": [m.entry() for m in self._members.values()],
        }

    def view_payload(self) -> dict:
        """This agent's full view in wire form (also the ping status body)."""
        with self._lock:
            return self._view_payload_locked()

    def _routing_view_locked(self) -> dict[str, Optional[str]]:
        return {
            m.name: m.url for m in self._members.values() if m.status != DEAD
        }

    def routing_view(self) -> dict[str, Optional[str]]:
        with self._lock:
            return self._routing_view_locked()

    def members(self) -> dict[str, Member]:
        with self._lock:
            return {m.name: dataclasses.replace(m) for m in self._members.values()}

    def count_status(self, status: str) -> int:
        with self._lock:
            return sum(1 for m in self._members.values() if m.status == status)

    def _apply_view_if_changed(self) -> None:
        with self._lock:
            view = self._routing_view_locked()
            if view == self._applied_view:
                return
            self._applied_view = view
            self.epoch += 1
            epoch = self.epoch
        # The router takes its own lock; called outside ours so the lock
        # order stays gossip -> ring with no blocking work under either.
        self._router.set_membership(view, epoch=epoch)
        self.tracer.event(
            "fleet.gossip.view", epoch=epoch, members=len(view),
        )

    # ---------------------------------------------------------------- merges
    def on_gossip(self, payload: Mapping) -> dict:
        """Handle one inbound exchange (POST /fleet/gossip): merge the
        sender's view, treat the contact itself as first-hand liveness
        evidence for the sender, and answer with our full view."""
        if self._stop.is_set():
            # A stopped agent is a member that LEFT: answering here would
            # count as first-hand liveness and keep this instance in every
            # ring forever (keep-alive handler threads outlive a gateway
            # stop, so "closed but still answering" is a real state).
            raise GossipStoppedError("gossip agent is stopped")
        members = payload.get("members")
        if not isinstance(members, list):
            raise ValueError("gossip payload has no members list")
        self.merge(payload, heard_from=payload.get("from"))
        return self.view_payload()

    def merge(self, payload: Mapping, *, heard_from: Optional[str] = None) -> int:
        """Fold a received view into ours by (incarnation, status, heartbeat)
        precedence; returns the number of entries that changed anything.

        `heard_from` names the member we are talking to directly: that is
        first-hand evidence it is alive RIGHT NOW, which revives even a
        locally-DEAD entry (with an incarnation above the dead one, so the
        revival wins the gossip race against the stale obituary)."""
        now = self._now()
        changed = 0
        refuted = False
        with self._lock:
            for entry in payload.get("members", ()):
                try:
                    name = str(entry["name"])
                    inc = int(entry["incarnation"])
                    status = str(entry["status"])
                    heartbeat = int(entry.get("heartbeat", 0))
                except (KeyError, TypeError, ValueError):
                    continue  # one malformed entry must not poison the view
                if status not in _STATUS_RANK:
                    continue
                url = entry.get("url") or None
                if name == self.instance_id:
                    me = self._members[self.instance_id]
                    if status != ALIVE and inc >= me.incarnation:
                        # Someone is spreading my obituary: refute it with a
                        # higher incarnation (SWIM §4.2); the next exchanges
                        # spread alive@inc+1 which beats suspect/dead@inc.
                        me.incarnation = inc + 1
                        self.refutations += 1
                        note_mutation("gossip.GossipAgent.refutations")
                        refuted = True
                        changed += 1
                    continue
                known = self._members.get(name)
                if known is None:
                    self._members[name] = Member(
                        name=name, url=url, incarnation=inc, status=status,
                        heartbeat=heartbeat,
                        last_heard=now,
                        suspected_at=now if status == SUSPECT else 0.0,
                    )
                    changed += 1
                    continue
                if url is not None and known.url != url:
                    known.url = url
                    changed += 1
                if _fresher(
                    inc, heartbeat, status,
                    known.incarnation, known.heartbeat, known.status,
                ):
                    # An incarnation advance restarts the member's heartbeat
                    # sequence (a rejoin after kill -9 starts from 0), so
                    # the winning entry's heartbeat replaces — never maxes
                    # with — the old one. A winning ALIVE that advanced
                    # (incarnation, heartbeat) is liveness evidence no
                    # matter how many hops it travelled.
                    if status == ALIVE and (inc, heartbeat) > (
                        known.incarnation, known.heartbeat
                    ):
                        known.last_heard = now
                        known.suspected_at = 0.0
                    elif status == SUSPECT and known.status != SUSPECT:
                        known.suspected_at = now
                    known.incarnation = inc
                    known.heartbeat = heartbeat
                    known.status = status
                    changed += 1
            if heard_from and heard_from != self.instance_id:
                direct = self._members.get(heard_from)
                if direct is not None:
                    direct.last_heard = now
                    if direct.status == DEAD:
                        # First-hand contact with a "dead" member: it is
                        # back (kill -9 + restart); give it an incarnation
                        # that outranks its obituary.
                        direct.incarnation = direct.incarnation + 1
                        changed += 1
                    if direct.status != ALIVE:
                        direct.status = ALIVE
                        direct.suspected_at = 0.0
                        changed += 1
            if changed:
                self.deltas_applied += changed
                note_mutation("gossip.GossipAgent._members")
        if refuted:
            self.tracer.event("fleet.gossip.refuted", member=self.instance_id)
        if changed:
            self._apply_view_if_changed()
        return changed


class GossipExchangeError(RuntimeError):
    """A gossip probe round trip failed at the HTTP layer."""


class GossipStoppedError(RuntimeError):
    """An inbound exchange reached an agent that has already stopped."""
