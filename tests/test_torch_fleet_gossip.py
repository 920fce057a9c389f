"""The port's SWIM gossip against the JAX package's, under one fake clock.

Each seeded schedule drives a 4-member gossip cluster in each package: the
same in-process transport, the same fake clock and no-op sleeper, and the
same events between periods (a member killed, a killed member restarted
with a fresh router and agent, a one-way partition opened or healed, a
flaky link that drops every fifth attempt on it). After every period the
two clusters must agree exactly: each live member's view (status,
incarnation, heartbeat, address and the fake-clock times it last heard and
suspected), epoch, counters, probe breakers, the jittered retry sleeps and
its router's ring, generation and view epoch.

Then the pieces: the precedence order ``_fresher`` on every triple pair,
``merge`` on seeded payloads, the refusals of a stopped agent and of a
payload without members, the gossip config and RSM wiring in the port, and
two port members gossiping over their gateways' ``POST /fleet/gossip``.
"""

from __future__ import annotations

import itertools
import json
import time

import numpy as np
import pytest

from tieredstorage_tpu import fleet as jax_fleet
from tieredstorage_tpu.fleet import gossip as jax_gossip
from tieredstorage_tpu_torch import fleet as port_fleet
from tieredstorage_tpu_torch.fleet import gossip as port_gossip
from tieredstorage_tpu_torch.rsm import RemoteStorageManager
from tieredstorage_tpu_torch.sidecar.http_gateway import SidecarHttpGateway

PACKAGES = {"jax": (jax_fleet, jax_gossip), "port": (port_fleet, port_gossip)}
NAMES = ("m0", "m1", "m2", "m3")


def _schedule(seed: int, periods: int = 40) -> list[list[tuple]]:
    """Events before each period, drawn once so both clusters see the
    same ones."""
    rng = np.random.default_rng(seed)
    alive, dead, cut = set(NAMES), {}, set()
    out = []
    for period in range(periods):
        events = []
        roll = rng.random()
        if (roll < 0.1 or period == 3) and len(alive) > 2:
            victim = sorted(alive)[int(rng.integers(0, len(alive)))]
            alive.discard(victim)
            dead[victim] = period
            events.append(("kill", victim))
        elif roll < 0.2 and any(period - p >= 8 for p in dead.values()):
            # Long enough gone to be declared dead first.
            back = sorted(n for n, p in dead.items() if period - p >= 8)[0]
            del dead[back]
            alive.add(back)
            events.append(("restart", back))
        elif roll < 0.26:
            src, dst = (NAMES[int(i)] for i in rng.choice(4, 2, replace=False))
            events.append(("cut", src, dst))
            cut.add((src, dst))
        elif roll < 0.34 and cut:
            pair = sorted(cut)[int(rng.integers(0, len(cut)))]
            cut.discard(pair)
            events.append(("heal", *pair))
        out.append(events)
    return out


class _Cluster:
    """Gossip agents of one package joined by an in-process transport."""

    def __init__(self, package: str, *, suspect_periods=3, dead_periods=3,
                 probe_retries=1, breaker_threshold=2):
        self.fleet, self.gossip = PACKAGES[package]
        self.clock = [0.0]
        self.alive = set(NAMES)
        self.cut: set = set()
        self.flaky = {("m0", "m2")}
        self.attempts: dict = {}
        self.sleeps: list = []
        self.seeds = {n: f"http://{n}" for n in NAMES}
        self.params = dict(interval_s=1.0, suspect_periods=suspect_periods,
                           dead_periods=dead_periods, probe_retries=probe_retries,
                           breaker_threshold=breaker_threshold)
        self.routers, self.agents = {}, {}
        for name in NAMES:
            self.start(name)

    def start(self, name: str) -> None:
        router = self.fleet.FleetRouter(name, vnodes=16)
        router.set_membership(self.seeds)
        self.routers[name] = router
        self.agents[name] = self.fleet.GossipAgent(
            router, **self.params, transport=self._transport_for(name),
            time_source=lambda: self.clock[0], sleeper=self.sleeps.append)

    def _transport_for(self, src):
        def transport(url, payload):
            dst = url.split("//")[1]
            n = self.attempts[(src, dst)] = self.attempts.get((src, dst), 0) + 1
            if dst not in self.alive or (src, dst) in self.cut:
                raise ConnectionRefusedError(f"{src}->{dst} unreachable")
            if (src, dst) in self.flaky and n % 5 == 0:
                raise ConnectionResetError(f"{src}->{dst} dropped")
            return self.agents[dst].on_gossip(payload)

        return transport

    def apply(self, event: tuple) -> None:
        kind, name = event[0], event[1]
        if kind == "kill":
            self.alive.discard(name)
        elif kind == "restart":
            self.start(name)
            self.alive.add(name)
        elif kind == "cut":
            self.cut.add((name, event[2]))
        else:
            self.cut.discard((name, event[2]))

    def tick(self) -> None:
        self.clock[0] += 1.0
        for name in sorted(self.alive):
            self.agents[name].run_period()

    def state(self) -> dict:
        out = {}
        for name in sorted(self.alive):
            agent, router = self.agents[name], self.routers[name]
            out[name] = {
                "members": {m: (v.url, v.incarnation, v.status, v.heartbeat, v.last_heard,
                                v.suspected_at) for m, v in agent.members().items()},
                "epoch": agent.epoch,
                "counters": (agent.periods, agent.probes_sent, agent.acks,
                             agent.probe_failures, agent.refutations, agent.deltas_applied,
                             agent.period_errors, agent.probe_skips, agent.retried_probes),
                "breakers": {t: s.name for t, s in agent.breakers.targets().items()},
                "board": (agent.breakers.opened, agent.breakers.half_opened,
                          agent.breakers.closed),
                "view": agent.routing_view(),
                "payload": agent.view_payload(),
                "ring": (router.instances, router.generation, router.view_epoch,
                         router.peers),
                "alive": agent.count_status("alive"),
            }
        return {"members": out, "sleeps": list(self.sleeps)}


@pytest.mark.parametrize("seed", range(6))
def test_gossip_cluster_equals_jax_after_every_period(seed):
    clusters = {name: _Cluster(name) for name in PACKAGES}
    states = []
    for events in _schedule(seed):
        for cluster in clusters.values():
            for event in events:
                cluster.apply(event)
            cluster.tick()
        got = {name: c.state() for name, c in clusters.items()}
        assert got["port"] == got["jax"], (len(states), events)
        states.append(got["port"])
    # The schedule exercised the state machine, not only the quiet path.
    statuses = {v[2] for s in states for m in s["members"].values() for v in m["members"].values()}
    assert statuses == {"alive", "suspect", "dead"}
    assert states[-1]["sleeps"]


@pytest.mark.parametrize("params", [
    {"suspect_periods": 2, "dead_periods": 50},
    {"suspect_periods": 1, "dead_periods": 1},
    {"probe_retries": 0, "breaker_threshold": 1},
    {"probe_retries": 3, "breaker_threshold": 5},
])
def test_gossip_cluster_parameters_equal_jax(params):
    clusters = {name: _Cluster(name, **params) for name in PACKAGES}
    for events in _schedule(100 + len(str(params)), periods=30):
        for cluster in clusters.values():
            for event in events:
                cluster.apply(event)
            cluster.tick()
        got = {name: c.state() for name, c in clusters.items()}
        assert got["port"] == got["jax"]


STATUSES = ("alive", "suspect", "dead")
TRIPLES = list(itertools.product((0, 1, 2), (0, 5, 6), STATUSES))


def test_precedence_order_equals_jax():
    for a, b in itertools.product(TRIPLES, TRIPLES):
        assert port_gossip._fresher(*a, *b) is jax_gossip._fresher(*a, *b), (a, b)
    assert port_gossip._STATUS_RANK == jax_gossip._STATUS_RANK


@pytest.mark.parametrize("seed", range(4))
def test_merge_of_seeded_payloads_equals_jax(seed):
    rng = np.random.default_rng(seed)
    payloads = []
    for _ in range(30):
        entries = []
        for _ in range(int(rng.integers(1, 5))):
            name = ["me", "x", "y", "z"][int(rng.integers(0, 4))]
            entry = {"name": name, "incarnation": int(rng.integers(0, 3)),
                     "status": STATUSES[int(rng.integers(0, 3))],
                     "heartbeat": int(rng.integers(0, 8)),
                     "url": [None, f"http://{name}", f"http://{name}:2"][int(rng.integers(0, 3))]}
            if rng.random() < 0.1:
                entry["incarnation"] = "NaN"
            if rng.random() < 0.05:
                entry["status"] = "zombie"
            entries.append(entry)
        heard = [None, "x", "y", "me"][int(rng.integers(0, 4))]
        payloads.append(({"members": entries}, heard))

    def run(package):
        fleet = PACKAGES[package][0]
        clock = [0.0]
        router = fleet.FleetRouter("me", vnodes=4)
        agent = fleet.GossipAgent(router, transport=lambda u, p: p,
                                  time_source=lambda: clock[0])
        out = []
        for payload, heard in payloads:
            clock[0] += 0.5
            changed = agent.merge(payload, heard_from=heard)
            out.append((changed, {m: (v.url, v.incarnation, v.status, v.heartbeat,
                                      v.last_heard, v.suspected_at)
                                  for m, v in agent.members().items()},
                        agent.epoch, agent.refutations, agent.deltas_applied,
                        router.generation, router.view_epoch, router.instances))
        agent.stop()
        return out

    assert run("port") == run("jax")


def test_refusals_equal_jax():
    def run(package):
        fleet, gossip = PACKAGES[package]
        agent = fleet.GossipAgent(fleet.FleetRouter("me", vnodes=4),
                                  transport=lambda u, p: p, time_source=lambda: 0.0)
        out = []
        with pytest.raises(ValueError) as err:
            agent.on_gossip({"from": "x"})
        out.append(str(err.value))
        payload = agent.view_payload()
        out.append(agent.on_gossip(payload) == payload)
        agent.stop()
        with pytest.raises(gossip.GossipStoppedError) as err:
            agent.on_gossip(payload)
        out.append(str(err.value))
        with pytest.raises(ValueError) as err:
            fleet.GossipAgent(fleet.FleetRouter("me"), interval_s=0)
        out.append(str(err.value))
        return out

    assert run("port") == run("jax")


def test_seed_never_resurrects_and_keeps_addresses_as_jax():
    def run(package):
        fleet = PACKAGES[package][0]
        agent = fleet.GossipAgent(fleet.FleetRouter("me", vnodes=4),
                                  transport=lambda u, p: p, time_source=lambda: 7.0)
        agent.merge({"members": [{"name": "c", "url": "http://c", "incarnation": 2,
                                  "status": "dead", "heartbeat": 4}]})
        agent.seed({"c": "http://c2", "d": None})
        agent.merge({"members": [{"name": "d", "url": None, "incarnation": 0,
                                  "status": "alive", "heartbeat": 1}]})
        agent.set_self_url("http://me")
        return ({m: (v.url, v.incarnation, v.status) for m, v in agent.members().items()},
                agent.self_url, agent.routing_view())

    assert run("port") == run("jax")


# ----------------------------------------------------------- RSM wiring
BASE = {"storage.backend.class": "tieredstorage_tpu_torch.storage.memory.InMemoryStorage",
        "chunk.size": 1024, "transform.device": "cpu"}


def test_rsm_builds_the_agent_from_the_gossip_keys():
    rsm = RemoteStorageManager()
    rsm.configure({**BASE, "fleet.enabled": True, "fleet.instance.id": "me",
                   "fleet.instances": ["me", "b=http://127.0.0.1:1"],
                   "fleet.gossip.enabled": True, "fleet.gossip.interval.ms": 500,
                   "fleet.gossip.probe.timeout.ms": 200, "fleet.gossip.suspect.periods": 4,
                   "fleet.gossip.dead.periods": 5, "retry.gossip.probe.attempts": 3,
                   "breaker.gossip.failure.threshold": 6})
    try:
        agent = rsm.gossip_agent
        assert (agent.interval_s, agent.probe_timeout_s) == (0.5, 0.2)
        assert (agent.suspect_after_s, agent.dead_after_s) == (2.0, 2.5)
        assert agent._probe_policy.max_attempts == 3
        assert agent.breakers._threshold == 6
        assert set(agent.members()) == {"me", "b"}
        payload = {"from": "b", "epoch": 0, "members": [
            {"name": "b", "url": "http://127.0.0.1:1", "incarnation": 0,
             "status": "alive", "heartbeat": 3}]}
        assert rsm.fleet_gossip(payload)["from"] == "me"
        assert agent.members()["b"].heartbeat == 3
    finally:
        rsm.close()
    with pytest.raises(Exception, match="fleet gossip is not enabled"):
        solo = RemoteStorageManager()
        solo.configure({**BASE, "fleet.enabled": True, "fleet.instance.id": "me"})
        try:
            solo.fleet_gossip({"members": []})
        finally:
            solo.close()


def test_port_members_gossip_over_their_gateways():
    """Two port members, gossip at 50 ms: the live daemons exchange views
    over POST /fleet/gossip; a member whose gateway and agent stop ages out
    of the survivor's ring (suspect, then dead) with an epoch."""
    rsms, gws = {}, {}
    for name in ("a", "b"):
        rsm = RemoteStorageManager()
        rsm.configure({**BASE, "fleet.enabled": True, "fleet.instance.id": name,
                       "fleet.gossip.enabled": True, "fleet.gossip.interval.ms": 50,
                       "fleet.gossip.probe.timeout.ms": 40,
                       "fleet.gossip.suspect.periods": 2, "fleet.gossip.dead.periods": 2})
        rsms[name], gws[name] = rsm, SidecarHttpGateway(rsm).start()
    try:
        peers = {n: f"http://127.0.0.1:{g.port}" for n, g in gws.items()}
        for rsm in rsms.values():
            rsm.set_fleet_peers(peers)
            rsm.start_fleet_gossip()
        deadline = time.monotonic() + 20
        while min(r.gossip_agent.acks for r in rsms.values()) < 3:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert rsms["a"].fleet_ping()["gossip"]["members"]["b"]["status"] == "alive"
        rsms["b"].gossip_agent.stop()
        gws["b"].stop()
        while "b" in rsms["a"].fleet_router.instances:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        ping = rsms["a"].fleet_ping()
        assert ping["gossip"]["members"]["b"]["status"] == "dead"
        assert ping["view_epoch"] >= 1 and ping["ring_instances"] == ["a"]
        body = json.dumps({"members": "none"}).encode()
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", gws["a"].port, timeout=10)
        conn.request("POST", "/fleet/gossip", body=body)
        resp = conn.getresponse()
        assert (resp.status, resp.read()) == \
            (400, b"ValueError: gossip payload has no members list")
        conn.close()
    finally:
        for g in gws.values():
            g.stop()
        for r in rsms.values():
            r.close()
