"""Deterministic fault injection at the named I/O seams: the FaultPlane.

Counterpart of tieredstorage_tpu/utils/faults.py, whole. `faults/schedule.py`
injects storage-op faults behind one decorator; this module generalises the
idea into a process-wide **FaultPlane** with named injection points threaded
through the I/O seams the retry policy (utils/retry.py) guards. A rule is

    site ":" kind ["=" arg] ["@" trigger] ["~" match]

- site: ``storage.read`` | ``storage.write`` | ``peer.forward`` |
  ``gossip.probe`` | ``device.launch`` | ``lifecycle.journal`` |
  ``lifecycle.sweep`` | ``*`` (any site)
- kind:
    - ``error`` — raise FaultInjectedError (a StorageBackendException, so
      it propagates — and classifies as retryable — exactly like a real
      backend failure)
    - ``latency`` — sleep ``arg`` milliseconds (default 10) before the
      call; ``latency=10..250`` draws uniformly from [10, 250] ms with the
      plane's seeded RNG
    - ``partial`` — keep only the first ``arg`` bytes of the payload
      (default: half); data-bearing sites only (``storage.read``,
      ``peer.forward``) — the seam applies it via :func:`mutate`, and the
      downstream GCM tag check must refuse to serve the torn bytes
    - ``flaky`` — error on the site's first ``arg`` calls (default 10),
      healthy afterwards: the flaky-then-heal shape
- trigger (same grammar as faults/schedule.py): ``@N`` (Nth call),
  ``@every=K``, ``@from=N``, ``@p=P`` (seeded RNG), absent = every call
- match: only fire when ``match`` is a substring of the seam's key (object
  key, peer URL, member id, work class)

The seams this package has: ``device.launch`` (transform/batcher.py, keyed
by work class), ``storage.read`` (fetch/chunk_manager.py and the RSM's
index reads), ``storage.write`` (the RSM's upload chokepoint),
``lifecycle.journal`` (storage/lifecycle.py) and ``lifecycle.sweep``
(scrub/sweeper.py). ``peer.forward`` and ``gossip.probe`` belong to the
fleet tier, which is not ported; rules naming them parse and never fire.

Arming mirrors the lock witness (utils/locks.py): set ``TSTPU_FAULTS`` to
the rule spec (rules joined with ``;`` or ``,``), optionally
``TSTPU_FAULTS_SEED``; unset means the module-level :func:`fire` helper is
one ``None`` check — zero wrappers, zero locks, zero work, asserted by a
poisoned-lock probe in the unit tests. The RSM installs a plane from
``faults.spec`` via :func:`install`. The JAX package keeps a plane of its
own: installing one here does not arm it. Everything is deterministic for a
given seed and call sequence; every firing is recorded in
``FaultPlane.injections`` so runs can assert on what was actually injected.
"""

from __future__ import annotations

import dataclasses
import os
import random
import re
import time
from collections import Counter
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Union

from tieredstorage_tpu_torch.storage.core import StorageBackendException
from tieredstorage_tpu_torch.utils.locks import new_lock, note_mutation

ENV_FLAG = "TSTPU_FAULTS"
SEED_ENV = "TSTPU_FAULTS_SEED"

SITES = (
    "storage.read",
    "storage.write",
    "peer.forward",
    "gossip.probe",
    "device.launch",
    # Crash-consistent lifecycle plane: intent-journal appends and
    # recovery-sweeper passes are first-class failure seams too.
    "lifecycle.journal",
    "lifecycle.sweep",
)
KINDS = ("error", "latency", "partial", "flaky")
#: Sites whose payload bytes a ``partial`` rule may mutate.
DATA_SITES = ("storage.read", "peer.forward")


class FaultInjectedError(StorageBackendException):
    """Raised by an injected ``error``/``flaky`` fault at a named site."""

    def __init__(self, site: str, key: str, rule: str) -> None:
        super().__init__(f"Injected fault at {site} (key={key!r}, rule={rule})")
        self.site = site
        self.key = key
        self.rule = rule


_RULE_RE = re.compile(
    r"(?P<site>\*|[a-z]+\.[a-z]+)\s*:\s*(?P<kind>[a-z]+)"
    r"(?:\s*=\s*(?P<arg>\d+(?:\s*\.\.\s*\d+)?))?"
    r"(?:\s*@\s*(?P<trigger>[a-z0-9.=]+))?"
    r"(?:\s*~\s*(?P<match>[^~]+))?"
)


@dataclasses.dataclass(frozen=True)
class FaultPoint:
    """One parsed injection rule."""

    site: str  # one of SITES or "*"
    kind: str
    arg: Optional[int] = None
    arg_hi: Optional[int] = None  # upper bound of a latency lo..hi range
    nth: Optional[int] = None
    every: Optional[int] = None
    from_nth: Optional[int] = None
    probability: Optional[float] = None
    match: Optional[str] = None

    def __post_init__(self) -> None:
        if self.site != "*" and self.site not in SITES:
            raise ValueError(
                f"Unknown fault site {self.site!r}; must be one of {SITES} or '*'"
            )
        if self.kind not in KINDS:
            raise ValueError(f"Unknown fault kind {self.kind!r}; must be one of {KINDS}")
        if self.kind == "partial" and self.site not in DATA_SITES + ("*",):
            raise ValueError(f"Kind 'partial' only applies to data sites {DATA_SITES}")
        if self.nth is not None and self.nth < 1:
            raise ValueError("nth must be >= 1")
        if self.every is not None and self.every < 1:
            raise ValueError("every must be >= 1")
        if self.from_nth is not None and self.from_nth < 1:
            raise ValueError("from must be >= 1")
        if self.probability is not None and not (0.0 <= self.probability <= 1.0):
            raise ValueError("probability must be in [0, 1]")
        if self.arg_hi is not None:
            if self.kind != "latency":
                raise ValueError("range args (lo..hi) only apply to latency")
            if self.arg is None or self.arg_hi < self.arg:
                raise ValueError(
                    f"latency range must be lo..hi with hi >= lo, "
                    f"got {self.arg}..{self.arg_hi}"
                )

    @staticmethod
    def parse(text: str) -> "FaultPoint":
        m = _RULE_RE.fullmatch(text.strip())
        if m is None:
            raise ValueError(
                f"Invalid fault rule {text!r}; expected "
                "site:kind[=arg][@trigger][~match]"
            )
        nth = every = from_nth = None
        probability = None
        trigger = m.group("trigger")
        if trigger is not None:
            if trigger.isdigit():
                nth = int(trigger)
            elif trigger.startswith("every="):
                every = int(trigger[len("every="):])
            elif trigger.startswith("from="):
                from_nth = int(trigger[len("from="):])
            elif trigger.startswith("p="):
                probability = float(trigger[len("p="):])
            else:
                raise ValueError(
                    f"Invalid fault trigger {trigger!r}; expected N, every=K, "
                    "from=N, or p=P"
                )
        arg = m.group("arg")
        arg_lo = arg_hi = None
        if arg is not None:
            if ".." in arg:
                lo, _, hi = arg.partition("..")
                arg_lo, arg_hi = int(lo), int(hi)
            else:
                arg_lo = int(arg)
        match = m.group("match")
        return FaultPoint(
            site=m.group("site"),
            kind=m.group("kind"),
            arg=arg_lo,
            arg_hi=arg_hi,
            nth=nth,
            every=every,
            from_nth=from_nth,
            probability=probability,
            match=match.strip() if match else None,
        )

    def spec(self) -> str:
        """The rule back in spec form (reports, error messages)."""
        out = f"{self.site}:{self.kind}"
        if self.arg is not None:
            out += f"={self.arg}" + (f"..{self.arg_hi}" if self.arg_hi is not None else "")
        if self.nth is not None:
            out += f"@{self.nth}"
        elif self.every is not None:
            out += f"@every={self.every}"
        elif self.from_nth is not None:
            out += f"@from={self.from_nth}"
        elif self.probability is not None:
            out += f"@p={self.probability}"
        if self.match is not None:
            out += f"~{self.match}"
        return out

    def matches(self, site: str, key: str) -> bool:
        if self.site != "*" and self.site != site:
            return False
        return self.match is None or self.match in key


class FaultPlane:
    """Evaluates fault points against per-site call counters; fully
    deterministic for a given seed and call sequence. Latency sleeps happen
    OUTSIDE the plane lock (blocking-under-lock discipline)."""

    def __init__(
        self,
        rules: Iterable[FaultPoint],
        *,
        seed: int = 0,
        sleeper: Callable[[float], None] = time.sleep,
    ) -> None:
        self._rules = list(rules)
        self._rng = random.Random(seed)
        self._sleep = sleeper
        self._lock = new_lock("faults.FaultPlane._lock")
        self._calls: Counter[str] = Counter()
        #: Every firing as (site, kind, key), in order.
        self.injections: List[tuple] = []
        #: Firings per (site, kind).
        self.fired: Counter = Counter()

    @classmethod
    def parse(
        cls,
        spec: Union[str, Sequence[str], None],
        *,
        seed: int = 0,
        sleeper: Callable[[float], None] = time.sleep,
    ) -> "FaultPlane":
        if spec is None:
            spec = []
        elif isinstance(spec, str):
            spec = [spec]
        parts = [q for p in spec for q in re.split(r"[;,]", str(p)) if q.strip()]
        return cls([FaultPoint.parse(q) for q in parts], seed=seed, sleeper=sleeper)

    @property
    def rules(self) -> List[FaultPoint]:
        return list(self._rules)

    def calls(self, site: str) -> int:
        with self._lock:
            return self._calls[site]

    def _fires_locked(self, rule: FaultPoint, call_no: int) -> bool:
        if rule.kind == "flaky":
            heal_after = rule.arg if rule.arg is not None else 10
            if call_no > heal_after:
                return False
            # fall through: an explicit trigger still gates the flaky window
        if rule.nth is not None:
            return call_no == rule.nth
        if rule.every is not None:
            return call_no % rule.every == 0
        if rule.from_nth is not None:
            return call_no >= rule.from_nth
        if rule.probability is not None:
            return self._rng.random() < rule.probability
        return True

    def fire(self, site: str, key: str = "") -> List[FaultPoint]:
        """Count one `site` call; sleep any fired latency, raise any fired
        error, and return fired data rules for the seam to apply via
        :func:`mutate`."""
        delays: List[float] = []
        error: Optional[FaultPoint] = None
        data_rules: List[FaultPoint] = []
        with self._lock:
            self._calls[site] += 1
            call_no = self._calls[site]
            note_mutation("faults.FaultPlane._calls")
            for rule in self._rules:
                if not rule.matches(site, key) or not self._fires_locked(rule, call_no):
                    continue
                self.injections.append((site, rule.kind, key))
                self.fired[(site, rule.kind)] += 1
                note_mutation("faults.FaultPlane.fired")
                if rule.kind == "latency":
                    if rule.arg is None:
                        delays.append(10.0)
                    elif rule.arg_hi is None:
                        delays.append(float(rule.arg))
                    else:
                        delays.append(self._rng.uniform(rule.arg, rule.arg_hi))
                elif rule.kind in ("error", "flaky"):
                    error = error if error is not None else rule
                else:  # partial
                    data_rules.append(rule)
        for delay_ms in delays:
            self._sleep(delay_ms / 1000.0)
        if error is not None:
            raise FaultInjectedError(site, key, error.spec())
        return data_rules

    @staticmethod
    def mutate(data: bytes, rules: Sequence[FaultPoint]) -> bytes:
        """Apply fired data rules (``partial``) to a fetched payload."""
        for rule in rules:
            keep = rule.arg if rule.arg is not None else len(data) // 2
            data = data[: max(0, min(len(data), keep))]
        return data

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "rules": [r.spec() for r in self._rules],
                "calls": dict(self._calls),
                "injections": len(self.injections),
                "fired": {f"{site}:{kind}": n for (site, kind), n in self.fired.items()},
            }


#: The installed plane. ``None`` (the default) means every seam's
#: ``fire()`` is a single attribute read — the zero-work disabled mode.
_PLANE: Optional[FaultPlane] = None


def plane() -> Optional[FaultPlane]:
    return _PLANE


def install(new_plane: Optional[FaultPlane]) -> Optional[FaultPlane]:
    """Install (or with None, remove) the process fault plane; returns the
    previous one so tools can restore it."""
    global _PLANE
    prior, _PLANE = _PLANE, new_plane
    return prior


def enabled() -> bool:
    return _PLANE is not None


def fire(site: str, key: str = "") -> Optional[List[FaultPoint]]:
    """The seam hook: no-op returning None unless a plane is installed."""
    p = _PLANE
    if p is None:
        return None
    return p.fire(site, key)


def mutate(data: bytes, rules: Optional[Sequence[FaultPoint]]) -> bytes:
    """Apply ``fire``'s returned data rules to a payload (no-op on None)."""
    if not rules:
        return data
    return FaultPlane.mutate(data, rules)


def _arm_from_env() -> None:
    spec = os.environ.get(ENV_FLAG, "")
    if spec in ("", "0", "false", "no"):
        return
    try:
        seed = int(os.environ.get(SEED_ENV, "0") or "0")
    except ValueError:
        seed = 0
    install(FaultPlane.parse(spec, seed=seed))


_arm_from_env()
