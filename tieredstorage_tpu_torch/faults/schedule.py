"""Seedable, deterministic fault schedules.

A schedule is a list of rules, each written as

    op ":" action ["=" arg] ["@" trigger]

- op: ``upload`` | ``fetch`` | ``delete`` | ``list`` | ``*`` (any operation)
- action:
    - ``raise`` — raise FaultInjectedException (a StorageBackendException)
    - ``key-not-found`` — raise KeyNotFoundException for the requested key
    - ``delay`` — sleep ``arg`` milliseconds (default 10) before the call;
      a jittered range ``delay=10..250`` sleeps a value drawn uniformly
      from [10, 250] ms by the schedule's seeded RNG — realistic
      tail-latency distributions instead of fixed sleeps
    - ``truncate`` — keep only the first ``arg`` bytes of a fetched object
      (default: half); fetch only
    - ``corrupt`` — flip the fetched byte at offset ``arg`` (default 0,
      taken modulo the object size); fetch only
- trigger:
    - ``@N`` — fire on the Nth call of that op (1-based)
    - ``@every=K`` — fire on every Kth call of that op
    - ``@from=N`` — fire on EVERY call from the Nth onward (1-based): a
      hard failure that starts mid-run and never recovers, e.g. killing a
      replica partway through a workload (``fetch:raise@from=20``)
    - ``@p=P`` — fire with probability P, drawn from the schedule's seeded
      RNG (deterministic for a given seed and call sequence)
    - absent — fire on every call

Examples: ``upload:raise@3``, ``fetch:corrupt=7@1``, ``*:delay=5@every=2``,
``fetch:delay=10..250@p=0.2``, ``fetch:truncate@p=0.1``. Rules are combined
with ``,`` or ``;`` in the
string form (``fault.schedule`` config) or passed as a list.

Call counting is per op and thread-safe; every fired rule is recorded in
``FaultSchedule.injections`` so tests and soak runs can assert on what was
actually injected.
"""

from __future__ import annotations

import dataclasses
import random
import re
from collections import Counter
from typing import Iterable, Optional, Sequence, Union

from tieredstorage_tpu_torch.storage.core import StorageBackendException
from tieredstorage_tpu_torch.utils.locks import new_lock

OPS = ("upload", "fetch", "delete", "list")
ACTIONS = ("raise", "key-not-found", "delay", "truncate", "corrupt")
#: Actions that mutate fetched bytes instead of failing the call.
DATA_ACTIONS = ("truncate", "corrupt")


class FaultInjectedException(StorageBackendException):
    """Raised by an injected `raise` fault."""


_RULE_RE = re.compile(
    r"(?P<op>\*|upload|fetch|delete|list)\s*:\s*(?P<action>[a-z-]+)"
    r"(?:\s*=\s*(?P<arg>\d+(?:\s*\.\.\s*\d+)?))?(?:\s*@\s*(?P<trigger>[a-z0-9.=]+))?"
)


@dataclasses.dataclass(frozen=True)
class FaultRule:
    op: str  # "upload" | "fetch" | "delete" | "*"
    action: str
    arg: Optional[int] = None
    nth: Optional[int] = None
    every: Optional[int] = None
    #: Fire on every call from the Nth onward (permanent failure mid-run).
    from_nth: Optional[int] = None
    probability: Optional[float] = None
    #: Upper bound of a jittered ``delay=lo..hi`` range (delay only); the
    #: actual sleep is drawn per firing from the schedule's seeded RNG.
    arg_hi: Optional[int] = None

    def __post_init__(self) -> None:
        if self.op != "*" and self.op not in OPS:
            raise ValueError(f"Unknown fault op {self.op!r}; must be one of {OPS} or '*'")
        if self.action not in ACTIONS:
            raise ValueError(
                f"Unknown fault action {self.action!r}; must be one of {ACTIONS}"
            )
        if self.action in DATA_ACTIONS and self.op not in ("fetch", "*"):
            raise ValueError(f"Action {self.action!r} only applies to fetch")
        if self.every is not None and self.every < 1:
            raise ValueError("every must be >= 1")
        if self.nth is not None and self.nth < 1:
            raise ValueError("nth must be >= 1")
        if self.from_nth is not None and self.from_nth < 1:
            raise ValueError("from must be >= 1")
        if self.probability is not None and not (0.0 <= self.probability <= 1.0):
            raise ValueError("probability must be in [0, 1]")
        if self.arg_hi is not None:
            if self.action != "delay":
                raise ValueError("range args (lo..hi) only apply to delay")
            if self.arg is None or self.arg_hi < self.arg:
                raise ValueError(
                    f"delay range must be lo..hi with hi >= lo, "
                    f"got {self.arg}..{self.arg_hi}"
                )

    @staticmethod
    def parse(text: str) -> "FaultRule":
        m = _RULE_RE.fullmatch(text.strip())
        if m is None:
            raise ValueError(
                f"Invalid fault rule {text!r}; expected op:action[=arg][@trigger]"
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
        return FaultRule(
            op=m.group("op"),
            action=m.group("action"),
            arg=arg_lo,
            nth=nth,
            every=every,
            from_nth=from_nth,
            probability=probability,
            arg_hi=arg_hi,
        )

    def matches_op(self, op: str) -> bool:
        return self.op == "*" or self.op == op


class FaultSchedule:
    """Evaluates rules against a per-op call counter; fully deterministic
    for a given seed and call sequence."""

    def __init__(self, rules: Iterable[FaultRule], *, seed: int = 0) -> None:
        self._rules = list(rules)
        self._rng = random.Random(seed)
        self._calls: Counter[str] = Counter()
        self._lock = new_lock("schedule.FaultSchedule._lock")
        #: Every fired rule as (op, action, key string), in order.
        self.injections: list[tuple[str, str, str]] = []

    @classmethod
    def parse(
        cls, spec: Union[str, Sequence[str], None], *, seed: int = 0
    ) -> "FaultSchedule":
        if spec is None:
            spec = []
        elif isinstance(spec, str):
            spec = [spec]
        # Config "list" values split on commas only; rules joined with ";"
        # arrive as one element, so re-split every element on both.
        parts = [q for p in spec for q in re.split(r"[;,]", str(p)) if q.strip()]
        return cls([FaultRule.parse(q) for q in parts], seed=seed)

    @property
    def rules(self) -> list[FaultRule]:
        return list(self._rules)

    def calls(self, op: str) -> int:
        with self._lock:
            return self._calls[op]

    def fired_rules(self, op: str, key: object) -> list[FaultRule]:
        """Count one `op` call and return the rules that fire on it."""
        with self._lock:
            self._calls[op] += 1
            call_no = self._calls[op]
            fired = [
                r for r in self._rules
                if r.matches_op(op) and self._fires_locked(r, call_no)
            ]
            for r in fired:
                self.injections.append((op, r.action, str(key)))
            return fired

    def delay_ms(self, rule: FaultRule) -> float:
        """Sleep duration for a fired `delay` rule: the fixed arg (default
        10 ms), or — for a jittered ``delay=lo..hi`` range — a uniform draw
        from the schedule's seeded RNG, so fault runs get realistic
        tail-latency distributions that are still reproducible."""
        if rule.arg is None:
            return 10.0
        if rule.arg_hi is None:
            return float(rule.arg)
        with self._lock:
            return self._rng.uniform(rule.arg, rule.arg_hi)

    def _fires_locked(self, rule: FaultRule, call_no: int) -> bool:
        if rule.nth is not None:
            return call_no == rule.nth
        if rule.every is not None:
            return call_no % rule.every == 0
        if rule.from_nth is not None:
            return call_no >= rule.from_nth
        if rule.probability is not None:
            return self._rng.random() < rule.probability
        return True

    def __len__(self) -> int:
        return len(self._rules)
