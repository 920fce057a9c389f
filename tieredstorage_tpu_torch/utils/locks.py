"""Named lock factories + the runtime LockWitness/RaceWitness.

Counterpart of tieredstorage_tpu/utils/locks.py, whole. When
``TSTPU_LOCK_WITNESS=1`` every lock created through these factories is
wrapped, each thread's acquisition stack is tracked, and every observed
"held A, then acquired B" pair becomes an edge in a global order graph. An
edge that would close a cycle — the runtime signature of a potential
deadlock (Coffman's circular-wait condition) — is recorded as a violation
(``TSTPU_LOCK_WITNESS=raise`` makes it throw at the acquisition site).

Granularity is the CLASS attribute, not the instance: all instances of
one class share one node (``lifecycle.UploadIntentJournal._lock``). Reentrant
acquisition of the same name (RLock, or two instances of one class) is not
an edge.

The same flag arms the **RaceWitness**: shared mutable attributes whose
mutation sites carry a ``note_mutation(site)`` hook record the witnessed
lock actually held (and the mutating thread) at every sampled write, so a
site mutated with the wrong (or no) lock held, or from more than one thread
where one is declared, shows in ``race_witness().snapshot()``.

When the flag is unset the factories return the raw ``threading``
primitives and ``note_mutation``/``new_unguarded`` are no-ops returning
immediately — zero wrappers, zero overhead, asserted by the unit tests.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, TypeVar

ENV_FLAG = "TSTPU_LOCK_WITNESS"


def witness_enabled() -> bool:
    return os.environ.get(ENV_FLAG, "") not in ("", "0", "false", "no")


def _witness_raises() -> bool:
    return os.environ.get(ENV_FLAG, "").lower() in ("raise", "strict")


class LockOrderViolation(RuntimeError):
    """Acquiring this lock here closes a cycle in the observed lock order."""


class LockWitness:
    """Global acquisition-order graph over named locks, per-thread stacks.

    Thread stacks live in a ``threading.local``; the shared edge graph is
    guarded by one plain (unwitnessed) lock. Edge insertion is O(reachable)
    for the cycle probe but runs at most once per distinct (a, b) pair over
    the process lifetime — steady state adds zero graph work.
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()  # guards _succ/_edge_sites/violations
        self._local = threading.local()
        #: adjacency: name -> set of names acquired while holding it
        self._succ: dict[str, set[str]] = {}
        #: first-seen (holder, acquired) pairs, insertion-ordered
        self._edge_sites: dict[tuple[str, str], int] = {}
        #: every witnessed lock name EVER acquired (edges only cover nested
        #: acquisitions; the race cross-check needs outermost locks too).
        #: Mutated via set.add (atomic under the GIL), snapshot-read.
        self._acquired_names: set[str] = set()
        self.violations: list[str] = []

    # ------------------------------------------------------------- thread TLS
    def _held(self) -> list[str]:
        held = getattr(self._local, "held", None)
        if held is None:
            held = self._local.held = []
        return held

    # ---------------------------------------------------------------- events
    def note_acquire(self, name: str) -> None:
        self._acquired_names.add(name)
        held = self._held()
        for holder in dict.fromkeys(held):  # distinct, preserve order
            if holder != name:  # reentrant / same-class sibling: not an edge
                self._add_edge(holder, name)
        held.append(name)

    def note_release(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    # ----------------------------------------------------------------- graph
    def _add_edge(self, a: str, b: str) -> None:
        with self._mu:
            if (a, b) in self._edge_sites:
                return
            if self._reachable(b, a):
                message = (
                    f"lock-order cycle: thread holds {a!r} while acquiring "
                    f"{b!r}, but the opposite order {b!r} -> ... -> {a!r} "
                    "was already observed"
                )
                self.violations.append(message)
                raise_now = _witness_raises()
            else:
                raise_now = False
            self._edge_sites[(a, b)] = len(self._edge_sites)
            self._succ.setdefault(a, set()).add(b)
        if raise_now:
            raise LockOrderViolation(message)

    def _reachable(self, src: str, dst: str) -> bool:
        seen = set()
        stack = [src]
        while stack:
            node = stack.pop()
            if node == dst:
                return True
            if node in seen:
                continue
            seen.add(node)
            stack.extend(self._succ.get(node, ()))
        return False

    # ------------------------------------------------------------ inspection
    def edges(self) -> list[tuple[str, str]]:
        with self._mu:
            return sorted(self._edge_sites, key=self._edge_sites.get)

    def lock_names(self) -> set[str]:
        with self._mu:
            return {n for edge in self._edge_sites for n in edge}

    def acquired_names(self) -> set[str]:
        """Every witnessed lock name acquired at least once this process."""
        return set(self._acquired_names)

    def held_names(self) -> list[str]:
        """The CURRENT thread's held witnessed-lock stack (outermost first)."""
        return list(self._held())

    def assert_dag(self) -> None:
        with self._mu:
            violations = list(self.violations)
        if violations:
            raise LockOrderViolation(
                f"{len(violations)} lock-order violation(s):\n  "
                + "\n  ".join(violations)
            )

    def reset(self) -> None:
        with self._mu:
            self._succ.clear()
            self._edge_sites.clear()
            self._acquired_names.clear()
            self.violations.clear()


_WITNESS = LockWitness()


def witness() -> LockWitness:
    """The process-wide witness (one graph across every subsystem)."""
    return _WITNESS


class _WitnessedLock:
    """threading.Lock/RLock wrapper reporting acquire/release to the witness.

    Duck-types the lock protocol ``threading.Condition`` relies on
    (acquire/release/context manager; no ``_is_owned`` so Condition falls
    back to its probe), so ``new_condition`` can build a Condition directly
    on top of one and the witness sees the condition's own release/reacquire
    around ``wait()`` for free.
    """

    __slots__ = ("_inner", "name")

    def __init__(self, name: str, inner) -> None:
        self.name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            try:
                _WITNESS.note_acquire(self.name)
            except LockOrderViolation:  # raise-mode: don't leak the lock
                self._inner.release()
                raise
        return ok

    def release(self) -> None:
        self._inner.release()
        _WITNESS.note_release(self.name)

    def locked(self) -> bool:
        return self._inner.locked()

    def _is_owned(self) -> bool:
        # threading.Condition ownership probe. Delegate to the RLock's own
        # notion when available; Condition's acquire(0) fallback is wrong for
        # a reentrant inner lock (the owner's probe would succeed).
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<WitnessedLock {self.name} {self._inner!r}>"


def new_lock(name: str) -> threading.Lock:
    """A ``threading.Lock``, witnessed under TSTPU_LOCK_WITNESS."""
    if witness_enabled():
        return _WitnessedLock(name, threading.Lock())
    return threading.Lock()


def new_rlock(name: str) -> threading.RLock:
    """A ``threading.RLock``, witnessed under TSTPU_LOCK_WITNESS."""
    if witness_enabled():
        return _WitnessedLock(name, threading.RLock())
    return threading.RLock()


def new_condition(name: str, lock: Optional[threading.Lock] = None) -> threading.Condition:
    """A ``threading.Condition``; its lock is witnessed under the flag.

    ``wait()`` releases and reacquires through the witnessed lock's own
    acquire/release (Condition's ``_release_save``/``_acquire_restore``
    fallbacks call them), so the held-stack stays accurate across waits.
    """
    if witness_enabled():
        inner = lock if lock is not None else threading.RLock()
        return threading.Condition(_WitnessedLock(name, inner))
    return threading.Condition(lock)


# --------------------------------------------------------------- RaceWitness
SAMPLE_ENV = "TSTPU_RACE_SAMPLE"


class RaceWitness:
    """Sampling recorder of the lock actually held at attribute mutation
    sites.

    A *site* is a ``<module stem>.<Class>.<attr>`` name passed to
    ``note_mutation`` from inside the mutation's critical section (or from
    an annotated lock-free site). Per site the witness keeps the SET of
    innermost witnessed-lock names observed held (``None`` when the
    mutating thread held no witnessed lock) and the set of mutating thread
    idents — enough to check a site against its declared guard: the guard
    must be the only lock ever observed, an annotated single-thread site
    must only ever see one thread. Sampling (``TSTPU_RACE_SAMPLE=n``
    records every n-th mutation per site, default 1) bounds the overhead
    on hot sites; set-insertion makes steady state O(1) regardless.
    """

    def __init__(self, witness: Optional[LockWitness] = None) -> None:
        self._witness = witness if witness is not None else _WITNESS
        self._mu = threading.Lock()
        try:
            self._sample_every = max(1, int(os.environ.get(SAMPLE_ENV, "1")))
        except ValueError:
            self._sample_every = 1
        #: site -> set of innermost held witnessed-lock names (None = none)
        self.held_at: dict[str, set[Optional[str]]] = {}
        #: site -> set of mutating thread idents
        self.threads_at: dict[str, set[int]] = {}
        #: site -> raw mutation events seen (pre-sampling)
        self.counts: dict[str, int] = {}
        #: names declared deliberately lock-free via ``new_unguarded``
        self.unguarded_names: set[str] = set()

    def note_mutation(self, site: str) -> None:
        held = self._witness._held()
        innermost = held[-1] if held else None
        ident = threading.get_ident()
        with self._mu:
            count = self.counts.get(site, 0)
            self.counts[site] = count + 1
            if count % self._sample_every:
                return
            self.held_at.setdefault(site, set()).add(innermost)
            self.threads_at.setdefault(site, set()).add(ident)

    def register_unguarded(self, name: str) -> None:
        with self._mu:
            self.unguarded_names.add(name)

    def sites(self) -> list[str]:
        with self._mu:
            return sorted(self.held_at)

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "sites": {
                    site: {
                        "held": sorted(
                            "<none>" if h is None else h
                            for h in self.held_at[site]
                        ),
                        "threads": len(self.threads_at.get(site, ())),
                        "mutations": self.counts.get(site, 0),
                    }
                    for site in sorted(self.held_at)
                },
                "unguarded_names": sorted(self.unguarded_names),
            }

    def reset(self) -> None:
        with self._mu:
            self.held_at.clear()
            self.threads_at.clear()
            self.counts.clear()
            self.unguarded_names.clear()


_RACE_WITNESS = RaceWitness()


def race_witness() -> RaceWitness:
    """The process-wide race witness (pairs with ``witness()``)."""
    return _RACE_WITNESS


def note_mutation(site: str) -> None:
    """Record a shared-attribute mutation at ``site`` (no-op unless the
    witness flag is armed). Call INSIDE the guarded section so the held
    witnessed lock is observable; annotated single-thread sites call it
    wherever the mutation happens."""
    if witness_enabled():
        _RACE_WITNESS.note_mutation(site)


_T = TypeVar("_T")


def new_unguarded(name: str, value: _T) -> _T:
    """Declare a DELIBERATELY lock-free shared attribute.

    Returns ``value`` unchanged (zero overhead, no wrapper); the name is the
    same ``<module stem>.<Class>.<attr>`` convention as ``new_lock``. The
    declaration says a torn update is an ACCEPTED cost (best-effort
    counters on hot paths). Under the witness flag the name registers with
    the RaceWitness so runtime observations of the site classify as
    declared rather than unknown.
    """
    if witness_enabled():
        _RACE_WITNESS.register_unguarded(name)
    return value
