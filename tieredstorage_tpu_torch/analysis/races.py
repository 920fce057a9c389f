"""Guarded-by data-race inference: every shared mutable attribute has ONE
guarding lock, held at every write.

The lock-order checker proves acquisition ORDER; it says nothing about
GUARDEDNESS — ``DispatchStats`` relying on a docstring sentence ("mutated
only from the dispatching thread") is exactly the kind of invariant that
becomes load-bearing with zero mechanical enforcement. This checker
applies the lockset idea of Eraser/ThreadSanitizer at the AST level,
reusing lockorder.py's held-stack walk and call resolution (the counterpart
of tieredstorage_tpu/analysis/races.py over this package's tree):

1. **Thread reachability.** Entry points that run on another thread are
   seeded mechanically: ``threading.Thread(target=...)`` targets (the
   sanctioned-daemon registry's spawn sites) and every callable handed to
   ``Executor.submit``/``map``. Their static call closure (via the
   lock-order summaries) marks classes whose instances are reachable from
   more than one thread; classes that OWN a witnessed lock are shared by
   self-declaration, and ``SHARED_CLASSES`` names the instances the
   resolver cannot prove (with the reason).

2. **Guarded-by inference.** For each shared class, every non-``__init__``
   write to a ``self`` attribute is collected with the lock stack held at
   the site — including locks inherited interprocedurally: a private
   method only ever called under ``self._lock`` (``*_locked`` helpers)
   analyzes with that lock held (entry-held sets are the intersection over
   all intra-class call sites, propagated to a fixed point; public methods
   and thread entry points start with nothing held). The attribute's guard
   is the lock held at the MAJORITY of its write sites (attributes are
   keyed by their root: all ``self.stats.*`` writes share one guard).

3. **Findings.** With a guard inferred: every write outside it is flagged
   (``torn-rmw`` for ``self.x += 1`` — a lost-update race even on
   CPython — ``unguarded-write`` otherwise). With no guard inferred, only
   augmented writes with NO lock held are flagged: a bare rebinding
   assignment may be a benign publish, but ``+=`` is always a
   read-modify-write.

Escape hatches are themselves checked inventory: a trailing
``# tsa: single-thread`` comment exempts one write site (a dead annotation
— on a line that writes no attribute — is a finding, and an annotation on
an attribute whose other writes inferred a guard is a ``contradictory``
finding); ``self.x = new_unguarded("<stem>.<Class>.x", value)`` in
``__init__`` exempts the whole attribute, with the name validated against
the assignment target and registered with the runtime RaceWitness so the
single-thread claim is observable. ``runtime_crosscheck`` validates the
static inference against what a witnessed run (``TSTPU_LOCK_WITNESS=1``)
actually observed (utils/locks.py RaceWitness); ``RemoteStorageManager.
fleet_ping(include_witness=True)`` reports its verdict.

Like the lock-order checker this is an over-approximation with explicit
resolution limits: container-method mutation (``self.d.pop(k)``), writes
through aliases, and ``getattr``/``setattr`` are invisible; anything the
walk CAN see is enforced, and the RaceWitness covers real executions.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Optional

from tieredstorage_tpu_torch.analysis import lockorder
from tieredstorage_tpu_torch.analysis.core import Finding, ParsedFile, Project

ANNOTATION = "# tsa: single-thread"
UNGUARDED_FACTORY = "new_unguarded"

#: Classes reachable from more than one thread that the call resolver
#: cannot prove (cross-object chains through constructor parameters), each
#: with the reason it is shared. Burn entries down by making the chain
#: resolvable, never by deleting the reason.
SHARED_CLASSES = {
    "tieredstorage_tpu_torch/transform/cuda.py:CudaTransformBackend":
        "one backend instance per RSM, driven by concurrent upload/fetch "
        "requests on the gateway worker pool (DispatchStats counters)",
    "tieredstorage_tpu_torch/transform/cuda.py:_StagingPool":
        "the backend's pinned staging buffers, acquired by every thread "
        "that stages a window (request threads unbatched, the batcher's "
        "flusher daemon merged) and released by whichever thread finishes "
        "it (free lists by window shape + allocation counter)",
    "tieredstorage_tpu_torch/fleet/peer_cache.py:PeerChunkCache":
        "one peer tier per instance, hit by every gateway worker thread "
        "and the chunk cache's loader pool",
    "tieredstorage_tpu_torch/fetch/cache/device_hot.py:DeviceHotCache":
        "one hot-window tier per RSM, hit by every gateway worker thread "
        "and the chunk cache's loader pool (serve/admit/evict counters and "
        "the resident-window maps)",
    "tieredstorage_tpu_torch/fetch/cache/device_hot.py:FrequencySketch":
        "the hot tier's admission sketch, touched from every thread the "
        "tier itself is (count-min rows + decay op counter)",
    "tieredstorage_tpu_torch/utils/flightrecorder.py:FlightRecorder":
        "one recorder per RSM, archiving records from every gateway "
        "worker and RSM operation thread (retention rings + counters)",
    "tieredstorage_tpu_torch/transform/batcher.py:WindowBatcher":
        "one device queue per backend: every request thread (fetch "
        "decrypts, produce encrypts, background scrub verification — each "
        "under its work class) submits into the shared class-keyed "
        "buckets while the flusher daemon drains them (pending maps, "
        "in-flight count, coalescing + per-class counters, fair-share "
        "deficit and admission-allowance state)",
    "tieredstorage_tpu_torch/metrics/slo.py:SloEngine":
        "one engine per RSM, ticked by every metrics scrape (gauge reads "
        "on exporter threads) and every GET /slo gateway worker",
    "tieredstorage_tpu_torch/fleet/telemetry.py:FleetTelemetry":
        "one aggregator per fleet member, scraped concurrently by "
        "gateway workers serving GET /fleet/telemetry (client cache + "
        "scrape counters)",
    "tieredstorage_tpu_torch/metrics/timeline.py:TimelineRecorder":
        "one event ring per RSM, fed by the batcher's flusher daemon on "
        "every merged launch and read by gateway workers serving "
        "GET /debug/timeline and by metrics-scrape gauge suppliers "
        "(ring deque + recorded/evicted/launch/expired counters)",
    "tieredstorage_tpu_torch/fetch/readahead.py:ReadaheadManager":
        "one readahead tier per RSM: every gateway worker's foreground "
        "read advances the detector + consumes pre-admitted entries while "
        "the tier's own speculation pool resolves completed/failed "
        "launches and metrics-scrape gauge suppliers read the counters "
        "(stream LRU, speculated-entry map, budget + waste accounting)",
    "tieredstorage_tpu_torch/fetch/manifest_cache.py:ManifestLookahead":
        "one lookahead per RSM: readahead's speculation pool launches "
        "manifest prefetch flights while gateway workers join or race "
        "them on segment-boundary crossings (flight table + counters)",
    # The unified failure-policy plane is by construction the most-shared
    # state in the process — every I/O seam on every thread reports into it.
    "tieredstorage_tpu_torch/utils/retry.py:CircuitBreaker":
        "one breaker per guarded target, taken by every gateway worker, "
        "the batcher's flusher daemon, and the gossip daemon (state "
        "machine + transition/fast-fail counters)",
    "tieredstorage_tpu_torch/utils/retry.py:BreakerBoard":
        "one per-target board per peer cache / gossip agent, keyed lazily "
        "from every thread that forwards or probes (breaker map + "
        "aggregated transition totals)",
    "tieredstorage_tpu_torch/utils/retry.py:RetryLedger":
        "ONE process-wide accounting plane: every call_with_retry site on "
        "every thread notes attempts/retries/give-ups into it while "
        "metrics-scrape gauge suppliers read them",
    "tieredstorage_tpu_torch/utils/faults.py:FaultPlane":
        "one installed plane reached by every armed seam concurrently "
        "(per-site call counters, injection log, fired counters)",
}

#: Shared state of this package with no JAX twin, guarded by a lock that is
#: not a class's own (or that guards state outside ``self``), by static lock
#: id: what the lock guards and which threads share it. The witness names
#: of these locks are the locks' own (``utils/locks`` factories).
PORT_SHARED_LOCKS = {
    "tieredstorage_tpu_torch/transform/cuda.py:_StagingPool._lock":
        "the staging pool's free lists by window shape: request threads "
        "and the batcher's flusher stage and release windows at once",
    "tieredstorage_tpu_torch/transform/cuda.py:CudaTransformBackend._pool_lock":
        "the lazily built zstd host pool of the backend, made on the first "
        "compressing request of any thread and shut down by close()",
    "tieredstorage_tpu_torch/ops/gcm.py:_CONSTS_MU":
        "the per-(context, device) constants uploaded once and shared by "
        "every thread that launches a window program on that device",
    "tieredstorage_tpu_torch/ops/gcm.py:_ContextCache._lock":
        "the GCM contexts most recently used, by (key, aad, size): every "
        "thread that runs a window (request threads, the batcher's "
        "flusher) looks its context up and stores the ones it built",
    "tieredstorage_tpu_torch/ops/crc32c.py:_CONSTS_MU":
        "the per-device CRC32C constants, shared by the scrubber's and the "
        "anti-entropy repairer's threads",
    "tieredstorage_tpu_torch/ops/_cuda.py:_LOCK":
        "the CUDA library (built once per source hash, loaded once) and the "
        "per-kernel launch counters every launching thread bumps",
}

#: Executor dispatch method names whose first argument runs on a pool thread.
_SUBMIT_ATTRS = {"submit", "map"}


# ------------------------------------------------------------------- model
@dataclasses.dataclass
class WriteSite:
    rel_path: str
    class_name: str
    method: str
    qualname: str
    attr_path: str  # dotted path under self ("stats.hits")
    root: str       # first component ("stats")
    line: int
    held: tuple[str, ...]  # lock ids held lexically at the site
    is_aug: bool
    annotated: bool
    #: held ∪ entry-held(method), filled by the fixed point
    effective_held: tuple[str, ...] = ()


@dataclasses.dataclass
class ClassRaces:
    rel_path: str
    name: str
    shared: bool
    reason: str
    lock_attrs: dict[str, str]               # attr -> static lock id
    lock_names: dict[str, str]               # attr -> new_lock name literal
    unguarded: dict[str, tuple[str, int]]    # attr -> (declared name, line)
    writes: list[WriteSite]
    init_write_lines: set[int]
    #: root attr -> inferred guarding lock id (only roots with writes)
    guards: dict[str, Optional[str]] = dataclasses.field(default_factory=dict)

    @property
    def key(self) -> str:
        return f"{self.rel_path}:{self.name}"

    @property
    def module_stem(self) -> str:
        return Path(self.rel_path).stem

    def site_name(self, root: str) -> str:
        """RaceWitness site naming convention for a root attribute."""
        return f"{self.module_stem}.{self.name}.{root}"


@dataclasses.dataclass
class RaceModel:
    classes: dict[str, ClassRaces]
    thread_entries: set[str]
    reached: set[str]
    #: file -> annotated line numbers without a matching write statement
    dead_annotations: dict[str, list[int]]

    def site_guards(self) -> dict[str, str]:
        """RaceWitness site -> expected witness lock name, for every root
        whose inferred guard was created through a NAMED factory."""
        out: dict[str, str] = {}
        for cr in self.classes.values():
            for root, guard in cr.guards.items():
                if guard is None:
                    continue
                attr = guard.rsplit(".", 1)[-1]
                name = cr.lock_names.get(attr)
                if name:
                    out[cr.site_name(root)] = name
        return out

    def single_thread_sites(self) -> set[str]:
        """Sites claimed single-thread via the ``# tsa: single-thread``
        annotation — the runtime witness must only ever see ONE thread
        mutate them."""
        sites: set[str] = set()
        for cr in self.classes.values():
            for w in cr.writes:
                if w.annotated:
                    sites.add(cr.site_name(w.root))
        return sites

    def unguarded_sites(self) -> set[str]:
        """Sites declared deliberately lock-free via ``new_unguarded`` (a
        torn update is an accepted cost there; no runtime constraint beyond
        being a KNOWN site)."""
        sites: set[str] = set()
        for cr in self.classes.values():
            for attr, (name, _line) in cr.unguarded.items():
                sites.add(name)
                sites.add(cr.site_name(attr))
        return sites


# ---------------------------------------------------------------- the walk
def _self_attr_path(node: ast.AST) -> Optional[str]:
    """Dotted attribute path for a write target rooted at ``self`` (the
    target itself, or the attribute under a subscript: ``self.d[k] = v``
    mutates ``self.d``)."""
    if isinstance(node, ast.Subscript):
        node = node.value
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name) and node.id == "self" and parts:
        return ".".join(reversed(parts))
    return None


class _ClassWalker:
    """Per-method walk: write sites + intra-class call sites, both with the
    lexically held lock stack (with-statements over the class's lock attrs
    and module locks; nested defs/lambdas run later, not under the locks)."""

    def __init__(self, fm, cm, pf: ParsedFile, annotated_lines: set[int]) -> None:
        self.fm = fm
        self.cm = cm
        self.pf = pf
        self.annotated = annotated_lines
        self.writes: list[WriteSite] = []
        self.init_write_lines: set[int] = set()
        #: (caller method, callee method, held-at-site)
        self.intra_calls: list[tuple[str, str, tuple[str, ...]]] = []
        #: methods referenced as bare ``self.m`` outside a call-func slot
        self.referenced: set[str] = set()
        self.held: list[str] = []
        self.method = ""

    def lock_of(self, expr: ast.AST) -> Optional[str]:
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
        ):
            return self.cm.lock_attrs.get(expr.attr)
        if isinstance(expr, ast.Name):
            return self.fm.module_locks.get(expr.id)
        return None

    def run(self, method_name: str, fn: ast.FunctionDef) -> None:
        self.method = method_name
        self.held = []
        self._stmts(fn.body)

    # -- statements
    def _stmts(self, stmts: list) -> None:
        for stmt in stmts:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.AST) -> None:
        if isinstance(stmt, ast.With):
            taken: list[str] = []
            for item in stmt.items:
                self._expr(item.context_expr)
                lock_id = self.lock_of(item.context_expr)
                if lock_id is not None:
                    taken.append(lock_id)
            self.held.extend(taken)
            self._stmts(stmt.body)
            del self.held[len(self.held) - len(taken):]
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            saved, self.held = self.held, []
            self._stmts(stmt.body)
            self.held = saved
            return
        if isinstance(stmt, ast.Assign):
            for target in stmt.targets:
                targets = target.elts if isinstance(target, ast.Tuple) else [target]
                for t in targets:
                    self._write(t, stmt, is_aug=False)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            if not (isinstance(stmt, ast.AnnAssign) and stmt.value is None):
                self._write(stmt.target, stmt, is_aug=isinstance(stmt, ast.AugAssign))
        elif isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                self._write(t, stmt, is_aug=False)
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, (ast.stmt, ast.excepthandler, ast.match_case)):
                self._stmt(child)
            else:
                self._expr(child)

    def _write(self, target: ast.AST, stmt: ast.AST, *, is_aug: bool) -> None:
        path = _self_attr_path(target)
        if path is None:
            return
        if self.method == "__init__" and not self.held:
            # Construction happens-before publication; only remember the
            # line so annotations there are not reported dead.
            self.init_write_lines.add(stmt.lineno)
            return
        self.writes.append(WriteSite(
            rel_path=self.pf.rel_path,
            class_name=self.cm.name,
            method=self.method,
            qualname=f"{self.cm.name}.{self.method}",
            attr_path=path,
            root=path.split(".", 1)[0],
            line=stmt.lineno,
            held=tuple(self.held),
            is_aug=is_aug,
            annotated=stmt.lineno in self.annotated,
        ))

    # -- expressions
    def _expr(self, node: ast.AST) -> None:
        if isinstance(node, ast.Lambda):
            saved, self.held = self.held, []
            self._expr(node.body)
            self.held = saved
            return
        if isinstance(node, ast.Call):
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id == "self"
                and func.attr in self.cm.methods
            ):
                self.intra_calls.append((self.method, func.attr, tuple(self.held)))
            self._expr(func)
            for child in list(node.args) + [kw.value for kw in node.keywords]:
                self._expr(child)
            return
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and node.attr in self.cm.methods
            and isinstance(node.ctx, ast.Load)
            and not isinstance(getattr(node, "_ts_parent", None), ast.Call)
        ):
            # ``self.m`` stored/passed without being the call target: the
            # method can run from anywhere — no inherited entry-held.
            self.referenced.add(node.attr)
        for child in ast.iter_child_nodes(node):
            self._expr(child)


def _annotated_lines(pf: ParsedFile) -> set[int]:
    """Lines carrying the annotation as a real COMMENT token (the literal
    inside a docstring — e.g. this module's own — is not an annotation)."""
    import io
    import tokenize

    lines: set[int] = set()
    try:
        for tok in tokenize.generate_tokens(io.StringIO(pf.source).readline):
            if tok.type == tokenize.COMMENT and "tsa: single-thread" in tok.string:
                lines.add(tok.start[0])
    except (tokenize.TokenError, IndentationError):  # pragma: no cover
        pass  # unparseable tail: the AST parse already succeeded, best effort
    return lines


def _thread_entry_keys(project: Project, file_models: dict) -> set[str]:
    """Summary keys of callables that run on a spawned thread: Thread
    targets and Executor.submit/map callables (bound methods and module
    functions; lambdas defer to the lock-order walk's own handling)."""
    entries: set[str] = set()
    for pf in project.files:
        fm = file_models[pf.rel_path]
        for node in pf.walk():
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            candidates: list[ast.AST] = []
            name = lockorder._dotted(func)
            if name and name.split(".")[-1] in ("Thread", "start_new_thread"):
                for kw in node.keywords:
                    if kw.arg == "target":
                        candidates.append(kw.value)
                if node.args:
                    candidates.append(node.args[0])
            elif isinstance(func, ast.Attribute) and func.attr in _SUBMIT_ATTRS:
                if node.args:
                    candidates.append(node.args[0])
            for cand in candidates:
                qual = pf.qualname_of(node)
                cls = qual.split(".", 1)[0]
                if (
                    isinstance(cand, ast.Attribute)
                    and isinstance(cand.value, ast.Name)
                    and cand.value.id == "self"
                    and cls in fm.classes
                    and cand.attr in fm.classes[cls].methods
                ):
                    entries.add(f"{pf.rel_path}:{cls}.{cand.attr}")
                elif isinstance(cand, ast.Name) and cand.id in fm.functions:
                    entries.add(f"{pf.rel_path}:{cand.id}")
    return entries


def _reached_from(entries: set[str], summaries: dict) -> set[str]:
    seen = set()
    stack = [k for k in entries if k in summaries]
    while stack:
        key = stack.pop()
        if key in seen:
            continue
        seen.add(key)
        summary = summaries.get(key)
        if summary is None:
            continue
        for site in summary.calls:
            if site.callee not in seen:
                stack.append(site.callee)
    return seen


def _entry_held_fixed_point(
    cm, walker: _ClassWalker, thread_entries: set[str], rel_path: str
) -> dict[str, frozenset]:
    """Entry-held set per method: the locks guaranteed held on entry.

    Public methods, thread/executor entry points, and methods stored as
    bare references start with nothing held; a private method inherits the
    INTERSECTION over all its intra-class call sites of (locks held at the
    site ∪ the caller's entry-held), narrowed to a fixed point from ⊤.
    """
    TOP = None  # not yet constrained
    entry: dict[str, Optional[frozenset]] = {}
    callers: dict[str, list[tuple[str, tuple[str, ...]]]] = {}
    for caller, callee, held in walker.intra_calls:
        callers.setdefault(callee, []).append((caller, held))
    for m in cm.methods:
        unconstrained = (
            not m.startswith("_")
            or m.startswith("__")
            or m in walker.referenced
            or f"{rel_path}:{cm.name}.{m}" in thread_entries
            or m not in callers
        )
        entry[m] = frozenset() if unconstrained else TOP
    changed = True
    while changed:
        changed = False
        for m, sites in callers.items():
            if entry[m] == frozenset():
                continue
            known = [
                frozenset(held) | entry[caller]
                for caller, held in sites
                if entry.get(caller) is not TOP
            ]
            if not known:
                continue
            new = frozenset.intersection(*known)
            candidate = new if entry[m] is TOP else entry[m] & new
            if candidate != entry[m]:
                entry[m] = candidate
                changed = True
    return {m: (e if e is not TOP else frozenset()) for m, e in entry.items()}


# ------------------------------------------------------------- model build
def _scan_init_declarations(
    fm, cm
) -> tuple[dict[str, str], dict[str, tuple[str, int]], list[Finding]]:
    """(lock name literals, new_unguarded declarations, naming findings)."""
    lock_names: dict[str, str] = {}
    unguarded: dict[str, tuple[str, int]] = {}
    findings: list[Finding] = []
    for method in cm.methods.values():
        for node in ast.walk(method):
            if not (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Attribute)
                and isinstance(node.targets[0].value, ast.Name)
                and node.targets[0].value.id == "self"
                and isinstance(node.value, ast.Call)
            ):
                continue
            attr = node.targets[0].attr
            callee = lockorder._dotted(node.value.func)
            last = callee.split(".")[-1] if callee else None
            if last in lockorder.LOCK_FACTORY_NAMES and node.value.args:
                first = node.value.args[0]
                if isinstance(first, ast.Constant) and isinstance(first.value, str):
                    lock_names[attr] = first.value
            elif last == UNGUARDED_FACTORY:
                first = node.value.args[0] if node.value.args else None
                name = (
                    first.value
                    if isinstance(first, ast.Constant) and isinstance(first.value, str)
                    else None
                )
                expected_suffix = f"{cm.name}.{attr}"
                if name is None or not name.endswith(expected_suffix):
                    findings.append(Finding(
                        checker="races",
                        path=fm.pf.rel_path,
                        line=node.lineno,
                        qualname=f"{cm.name}.__init__",
                        detail=f"bad-unguarded-name:{cm.name}.{attr}",
                        message=(
                            f"new_unguarded name for self.{attr} must be a "
                            f"string literal ending in {expected_suffix!r} "
                            "(the RaceWitness site convention), got "
                            f"{name!r}"
                        ),
                    ))
                else:
                    unguarded[attr] = (name, node.lineno)
    return lock_names, unguarded, findings


def build_race_model(project: Project) -> tuple[RaceModel, list[Finding]]:
    file_models = {
        pf.rel_path: lockorder._build_file_model(pf) for pf in project.files
    }
    class_registry = {}
    for fm in file_models.values():
        for cm in fm.classes.values():
            class_registry[f"{fm.module_name}.{cm.name}"] = cm
    for fm in file_models.values():
        lockorder._bind_class_attrs(fm, class_registry)
    summaries, _edges, _blocking = lockorder.build_lock_model(project)
    thread_entries = _thread_entry_keys(project, file_models)
    reached = _reached_from(thread_entries, summaries)

    findings: list[Finding] = []
    classes: dict[str, ClassRaces] = {}
    dead: dict[str, list[int]] = {}
    for pf in project.files:
        fm = file_models[pf.rel_path]
        annotated = _annotated_lines(pf)
        covered: set[int] = set()
        for cm in fm.classes.values():
            key = f"{pf.rel_path}:{cm.name}"
            reasons = []
            if cm.lock_attrs:
                reasons.append("owns a lock (shared by self-declaration)")
            touched = [
                m for m in cm.methods
                if f"{pf.rel_path}:{cm.name}.{m}" in reached
                or f"{pf.rel_path}:{cm.name}.{m}" in thread_entries
            ]
            if touched:
                reasons.append(
                    f"reachable from a spawned thread via {touched[0]}()"
                )
            if key in SHARED_CLASSES:
                reasons.append(SHARED_CLASSES[key])
            walker = _ClassWalker(fm, cm, pf, annotated)
            for name, fn in cm.methods.items():
                walker.run(name, fn)
            lock_names, unguarded, naming = _scan_init_declarations(fm, cm)
            findings.extend(naming)
            entry_held = _entry_held_fixed_point(
                cm, walker, thread_entries, pf.rel_path
            )
            for w in walker.writes:
                w.effective_held = tuple(
                    dict.fromkeys(list(w.held) + sorted(entry_held.get(w.method, ())))
                )
            covered |= {w.line for w in walker.writes}
            covered |= walker.init_write_lines
            covered |= {line for _name, line in unguarded.values()}
            classes[key] = ClassRaces(
                rel_path=pf.rel_path,
                name=cm.name,
                shared=bool(reasons),
                reason="; ".join(reasons),
                lock_attrs=dict(cm.lock_attrs),
                lock_names=lock_names,
                unguarded=unguarded,
                writes=walker.writes,
                init_write_lines=walker.init_write_lines,
            )
        stale = sorted(annotated - covered)
        if stale:
            dead[pf.rel_path] = stale
            for line in stale:
                f = Finding(
                    checker="races",
                    path=pf.rel_path,
                    line=line,
                    qualname=pf.qualname_of(pf.tree),
                    detail="dead-annotation",
                    message=(
                        f"'{ANNOTATION}' on a line that writes no self "
                        "attribute (annotations must sit on the write "
                        "statement's first line); remove or move it"
                    ),
                )
                if f.fingerprint not in {x.fingerprint for x in findings}:
                    findings.append(f)

    # Guard inference + race findings, shared classes only.
    for cr in classes.values():
        if not cr.shared:
            continue
        by_root: dict[str, list[WriteSite]] = {}
        for w in cr.writes:
            if w.root in cr.unguarded or w.root in cr.lock_attrs:
                continue  # declared lock-free / the locks themselves
            by_root.setdefault(w.root, []).append(w)
        for root, sites in sorted(by_root.items()):
            counts: dict[str, int] = {}
            for w in sites:
                for lock in w.effective_held:
                    counts[lock] = counts.get(lock, 0) + 1
            guard: Optional[str] = None
            if counts:
                best = max(sorted(counts), key=lambda k: counts[k])
                if counts[best] * 2 > len(sites):
                    guard = best
            cr.guards[root] = guard
            seen_fps: set[str] = set()
            for w in sites:
                if guard is not None:
                    if guard in w.effective_held:
                        continue
                    if w.annotated:
                        f = Finding(
                            checker="races",
                            path=cr.rel_path, line=w.line, qualname=w.qualname,
                            detail=f"contradictory-annotation:{cr.name}.{w.attr_path}",
                            message=(
                                f"self.{w.attr_path} is annotated "
                                "single-thread here but its other writes "
                                f"inferred the guard {guard}; pick one "
                                "discipline"
                            ),
                        )
                    else:
                        kind = "torn-rmw" if w.is_aug else "unguarded-write"
                        f = Finding(
                            checker="races",
                            path=cr.rel_path, line=w.line, qualname=w.qualname,
                            detail=f"{kind}:{cr.name}.{w.attr_path}",
                            message=(
                                f"write to self.{w.attr_path} outside its "
                                f"inferred guard {guard} (held at the "
                                "majority of write sites) in a class "
                                f"reachable from more than one thread "
                                f"({cr.reason}); guard it, or annotate "
                                f"'{ANNOTATION}' with evidence"
                            ),
                        )
                elif w.is_aug and not w.effective_held and not w.annotated:
                    f = Finding(
                        checker="races",
                        path=cr.rel_path, line=w.line, qualname=w.qualname,
                        detail=f"torn-rmw:{cr.name}.{w.attr_path}",
                        message=(
                            f"read-modify-write of self.{w.attr_path} with "
                            "no lock held in a class reachable from more "
                            f"than one thread ({cr.reason}); a concurrent "
                            "writer loses updates — guard it, declare it "
                            f"with new_unguarded(), or annotate "
                            f"'{ANNOTATION}' with evidence"
                        ),
                    )
                else:
                    continue
                if f.fingerprint not in seen_fps:
                    seen_fps.add(f.fingerprint)
                    findings.append(f)

    model = RaceModel(
        classes=classes,
        thread_entries=thread_entries,
        reached=reached,
        dead_annotations=dead,
    )
    return model, findings


def check_races(project: Project) -> list[Finding]:
    _model, findings = build_race_model(project)
    return findings


# ------------------------------------------------------ runtime cross-check
def runtime_crosscheck(
    project: Optional[Project] = None,
    *,
    race=None,
    lock_witness=None,
) -> dict:
    """Validate the static guarded-by inference against runtime evidence.

    Returns ``{"violations": [...], "validated": [...], "unobserved":
    [...]}``. A violation is an OBSERVED contradiction: a sampled mutation
    of an inferred-guarded site with the wrong (or no) witnessed lock held,
    a single-thread-annotated site mutated from more than one thread, or a
    runtime site name the static model does not know (stale hook).
    Inferred guards with no sampled mutations are merely ``unobserved``
    (the suites do not exercise every path every run) — unless the guard
    lock itself was never even acquired, which is also only informational.
    """
    from tieredstorage_tpu_torch.analysis.core import load_project
    from tieredstorage_tpu_torch.utils import locks as locks_mod

    if project is None:
        project = load_project(Path(__file__).resolve().parents[2])
    race = race if race is not None else locks_mod.race_witness()
    lw = lock_witness if lock_witness is not None else locks_mod.witness()
    model, _findings = build_race_model(project)
    guards = model.site_guards()
    single = model.single_thread_sites()
    unguarded = model.unguarded_sites() | set(race.unguarded_names)

    violations: list[str] = []
    validated: list[str] = []
    for site in race.sites():
        helds = race.held_at.get(site, set())
        threads = race.threads_at.get(site, set())
        if site in guards:
            expected = guards[site]
            wrong = sorted(
                "<none>" if h is None else h for h in helds if h != expected
            )
            if wrong:
                violations.append(
                    f"{site}: statically inferred guard {expected!r} but "
                    f"observed mutations holding {wrong}"
                )
            else:
                validated.append(site)
        elif site in single:
            if len(threads) > 1:
                violations.append(
                    f"{site}: declared single-thread but mutated from "
                    f"{len(threads)} distinct threads"
                )
            else:
                validated.append(site)
        elif site in unguarded:
            validated.append(site)  # lock-free by declaration
        else:
            violations.append(
                f"{site}: observed at runtime but unknown to the static "
                "race model (stale note_mutation hook?)"
            )
    acquired = lw.acquired_names()
    unobserved = sorted(
        f"{site} (guard {guards[site]}"
        + ("" if guards[site] in acquired else ", lock never acquired")
        + ")"
        for site in guards
        if site not in race.held_at
    )
    return {
        "violations": violations,
        "validated": sorted(validated),
        "unobserved": unobserved,
    }
