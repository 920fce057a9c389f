"""Lock-order checker: the cross-module acquisition graph must stay a DAG,
and nothing blocking may run while a lock is held.

Counterpart of tieredstorage_tpu/analysis/lockorder.py, the same graph built
over this package's tree. A lock node is ``<file>:<Class>.<attr>`` (module
locks ``<file>:<var>``); the witnessed factories name the same lock
``<module stem>.<Class>.<attr>`` (``transform/cuda.py:_StagingPool._lock``
is ``cuda._StagingPool._lock``), which is how the runtime LockWitness edges
and this graph talk about the same objects.

Model (two passes, whole-project):

1. **Inventory.** Every ``self.X = threading.Lock()/RLock()/Condition()`` (or
   the witnessed ``new_lock``/``new_rlock``/``new_condition`` factories from
   utils/locks.py) becomes the lock node ``<file>:<Class>.<attr>``; module
   level ``X = threading.Lock()`` becomes ``<file>:<var>``. Assignments
   ``self.Y = SomeProjectClass(...)`` bind the attribute's type so calls
   through it resolve cross-module.

2. **Summaries + fixed point.** Each function gets a summary: locks it
   acquires directly (``with self.X:`` bodies and explicit ``.acquire()``),
   whether it makes a blocking call (socket/HTTP/``wait``/``result``/
   executor dispatch/connection ``close``), and its resolvable call sites
   (``self.m()``, module functions, constructors, and one level of
   ``self.attr.m()`` through the type bindings). Acquire-sets and the
   blocks flag propagate through the call graph to a fixed point, so
   "holding A, call helper that takes B" yields the edge A -> B and
   "holding A, call helper that does a socket round-trip" is flagged even
   when the round-trip is two calls deep.

Findings: one per cycle in the resulting graph (potential deadlock by
circular wait), and one per blocking call site made while a lock is held.
``Condition.wait`` on the lock actually held is NOT blocking-under-lock (the
wait releases it); waiting on anything else while holding a lock is.

This is deliberately an over-approximation with explicit resolution limits
(no aliasing through locals, no duck-typed delegates): anything it cannot
resolve is silent, anything it CAN resolve is enforced, and the runtime
LockWitness covers the remainder from real executions.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Optional

from tieredstorage_tpu_torch.analysis.core import Finding, ParsedFile, Project

LOCK_FACTORY_NAMES = {"new_lock", "new_rlock", "new_condition"}
THREADING_LOCK_CTORS = {"Lock", "RLock", "Condition"}

#: Method names that block the calling thread (socket / HTTP / futures /
#: condition waits / executor dispatch). ``wait`` on the very lock being
#: held is exempted at the call site.
BLOCKING_ATTRS = {
    "request", "request_stream", "urlopen", "getresponse", "connect",
    "accept", "recv", "recv_into", "send", "sendall", "wait", "result",
    "submit", "shutdown",
}
#: ``.close()`` counts as blocking only on connection-ish receivers (socket
#: teardown does a network round-trip); matched against the receiver source.
CLOSE_RECEIVER_RE = re.compile(r"(conn|client|sock|stream|resp|idle)", re.IGNORECASE)


# ------------------------------------------------------------------- models
@dataclasses.dataclass
class ClassModel:
    rel_path: str
    name: str
    lock_attrs: dict[str, str] = dataclasses.field(default_factory=dict)  # attr -> lock id
    attr_types: dict[str, str] = dataclasses.field(default_factory=dict)  # attr -> class full name
    methods: dict[str, ast.FunctionDef] = dataclasses.field(default_factory=dict)

    @property
    def full_name_suffix(self) -> str:
        return self.name


@dataclasses.dataclass
class FileModel:
    pf: ParsedFile
    imports: dict[str, str] = dataclasses.field(default_factory=dict)  # local -> dotted
    classes: dict[str, ClassModel] = dataclasses.field(default_factory=dict)
    module_locks: dict[str, str] = dataclasses.field(default_factory=dict)  # var -> lock id
    functions: dict[str, ast.FunctionDef] = dataclasses.field(default_factory=dict)

    @property
    def module_name(self) -> str:
        return self.pf.rel_path[: -len(".py")].replace("/", ".")


@dataclasses.dataclass
class CallSite:
    callee: str  # summary key
    held: tuple[str, ...]  # lock ids held at the call
    line: int
    qualname: str
    rel_path: str
    label: str  # short human label for the callee


@dataclasses.dataclass
class FnSummary:
    key: str
    rel_path: str
    qualname: str
    acquires: set[str] = dataclasses.field(default_factory=set)
    blocks: Optional[str] = None  # description of first direct blocking call
    blocks_trans: Optional[str] = None
    calls: list[CallSite] = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------- inventory
def _dotted(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _is_lock_ctor(call: ast.Call, imports: dict[str, str]) -> bool:
    name = _dotted(call.func)
    if name is None:
        return False
    last = name.split(".")[-1]
    if last in LOCK_FACTORY_NAMES:  # utils.locks factories, however imported
        return True
    if name.startswith("threading.") and last in THREADING_LOCK_CTORS:
        return True
    return imports.get(name) in {f"threading.{c}" for c in THREADING_LOCK_CTORS}


def _resolve_dotted(name: str, fm: "FileModel") -> str:
    """Expand a local (possibly dotted) name to its full module path using
    the file's import table; bare names default to the file's own module."""
    if "." in name:
        head, _, rest = name.partition(".")
        base = fm.imports.get(head)
        return f"{base}.{rest}" if base else name
    return fm.imports.get(name, f"{fm.module_name}.{name}")


def _build_file_model(pf: ParsedFile) -> FileModel:
    fm = FileModel(pf=pf)
    for node in pf.walk():
        if isinstance(node, ast.Import):
            for alias in node.names:
                fm.imports[alias.asname or alias.name.split(".")[0]] = alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for alias in node.names:
                fm.imports[alias.asname or alias.name] = f"{node.module}.{alias.name}"
    for node in ast.iter_child_nodes(pf.tree):
        if isinstance(node, ast.ClassDef):
            cm = ClassModel(rel_path=pf.rel_path, name=node.name)
            fm.classes[node.name] = cm
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    cm.methods[item.name] = item
        elif isinstance(node, ast.FunctionDef):
            fm.functions[node.name] = node
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            if (
                isinstance(target, ast.Name)
                and isinstance(node.value, ast.Call)
                and _is_lock_ctor(node.value, fm.imports)
            ):
                fm.module_locks[target.id] = f"{pf.rel_path}:{target.id}"
    return fm


def _bind_class_attrs(fm: FileModel, class_registry: dict[str, ClassModel]) -> None:
    """Scan every method for ``self.X = <lock ctor | ProjectClass(...)>``."""
    for cm in fm.classes.values():
        for method in cm.methods.values():
            for node in ast.walk(method):
                if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                    continue
                target = node.targets[0]
                if not (
                    isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"
                    and isinstance(node.value, ast.Call)
                ):
                    continue
                if _is_lock_ctor(node.value, fm.imports):
                    cm.lock_attrs[target.attr] = (
                        f"{fm.pf.rel_path}:{cm.name}.{target.attr}"
                    )
                    continue
                ctor = _dotted(node.value.func)
                if ctor is None:
                    continue
                full = _resolve_dotted(ctor, fm)
                if full in class_registry:
                    cm.attr_types[target.attr] = full


# ---------------------------------------------------------------- summaries
class _FnWalker:
    """Single-function walk tracking the statically-held lock stack."""

    def __init__(
        self,
        summary: FnSummary,
        fm: FileModel,
        cm: Optional[ClassModel],
        class_registry: dict[str, ClassModel],
        edges: dict[tuple[str, str], tuple[str, int, str]],
        blocking_sites: list[tuple[str, int, str, str, str]],
    ) -> None:
        self.s = summary
        self.fm = fm
        self.cm = cm
        self.registry = class_registry
        self.edges = edges
        self.blocking_sites = blocking_sites
        self.held: list[str] = []

    # -- resolution helpers
    def lock_of(self, expr: ast.AST) -> Optional[str]:
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and self.cm is not None
        ):
            return self.cm.lock_attrs.get(expr.attr)
        if isinstance(expr, ast.Name):
            return self.fm.module_locks.get(expr.id)
        return None

    def callee_key(self, func: ast.AST) -> Optional[tuple[str, str]]:
        """(summary key, short label) for a resolvable call target."""
        if isinstance(func, ast.Name):
            if func.id in self.fm.functions:
                return f"{self.fm.pf.rel_path}:{func.id}", func.id
            target = self.registry.get(_resolve_dotted(func.id, self.fm))
            if target is not None and "__init__" in target.methods:
                return f"{target.rel_path}:{target.name}.__init__", f"{target.name}()"
            return None
        if not isinstance(func, ast.Attribute):
            return None
        recv, meth = func.value, func.attr
        if isinstance(recv, ast.Name) and recv.id == "self" and self.cm is not None:
            if meth in self.cm.methods:
                return f"{self.cm.rel_path}:{self.cm.name}.{meth}", f"self.{meth}"
            return None
        if (
            isinstance(recv, ast.Attribute)
            and isinstance(recv.value, ast.Name)
            and recv.value.id == "self"
            and self.cm is not None
        ):
            bound = self.cm.attr_types.get(recv.attr)
            target = self.registry.get(bound) if bound else None
            if target is not None and meth in target.methods:
                return (
                    f"{target.rel_path}:{target.name}.{meth}",
                    f"self.{recv.attr}.{meth}",
                )
        return None

    def blocking_label(self, call: ast.Call) -> tuple[Optional[str], Optional[str]]:
        """(label, holder-lock id) for a blocking call, (None, None) if benign.

        ``Condition.wait`` on a held lock releases that lock for the wait, so
        it only counts as blocking with respect to OTHER locks still held.
        """
        func = call.func
        if not isinstance(func, ast.Attribute):
            return None, None
        recv, attr = func.value, func.attr
        recv_src = ast.unparse(recv)
        holder = self.held[-1] if self.held else None
        if attr == "sleep" and recv_src == "time":
            return "time.sleep", holder
        if attr in BLOCKING_ATTRS:
            if attr == "wait":
                waited = self.lock_of(recv)
                if waited is not None and waited in self.held:
                    others = [h for h in self.held if h != waited]
                    if not others:
                        return None, None
                    return "wait", others[-1]
            return attr, holder
        if attr == "close" and CLOSE_RECEIVER_RE.search(recv_src):
            return "close", holder
        return None, None

    # -- traversal
    def run(self, fn: ast.FunctionDef) -> None:
        self._stmts(fn.body)

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
                    self._acquired(lock_id, stmt.lineno)
                    taken.append(lock_id)
            self.held.extend(taken)
            self._stmts(stmt.body)
            del self.held[len(self.held) - len(taken):]
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # Nested defs (callbacks) run later, not under the current locks.
            saved, self.held = self.held, []
            self._stmts(stmt.body)
            self.held = saved
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, (ast.stmt, ast.excepthandler, ast.match_case)):
                self._stmt(child)
            else:
                self._expr(child)

    def _expr(self, node: ast.AST) -> None:
        if isinstance(node, ast.Lambda):
            # Deferred execution: the body does not run under current locks.
            saved, self.held = self.held, []
            self._expr(node.body)
            self.held = saved
            return
        if isinstance(node, ast.Call):
            self._call(node)
        for child in ast.iter_child_nodes(node):
            self._expr(child)

    def _call(self, call: ast.Call) -> None:
        func = call.func
        # Explicit lock.acquire() without a with-scope.
        if isinstance(func, ast.Attribute) and func.attr == "acquire":
            lock_id = self.lock_of(func.value)
            if lock_id is not None:
                self._acquired(lock_id, call.lineno)
                return
        label, holder = self.blocking_label(call)
        if label is not None:
            if self.s.blocks is None:
                self.s.blocks = f"{label} (line {call.lineno})"
            if holder is not None:
                self.blocking_sites.append(
                    (self.s.rel_path, call.lineno, self.s.qualname, label, holder)
                )
        resolved = self.callee_key(func)
        if resolved is not None:
            key, short = resolved
            self.s.calls.append(CallSite(
                callee=key, held=tuple(self.held), line=call.lineno,
                qualname=self.s.qualname, rel_path=self.s.rel_path, label=short,
            ))

    def _acquired(self, lock_id: str, lineno: int) -> None:
        self.s.acquires.add(lock_id)
        for holder in self.held:
            if holder != lock_id:
                self.edges.setdefault(
                    (holder, lock_id), (self.s.rel_path, lineno, self.s.qualname)
                )


# ------------------------------------------------------------------ checker
def build_lock_model(project: Project):
    """(summaries, edges, blocking_sites) — exposed for tests/tools."""
    file_models = {pf.rel_path: _build_file_model(pf) for pf in project.files}
    class_registry: dict[str, ClassModel] = {}
    for fm in file_models.values():
        for cm in fm.classes.values():
            class_registry[f"{fm.module_name}.{cm.name}"] = cm
    for fm in file_models.values():
        _bind_class_attrs(fm, class_registry)

    summaries: dict[str, FnSummary] = {}
    edges: dict[tuple[str, str], tuple[str, int, str]] = {}
    blocking_sites: list[tuple[str, int, str, str, str]] = []

    def summarize(fm: FileModel, cm: Optional[ClassModel], fn: ast.FunctionDef, qual: str):
        key = f"{fm.pf.rel_path}:{qual}"
        s = FnSummary(key=key, rel_path=fm.pf.rel_path, qualname=qual)
        summaries[key] = s
        _FnWalker(s, fm, cm, class_registry, edges, blocking_sites).run(fn)

    for fm in file_models.values():
        for name, fn in fm.functions.items():
            summarize(fm, None, fn, name)
        for cm in fm.classes.values():
            for name, fn in cm.methods.items():
                summarize(fm, cm, fn, f"{cm.name}.{name}")

    # Fixed point: propagate acquire-sets and the blocks flag through calls.
    changed = True
    while changed:
        changed = False
        for s in summaries.values():
            for site in s.calls:
                callee = summaries.get(site.callee)
                if callee is None:
                    continue
                if not callee.acquires <= s.acquires:
                    s.acquires |= callee.acquires
                    changed = True
                callee_blocks = callee.blocks_trans or callee.blocks
                if callee_blocks and s.blocks_trans is None and s.blocks is None:
                    s.blocks_trans = f"via {site.label}: {callee_blocks}"
                    changed = True

    # Call-site effects: edges + blocking-through-calls.
    for s in summaries.values():
        for site in s.calls:
            callee = summaries.get(site.callee)
            if callee is None or not site.held:
                continue
            for holder in site.held:
                for acquired in callee.acquires:
                    if acquired != holder:
                        edges.setdefault(
                            (holder, acquired), (site.rel_path, site.line, site.qualname)
                        )
            callee_blocks = callee.blocks_trans or callee.blocks
            if callee_blocks:
                blocking_sites.append((
                    site.rel_path, site.line, site.qualname,
                    f"{site.label} -> {callee_blocks}", site.held[-1],
                ))
    return summaries, edges, blocking_sites


def _cycles(edges: dict[tuple[str, str], tuple[str, int, str]]) -> list[list[str]]:
    graph: dict[str, set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    sccs: list[list[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:  # iterative Tarjan
        work = [(v, iter(sorted(graph[v])))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph[w]))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                if len(scc) > 1 or node in graph[node]:
                    sccs.append(sorted(scc))

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)
    return sccs


def check_lock_order(project: Project) -> list[Finding]:
    _, edges, blocking_sites = build_lock_model(project)
    findings: list[Finding] = []
    for scc in _cycles(edges):
        first_edge = next(
            ((a, b) for (a, b) in sorted(edges) if a in scc and b in scc), None
        )
        rel_path, line, qual = edges[first_edge] if first_edge else (scc[0].split(":")[0], 1, "<module>")
        findings.append(Finding(
            checker="lock-order",
            path=rel_path,
            line=line,
            qualname=qual,
            detail="cycle:" + "->".join(scc),
            message=(
                "lock-acquisition cycle (potential deadlock by circular "
                "wait): " + " -> ".join(scc)
            ),
        ))
    seen: set[str] = set()
    for rel_path, line, qual, label, holder in blocking_sites:
        lock_short = holder.split(":")[-1]
        f = Finding(
            checker="lock-order",
            path=rel_path,
            line=line,
            qualname=qual,
            detail=f"blocking:{label.split(' ')[0].split(':')[0]}@{lock_short}",
            message=(
                f"blocking call ({label}) while holding lock {holder}; "
                "move the slow operation outside the critical section"
            ),
        )
        if f.fingerprint not in seen:
            seen.add(f.fingerprint)
            findings.append(f)
    return findings
