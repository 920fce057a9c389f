"""Per-file invariant checkers: deadline discipline, bounded concurrency,
monotonic clock, swallowed exceptions.

Counterpart of tieredstorage_tpu/analysis/checkers.py over this package's
paths. Each is a small AST pass with project-specific knowledge encoded up
front (the request-path module set, the sanctioned-daemon registry, the
deadline-wrapper allowlist) so that a violation is a *finding*, not a style
opinion: every rule here maps to a production invariant the serving tier
already relies on (the end-to-end Deadline budget, the bounded pools).
Where an entry names this package's twin of a JAX module, it keeps the JAX
package's justification.
"""

from __future__ import annotations

import ast
from typing import Optional

from tieredstorage_tpu_torch.analysis.core import Finding, Project

# ---------------------------------------------------------------- deadline
#: Modules on the request path: every blocking wait here must clamp its
#: timeout to the end-to-end Deadline budget (utils/deadline.py).
REQUEST_PATH_PREFIXES = (
    "tieredstorage_tpu_torch/storage/",
    "tieredstorage_tpu_torch/fetch/",
    "tieredstorage_tpu_torch/fleet/",
    "tieredstorage_tpu_torch/sidecar/",
)

#: Identifier fragments that mark a timeout expression as budget-derived:
#: the Deadline API (remaining/deadline/budget), an explicit timeout knob
#: plumbed from config, or a hedge delay (itself p95-derived and bounded).
DEADLINE_NAME_FRAGMENTS = (
    "deadline", "remaining", "budget", "timeout", "delay", "grace",
)

#: Functions that ARE the sanctioned daemons' run loops: their idle waits
#: pace a background thread (interval sleeps), not a caller's request.
DAEMON_LOOP_FUNCTIONS = {
    "tieredstorage_tpu_torch/storage/replicated.py:HealthProber._run",
    "tieredstorage_tpu_torch/sidecar/server.py:main",
    "tieredstorage_tpu_torch/fleet/gossip.py:GossipAgent._run",
    "tieredstorage_tpu_torch/transform/batcher.py:WindowBatcher._run",
}

#: Blocking-wait method names checked for a clamped timeout argument.
WAIT_METHODS = {"wait", "result"}


def _timeout_expr(call: ast.Call) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == "timeout":
            return kw.value
    if call.args:
        return call.args[0]
    return None


def _mentions_budget(expr: ast.AST) -> bool:
    for node in ast.walk(expr):
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        elif isinstance(node, ast.keyword):
            name = node.arg
        if name and any(frag in name.lower() for frag in DEADLINE_NAME_FRAGMENTS):
            return True
    return False


def check_deadline_discipline(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for pf in project.files:
        if not pf.rel_path.startswith(REQUEST_PATH_PREFIXES):
            continue
        for node in pf.walk():
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
                continue
            if node.func.attr not in WAIT_METHODS:
                continue
            qual = pf.qualname_of(node)
            if f"{pf.rel_path}:{qual}" in DAEMON_LOOP_FUNCTIONS:
                continue
            recv = ast.unparse(node.func.value)
            timeout = _timeout_expr(node)
            if timeout is None:
                findings.append(Finding(
                    checker="deadline",
                    path=pf.rel_path,
                    line=node.lineno,
                    qualname=qual,
                    detail=f"unbounded:{node.func.attr}@{recv}",
                    message=(
                        f"unbounded blocking {node.func.attr}() on {recv!r} in a "
                        "request-path module; pass a timeout clamped to the "
                        "remaining Deadline budget"
                    ),
                ))
            elif not _mentions_budget(timeout):
                findings.append(Finding(
                    checker="deadline",
                    path=pf.rel_path,
                    line=node.lineno,
                    qualname=qual,
                    detail=f"unclamped:{node.func.attr}@{recv}",
                    message=(
                        f"blocking {node.func.attr}() on {recv!r} has a timeout "
                        f"({ast.unparse(timeout)!r}) that is not derived from the "
                        "Deadline budget (expected a deadline/remaining/budget/"
                        "timeout/delay expression)"
                    ),
                ))
    return findings


# ----------------------------------------------------- bounded concurrency
#: The ONLY places allowed to spawn a raw thread: long-lived, named,
#: daemonized singletons with a stop() path. Everything else must ride a
#: bounded executor.
SANCTIONED_THREAD_SPAWNS = {
    "tieredstorage_tpu_torch/metrics/prometheus.py:PrometheusExporter.__init__":
        "metrics exporter serve loop (one per endpoint, stopped via close)",
    "tieredstorage_tpu_torch/storage/replicated.py:HealthProber.start":
        "replica health-probe daemon (one per replicated backend)",
    "tieredstorage_tpu_torch/scrub/antientropy.py:AntiEntropyScheduler.start":
        "anti-entropy daemon (one per RSM)",
    "tieredstorage_tpu_torch/scrub/scheduler.py:ScrubScheduler.start":
        "scrub daemon (one per RSM)",
    "tieredstorage_tpu_torch/scrub/sweeper.py:SweepScheduler.start":
        "recovery-sweep daemon (one per RSM, stopped via stop)",
    "tieredstorage_tpu_torch/sidecar/http_gateway.py:SidecarHttpGateway.start":
        "gateway accept loop (workers ride the bounded executor)",
    "tieredstorage_tpu_torch/fleet/gossip.py:GossipAgent.start":
        "gossip membership daemon (one per fleet member, stopped via stop)",
    "tieredstorage_tpu_torch/transform/batcher.py:WindowBatcher.start":
        "cross-request GCM flush daemon (one device queue per backend, "
        "stopped via stop)",
}


def check_bounded_concurrency(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for pf in project.files:
        for node in pf.walk():
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            qual = pf.qualname_of(node)
            site = f"{pf.rel_path}:{qual}"
            if name in ("threading.Thread", "Thread", "_thread.start_new_thread",
                        "multiprocessing.Process"):
                if site in SANCTIONED_THREAD_SPAWNS:
                    if not any(
                        kw.arg == "daemon"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is True
                        for kw in node.keywords
                    ):
                        findings.append(Finding(
                            checker="bounded-concurrency",
                            path=pf.rel_path, line=node.lineno, qualname=qual,
                            detail="thread-not-daemon",
                            message=(
                                "sanctioned daemon thread must pass daemon=True "
                                "(a wedged loop must not block interpreter exit)"
                            ),
                        ))
                    continue
                findings.append(Finding(
                    checker="bounded-concurrency",
                    path=pf.rel_path, line=node.lineno, qualname=qual,
                    detail="unsanctioned-thread",
                    message=(
                        "bare threading.Thread outside the sanctioned-daemon "
                        "registry; use a bounded executor, or register the "
                        "daemon in analysis/checkers.py:SANCTIONED_THREAD_SPAWNS"
                    ),
                ))
            elif name is not None and name.split(".")[-1] == "ThreadPoolExecutor":
                if not any(kw.arg == "max_workers" for kw in node.keywords) and not node.args:
                    findings.append(Finding(
                        checker="bounded-concurrency",
                        path=pf.rel_path, line=node.lineno, qualname=qual,
                        detail="unbounded-executor",
                        message=(
                            "ThreadPoolExecutor without max_workers (defaults "
                            "to cpu*5 threads); size the pool explicitly"
                        ),
                    ))
    return findings


def _call_name(call: ast.Call) -> Optional[str]:
    func = call.func
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        parts = []
        node: ast.AST = func
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
            return ".".join(reversed(parts))
    return None


# ------------------------------------------------------------ monotonic clock
def check_monotonic_clock(project: Project) -> list[Finding]:
    """``time.time()`` is wall clock: NTP steps make durations computed from
    it lie, so timeouts/intervals/latency math must use ``time.monotonic()``.
    The rare protocol-mandated wall-clock read (JWT iat/exp) carries a
    suppression with its justification."""
    findings: list[Finding] = []
    for pf in project.files:
        for node in pf.walk():
            if (
                isinstance(node, ast.Call)
                and _call_name(node) in ("time.time", "time.clock")
            ):
                qual = pf.qualname_of(node)
                findings.append(Finding(
                    checker="monotonic-clock",
                    path=pf.rel_path, line=node.lineno, qualname=qual,
                    detail="time.time",
                    message=(
                        "time.time() is wall clock (steps under NTP); use "
                        "time.monotonic() for durations/timeouts, or suppress "
                        "with a justification if wall time is protocol-required"
                    ),
                ))
    return findings


# --------------------------------------------------------- swallowed except
BROAD_EXCEPTION_NAMES = {"Exception", "BaseException"}


def _is_broad_handler(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:  # bare except
        return True
    types = (
        handler.type.elts if isinstance(handler.type, ast.Tuple) else [handler.type]
    )
    for t in types:
        name = t.id if isinstance(t, ast.Name) else (
            t.attr if isinstance(t, ast.Attribute) else None
        )
        if name in BROAD_EXCEPTION_NAMES:
            return True
    return False


def _is_empty_body(body: list[ast.stmt]) -> bool:
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            continue  # docstring / ellipsis
        return False
    return True


def check_swallowed_exceptions(project: Project) -> list[Finding]:
    """A broad ``except Exception: pass`` erases failures with no trace
    event, metric, or log — the scrubber exists because silent failure is
    the worst failure. Narrow catches (``except KeyError: pass``)
    are the deliberate-fallback idiom and stay legal; broad handlers must
    *do* something (counter bump, tracer event, log, re-raise)."""
    findings: list[Finding] = []
    for pf in project.files:
        for node in pf.walk():
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not (_is_broad_handler(node) and _is_empty_body(node.body)):
                continue
            qual = pf.qualname_of(node)
            caught = ast.unparse(node.type) if node.type else "<bare>"
            findings.append(Finding(
                checker="swallowed-exception",
                path=pf.rel_path, line=node.lineno, qualname=qual,
                detail=f"swallow:{caught}",
                message=(
                    f"broad 'except {caught}' with an empty body swallows "
                    "failures silently; record a metric/trace event/log (or "
                    "narrow the exception type)"
                ),
            ))
    return findings


__all__ = [
    "check_deadline_discipline",
    "check_bounded_concurrency",
    "check_monotonic_clock",
    "check_swallowed_exceptions",
    "SANCTIONED_THREAD_SPAWNS",
    "DAEMON_LOOP_FUNCTIONS",
    "REQUEST_PATH_PREFIXES",
]
