"""Checker framework: parsed project model, findings, suppressions, reports.

Counterpart of tieredstorage_tpu/analysis/core.py over this package's tree.
Pure stdlib ``ast``: every checker is a function ``(Project) ->
list[Finding]`` registered in ``checker_registry``, and the CLI
(``__main__.py``) renders text + a JSON artifact and exits non-zero on any
unsuppressed finding OR any stale suppression — the suppression file is a
burn-down list, not a grandfather clause.

Fingerprints are deliberately line-independent
(``checker:path:qualname:detail``, the JAX package's form) so a suppression
survives unrelated edits to the file but dies with the code it covers.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import pickle
from pathlib import Path
from typing import Callable, Iterable, Optional


# --------------------------------------------------------------------- model
@dataclasses.dataclass(frozen=True)
class Finding:
    checker: str
    path: str  # repo-relative, posix separators
    line: int
    qualname: str  # enclosing class.function ("<module>" at top level)
    detail: str  # stable short code (call name, lock edge, config key...)
    message: str

    @property
    def fingerprint(self) -> str:
        return f"{self.checker}:{self.path}:{self.qualname}:{self.detail}"

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}: [{self.checker}] {self.message}"
            f"\n    fingerprint: {self.fingerprint}"
        )


class ParsedFile:
    """One source file: AST with parent links and enclosing-scope names."""

    def __init__(self, path: Path, rel_path: str, source: str) -> None:
        self.path = path
        self.rel_path = rel_path
        self.source = source
        self.tree = ast.parse(source, filename=rel_path)
        self._annotate()

    def _annotate(self) -> None:
        """Attach ``_ts_parent`` and ``_ts_qual`` (enclosing qualname) to
        every node; scope nodes are Module / ClassDef / FunctionDef."""
        scopes = [(self.tree, "<module>")]
        self.tree._ts_qual = "<module>"  # type: ignore[attr-defined]
        stack = [(self.tree, "<module>")]
        while stack:
            node, qual = stack.pop()
            for child in ast.iter_child_nodes(node):
                child._ts_parent = node  # type: ignore[attr-defined]
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                    child_qual = child.name if qual == "<module>" else f"{qual}.{child.name}"
                else:
                    child_qual = qual
                child._ts_qual = child_qual  # type: ignore[attr-defined]
                stack.append((child, child_qual))
        del scopes

    def qualname_of(self, node: ast.AST) -> str:
        return getattr(node, "_ts_qual", "<module>")

    def walk(self) -> Iterable[ast.AST]:
        return ast.walk(self.tree)


class Project:
    """Every parsed file under the scan root, plus repo-level context."""

    def __init__(self, root: Path, files: list[ParsedFile]) -> None:
        self.root = root
        self.files = files

    def file(self, rel_path: str) -> Optional[ParsedFile]:
        for pf in self.files:
            if pf.rel_path == rel_path:
                return pf
        return None


def load_project(
    root: Path,
    scan_dirs: Optional[list[str]] = None,
    *,
    cache_path: Optional[Path] = None,
) -> Project:
    """Parse every ``.py`` file under ``scan_dirs`` (default: the package).

    With ``cache_path``, parsed+annotated trees are reused from a
    content-hash pickle (the incremental ``--paths`` mode's parse cache —
    whole-tree runs parse faster than they unpickle, so the CI gate never
    passes one). The cache is strictly best-effort: any read/write failure
    degrades to a plain parse.
    """
    root = Path(root).resolve()
    dirs = scan_dirs or ["tieredstorage_tpu_torch"]
    cache: dict[str, tuple[str, ParsedFile]] = {}
    if cache_path is not None and cache_path.exists():
        try:
            cache = pickle.loads(cache_path.read_bytes())
        except Exception as e:  # noqa: BLE001 — corrupt/foreign cache: reparse
            _note_cache_failure(e)
            cache = {}
    changed = False
    files: list[ParsedFile] = []
    for d in dirs:
        base = root / d
        paths = sorted(base.rglob("*.py")) if base.is_dir() else [base]
        for path in paths:
            if "__pycache__" in path.parts:
                continue
            rel = path.relative_to(root).as_posix()
            source = path.read_text()
            digest = hashlib.sha256(source.encode()).hexdigest()
            hit = cache.get(rel)
            if hit is not None and hit[0] == digest:
                files.append(hit[1])
                continue
            pf = ParsedFile(path, rel, source)
            cache[rel] = (digest, pf)
            changed = True
            files.append(pf)
    if cache_path is not None and changed:
        try:
            cache_path.parent.mkdir(parents=True, exist_ok=True)
            cache_path.write_bytes(
                pickle.dumps(cache, protocol=pickle.HIGHEST_PROTOCOL)
            )
        except Exception as e:  # noqa: BLE001 — cache is an optimization only
            _note_cache_failure(e)
    return Project(root, files)


#: Last parse-cache read/write failure, for inspection (the cache is a pure
#: optimization — every failure degrades to a plain parse, but must not
#: vanish without a trace: swallowed-exception checker).
_CACHE_LAST_ERROR: list[str] = []


def _note_cache_failure(exc: BaseException) -> None:
    _CACHE_LAST_ERROR[:] = [repr(exc)]


# --------------------------------------------------------------- suppressions
class SuppressionError(ValueError):
    pass


class Suppressions:
    """Vetted per-finding suppressions: ``<fingerprint>  # <justification>``.

    Every entry MUST carry a non-empty justification; entries that no longer
    match any finding are STALE and fail the run (burn-down semantics: fixed
    code must shed its suppression in the same change).
    """

    def __init__(self, entries: Optional[dict[str, str]] = None) -> None:
        #: fingerprint -> justification, insertion-ordered
        self.entries: dict[str, str] = dict(entries or {})

    @classmethod
    def parse(cls, text: str, *, origin: str = "<suppressions>") -> "Suppressions":
        entries: dict[str, str] = {}
        for lineno, raw in enumerate(text.splitlines(), 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            fingerprint, sep, justification = line.partition("#")
            fingerprint = fingerprint.strip()
            justification = justification.strip()
            if not sep or not justification:
                raise SuppressionError(
                    f"{origin}:{lineno}: suppression {fingerprint!r} needs a "
                    "'# <one-line justification>'"
                )
            if fingerprint in entries:
                raise SuppressionError(
                    f"{origin}:{lineno}: duplicate suppression {fingerprint!r}"
                )
            entries[fingerprint] = justification
        return cls(entries)

    @classmethod
    def load(cls, path: Path) -> "Suppressions":
        if not path.exists():
            return cls()
        return cls.parse(path.read_text(), origin=str(path))

    def serialize(self) -> str:
        lines = [
            "# Static-analysis suppressions (tools/torch_analysis_suppressions.txt).",
            "# One vetted finding per line: <fingerprint>  # <justification>.",
            "# Stale entries FAIL the analysis - remove them with the fix.",
            "",
        ]
        lines += [f"{fp}  # {why}" for fp, why in self.entries.items()]
        return "\n".join(lines) + "\n"

    def justification(self, fingerprint: str) -> Optional[str]:
        return self.entries.get(fingerprint)


# -------------------------------------------------------------------- report
@dataclasses.dataclass
class AnalysisReport:
    root: str
    files_scanned: int
    checkers: list[str]
    findings: list[Finding]
    suppressions: Suppressions
    notes: list[str] = dataclasses.field(default_factory=list)

    @property
    def suppressed(self) -> list[tuple[Finding, str]]:
        return [
            (f, self.suppressions.entries[f.fingerprint])
            for f in self.findings
            if f.fingerprint in self.suppressions.entries
        ]

    @property
    def unsuppressed(self) -> list[Finding]:
        return [
            f for f in self.findings
            if f.fingerprint not in self.suppressions.entries
        ]

    @property
    def stale_suppressions(self) -> list[str]:
        live = {f.fingerprint for f in self.findings}
        return [fp for fp in self.suppressions.entries if fp not in live]

    @property
    def ok(self) -> bool:
        return not self.unsuppressed and not self.stale_suppressions

    def to_json(self) -> dict:
        return {
            "version": 1,
            "generated_by": "tieredstorage_tpu_torch.analysis",
            "root": self.root,
            "files_scanned": self.files_scanned,
            "checkers": list(self.checkers),
            "findings": [
                {
                    "checker": f.checker,
                    "path": f.path,
                    "line": f.line,
                    "qualname": f.qualname,
                    "detail": f.detail,
                    "message": f.message,
                    "fingerprint": f.fingerprint,
                    "suppressed": f.fingerprint in self.suppressions.entries,
                    "justification": self.suppressions.justification(f.fingerprint),
                }
                for f in self.findings
            ],
            "stale_suppressions": self.stale_suppressions,
            "notes": list(self.notes),
            "summary": {
                "total": len(self.findings),
                "suppressed": len(self.suppressed),
                "unsuppressed": len(self.unsuppressed),
                "stale_suppressions": len(self.stale_suppressions),
                "ok": self.ok,
            },
        }

    def render_text(self) -> str:
        out: list[str] = []
        for f in self.unsuppressed:
            out.append(f.render())
        if self.stale_suppressions:
            out.append("stale suppressions (no longer match any finding):")
            out += [f"    {fp}" for fp in self.stale_suppressions]
        out.append(
            f"analysis: {self.files_scanned} files, "
            f"{len(self.findings)} finding(s) "
            f"({len(self.suppressed)} suppressed, "
            f"{len(self.unsuppressed)} unsuppressed, "
            f"{len(self.stale_suppressions)} stale suppression(s))"
        )
        out.append("analysis: OK" if self.ok else "analysis: FAIL")
        return "\n".join(out)

    def write_json(self, path: Path) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(), indent=1) + "\n")


# ----------------------------------------------------------------- execution
CheckerFn = Callable[[Project], list[Finding]]


def checker_registry() -> dict[str, CheckerFn]:
    """Name -> checker function (import deferred to avoid cycles)."""
    from tieredstorage_tpu_torch.analysis import checkers, dispatch, drift, lockorder, races

    return {
        "lock-order": lockorder.check_lock_order,
        "races": races.check_races,
        "device-dispatch": dispatch.check_device_dispatch,
        "deadline": checkers.check_deadline_discipline,
        "bounded-concurrency": checkers.check_bounded_concurrency,
        "monotonic-clock": checkers.check_monotonic_clock,
        "swallowed-exception": checkers.check_swallowed_exceptions,
        "config-drift": drift.check_config_drift,
    }


def run_analysis(
    project: Project,
    *,
    suppressions: Optional[Suppressions] = None,
    only: Optional[list[str]] = None,
) -> AnalysisReport:
    registry = checker_registry()
    names = list(registry) if only is None else list(only)
    unknown = [n for n in names if n not in registry]
    if unknown:
        raise ValueError(f"unknown checker(s): {', '.join(unknown)}")
    findings: list[Finding] = []
    notes: list[str] = []
    for name in names:
        result = registry[name](project)
        for item in result:
            if isinstance(item, Finding):
                findings.append(item)
            else:  # (finding-list, notes) escape hatch for drift checkers
                notes.append(str(item))
    findings.sort(key=lambda f: (f.path, f.line, f.checker, f.detail))
    return AnalysisReport(
        root=str(project.root),
        files_scanned=len(project.files),
        checkers=names,
        findings=findings,
        suppressions=suppressions or Suppressions(),
        notes=notes,
    )
