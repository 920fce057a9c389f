"""CLI: ``python -m tieredstorage_tpu_torch.analysis``.

Exit status: 0 when every finding is suppressed-with-justification and no
suppression is stale; 1 otherwise. ``--json`` writes the machine-readable
report.

``--paths <files...>`` is the INCREMENTAL developer mode: only the given
files are parsed (through a content-hash parse cache under ``artifacts/``,
so an editor-save lint loop on a small diff is sub-second), every checker
runs on that subset, and the stale-suppression gate is skipped (a subset
cannot see every finding a suppression covers). Cross-module context
outside the given files is invisible there, so full-project mode stays the
gate.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from tieredstorage_tpu_torch.analysis.core import (
    Suppressions,
    SuppressionError,
    checker_registry,
    load_project,
    run_analysis,
)

DEFAULT_SUPPRESSIONS = "tools/torch_analysis_suppressions.txt"
PARSE_CACHE = "artifacts/torch_analysis_parse_cache.pkl"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tieredstorage_tpu_torch.analysis", description=__doc__
    )
    ap.add_argument(
        "--root", default=None,
        help="repo root (default: autodetected from the package location)",
    )
    ap.add_argument(
        "--json", default=None, metavar="PATH",
        help="write the JSON findings artifact here",
    )
    ap.add_argument(
        "--suppressions", default=None, metavar="PATH",
        help=f"suppression file (default: <root>/{DEFAULT_SUPPRESSIONS})",
    )
    ap.add_argument(
        "--checker", action="append", default=None, metavar="NAME",
        help="run only this checker (repeatable); default: all",
    )
    ap.add_argument(
        "--scan", action="append", default=None, metavar="DIR",
        help="directory/file under root to scan (default: tieredstorage_tpu_torch)",
    )
    ap.add_argument(
        "--paths", nargs="+", default=None, metavar="FILE",
        help="incremental mode: analyze only these files (repo-relative), "
        "via the parse cache; stale-suppression check skipped",
    )
    ap.add_argument(
        "--parse-cache", default=None, metavar="PATH",
        help="parse-cache pickle for --paths mode "
        f"(default: <root>/{PARSE_CACHE})",
    )
    ap.add_argument(
        "--list-checkers", action="store_true", help="list checkers and exit"
    )
    ap.add_argument(
        "-q", "--quiet", action="store_true",
        help="suppress the per-finding text output (summary only)",
    )
    args = ap.parse_args(argv)

    if args.list_checkers:
        for name in checker_registry():
            print(name)
        return 0

    root = (
        Path(args.root).resolve()
        if args.root
        else Path(__file__).resolve().parents[2]
    )
    suppressions_path = (
        Path(args.suppressions) if args.suppressions else root / DEFAULT_SUPPRESSIONS
    )
    try:
        suppressions = Suppressions.load(suppressions_path)
    except SuppressionError as e:
        print(f"analysis: bad suppression file: {e}", file=sys.stderr)
        return 2

    if args.paths:
        cache = (
            Path(args.parse_cache)
            if args.parse_cache
            else root / PARSE_CACHE
        )
        scan = [
            Path(p).resolve().relative_to(root).as_posix()
            if Path(p).is_absolute()
            else p
            for p in args.paths
        ]
        project = load_project(root, scan, cache_path=cache)
    else:
        project = load_project(root, args.scan)
    only = args.checker
    if args.paths and only is None:
        # config-drift's declared-keys check is whole-project by nature
        # (declarations live in other files); a subset view would flood
        # with false undeclared-key findings.
        only = [n for n in checker_registry() if n != "config-drift"]
    report = run_analysis(project, suppressions=suppressions, only=only)
    if args.paths:
        # Subset view: a suppression whose finding lives elsewhere is not
        # stale — drop unmatched entries so only real findings gate.
        for fingerprint in report.stale_suppressions:
            del report.suppressions.entries[fingerprint]

    if args.json:
        report.write_json(Path(args.json))
    text = report.render_text()
    if args.quiet:
        text = "\n".join(text.splitlines()[-2:])
    print(text)
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
