"""Config/metrics drift gates.

Counterpart of tieredstorage_tpu/analysis/drift.py over this package's tree
and its generated docs. Two mechanically-checkable invariants tie code to
docs:

1. **Declared reads.** Every config key the code reads (``..._values["k"]``
   subscripts and constant ``_props.get("k")`` lookups) must be declared as
   a ``ConfigKey`` somewhere in the tree. Dynamic key families
   (``encryption.key.pairs.<id>.*``, ``replication.replica.<name>.*``) are
   declared by prefix.

2. **Generated docs.** ``docs/torch/configs.rst`` and
   ``docs/torch/metrics.rst`` are GENERATED from the live ConfigDefs /
   metric registries (``python -m tieredstorage_tpu_torch.docs.configs_docs``
   and ``...metrics_docs``); this checker re-generates both in-process and
   diffs them against the committed files, so a new key or metric cannot
   merge undocumented. The generators need only torch and this package;
   should they fail to import, the docs half degrades to a note in the JSON
   report (the real tree's run is held to having no such note).
"""

from __future__ import annotations

import ast

from tieredstorage_tpu_torch.analysis.core import Finding, Project

#: Key families defined dynamically (two-phase define / reflective config).
DYNAMIC_KEY_PREFIXES = (
    "encryption.key.pairs.",
    "replication.replica.",
)

_GENERATED_DOCS = (
    ("docs/torch/configs.rst", "tieredstorage_tpu_torch.docs.configs_docs"),
    ("docs/torch/metrics.rst", "tieredstorage_tpu_torch.docs.metrics_docs"),
)

#: How the committed generated docs are brought up to date.
_REGENERATE = (
    "regenerate with `python -m tieredstorage_tpu_torch.docs.configs_docs` "
    "and `python -m tieredstorage_tpu_torch.docs.metrics_docs`"
)


def _declared_keys(project: Project) -> set[str]:
    declared: set[str] = set()
    for pf in project.files:
        for node in pf.walk():
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = func.id if isinstance(func, ast.Name) else (
                func.attr if isinstance(func, ast.Attribute) else None
            )
            if name != "ConfigKey" or not node.args:
                continue
            first = node.args[0]
            if isinstance(first, ast.Constant) and isinstance(first.value, str):
                declared.add(first.value)
    return declared


def _read_keys(project: Project) -> list[tuple[str, int, str, str]]:
    """(rel_path, line, qualname, key) for every constant config read."""
    reads: list[tuple[str, int, str, str]] = []
    for pf in project.files:
        for node in pf.walk():
            key = None
            if (
                isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Attribute)
                and node.value.attr.endswith("_values")
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)
            ):
                key = node.slice.value
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and isinstance(node.func.value, ast.Attribute)
                and node.func.value.attr.endswith("_props")
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                key = node.args[0].value
            if key is not None:
                reads.append((pf.rel_path, node.lineno, pf.qualname_of(node), key))
    return reads


def check_config_drift(project: Project) -> list:
    findings: list = []
    declared = _declared_keys(project)
    for rel_path, line, qual, key in _read_keys(project):
        if key in declared or key.startswith(DYNAMIC_KEY_PREFIXES):
            continue
        findings.append(Finding(
            checker="config-drift",
            path=rel_path, line=line, qualname=qual,
            detail=f"undeclared-key:{key}",
            message=(
                f"config key {key!r} is read here but not declared as a "
                "ConfigKey (config/rsm_config.py et al.)"
            ),
        ))

    # Declared-but-undocumented: every key of the central def must render in
    # the committed configs.rst (cheap text containment; the full diff below
    # is the authoritative gate when generators are importable).
    configs_rst = project.root / _GENERATED_DOCS[0][0]
    rst_text = configs_rst.read_text() if configs_rst.exists() else ""
    rsm_config = project.file("tieredstorage_tpu_torch/config/rsm_config.py")
    if rsm_config is not None and rst_text:
        central = _declared_keys(Project(project.root, [rsm_config]))
        for key in sorted(central):
            if f"``{key}``" not in rst_text:
                findings.append(Finding(
                    checker="config-drift",
                    path=_GENERATED_DOCS[0][0], line=1, qualname="<doc>",
                    detail=f"undocumented-key:{key}",
                    message=(
                        f"config key {key!r} is declared but missing from "
                        f"{_GENERATED_DOCS[0][0]} - {_REGENERATE}"
                    ),
                ))

    findings.extend(_check_generated_docs(project))
    return findings


def _check_generated_docs(project: Project) -> list:
    results: list = []
    if project.file("tieredstorage_tpu_torch/config/rsm_config.py") is None:
        return results  # fixture tree, not the real repo: nothing to diff
    for rel, module_name in _GENERATED_DOCS:
        committed = project.root / rel
        if not committed.exists():
            results.append(Finding(
                checker="config-drift", path=rel, line=1, qualname="<doc>",
                detail="missing-doc",
                message=f"{rel} is missing - {_REGENERATE}",
            ))
            continue
        try:
            import importlib

            module = importlib.import_module(module_name)
            generated = module.generate()
        except Exception as e:  # degrade to a note: the generator cannot run here
            results.append(
                f"config-drift: {rel} not re-generated here "
                f"({type(e).__name__}: {e})"
            )
            continue
        if generated != committed.read_text():
            results.append(Finding(
                checker="config-drift", path=rel, line=1, qualname="<doc>",
                detail="stale-generated-doc",
                message=(
                    f"{rel} does not match the output of {module_name} - "
                    f"{_REGENERATE} and commit the result"
                ),
            ))
    return results
