"""The port's static analysis against the JAX package's.

Fixture trees come from the JAX package's own analysis tests
(`tests/test_static_analysis.py`, `tests/test_race_checker.py`): every dict
literal there that lays out a `tieredstorage_tpu/` tree is harvested, laid
out once under each package's prefix in `tmp_path`, and run through both
packages' generic checkers (`lock-order`, `races`, `deadline`,
`bounded-concurrency`, `monotonic-clock`, `swallowed-exception` and the
declared-reads half of `config-drift`). The findings must be the same, at
the same lines, with fingerprints equal after the path map below.

On the real trees: the port's findings are JAX's after the map (less the
named findings the port does not have), its suppression file is JAX's
after the map, its static lock graph is JAX's plus only the listed edges
that touch port-only locks, and the whole port tree passes the CLI.

The map between the packages lives here and only here (`map_path`,
`map_text`, `map_site`); the other `test_torch_*` analysis tests import it.
"""

from __future__ import annotations

import ast
import importlib
import json
import pathlib
import re
import sys
import textwrap

import pytest

from tieredstorage_tpu.analysis import core as jax_core
from tieredstorage_tpu.analysis import lockorder as jax_lockorder
from tieredstorage_tpu_torch.analysis import core, drift, lockorder
from tieredstorage_tpu_torch.analysis.__main__ import main
from tieredstorage_tpu_torch.analysis.core import (
    Suppressions,
    SuppressionError,
    load_project,
    run_analysis,
)

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]

#: The checkers whose rules are the JAX package's, unchanged.
GENERIC = ["lock-order", "races", "deadline", "bounded-concurrency",
           "monotonic-clock", "swallowed-exception", "config-drift"]

#: Findings of the JAX tree the port's tree does not have, with why.
JAX_ONLY_FINDINGS = {
    "swallowed-exception:tieredstorage_tpu/utils/tracing.py:Tracer.event:swallow:Exception":
        "the port's tracer forwards spans to torch.profiler.record_function, "
        "which needs no guarded optional import: there is no handler",
}

#: Edges of the port's static lock graph with no JAX twin: each must touch
#: a port-only lock (analysis/races.py PORT_SHARED_LOCKS). None today.
PORT_ONLY_EDGES: set = set()


# ------------------------------------------------------------- the map
_MODULE_RENAMES = (
    ("tieredstorage_tpu/transform/tpu.py", "tieredstorage_tpu_torch/transform/cuda.py"),
)
_NAME_RENAMES = (("TpuTransformBackend", "CudaTransformBackend"),)


def map_path(path: str) -> str:
    """A JAX repo path (or any text holding such paths) as the port's."""
    for jax, port in _MODULE_RENAMES:
        path = path.replace(jax, port)
    return re.sub(r"\btieredstorage_tpu/", "tieredstorage_tpu_torch/", path)


def map_text(text: str) -> str:
    """JAX source or fingerprint text in the port's terms: paths, dotted
    module names, the backend class and its witness names."""
    text = map_path(text)
    text = re.sub(r"\btieredstorage_tpu\b(?!_)", "tieredstorage_tpu_torch", text)
    for jax, port in _NAME_RENAMES:
        text = text.replace(jax, port)
    return text


def map_site(site: str) -> str:
    """A JAX witness name (lock or mutation site) as the port's twin."""
    return re.sub(r"^tpu\.", "cuda.", site.replace("TpuTransformBackend", "CudaTransformBackend"))


# ------------------------------------------------------ fixture harvest
def harvest(module_name: str) -> list[tuple[str, dict]]:
    """(id, files) for every dict literal in a JAX test module whose keys
    are all `tieredstorage_tpu/` paths, evaluated in the module's namespace
    plus the string constants of its enclosing function."""
    module = importlib.import_module(module_name)
    tree = ast.parse(pathlib.Path(module.__file__).read_text())
    parents = {c: n for n in ast.walk(tree) for c in ast.iter_child_nodes(n)}
    out, seen = [], {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Dict) and node.keys and all(
            isinstance(k, ast.Constant) and isinstance(k.value, str)
            and k.value.startswith("tieredstorage_tpu/") for k in node.keys
        )):
            continue
        scope = node
        while scope in parents and not isinstance(scope, ast.FunctionDef):
            scope = parents[scope]
        namespace = dict(vars(module))
        name = getattr(scope, "name", "module")
        if isinstance(scope, ast.FunctionDef):
            for a in ast.walk(scope):
                if (isinstance(a, ast.Assign) and len(a.targets) == 1
                        and isinstance(a.targets[0], ast.Name)
                        and isinstance(a.value, ast.Constant)):
                    namespace[a.targets[0].id] = a.value.value
        files = eval(compile(ast.Expression(node), module.__file__, "eval"), namespace)
        seen[name] = seen.get(name, 0) + 1
        out.append((f"{module_name.rsplit('.', 1)[-1]}:{name}:{seen[name]}", files))
    return out


def write_tree(root: pathlib.Path, files: dict[str, str]) -> list[str]:
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    return sorted(files)


def port_files(files: dict[str, str]) -> dict[str, str]:
    return {map_path(rel): map_text(src) for rel, src in files.items()}


def both_reports(tmp_path, files, only):
    jax = jax_core.run_analysis(
        jax_core.load_project(tmp_path / "jax", write_tree(tmp_path / "jax", files)),
        only=only)
    port_tree = port_files(files)
    port = run_analysis(
        load_project(tmp_path / "port", write_tree(tmp_path / "port", port_tree)), only=only)
    return jax, port


def keyed(findings, mapper=lambda s: s):
    return sorted((mapper(f.fingerprint), f.line) for f in findings)


FIXTURES = harvest("tests.test_static_analysis") + harvest("tests.test_race_checker")


def test_harvest_found_the_fixtures():
    assert len(FIXTURES) >= 50
    checkers = " ".join(src for _, files in FIXTURES for src in files.values())
    for marker in ("time.time()", "except Exception", "threading.Thread", ".result()",
                   "new_lock", "tsa: single-thread", "new_unguarded", "ConfigKey"):
        assert marker in checkers, marker


@pytest.mark.parametrize("case", FIXTURES, ids=[c[0] for c in FIXTURES])
def test_fixture_findings_equal_jax(tmp_path, case):
    _, files = case
    jax, port = both_reports(tmp_path, files, GENERIC)
    assert keyed(port.findings) == keyed(jax.findings, map_text)
    assert [f.message for f in port.findings] == [map_text(f.message) for f in jax.findings]


@pytest.mark.parametrize("checker", GENERIC)
def test_every_generic_checker_finds_something_on_the_fixtures(tmp_path, checker):
    """The parity above is not vacuous: each checker has a flagged fixture."""
    hits = 0
    for i, (_, files) in enumerate(FIXTURES):
        _, port = both_reports(tmp_path / str(i), files, [checker])
        hits += len(port.findings)
        if hits:
            break
    assert hits


# ------------------------------------------------------------ real trees
@pytest.fixture(scope="module")
def projects():
    return jax_core.load_project(REPO_ROOT), load_project(REPO_ROOT)


@pytest.fixture(scope="module")
def real_reports(projects):
    jax_project, port_project = projects
    return (jax_core.run_analysis(jax_project, only=GENERIC),
            run_analysis(port_project, only=GENERIC))


def test_port_scans_its_own_package_only(projects):
    _, port = projects
    assert port.files and all(
        pf.rel_path.startswith("tieredstorage_tpu_torch/") for pf in port.files)
    assert port.file("tieredstorage_tpu_torch/transform/cuda.py") is not None


def test_real_tree_findings_equal_jax(real_reports):
    jax, port = real_reports
    expected = {map_text(fp) for fp in {f.fingerprint for f in jax.findings} - set(JAX_ONLY_FINDINGS)}
    assert {f.fingerprint for f in port.findings} == expected
    assert set(JAX_ONLY_FINDINGS) <= {f.fingerprint for f in jax.findings}


@pytest.mark.parametrize("checker", ["deadline", "lock-order", "races", "config-drift"])
def test_real_tree_checker_parity(real_reports, checker):
    jax, port = real_reports
    pick = lambda r: sorted(f.fingerprint for f in r.findings if f.checker == checker)
    assert pick(port) == sorted(map_text(fp) for fp in pick(jax) if fp not in JAX_ONLY_FINDINGS)


def test_deadline_reaches_the_ports_request_path(real_reports):
    """`deadline` looks at the port's request-path modules (its prefixes are
    the port's): the hedger's vetted waits are found there."""
    _, port = real_reports
    hits = [f for f in port.findings if f.checker == "deadline"]
    assert {f.path for f in hits} >= {"tieredstorage_tpu_torch/fetch/hedge.py",
                                      "tieredstorage_tpu_torch/storage/replicated.py"}


def test_suppressions_are_jaxs_after_the_map():
    jax = jax_core.Suppressions.load(REPO_ROOT / "tools" / "analysis_suppressions.txt")
    port = Suppressions.load(REPO_ROOT / "tools" / "torch_analysis_suppressions.txt")
    expected = {map_text(fp): why for fp, why in jax.entries.items()
                if fp not in JAX_ONLY_FINDINGS}
    assert port.entries == expected
    for fp, why in port.entries.items():
        assert len(why) >= 20, fp


def test_repo_is_clean_under_its_suppression_file():
    """The gate: the port's tree yields zero unsuppressed findings and zero
    stale suppressions, every checker included, with no degraded docs note."""
    suppressions = Suppressions.load(REPO_ROOT / "tools" / "torch_analysis_suppressions.txt")
    report = run_analysis(load_project(REPO_ROOT), suppressions=suppressions)
    assert report.unsuppressed == [], "\n".join(f.render() for f in report.unsuppressed)
    assert report.stale_suppressions == []
    assert report.notes == []
    assert report.ok


def test_cli_passes_on_the_repo(tmp_path, capsys):
    out = tmp_path / "analysis.json"
    assert main(["--json", str(out), "-q"]) == 0
    data = json.loads(out.read_text())
    assert data["generated_by"] == "tieredstorage_tpu_torch.analysis"
    assert data["summary"]["ok"] and data["summary"]["unsuppressed"] == 0
    assert data["root"] == str(REPO_ROOT)
    assert not any("not re-generated" in n for n in data["notes"])
    assert "analysis: OK" in capsys.readouterr().out


def test_lock_graph_is_jaxs_plus_listed_port_only_edges(projects):
    from tieredstorage_tpu_torch.analysis.races import PORT_SHARED_LOCKS

    jax_project, port_project = projects
    _, jax_edges, _ = jax_lockorder.build_lock_model(jax_project)
    _, port_edges, _ = lockorder.build_lock_model(port_project)
    mapped = {(map_text(a), map_text(b)) for a, b in jax_edges}
    assert mapped <= set(port_edges)
    assert set(port_edges) - mapped == PORT_ONLY_EDGES
    for edge in PORT_ONLY_EDGES:
        assert set(edge) & set(PORT_SHARED_LOCKS), edge
    assert mapped


def test_port_only_locks_are_static_lock_nodes(projects):
    from tieredstorage_tpu_torch.analysis.races import PORT_SHARED_LOCKS

    _, port_project = projects
    summaries, _, _ = lockorder.build_lock_model(port_project)
    acquired = set().union(*(s.acquires for s in summaries.values()))
    for lock_id, why in PORT_SHARED_LOCKS.items():
        assert lock_id in acquired, lock_id
        assert len(why) >= 20


def test_witness_names_match_static_lock_model(projects):
    """Every literal name handed to new_lock/new_rlock/new_condition in the
    port's tree is a lock node the static model derives, so LockWitness
    edges and the lock-order graph talk about the same objects."""
    _, project = projects
    summaries, _, _ = lockorder.build_lock_model(project)
    static_ids = set().union(*(s.acquires for s in summaries.values()))
    name_re = re.compile(r"new_(?:lock|rlock|condition)\(\"([^\"]+)\"\)")
    runtime_names = {m for pf in project.files for m in name_re.findall(pf.source)}
    assert {"cuda._StagingPool._lock", "cuda.CudaTransformBackend._stats_lock",
            "gcm._CONSTS_MU", "_cuda._LOCK"} <= runtime_names
    for name in sorted(runtime_names):
        stem, _, suffix = name.partition(".")
        matches = [
            lock_id for lock_id in static_ids
            if lock_id.split(":", 1)[1] == suffix
            and lock_id.split(":", 1)[0].endswith(f"/{stem}.py")
            or (stem == "native" and lock_id.startswith("tieredstorage_tpu_torch/native/"))
            and lock_id.endswith(f":{suffix}")
        ]
        assert matches, f"witness name {name!r} has no static lock node"


def test_jax_witness_names_map_onto_the_ports(projects):
    """The runtime names of the two trees' locks: JAX's after the site map,
    plus the port-only locks."""
    from tieredstorage_tpu_torch.analysis.races import PORT_SHARED_LOCKS

    name_re = re.compile(r"new_(?:lock|rlock|condition)\(\"([^\"]+)\"\)")
    jax_project, port_project = projects
    names = [{m for pf in p.files for m in name_re.findall(pf.source)}
             for p in (jax_project, port_project)]
    port_only = {lockorder_name(lock_id) for lock_id in PORT_SHARED_LOCKS}
    assert names[1] - {map_site(n) for n in names[0]} <= port_only
    assert {map_site(n) for n in names[0]} <= names[1]


def lockorder_name(lock_id: str) -> str:
    """Static lock id -> the witness name its factory records."""
    path, _, suffix = lock_id.partition(":")
    return f"{pathlib.PurePosixPath(path).stem}.{suffix}"


# ---------------------------------------------------- framework behaviour
def make_project(tmp_path, files):
    return load_project(tmp_path, write_tree(tmp_path, files))


TIME_TIME = {"tieredstorage_tpu_torch/mod.py": """
    import time

    def f():
        return time.time()
"""}


class TestSuppressions:
    def test_round_trip(self, tmp_path):
        report = run_analysis(make_project(tmp_path, TIME_TIME), only=["monotonic-clock"])
        assert not report.ok
        sup = Suppressions({report.findings[0].fingerprint: "fixture: wall clock intended"})
        reparsed = Suppressions.parse(sup.serialize())
        assert reparsed.entries == sup.entries
        assert "tools/torch_analysis_suppressions.txt" in sup.serialize()
        clean = run_analysis(make_project(tmp_path / "again", TIME_TIME),
                             suppressions=reparsed, only=["monotonic-clock"])
        assert clean.ok and len(clean.suppressed) == 1

    def test_stale_suppression_fails(self, tmp_path):
        sup = Suppressions({"monotonic-clock:gone.py:f:time.time": "obsolete"})
        report = run_analysis(
            make_project(tmp_path, {"tieredstorage_tpu_torch/mod.py": "x = 1\n"}),
            suppressions=sup, only=["monotonic-clock"])
        assert not report.ok
        assert report.stale_suppressions == ["monotonic-clock:gone.py:f:time.time"]

    @pytest.mark.parametrize("text", ["checker:file.py:f:detail\n",
                                      "checker:file.py:f:detail  #   \n",
                                      "a:b:c:d  # one\na:b:c:d  # two\n"])
    def test_bad_files_rejected(self, text):
        with pytest.raises(SuppressionError):
            Suppressions.parse(text)


class TestCli:
    def test_exit_codes_and_default_scan(self, tmp_path):
        write_tree(tmp_path, TIME_TIME)
        rc = main(["--root", str(tmp_path), "--checker", "monotonic-clock",
                   "--json", str(tmp_path / "r.json")])
        assert rc == 1
        data = json.loads((tmp_path / "r.json").read_text())
        assert data["files_scanned"] == 1
        fp = data["findings"][0]["fingerprint"]
        assert fp == "monotonic-clock:tieredstorage_tpu_torch/mod.py:f:time.time"
        (tmp_path / "sup.txt").write_text(f"{fp}  # fixture waiver\n")
        assert main(["--root", str(tmp_path), "--checker", "monotonic-clock",
                     "--suppressions", str(tmp_path / "sup.txt")]) == 0

    def test_default_suppression_file_is_the_ports(self, tmp_path):
        write_tree(tmp_path, TIME_TIME)
        (tmp_path / "tools").mkdir()
        (tmp_path / "tools" / "torch_analysis_suppressions.txt").write_text(
            "monotonic-clock:tieredstorage_tpu_torch/mod.py:f:time.time  # fixture waiver\n")
        (tmp_path / "tools" / "analysis_suppressions.txt").write_text("")
        assert main(["--root", str(tmp_path), "--checker", "monotonic-clock"]) == 0

    def test_rejects_unjustified_suppressions(self, tmp_path):
        write_tree(tmp_path, {"tieredstorage_tpu_torch/mod.py": "x = 1\n"})
        (tmp_path / "sup.txt").write_text("some:finger:print:here\n")
        assert main(["--root", str(tmp_path), "--suppressions",
                     str(tmp_path / "sup.txt")]) == 2

    def test_list_checkers(self, capsys):
        assert main(["--list-checkers"]) == 0
        assert capsys.readouterr().out.split() == list(core.checker_registry())

    def test_paths_mode_uses_its_own_parse_cache(self, tmp_path):
        write_tree(tmp_path, TIME_TIME)
        assert main(["--root", str(tmp_path), "--paths", "tieredstorage_tpu_torch/mod.py"]) == 1
        assert (tmp_path / "artifacts" / "torch_analysis_parse_cache.pkl").exists()
        assert not (tmp_path / "artifacts" / "analysis_parse_cache.pkl").exists()

    def test_paths_mode_skips_stale_suppressions(self, tmp_path):
        write_tree(tmp_path, {"tieredstorage_tpu_torch/mod.py": "x = 1\n"})
        (tmp_path / "sup.txt").write_text(
            "deadline:tieredstorage_tpu_torch/other.py:f:unbounded:result@x  # lives elsewhere\n")
        args = ["--root", str(tmp_path), "--suppressions", str(tmp_path / "sup.txt")]
        assert main(args) == 1
        assert main(args + ["--paths", "tieredstorage_tpu_torch/mod.py"]) == 0

    def test_json_schema(self, tmp_path):
        report = run_analysis(make_project(tmp_path, TIME_TIME), only=["monotonic-clock"])
        report.write_json(tmp_path / "report.json")
        data = json.loads((tmp_path / "report.json").read_text())
        assert data["version"] == 1
        assert data["generated_by"] == "tieredstorage_tpu_torch.analysis"
        assert data["summary"] == {"total": 1, "suppressed": 0, "unsuppressed": 1,
                                   "stale_suppressions": 0, "ok": False}


class TestParseCache:
    def test_round_trip_and_invalidation(self, tmp_path):
        mod = tmp_path / "tieredstorage_tpu_torch" / "mod.py"
        write_tree(tmp_path, TIME_TIME)
        cache = tmp_path / "cache.pkl"
        load_project(tmp_path, ["tieredstorage_tpu_torch/mod.py"], cache_path=cache)
        assert cache.exists()
        again = load_project(tmp_path, ["tieredstorage_tpu_torch/mod.py"], cache_path=cache)
        assert [f.detail for f in run_analysis(again, only=["monotonic-clock"]).findings] \
            == ["time.time"]
        mod.write_text("import time\n\ndef f():\n    return time.monotonic()\n")
        fresh = load_project(tmp_path, ["tieredstorage_tpu_torch/mod.py"], cache_path=cache)
        assert run_analysis(fresh, only=["monotonic-clock"]).findings == []

    def test_corrupt_cache_degrades_to_parse(self, tmp_path):
        write_tree(tmp_path, {"tieredstorage_tpu_torch/mod.py": "x = 1\n"})
        cache = tmp_path / "cache.pkl"
        cache.write_bytes(b"not a pickle")
        project = load_project(tmp_path, ["tieredstorage_tpu_torch/mod.py"], cache_path=cache)
        assert len(project.files) == 1


class TestDrift:
    def test_generated_docs_never_degrade_on_the_real_tree(self, projects):
        """The port's generators import no JAX: the real tree's docs half
        always regenerates, so it yields no note."""
        _, port_project = projects
        results = drift._check_generated_docs(port_project)
        assert results == [], results

    def test_unimportable_generators_degrade_to_notes(self, monkeypatch, projects):
        _, port_project = projects
        for name in ("configs_docs", "metrics_docs"):
            monkeypatch.setitem(sys.modules, f"tieredstorage_tpu_torch.docs.{name}", None)
        results = drift._check_generated_docs(port_project)
        assert len(results) == 2
        assert all(isinstance(r, str) and "not re-generated" in r for r in results)

    def test_transform_device_is_declared(self, projects):
        _, port_project = projects
        assert "device" in drift._declared_keys(port_project)
        reads = {key for *_, key in drift._read_keys(port_project)}
        assert reads and not [
            k for k in reads - drift._declared_keys(port_project)
            if not k.startswith(drift.DYNAMIC_KEY_PREFIXES)]

    def test_undocumented_central_key_is_flagged(self, tmp_path):
        files = {
            "tieredstorage_tpu_torch/config/rsm_config.py": """
                from tieredstorage_tpu_torch.config.configdef import ConfigKey

                KEYS = [ConfigKey("a.key", "int"), ConfigKey("b.key", "int")]
            """,
        }
        (tmp_path / "docs" / "torch").mkdir(parents=True)
        (tmp_path / "docs" / "torch" / "configs.rst").write_text("``a.key``\n")
        report = run_analysis(make_project(tmp_path, files), only=["config-drift"])
        details = {f.detail for f in report.findings}
        assert "undocumented-key:b.key" in details
        assert "undocumented-key:a.key" not in details
