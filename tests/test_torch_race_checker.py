"""The port's race model against the JAX package's.

On every race fixture of `tests/test_race_checker.py` (laid out under each
package's prefix) and on the two real trees, the guarded-by model —
`site_guards()`, `single_thread_sites()`, `unguarded_sites()`, the thread
entries and what they reach — must be JAX's after the site map, plus only
the port-only sites listed here. The runtime cross-check must judge the
same witness evidence the same way in both packages.
"""

from __future__ import annotations

import pytest

from tests.test_torch_static_analysis import (
    REPO_ROOT,
    harvest,
    map_site,
    map_text,
    port_files,
    write_tree,
)
from tieredstorage_tpu.analysis import core as jax_core
from tieredstorage_tpu.analysis import races as jax_races
from tieredstorage_tpu_torch.analysis import races
from tieredstorage_tpu_torch.analysis.core import load_project

#: Guarded sites of port-only state (no JAX twin) -> their guard.
PORT_ONLY_GUARDS = {
    "cuda._StagingPool.allocations": "cuda._StagingPool._lock",
    "cuda.CudaTransformBackend._pool": "cuda.CudaTransformBackend._pool_lock",
}
#: SHARED_CLASSES entries of port-only classes.
PORT_ONLY_SHARED = {"tieredstorage_tpu_torch/transform/cuda.py:_StagingPool"}
#: Thread entries of port-only code: the tasks of a window's host zstd on the
#: CUDA backend's workers.
PORT_ONLY_ENTRIES = {"tieredstorage_tpu_torch/transform/host_zstd.py:WindowCompression._run"}

FIXTURES = harvest("tests.test_race_checker")


def models(tmp_path, files):
    jax_model, jax_findings = jax_races.build_race_model(
        jax_core.load_project(tmp_path / "jax", write_tree(tmp_path / "jax", files)))
    port_model, port_findings = races.build_race_model(
        load_project(tmp_path / "port", write_tree(tmp_path / "port", port_files(files))))
    return (jax_model, jax_findings), (port_model, port_findings)


def mapped_guards(model):
    return {map_site(k): map_site(v) for k, v in model.site_guards().items()}


@pytest.mark.parametrize("case", FIXTURES, ids=[c[0] for c in FIXTURES])
def test_fixture_models_equal_jax(tmp_path, case):
    (jm, jf), (pm, pf) = models(tmp_path, case[1])
    assert pm.site_guards() == mapped_guards(jm)
    assert pm.single_thread_sites() == {map_site(s) for s in jm.single_thread_sites()}
    assert pm.unguarded_sites() == {map_site(s) for s in jm.unguarded_sites()}
    assert pm.thread_entries == {map_text(k) for k in jm.thread_entries}
    assert pm.reached == {map_text(k) for k in jm.reached}
    assert pm.dead_annotations == {map_text(k): v for k, v in jm.dead_annotations.items()}
    assert {k: (c.shared, {r: g for r, g in c.guards.items()}) for k, c in pm.classes.items()} \
        == {map_text(k): (c.shared, {r: g and map_text(g) for r, g in c.guards.items()})
            for k, c in jm.classes.items()}
    assert sorted(f.fingerprint for f in pf) == sorted(map_text(f.fingerprint) for f in jf)


# ------------------------------------------------------------ real trees
@pytest.fixture(scope="module")
def real_models():
    jax_model, jax_findings = jax_races.build_race_model(jax_core.load_project(REPO_ROOT))
    port_model, port_findings = races.build_race_model(load_project(REPO_ROOT))
    return jax_model, jax_findings, port_model, port_findings


def test_real_tree_has_no_race_findings(real_models):
    _, jax_findings, _, port_findings = real_models
    assert port_findings == [] and jax_findings == []


def test_site_guards_are_jaxs_plus_port_only(real_models):
    jax_model, _, port_model, _ = real_models
    assert port_model.site_guards() == {**mapped_guards(jax_model), **PORT_ONLY_GUARDS}
    assert port_model.site_guards()["cuda.CudaTransformBackend.dispatch_stats"] \
        == "cuda.CudaTransformBackend._stats_lock"


def test_single_thread_and_unguarded_sites_are_jaxs(real_models):
    jax_model, _, port_model, _ = real_models
    assert port_model.single_thread_sites() == {map_site(s) for s in jax_model.single_thread_sites()}
    assert port_model.unguarded_sites() == {map_site(s) for s in jax_model.unguarded_sites()}
    assert "chunk_cache.ChunkCache.degradations" in port_model.unguarded_sites()


def test_thread_entries_are_jaxs(real_models):
    """The spawned-thread entry points: JAX's, after the map, and the
    port-only ones. (The nvcc waiters of ops/_cuda.py ride a bounded
    executor through a nested function, which is not an entry the model
    resolves.)"""
    jax_model, _, port_model, _ = real_models
    assert port_model.thread_entries == \
        {map_text(k) for k in jax_model.thread_entries} | PORT_ONLY_ENTRIES


def test_shared_classes_are_jaxs_plus_the_staging_pool(real_models):
    _, _, port_model, _ = real_models
    expected = {map_text(k): v for k, v in jax_races.SHARED_CLASSES.items()}
    port_only = {k: v for k, v in races.SHARED_CLASSES.items() if k not in expected}
    assert set(port_only) == PORT_ONLY_SHARED
    assert {k: v for k, v in races.SHARED_CLASSES.items() if k in expected} == expected
    for key, why in races.SHARED_CLASSES.items():
        assert key in port_model.classes, f"stale SHARED_CLASSES entry {key}"
        assert port_model.classes[key].shared and len(why) >= 20


def test_port_shared_locks_name_the_port_only_locks():
    from tests.test_torch_lock_names import PORT_ONLY
    from tests.test_torch_static_analysis import lockorder_name

    assert {lockorder_name(k) for k in races.PORT_SHARED_LOCKS} == set(PORT_ONLY)


# ------------------------------------------------ the runtime cross-check
CROSSCHECK_FIXTURE = {
    "tieredstorage_tpu/mod.py": """
        from tieredstorage_tpu.utils.locks import new_lock

        class C:
            def __init__(self):
                self._lock = new_lock("mod.C._lock")
                self.count = 0

            def bump(self):
                with self._lock:
                    self.count += 1

            def tick(self):
                self.solo = 1  # tsa: single-thread
    """,
}

#: name -> (site -> (held locks, threads)) of witness evidence.
EVIDENCE = {
    "guard-observed": {"mod.C.count": ({"mod.C._lock"}, {1})},
    "wrong-lock": {"mod.C.count": ({"other.D._mu", None}, {1, 2})},
    "single-thread-two-threads": {"mod.C.solo": ({None}, {1, 2})},
    "single-thread-one-thread": {"mod.C.solo": ({None}, {7})},
    "unknown-site": {"gone.X.y": ({None}, {1})},
    "nothing-observed": {},
}


def crosscheck(pkg, project, evidence):
    locks = __import__(f"{pkg}.utils.locks", fromlist=["locks"])
    lw, race = locks.LockWitness(), locks.RaceWitness(witness=locks.LockWitness())
    for site, (held, threads) in evidence.items():
        race.held_at[site] = set(held)
        race.threads_at[site] = set(threads)
    module = jax_races if pkg == "tieredstorage_tpu" else races
    return module.runtime_crosscheck(project, race=race, lock_witness=lw)


@pytest.mark.parametrize("name", sorted(EVIDENCE))
def test_crosscheck_judges_evidence_as_jax(tmp_path, name):
    jax_project = jax_core.load_project(
        tmp_path / "jax", write_tree(tmp_path / "jax", CROSSCHECK_FIXTURE))
    port_project = load_project(
        tmp_path / "port", write_tree(tmp_path / "port", port_files(CROSSCHECK_FIXTURE)))
    jax = crosscheck("tieredstorage_tpu", jax_project, EVIDENCE[name])
    port = crosscheck("tieredstorage_tpu_torch", port_project, EVIDENCE[name])
    assert port == jax
    if name in ("wrong-lock", "single-thread-two-threads", "unknown-site"):
        assert len(port["violations"]) == 1
    else:
        assert port["violations"] == []
    if name == "nothing-observed":
        assert any("mod.C.count" in s for s in port["unobserved"])


def test_crosscheck_defaults_to_the_ports_tree():
    """No project: the port's own tree (empty witnesses here; the witnessed
    subprocess drive of test_torch_lock_names holds the process-wide ones)."""
    from tieredstorage_tpu_torch.utils.locks import LockWitness, RaceWitness

    result = races.runtime_crosscheck(race=RaceWitness(witness=LockWitness()),
                                      lock_witness=LockWitness())
    assert result["violations"] == [] and result["validated"] == []
    assert any(s.startswith("cuda.CudaTransformBackend.dispatch_stats") for s in result["unobserved"])
