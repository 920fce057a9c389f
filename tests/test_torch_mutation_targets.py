"""tools/torch_mutation_test.py: the port's mutation targets and one real run.

- Each of the 37 default targets of tools/mutation_test.py has a twin: the
  port module at the same path (`transform/tpu.py` -> `transform/cuda.py`,
  `ops/ghash_pallas.py` -> `ops/ghash_cuda.py`), owned by a
  `tests/test_torch_*.py` file that exists and imports it (directly, or
  through its package when the package's `__init__` imports it).
- `--list` finds at least one mutation site in every target.
- One real target, `utils/varint.py` with its owner, is mutated with
  `--budget 4` in a copy of the tree under `tmp_path` (`--repo`; the live
  tree is never rewritten): the kill rate is at least the gate's 0.7, and
  the copied file is restored byte for byte.
"""

from __future__ import annotations

import ast
import importlib.util
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

from tests.torch_gates import XLA_ONE_THREAD

REPO = Path(__file__).resolve().parent.parent
RENAMED = {
    "tieredstorage_tpu/transform/tpu.py": "tieredstorage_tpu_torch/transform/cuda.py",
    "tieredstorage_tpu/ops/ghash_pallas.py": "tieredstorage_tpu_torch/ops/ghash_cuda.py",
}


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _imported_modules(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
        elif isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
    return names


def _imports_target(owner: Path, target: str) -> bool:
    dotted = target[: -len(".py")].replace("/", ".")
    imported = _imported_modules(owner)
    if dotted in imported:
        return True
    package, _, module = dotted.rpartition(".")
    init = REPO / package.replace(".", "/") / "__init__.py"
    return package in imported and init.exists() and (
        f"{package}.{module}" in _imported_modules(init)
        or any(n.startswith(f"{package}.{module}.") for n in _imported_modules(init)))


def test_every_jax_target_has_a_port_twin_with_an_owner():
    jax_targets = _load("mutation_test").DEFAULT_TARGETS
    port_targets = _load("torch_mutation_test").TARGETS
    assert len(jax_targets) == len(port_targets) == 37
    for (jax_module, _), (module, owners) in zip(jax_targets, port_targets):
        twin = RENAMED.get(jax_module, jax_module.replace("tieredstorage_tpu/",
                                                          "tieredstorage_tpu_torch/", 1))
        assert module == twin, (jax_module, module)
        assert (REPO / module).is_file(), module
        assert owners and all(re.fullmatch(r"tests/test_torch_\w+\.py", o) for o in owners)
        for owner in owners:
            assert (REPO / owner).is_file(), owner
            assert _imports_target(REPO / owner, module), (owner, module)


def test_list_finds_sites_in_every_target():
    res = subprocess.run([sys.executable, "tools/torch_mutation_test.py", "--list"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    counts = dict(re.findall(r"^(tieredstorage_tpu_torch/\S+): (\d+) sites$", res.stdout, re.M))
    targets = [module for module, _ in _load("torch_mutation_test").TARGETS]
    assert sorted(counts) == sorted(targets)
    assert all(int(n) >= 1 for n in counts.values()), counts


def test_real_mutants_in_a_copy_are_killed_and_the_file_restored(tmp_path):
    target = "tieredstorage_tpu_torch/utils/varint.py"
    owner = "tests/test_torch_wire_codecs.py"
    copy = tmp_path / "tree"
    ignore = shutil.ignore_patterns("__pycache__", "_build")
    for package in ("tieredstorage_tpu", "tieredstorage_tpu_torch"):
        shutil.copytree(REPO / package, copy / package, ignore=ignore)
    (copy / "tests").mkdir()
    for name in ("__init__.py", "conftest.py", Path(owner).name):
        shutil.copy(REPO / "tests" / name, copy / "tests" / name)
    shutil.copy(REPO / "pyproject.toml", copy / "pyproject.toml")
    original = (REPO / target).read_bytes()

    # The owner's runs get one core, as the gate pairs' children do.
    env = dict(os.environ, OMP_NUM_THREADS="1",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {XLA_ONE_THREAD}".strip())
    res = subprocess.run(
        [sys.executable, "tools/torch_mutation_test.py", "--module", target, "--tests", owner,
         "--budget", "4", "--repo", str(copy)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=220)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    killed, total = map(int, re.search(r"\[mutation\] (\d+)/(\d+) killed \(", res.stdout).groups())
    assert total == 4 and killed / total >= 0.7, res.stdout
    assert (copy / target).read_bytes() == original
    assert (REPO / target).read_bytes() == original
