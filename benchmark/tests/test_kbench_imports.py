"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names compared whole)."""

import ast
import subprocess
import sys

from benchmark import harness

BENCH = harness.HERE


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        assert not _top_level_imports(path) & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert "tieredstorage_tpu_torch" not in _top_level_imports(path), path
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.reference import aes_gcm, check, rsa_oaep, zstd\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))" % str(harness.ROOT))
    loaded = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                            check=True, timeout=120).stdout
    assert "'tieredstorage_tpu_torch'" not in loaded and "'jax'" not in loaded


def test_a_whole_rehearsed_run_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness, rehearse\n"
            "out = rehearse.rehearse('gcm.tiering', 3, 1.0)\n"
            "assert out['correct'], out\n"
            "print('FORBIDDEN', harness.forbidden_modules())" % str(harness.ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "FORBIDDEN []" in res.stdout
