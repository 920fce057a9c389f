"""The port imports neither JAX nor anything of the JAX package.

A subprocess installs a meta-path hook that refuses `jax`, `jaxlib` and
`tieredstorage_tpu` (but not `tieredstorage_tpu_torch`), then imports every
module of the port, chip_smoke.py, the port's e2e harness (tests/torch_e2e),
its demo (demo/torch_run_demo.py), its gates (tools/torch_*_demo.py,
tools/torch_chaos_matrix.py, tools/torch_fleet_soak.py,
tools/torch_timeline_export.py, tools/torch_segment_scale_probe.py) and
tools/torch_mutation_test.py. The gates and the demo also refuse to run
without CUDA unless they are asked for the CPU. No file of the port names
a path under the repo's `native/` or `tieredstorage_tpu/` (it keeps its own
copy of what it needs), and the demo and its sidecar configs take the JAX
demo's codec.
"""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = r'''
import importlib, importlib.util, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "tieredstorage_tpu")

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import tieredstorage_tpu_torch
import tieredstorage_tpu_torch.rsm
names = [m.name for m in pkgutil.walk_packages(
    tieredstorage_tpu_torch.__path__, "tieredstorage_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import tests.torch_e2e.broker, tests.torch_e2e.records
for path in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location(path.replace("/", "_")[:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(" ".join(names))
print(len(names))
'''

#: Modules of the scheduler and scrub plane, named so that a module left out
#: of the walk (a missing __init__) fails here.
_SCHEDULER_AND_SCRUB = (
    "tieredstorage_tpu_torch.transform.batcher",
    "tieredstorage_tpu_torch.ops.crc32c",
    "tieredstorage_tpu_torch.scrub.scrubber",
    "tieredstorage_tpu_torch.scrub.scheduler",
    "tieredstorage_tpu_torch.utils.retry",
    "tieredstorage_tpu_torch.utils.ratelimit",
)

#: Modules of the compression slice: the native host library and the codecs.
_COMPRESSION = (
    "tieredstorage_tpu_torch.native",
    "tieredstorage_tpu_torch.ops.huffman",
    "tieredstorage_tpu_torch.ops.lz",
    "tieredstorage_tpu_torch.transform.thuff",
    "tieredstorage_tpu_torch.transform.lzhuff",
    "tieredstorage_tpu_torch.transform.native_backend",
    "tieredstorage_tpu_torch.transform.cpu",
)

#: Modules of the storage layer: the memory backend, the HTTP transport and
#: its SOCKS5 proxy, the S3, GCS and Azure backends and replicated storage.
_STORAGE = (
    "tieredstorage_tpu_torch.storage.memory",
    "tieredstorage_tpu_torch.storage.proxy",
    "tieredstorage_tpu_torch.storage.httpclient",
    "tieredstorage_tpu_torch.storage.replicated",
    "tieredstorage_tpu_torch.storage.s3",
    "tieredstorage_tpu_torch.storage.s3.signer",
    "tieredstorage_tpu_torch.storage.s3.config",
    "tieredstorage_tpu_torch.storage.s3.client",
    "tieredstorage_tpu_torch.storage.s3.multipart",
    "tieredstorage_tpu_torch.storage.s3.storage",
    "tieredstorage_tpu_torch.storage.gcs",
    "tieredstorage_tpu_torch.storage.gcs.auth",
    "tieredstorage_tpu_torch.storage.gcs.config",
    "tieredstorage_tpu_torch.storage.gcs.storage",
    "tieredstorage_tpu_torch.storage.azure",
    "tieredstorage_tpu_torch.storage.azure.auth",
    "tieredstorage_tpu_torch.storage.azure.config",
    "tieredstorage_tpu_torch.storage.azure.storage",
)


#: Modules of the failure policy: the breakers, the retry budget, hedging,
#: admission, the SLO engine and the retry-metrics group.
_FAILURE_POLICY = (
    "tieredstorage_tpu_torch.utils.retry",
    "tieredstorage_tpu_torch.utils.deadline",
    "tieredstorage_tpu_torch.utils.admission",
    "tieredstorage_tpu_torch.storage.resilient",
    "tieredstorage_tpu_torch.fetch.hedge",
    "tieredstorage_tpu_torch.metrics.slo",
    "tieredstorage_tpu_torch.metrics.retry_metrics",
)

#: Modules of the sidecar: the shim wire, its HTTP gateway, the gRPC service,
#: its client and the `python -m` entry point.
_SIDECAR = (
    "tieredstorage_tpu_torch.sidecar",
    "tieredstorage_tpu_torch.sidecar.__main__",
    "tieredstorage_tpu_torch.sidecar.shimwire",
    "tieredstorage_tpu_torch.sidecar.sidecar_pb2",
    "tieredstorage_tpu_torch.sidecar.rpc",
    "tieredstorage_tpu_torch.sidecar.http_gateway",
    "tieredstorage_tpu_torch.sidecar.server",
    "tieredstorage_tpu_torch.sidecar.client",
)

#: Modules of the fleet: the ring, single flight, the peer tier, gossip, the
#: fleet metrics and the fleet-wide telemetry.
_FLEET = (
    "tieredstorage_tpu_torch.fleet",
    "tieredstorage_tpu_torch.fleet.ring",
    "tieredstorage_tpu_torch.fleet.singleflight",
    "tieredstorage_tpu_torch.fleet.peer_cache",
    "tieredstorage_tpu_torch.fleet.metrics",
    "tieredstorage_tpu_torch.fleet.gossip",
    "tieredstorage_tpu_torch.fleet.telemetry",
)

#: Modules of the mesh: the plan, the drill and the virtual-device pin.
_MESH = (
    "tieredstorage_tpu_torch.parallel",
    "tieredstorage_tpu_torch.parallel.mesh",
    "tieredstorage_tpu_torch.parallel.multichip",
    "tieredstorage_tpu_torch.utils.platforms",
)


#: The port's gates and demo, imported by path in the sweep.
_GATES = (
    "tools/torch_transform_demo.py",
    "tools/torch_hot_demo.py",
    "tools/torch_failover_demo.py",
    "tools/torch_chaos_matrix.py",
    "tools/torch_multichip_demo.py",
    "tools/torch_tail_demo.py",
    "tools/torch_scrub_demo.py",
    "tools/torch_trace_demo.py",
    "tools/torch_timeline_export.py",
    "tools/torch_fleet_demo.py",
    "tools/torch_fleet_soak.py",
    "tools/torch_load_demo.py",
    "tools/torch_segment_scale_probe.py",
)
#: The port's tools that are not gates (no device of their own), imported
#: by path in the sweep.
_TOOLS = ("tools/torch_mutation_test.py",)
_DEMO = "demo/torch_run_demo.py"


def test_port_and_chip_smoke_import_without_jax():
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT, *_GATES, *_TOOLS, _DEMO], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    *_, names, count = res.stdout.strip().splitlines()
    assert int(count) >= 36 + len(_COMPRESSION) + len(_STORAGE)  # every module was imported
    assert set(_SCHEDULER_AND_SCRUB) <= set(names.split())
    assert set(_COMPRESSION) <= set(names.split())
    assert set(_STORAGE) <= set(names.split())
    assert set(_FAILURE_POLICY) <= set(names.split())
    assert set(_SIDECAR) <= set(names.split())
    assert set(_FLEET) <= set(names.split())
    assert set(_MESH) <= set(names.split())


def test_chip_smoke_refuses_without_cuda():
    """Without a card the smoke exits non-zero and prints no result line."""
    probe = (
        "import sys, torch; torch.cuda.is_available = lambda: False; "
        "sys.argv = ['chip_smoke.py']; import chip_smoke; sys.exit(chip_smoke.main())"
    )
    res = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def _no_cuda(path: str, *args: str) -> list:
    """argv running `path` with torch told there is no CUDA."""
    probe = (
        "import runpy, sys, torch; torch.cuda.is_available = lambda: False; "
        f"sys.argv = {[path, *args]!r}; runpy.run_path({path!r}, run_name='__main__')"
    )
    return [sys.executable, "-c", probe]


def test_gates_and_demo_refuse_to_run_without_cuda(tmp_path):
    """Without CUDA and without a request for the CPU, each gate and the
    demo exit non-zero with a message and write no report."""
    for path in (*_GATES, _DEMO):
        out = tmp_path / (Path(path).stem + ".json")
        args = ("--backend", "filesystem") if path == _DEMO else ("--out", str(out))
        res = subprocess.run(_no_cuda(path, *args), cwd=REPO, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode != 0, (path, res.stdout, res.stderr)
        assert "CUDA is not available" in res.stderr, (path, res.stderr)
        assert not out.exists()


def test_demo_runs_on_the_cpu_over_the_filesystem_backend():
    res = subprocess.run(
        [sys.executable, _DEMO, "--transform", "cpu", "--backend", "filesystem",
         "--codec", "zstd"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "demo complete" in res.stdout


#: A path under the repo's native/ or the JAX package: the word as a path
#: component (`tieredstorage_tpu_torch/...` is the port's own).
_JAX_PATH = re.compile(r"(^|[^\w.])(native|tieredstorage_tpu)(/|$)")


def _docstrings(tree: ast.AST) -> set:
    return {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}


def _jax_paths(path: Path) -> list:
    """Strings of a module (docstrings aside) that name a path under
    `native/` or `tieredstorage_tpu/`, with their lines."""
    tree = ast.parse(path.read_text())
    docs = _docstrings(tree)
    return [f"{path.relative_to(REPO)}:{node.lineno} {node.value[:60]!r}"
            for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs and _JAX_PATH.search(node.value)]


def test_no_port_file_names_a_path_under_native_or_the_jax_package():
    """Code of the port never reaches into the JAX side's files: no string
    of a module (docstrings aside, which name their JAX counterparts) is a
    path under `native/` or `tieredstorage_tpu/` or such a path's component
    in a join, and no source under csrc/ includes one."""
    port = REPO / "tieredstorage_tpu_torch"
    found = [hit for path in sorted(port.rglob("*.py")) for hit in _jax_paths(path)]
    for path in sorted((port / "csrc").iterdir()):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if line.lstrip().startswith("#include") and _JAX_PATH.search(line.split(None, 1)[1]):
                found.append(f"{path.relative_to(REPO)}:{n} {line.strip()}")
    assert not found, found
    # The check bites: the JAX package's loader joins the repo's native/.
    assert _jax_paths(REPO / "tieredstorage_tpu" / "native" / "__init__.py")


def _codec_default(demo: str) -> str:
    """The `--codec` argument's default in a demo script."""
    for node in ast.walk(ast.parse((REPO / demo).read_text())):
        if (isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == "--codec"):
            return next(k.value.value for k in node.keywords if k.arg == "default")
    raise AssertionError(f"{demo} has no --codec")


def test_demo_and_sidecar_configs_take_the_jax_demos_codec():
    assert _codec_default(_DEMO) == _codec_default("demo/run_demo.py") == "zstd"
    for name in ("sidecar-local-fs.json", "sidecar-s3-minio.json"):
        jax = json.loads((REPO / "demo" / name).read_text())
        ours = json.loads((REPO / "demo" / f"torch-{name}").read_text())
        assert ours["compression.enabled"] == jax["compression.enabled"]
        assert ours.get("compression.codec", "zstd") == jax.get("compression.codec", "zstd")
