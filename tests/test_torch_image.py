"""docker/Dockerfile.torch and demo/compose-torch-local-fs.yml, read as files.

Nothing is built or pulled: the Dockerfile is parsed into its
instructions and the compose file as YAML, and held to what the image must
be. It copies the port (with its CUDA sources and its host library's
source) and nothing else; it installs every third-party module the port
imports and no jax, and the runtime libzstd, not its headers; it
builds the kernels into a `TSTORCH_BUILD_DIR` the runtime user owns; its
entry point is the port's sidecar, every flag of its command one that the
sidecar's argument parser takes. The compose file builds that image,
reserves one GPU and mounts a config that exists and loads through the
port's config.
"""

from __future__ import annotations

import ast
import json
import re
import shlex
import subprocess
import sys
from pathlib import Path

import yaml

REPO = Path(__file__).resolve().parent.parent
DOCKERFILE = REPO / "docker" / "Dockerfile.torch"
COMPOSE = REPO / "demo" / "compose-torch-local-fs.yml"
#: Import name -> the pip distribution that provides it.
DISTRIBUTIONS = {"grpc": "grpcio", "google": "protobuf", "numpy": "numpy",
                 "zstandard": "zstandard", "cryptography": "cryptography"}


def _instructions() -> list[tuple[str, str]]:
    """(INSTRUCTION, arguments) with continuation lines joined."""
    out, pending = [], ""
    for line in DOCKERFILE.read_text().splitlines():
        if not pending and (not line.strip() or line.lstrip().startswith("#")):
            continue
        pending += line.rstrip()
        if pending.endswith("\\"):
            pending = pending[:-1] + " "
            continue
        word, _, rest = pending.strip().partition(" ")
        out.append((word.upper(), rest.strip()))
        pending = ""
    return out


def _all(name: str) -> list[str]:
    return [args for word, args in _instructions() if word == name]


def _port_third_party_imports() -> set:
    names = set()
    for path in (REPO / "tieredstorage_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names.add(node.module.split(".")[0])
    return {n for n in names if n not in sys.stdlib_module_names
            and n not in ("tieredstorage_tpu_torch", "torch")}


def test_image_copies_the_port_and_never_the_jax_package():
    sources = [shlex.split(args)[:-1] for args in _all("COPY")]
    copied = {s.rstrip("/") for srcs in sources for s in srcs}
    assert "tieredstorage_tpu_torch" in copied
    assert (REPO / "tieredstorage_tpu_torch" / "csrc" / "aes_ctr.cu").exists()
    assert not any(s == "tieredstorage_tpu" or s.startswith("tieredstorage_tpu/")
                   or s in (".", "pyproject.toml") for s in copied), copied
    # The host library's source is the port's own (csrc/transform_host.cpp).
    assert copied == {"tieredstorage_tpu_torch"}, copied


def test_image_installs_what_the_port_imports_and_no_jax():
    runs = " ".join(_all("RUN"))
    installs = set()
    for match in re.finditer(r"pip install ([^&]*)", runs):
        installs.update(w for w in match.group(1).split() if not w.startswith("-"))
    assert not any(re.match(r"jax(lib)?\b", w) for w in installs), installs
    assert not re.search(r"\bjax", runs), runs
    needed = {DISTRIBUTIONS[m] for m in _port_third_party_imports()}
    assert needed <= installs, needed - installs
    base = _all("ARG")[0]
    assert re.fullmatch(r"BASE=pytorch/pytorch:[\w.]+-cuda[\d.]+-cudnn\d+-devel", base), base


def test_image_installs_the_runtime_libzstd_and_not_its_headers():
    """The host library opens libzstd.so.1 with dlopen and includes no
    zstd.h, so the image needs Debian's runtime package alone."""
    from tieredstorage_tpu_torch import native

    packages = set()
    for match in re.finditer(r"apt-get install ([^&]*)", " ".join(_all("RUN"))):
        packages.update(w for w in match.group(1).split() if not w.startswith("-"))
    assert "libzstd1" in packages and "libzstd-dev" not in packages, packages
    assert "g++" in packages, packages  # the host library is compiled at image build
    assert native.ZSTD_LIBRARY == "libzstd.so.1"
    assert "-lzstd" not in native.LDFLAGS


def test_kernels_are_built_at_image_build_into_a_dir_the_user_owns():
    env = " ".join(_all("ENV"))
    build_dir = re.search(r"TSTORCH_BUILD_DIR=(\S+)", env).group(1)
    runs = _all("RUN")
    build = [r for r in runs if "_cuda.build()" in r]
    assert build and "native.load()" in build[0]
    user = _all("USER")[-1]
    assert re.search(rf"chown -R {user} \$\{{TSTORCH_BUILD_DIR\}}", build[0])
    assert any(f"useradd --system --create-home {user}" in r for r in runs)
    assert build_dir.startswith("/srv/tieredstorage/")


def test_entry_point_is_the_port_sidecar_with_flags_its_parser_takes():
    entry = json.loads(_all("ENTRYPOINT")[-1])
    assert entry == ["python", "-m", "tieredstorage_tpu_torch.sidecar"]
    cmd = json.loads(_all("CMD")[-1])
    flags = [a for a in cmd if a.startswith("--")]
    assert flags == ["--config", "--host", "--port", "--metrics-port"]
    res = subprocess.run([sys.executable, "-m", "tieredstorage_tpu_torch.sidecar", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for flag in flags:
        assert re.search(rf"(^|\s|\[){re.escape(flag)}\b", res.stdout), flag
    ports = {cmd[cmd.index(f) + 1] for f in ("--port", "--metrics-port")}
    assert ports == set(_all("EXPOSE")[-1].split())


def test_compose_reserves_one_gpu_and_mounts_a_config_the_port_loads():
    from tieredstorage_tpu_torch.config.rsm_config import RemoteStorageManagerConfig

    compose = yaml.safe_load(COMPOSE.read_text())
    sidecar = compose["services"]["sidecar"]
    assert sidecar["build"] == {"context": "..", "dockerfile": "docker/Dockerfile.torch"}
    (device,) = sidecar["deploy"]["resources"]["reservations"]["devices"]
    assert device == {"driver": "nvidia", "count": 1, "capabilities": ["gpu"]}
    cmd = json.loads(_all("CMD")[-1])
    config_in_image = cmd[cmd.index("--config") + 1]
    mounts = {v.split(":")[1]: v.split(":")[0] for v in sidecar["volumes"]}  # target: source
    config = json.loads((COMPOSE.parent / mounts[config_in_image]).read_text())
    loaded = RemoteStorageManagerConfig(config)
    assert loaded.transform_backend_class.__module__ == "tieredstorage_tpu_torch.transform.cuda"
    assert config["transform.device"] == "cuda:0"
    assert mounts[config["storage.root"]] == "remote-storage"
    assert all(str(v).startswith("tieredstorage_tpu_torch.") for k, v in config.items()
               if k.endswith(".class"))
