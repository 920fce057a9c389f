"""The port's generated docs against the JAX package's.

- `metrics_docs.generate()` equals JAX's byte for byte: the port emits the
  JAX package's metric names.
- `configs_docs.generate()` carries JAX's (section, key, type, default,
  valid values, importance) entries in JAX's order, plus `transform.device`
  only; the keys whose doc text (or default) describes the port are named
  below.
- `docs/torch/*.rst` are the generators' output, and the drift gate of the
  port's analysis fails a copy of the tree that gains an undocumented
  ConfigKey.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from tieredstorage_tpu.docs import configs_docs as jax_configs
from tieredstorage_tpu.docs import metrics_docs as jax_metrics
from tieredstorage_tpu_torch.docs import configs_docs, metrics_docs

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]

#: Port section titles of JAX's sections.
SECTIONS = {
    "TpuTransformBackendConfig (prefix: transform.)":
        "CudaTransformBackendConfig (prefix: transform.)",
}
#: The one key the port declares that JAX does not.
PORT_ONLY_KEYS = {("CudaTransformBackendConfig (prefix: transform.)", "transform.device")}
#: Keys whose default names the port's own class.
PORT_DEFAULTS = {
    "transform.backend.class": ("tieredstorage_tpu.transform.cpu.CpuTransformBackend",
                                "tieredstorage_tpu_torch.transform.cuda.CudaTransformBackend"),
}
#: Keys whose doc text describes the port (its CUDA backend, its tracer,
#: its batcher, its flight recorder and timeline routes).
PORT_DOCS = {
    "transform.backend.class", "compression.codec", "flight.enabled", "lifecycle.enabled",
    "scrub.checksums.enabled", "timeline.enabled", "retry.launch.attempts",
    "tracing.enabled", "tracing.export.path", "tracing.jax.profiler.enabled",
    "transform.batch.bytes", "transform.batch.enabled", "transform.batch.wait.ms",
    "transform.batch.windows", "transform.mesh.devices", "transform.pipeline.depth",
    "transform.batch.background.max.age.ms", "cache.device.bytes",
    "readahead.misprediction.max.ratio",
}


def entries(rst: str) -> list[dict]:
    """Every rendered key: its section, name, doc and bullets, in order."""
    lines = rst.splitlines()
    out, section, i = [], None, 0
    while i < len(lines):
        line = lines[i]
        if i + 1 < len(lines) and re.fullmatch(r"-+", lines[i + 1] or "x") \
                and len(lines[i + 1]) == len(line):
            section = line
            i += 2
            continue
        m = re.fullmatch(r"``([^`]+)``", line)
        if m and section is not None:
            entry = {"section": section, "key": m.group(1), "doc": [], "bullets": {}}
            i += 1
            while i < len(lines) and lines[i].startswith("  ") and not lines[i].startswith("  * "):
                entry["doc"].append(lines[i].strip())
                i += 1
            while i < len(lines) and (not lines[i] or lines[i].startswith("  ")):
                b = re.fullmatch(r"  \* ([A-Za-z ]+): ?(.*)", lines[i])
                if b:
                    entry["bullets"][b.group(1)] = b.group(2)
                i += 1
            out.append(entry)
            continue
        i += 1
    return out


def shape(entry: dict) -> tuple:
    b = entry["bullets"]
    return (entry["section"], entry["key"], b.get("Type"), b.get("Default"),
            b.get("Valid Values"), b.get("Importance"))


@pytest.fixture(scope="module")
def configs():
    return entries(jax_configs.generate()), entries(configs_docs.generate())


def test_metrics_doc_equals_jax_byte_for_byte():
    assert metrics_docs.generate() == jax_metrics.generate()


def test_configs_doc_parses(configs):
    jax, port = configs
    assert len(jax) >= 140 and len(port) == len(jax) + 1
    assert all(e["bullets"].get("Type") and e["bullets"].get("Importance") for e in port)


def test_config_entries_are_jaxs_plus_transform_device(configs):
    jax, port = configs
    expected = []
    for e in jax:
        section, key, typ, default, valid, importance = shape(e)
        if key in PORT_DEFAULTS:
            assert default == PORT_DEFAULTS[key][0]
            default = PORT_DEFAULTS[key][1]
        expected.append((SECTIONS.get(section, section), key, typ, default, valid, importance))
    got = [shape(e) for e in port if (e["section"], e["key"]) not in PORT_ONLY_KEYS]
    assert got == expected
    assert {(e["section"], e["key"]) for e in port} - {t[:2] for t in expected} == PORT_ONLY_KEYS


def test_doc_text_differs_only_on_the_named_keys(configs):
    jax, port = configs
    jax_docs = {(SECTIONS.get(e["section"], e["section"]), e["key"]): e["doc"] for e in jax}
    differ = {e["key"] for e in port
              if jax_docs.get((e["section"], e["key"]), e["doc"]) != e["doc"]}
    assert differ == PORT_DOCS


def test_transform_device_renders_in_the_backend_section(configs):
    _, port = configs
    device = next(e for e in port if e["key"] == "transform.device")
    assert shape(device) == ("CudaTransformBackendConfig (prefix: transform.)",
                             "transform.device", "string", "cuda:0", None, "high")


@pytest.mark.parametrize("name,generator", [("configs", configs_docs), ("metrics", metrics_docs)])
def test_committed_docs_equal_the_generators(name, generator):
    assert (REPO_ROOT / "docs" / "torch" / f"{name}.rst").read_text() == generator.generate()
    assert generator.OUTPUT == f"docs/torch/{name}.rst"


def test_main_writes_its_file(tmp_path, monkeypatch, capsys):
    out = tmp_path / "configs.rst"
    monkeypatch.setattr(configs_docs, "OUTPUT", str(out))
    configs_docs.main()
    assert out.read_text() == configs_docs.generate()
    assert str(out) in capsys.readouterr().out


def test_new_config_key_makes_the_committed_doc_stale(tmp_path):
    """A copy of the tree that declares one more ConfigKey, analysed in a
    process that imports the copy: the drift gate names the stale doc and
    the undocumented key."""
    shutil.copytree(REPO_ROOT / "tieredstorage_tpu_torch", tmp_path / "tieredstorage_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copytree(REPO_ROOT / "docs" / "torch", tmp_path / "docs" / "torch")
    rsm_config = tmp_path / "tieredstorage_tpu_torch" / "config" / "rsm_config.py"
    src = rsm_config.read_text()
    anchor = "def _base_def() -> ConfigDef:\n    d = ConfigDef()\n"
    assert anchor in src
    rsm_config.write_text(src.replace(anchor, anchor + (
        '    d.define(ConfigKey("drift.probe.key", "int", default=1, importance="low",\n'
        '                       doc="A key the committed doc does not have."))\n')))
    env = {**os.environ, "PYTHONPATH": str(tmp_path)}
    res = subprocess.run(
        [sys.executable, "-m", "tieredstorage_tpu_torch.analysis", "--root", str(tmp_path),
         "--checker", "config-drift", "--suppressions", os.devnull,
         "--json", str(tmp_path / "r.json")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 1, res.stdout + res.stderr
    findings = json.loads((tmp_path / "r.json").read_text())["findings"]
    assert {(f["path"], f["detail"]) for f in findings} == {
        ("docs/torch/configs.rst", "stale-generated-doc"),
        ("docs/torch/configs.rst", "undocumented-key:drift.probe.key"),
    }
