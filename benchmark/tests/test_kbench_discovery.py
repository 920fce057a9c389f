"""Configurations, traffic mixes, drivers and metrics are found by name, and
a file dropped into a copy of the benchmark is found the same way."""

import json

import pytest

from benchmark import harness

SPEC = harness.load_spec()


def test_every_cell_resolves_to_its_files():
    for cell in SPEC["workloads"]:
        ctx = harness.context(cell["name"], 1, 1.0, False, "cpu")
        assert ctx.config["name"] == cell["config"]
        assert harness.load_module("drivers", ctx.traffic["driver"]).Driver
    for m in SPEC["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_each_cell_reports_setup_another_end_to_end_metric_and_a_layer_metric():
    for cell in SPEC["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(SPEC, cell["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.metrics_of(SPEC, cell["name"], "per_layer")
        assert layer and all(m["moves"] in e2e for m in layer)


def test_configuration_files_match_the_spec():
    for c in SPEC["configs"]:
        body = json.loads((harness.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]


def test_unknown_names_are_refused():
    with pytest.raises(harness.SetupError):
        harness.find(SPEC, "no-such-cell")
    with pytest.raises(harness.SetupError):
        harness.load_json("traffic", "no-such-mix")
    with pytest.raises(harness.SetupError):
        harness.load_module("metrics", "no_such_metric")


def test_every_traffic_names_a_driver_and_every_metric_file_reads():
    for path in (harness.HERE / "traffic").glob("*.json"):
        mix = harness.load_json("traffic", path.stem)
        assert harness.load_module("drivers", mix["driver"]).Driver
    for path in (harness.HERE / "metrics").glob("*.py"):
        assert callable(harness.load_module("metrics", path.name[:-3]).read)


def test_new_files_in_a_copy_are_found_by_name(tmp_path):
    from conftest import checkout_with

    cell = {"name": "gcm8.tiering-2", "config": "kafka-gcm-8mib", "traffic": "tiering-2",
            "chips": 1, "why": "2 copiers of 1 GiB segments in 8 MiB chunks"}
    rate = {"name": "copy_GiBps.2", "unit": "GiB/s", "better": "higher", "bound": 0.25,
            "source": "host_clock", "workloads": [cell["name"]]}
    root = checkout_with(tmp_path, [cell], [rate])
    here = root / "benchmark"
    config = json.loads((here / "configs" / "kafka-gcm.json").read_text())
    config["name"] = "kafka-gcm-8mib"
    config["rsm"]["chunk.size"] = 8 << 20
    (here / "configs" / "kafka-gcm-8mib.json").write_text(json.dumps(config))
    (here / "traffic" / "tiering-2.json").write_text(json.dumps(
        {**json.loads((here / "traffic" / "tiering.json").read_text()), "copiers": 2}))
    (here / "metrics" / "copies.copy2.py").write_text(
        "def read(layer):\n    return float(layer['bytes'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "copies.copy2", "unit": "B", "better": "higher",
                              "source": "program_counter", "layer": "RSM",
                              "moves": "copy_GiBps.2", "workloads": [cell["name"]]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    ctx = harness.context(cell["name"], 5, 1.0, False, "cpu", root=root)
    assert ctx.chunk == 8 << 20 and ctx.traffic["copiers"] == 2
    assert harness.load_module("drivers", ctx.traffic["driver"], here).Driver
    names = [m["name"] for m in harness.metrics_of(spec, cell["name"], "per_layer")]
    assert names == ["copies.copy2"]
    assert {m["name"] for m in harness.metrics_of(spec, cell["name"], "end_to_end")} == {
        "copy_GiBps.2", "setup_s"}
    assert harness.load_module("metrics", "copies.copy2", here).read({"bytes": 3}) == 3.0
