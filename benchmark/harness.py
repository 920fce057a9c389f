"""Run one cell of the benchmark once: set up, measure, trace, compare.

Everything a cell is made of is found by name: the cell in BENCHMARK.json,
its configuration in `configs/<name>.json`, its traffic mix in
`traffic/<name>.json`, the traffic's driver in `drivers/<kind>.py`, and each
per-layer metric's reader in `metrics/<name>.py`. A later change adds a
configuration, a mix or a metric by adding files.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tieredstorage_tpu")


class SetupError(Exception):
    """The run cannot measure (no card, an unknown cell, ...): no result."""


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(spec: dict, workload: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SetupError(f"no workload named {workload!r} in BENCHMARK.json")


def load_json(kind: str, name: str, here: Path = HERE) -> dict:
    path = here / kind / f"{name}.json"
    if not path.is_file():
        raise SetupError(f"no {kind[:-1]} file {path.relative_to(here.parent)}")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, here: Path = HERE):
    path = here / kind / f"{name}.py"
    if not path.is_file():
        raise SetupError(f"no {kind[:-1]} module {path.relative_to(here.parent)}")
    mod_name = f"benchmark_{kind}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(spec: dict, workload: str, section: str) -> list[dict]:
    """The end-to-end or per-layer metrics this cell reports."""
    cell_e2e = {m["name"] for m in spec["end_to_end"]
                if workload in m.get("workloads", [workload])}
    out = []
    for m in spec[section]:
        if section == "end_to_end":
            if m["name"] in cell_e2e:
                out.append(m)
        elif workload in m.get("workloads", [workload] if m["moves"] in cell_e2e else []):
            out.append(m)
    return out


def process_start() -> float:
    """The process's start on the `time.time()` clock (from /proc)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list[str]:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What a driver is given: the cell's files, its sizes and its run."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: str
    config: dict
    traffic: dict
    control: str | None = None
    segment_bytes: int = 0
    chunk: int = 0
    scratch: Path | None = None

    def log(self, msg: str) -> None:
        print(f"[{self.workload}] {msg}", file=sys.stderr, flush=True)


def context(workload: str, seed: int, seconds: float, trace: bool, device: str,
            control: str | None = None, overrides: dict | None = None, root: Path = ROOT) -> Context:
    """The cell's context; `overrides` shrinks sizes for the CPU rehearsal."""
    spec = load_spec(root)
    cell = find(spec, workload)
    config = load_json("configs", cell["config"], root / "benchmark")
    traffic = load_json("traffic", cell["traffic"], root / "benchmark")
    overrides = overrides or {}
    config = json.loads(json.dumps(config))
    config["rsm"].update(overrides.get("rsm", {}))
    return Context(
        workload=workload, seed=seed, seconds=seconds, trace=trace, device=device,
        config=config, traffic=traffic, control=control,
        segment_bytes=overrides.get("segment_bytes", config["segment"]["log.segment.bytes"]),
        chunk=config["rsm"]["chunk.size"],
    )


def compared_holds(compared: dict) -> bool:
    ok = True
    for entry in compared.values():
        if "max" in entry:
            ok &= entry["value"] <= entry["max"]
        if "min" in entry:
            ok &= entry["value"] >= entry["min"]
    return bool(ok)


def run_cell(ctx: Context, spec: dict, *, on_card: bool, t_start: float) -> dict:
    """Set up, measure for ctx.seconds, read the trace, compare. Returns the
    result line's fields; device fields only when `on_card`."""
    import torch

    from benchmark import program
    from benchmark.reference import rsa_oaep

    ctx.log(f"process start to harness {time.time() - t_start:.3f} s")
    driver_mod = load_module("drivers", ctx.traffic["driver"])
    ctx.scratch = Path(tempfile.mkdtemp(prefix="kbench-"))
    pair = rsa_oaep.generate(ctx.seed, ctx.config.get("rsa.key.bits", 2048))
    key_files = rsa_oaep.write_pem_files(pair, ctx.scratch)
    if on_card:
        t = time.perf_counter()
        program.build_kernels()
        ctx.log(f"kernels and native library {time.perf_counter() - t:.3f} s")
    driver = driver_mod.Driver(ctx, key_files, pair)
    try:
        driver.setup()
        if on_card:
            # The peak is the program's: from the warmed-up state on, not the
            # segment's transient buffer on the card in set-up.
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.time() - t_start
        ctx.log(f"set-up {setup_s:.3f} s; window {ctx.seconds} s")
        profiler = None
        if ctx.trace and on_card:
            from benchmark import trace as trace_mod
            profiler = trace_mod.Profiler()
            profiler.__enter__()
        try:
            window = driver.run_window()
        finally:
            if profiler is not None:
                profiler.__exit__(None, None, None)
        out: dict = {"attempted": window["attempted"], "failed": window["failed"]}
        metrics: dict = {}
        if on_card:
            torch.cuda.synchronize()
            peak = int(torch.cuda.max_memory_allocated(0))
            out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                             "count": 1, "memory_peak_bytes": peak}
        if not ctx.trace:
            values = driver.end_to_end(window)
            values["setup_s"] = setup_s
            for m in metrics_of(spec, ctx.workload, "end_to_end"):
                if m["name"] in values:
                    metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        else:
            layer = driver.layer_inputs(window)
            device_trace = None
            if profiler is not None:
                device_trace = profiler.result(
                    [(s.name, s.start_s, s.end_s) for s in layer["spans"]] + window["host_ranges"])
                ctx.log(f"trace reduced in {profiler.reduce_s:.1f} s")
                out["device"]["busy_s"] = device_trace.busy_s
                out["device"]["window_s"] = device_trace.window_s
                out["breakdown"] = {"device_ops": device_trace.device_ops,
                                    "idle_gaps": device_trace.idle_gaps}
            layer["trace"] = device_trace
            for m in metrics_of(spec, ctx.workload, "per_layer"):
                value = load_module("metrics", m["name"]).read(layer)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["metrics"] = metrics
        driver.release()
        if on_card:
            torch.cuda.empty_cache()
        t = time.perf_counter()
        compared = driver.compare(window)
        ctx.log(f"comparison {time.perf_counter() - t:.1f} s")
        out["correct"] = compared_holds(compared)
        out["compared"] = compared
        return out
    finally:
        driver.close()
        for p in ctx.scratch.iterdir():
            p.unlink()
        ctx.scratch.rmdir()


def result_line(out: dict) -> str:
    ordered = {k: out[k] for k in ("correct", "attempted", "failed", "metrics", "device", "breakdown")
               if k in out}
    ordered["compared"] = out["compared"]
    return json.dumps(ordered)


def compared_lines(compared: dict) -> list[str]:
    lines = []
    for name, e in compared.items():
        limit = " ".join(f"{k} {e[k]}" for k in ("min", "max") if k in e)
        lines.append(f"compared {name}: {e['value']} (limit: {limit})")
    return lines
