"""Put the checkout's root on the path so `benchmark` imports as a package,
and give the tests a copy of the benchmark to add files to."""

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def checkout_with(tmp: Path, cells: list, end_to_end: list) -> Path:
    """A copy of BENCHMARK.json and benchmark/ under `tmp`, with more cells
    and end-to-end metrics in the spec."""
    root = tmp / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"] += cells
    spec["end_to_end"] += end_to_end
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
