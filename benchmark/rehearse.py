"""Rehearse a cell on the CPU at a tiny size: every step of a run but the card.

    python3 benchmark/rehearse.py --workload <cell> [--seed N] [--seconds S] [--control alter|half]

The driver and the comparison run end to end with `transform.device=cpu`,
an 8 MiB segment of 256 KiB chunks and a 4 MiB chunk cache. It prints the
comparison's verdict and the counts, and no device metric: no number it
prints is a measurement of the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TINY = {
    "segment_bytes": 8 << 20,
    "rsm": {"chunk.size": 256 << 10, "fetch.chunk.cache.size": 4 << 20,
            "fetch.chunk.cache.prefetch.max.size": 1 << 20},
}


def rehearse(workload: str, seed: int, seconds: float, control: str | None = None,
             trace: bool = False, root: Path = ROOT) -> dict:
    from benchmark import harness

    spec = harness.load_spec(root)
    ctx = harness.context(workload, seed, seconds, trace, "cpu", control=control,
                          overrides=TINY, root=root)
    out = harness.run_cell(ctx, spec, on_card=False, t_start=time.time())
    out.pop("device", None)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--control", choices=("alter", "half"), default=None)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    out = rehearse(args.workload, args.seed, args.seconds, args.control, bool(args.trace))
    print(json.dumps({"rehearsal": "cpu", "correct": out["correct"], "attempted": out["attempted"],
                      "failed": out["failed"], "compared": out["compared"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
