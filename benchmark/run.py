"""Run one cell of the benchmark once on the card and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device`, with `--trace 1` a `breakdown`, and last
`compared`, each number the comparison judged beside its limit; the same
numbers end standard error. Without a CUDA device, or with fewer than the
cell asks for, it exits 3 and prints no result. `--control alter|half`
breaks the program's output where it is produced (a control run, never
part of a measurement).
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")


def steady_malloc() -> None:
    """Fix glibc's heap thresholds for this process: chunk buffers of a few
    MiB come from the heap, and freed ones are kept for reuse instead of
    being returned to the kernel and faulted in again, which otherwise
    depends on how the copiers' allocations interleave."""
    import ctypes

    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (OSError, AttributeError):
        return
    mallopt(-3, 32 << 20)   # M_MMAP_THRESHOLD, glibc's largest
    mallopt(-1, 1 << 30)    # M_TRIM_THRESHOLD


def main(argv=None) -> int:
    from benchmark import harness

    t_start = harness.process_start()
    steady_malloc()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", choices=("alter", "half"), default=None)
    args = parser.parse_args(argv)
    try:
        spec = harness.load_spec()
        cell = harness.find(spec, args.workload)
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise harness.SetupError(
                f"the cell needs {cell['chips']} CUDA device(s); "
                f"available: {torch.cuda.is_available()}, count: "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        ctx = harness.context(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                              control=args.control)
        out = harness.run_cell(ctx, spec, on_card=True, t_start=t_start)
    except harness.SetupError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for line in harness.compared_lines(out["compared"]):
        print(line, file=sys.stderr)
    print(harness.result_line(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
