"""Run one phase of a load gate (tools/load_demo.py or its twin
tools/torch_load_demo.py) as a child, with some of its constants set.

    python tests/torch_gate_phase.py TOOL PHASE --out REPORT [--set NAME=VALUE ...]
        [--device cpu]

The tool is imported as a module (its `main` guarded, nothing runs at
import), each `--set` replaces one of its module constants (the value is
read as a Python literal), then PHASE runs and its result is written to
REPORT as JSON:

- `capacity_probe`: `capacity_probe(PROBE_STREAMS)`. One of its checks
  hangs on scheduling rather than on the code under test: batched round
  trips a window <= 1, which a loaded host breaks by merging fewer windows
  a launch. Stopped there, the three modes are written with
  `"stopped_at": "hbm_roundtrips"` and the batched mode's numbers as
  `"verdict"`; any other failure fails the run;
- `probe_modes`: the twin's `capacity_probe_modes(PROBE_STREAMS)`, the
  probe's three modes without its checks;
- `readahead_ab`: `readahead_ab_phase()`. Its first check, replay p99
  with readahead < without, hangs on scheduling at a cut depth (its
  promotion reads are more than 1 % of the replay's): stopped there, the
  two arms are written with `"stopped_at": "readahead_p99"`; any other
  failure fails the run;
- `readahead_modes`: the twin's `readahead_ab_modes()`, the phase's two
  arms without its checks;
- `fleet`: the whole gate, `run(...)`, up to the capacity probe: the
  closed loop under both kills, the SLO verdicts, overload and recovery,
  the fleet telemetry, the flight records, scrub under chaos and the
  timeline, each with its checks. The probe is replaced by a stop that
  takes the gate's report as it stands, from `run()`'s frame, and the
  report is written after `run()` has closed its fleet, with
  `"stopped_at": "capacity_probe"`. Two failed checks, each hanging on
  timing rather than on the code under test, stop it too (`KNOWN_STOPS`):
  the SLO section's `fetch-latency` `burn_rate_long` check, which both
  gates fail once the closed loop outlasts the long window after its last
  cold chunk fetch, and the timeline phase's exemplar search, which finds
  no request that both forwarded a chunk and rode a merged launch when
  its burst, whose segment the origin owns, forwards nothing and the
  closed loop left no such record. The report as it stood then is written
  with `"stopped_at"` naming the check and its message as `"verdict"`. Any
  other failure fails the run.

`--device` sets the twin's `DEVICE` (the JAX gate has none). Neither tool
file is edited: the tests/test_torch_gate_load.py helper.
"""

from __future__ import annotations

import argparse
import ast
import importlib.util
import json
import sys
import tempfile
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def load_tool(path: str):
    spec = importlib.util.spec_from_file_location(Path(path).stem, REPO / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


#: Source text of a check's line -> the name the fleet phase records when
#: that check stops the gate.
KNOWN_STOPS = {
    'latency["burn_rate_long"] is not None': "burn_rate_long",
    "assembled is not None": "timeline_exemplar",
    'batched["hbm_roundtrips_per_window"] <= 1.0': "hbm_roundtrips",
    'on["replay_p99_ms"] < off["replay_p99_ms"]': "readahead_p99",
}


class _FleetPartDone(Exception):
    """Raised in place of the capacity probe; carries the gate's report."""


def _frame_of(tb, function: str):
    """The frame of the tool's `function` in a traceback."""
    frame = None
    while tb is not None:
        if tb.tb_frame.f_code.co_name == function:
            frame = tb.tb_frame
        tb = tb.tb_next
    return frame


def _known_stop(failed: AssertionError):
    """The KNOWN_STOPS name of the check that raised `failed`, or None."""
    line = traceback.extract_tb(failed.__traceback__)[-1].line
    return next((name for text, name in KNOWN_STOPS.items() if text in line), None)


def _run(tool, twin: bool, out: Path) -> int:
    if twin:
        return tool.run(out, tool.DEVICE)
    with tempfile.TemporaryDirectory() as scratch:
        return tool.run(out, Path(scratch) / "bench.json")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("tool")
    parser.add_argument("phase", choices=("capacity_probe", "probe_modes", "readahead_ab",
                                          "readahead_modes", "fleet"))
    parser.add_argument("--out", required=True)
    parser.add_argument("--set", action="append", default=[], metavar="NAME=VALUE")
    parser.add_argument("--device")
    args = parser.parse_args(argv)

    tool = load_tool(args.tool)
    for item in args.set:
        name, value = item.split("=", 1)
        if not hasattr(tool, name):
            parser.error(f"{args.tool} has no constant {name}")
        setattr(tool, name, ast.literal_eval(value))
    twin = hasattr(tool, "DEVICE")
    if twin:
        tool.DEVICE = args.device or tool.DEVICE
    out = Path(args.out)
    if args.phase == "fleet":
        def stop(_streams):
            raise _FleetPartDone(sys._getframe(1).f_locals["report"])

        tool.capacity_probe = stop
        try:
            _run(tool, twin, out)
        except _FleetPartDone as done:
            out.write_text(json.dumps({**done.args[0], "stopped_at": "capacity_probe"}, indent=1))
            return 0
        except AssertionError as failed:
            frame, stop = _frame_of(failed.__traceback__, "run"), _known_stop(failed)
            if frame is None or stop not in ("burn_rate_long", "timeline_exemplar"):
                raise
            out.write_text(json.dumps({**frame.f_locals["report"], "stopped_at": stop,
                                       "verdict": failed.args[0]}, indent=1))
            return 0
        raise AssertionError("the gate ended without reaching its capacity probe")
    if args.phase == "capacity_probe":
        try:
            result = tool.capacity_probe(tool.PROBE_STREAMS)
        except AssertionError as failed:
            frame = _frame_of(failed.__traceback__, "capacity_probe")
            if frame is None or _known_stop(failed) != "hbm_roundtrips":
                raise
            modes = frame.f_locals
            result = {"batched": modes["batched"], "batched_with_scrub": modes["isolated"],
                      "unbatched_control": modes["control"], "stopped_at": "hbm_roundtrips",
                      "verdict": failed.args[0]}
    elif args.phase == "probe_modes":
        result = tool.capacity_probe_modes(tool.PROBE_STREAMS)
    elif args.phase == "readahead_modes":
        result = tool.readahead_ab_modes()
    else:
        try:
            result = tool.readahead_ab_phase()
        except AssertionError as failed:
            frame = _frame_of(failed.__traceback__, "readahead_ab_phase")
            if frame is None or _known_stop(failed) != "readahead_p99":
                raise
            arms = frame.f_locals
            result = {"readahead_on": arms["on"], "readahead_off": arms["off"],
                      "stopped_at": "readahead_p99"}
    out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
