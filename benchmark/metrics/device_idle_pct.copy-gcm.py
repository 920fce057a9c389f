"""`device_idle_pct.copy` in a cell that reports no `copy_GiBps` end to end, where
it moves `stored_ratio`: the same reader."""

from benchmark import harness

read = harness.load_module("metrics", "device_idle_pct.copy").read
