"""The `transform.assemble` spans' time (the wire chunks IV || ct || tag
made from a finished window on the host) as a share of the copiers' copy
time."""

from benchmark import harness

_share = harness.load_module("metrics", "gcm_context_pct.copy").span_share


def read(layer: dict):
    return _share(layer, "transform.assemble")
