"""The share of the traced window in which no kernel or copy ran on the card."""

from benchmark import layers


def read(layer: dict):
    return layers.device_idle_pct(layer) if layer["kind"] == "copy" else None
