"""Mean rows (chunks) of the AES-256-CTR launches in the window."""

from benchmark import layers


def read(layer: dict):
    return layers.mean_rows(layer) if layer["kind"] == "copy" else None
