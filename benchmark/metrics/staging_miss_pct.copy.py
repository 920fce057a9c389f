"""The share of windows whose staging buffer missed the backend's pool and
was allocated anew: `transform.stage` spans with `allocated` 1 over all of
them."""


def read(layer: dict):
    if layer["kind"] != "copy":
        return None
    stages = [s for s in layer["spans"] if s.name == "transform.stage"]
    if not stages:
        return None
    return 100.0 * sum(s.attributes.get("allocated", 0) for s in stages) / len(stages)
