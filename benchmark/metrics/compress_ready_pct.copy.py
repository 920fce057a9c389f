"""The share of the windows compressed ahead whose frames were all there
when the copier reached them: `transform.compress_wait` spans with `ahead`
1 and `ready` 1 over those with `ahead` 1."""


def read(layer: dict):
    if layer["kind"] != "copy":
        return None
    ahead = [s for s in layer["spans"]
             if s.name == "transform.compress_wait" and s.attributes.get("ahead") == 1]
    if not ahead:
        return None
    return 100.0 * sum(s.attributes.get("ready", 0) for s in ahead) / len(ahead)
