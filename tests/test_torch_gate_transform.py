"""tools/torch_transform_demo.py against tools/transform_demo.py on the CPU.

Both gates run at the same seed and shapes; the JAX gate through a wrapper
that pins its data key to the twin's seeded one and digests the wire bytes
of its window path. Their reports must agree on every deterministic field:
the dispatch counts, the ops-level dispatches, every check (through the
counterparts named in the twin's docstring) and the wire bytes. Timings
are exempt, and so are the HBM round trips, which differ by design: the
JAX tree path writes one intermediate a window, the port's fixed window
two and its varlen window four, the fixed total the twin holds its count
to (10 for the four windows).
"""

from __future__ import annotations

import numpy as np

from tests.torch_gates import run_pair

#: JAX check -> the twin's counterpart (same name where none is listed).
COUNTERPARTS = {
    "one_hbm_roundtrip_per_window": "hbm_roundtrips_fixed_2_varlen_4",
    "ladder_control_exceeds_one_roundtrip": "ladder_control_exceeds_tree_roundtrips",
    "batched_hbm_roundtrips_per_window_le_1": "batched_hbm_roundtrips_per_window_le_unbatched",
    "bench_shapes_pallas_eligible_on_host": "bench_shapes_tree_eligible_on_host",
}

_JAX_WRAPPER = r'''
import hashlib, json, pathlib, sys
out, KEY, AAD = sys.argv[1], bytes.fromhex(sys.argv[2]), bytes.fromhex(sys.argv[3])
sys.path.insert(0, "tools")
sys.argv = ["transform_demo.py", "--out", out]
import transform_demo as gate
from tieredstorage_tpu.security import aes

aes.AesEncryptionProvider.create_data_key_and_aad = staticmethod(
    lambda: aes.DataKeyAndAAD(KEY, AAD))
calls = []
window_path = gate.TpuTransformBackend.transform_windows

def recorded(self, windows, opts):
    out = []
    calls.append(out)
    for w in window_path(self, windows, opts):
        out.append(list(w))
        yield w

gate.TpuTransformBackend.transform_windows = recorded
code = gate.main()
digest = hashlib.sha256()
for w in calls[0]:
    for c in w:
        digest.update(c)
path = pathlib.Path(out)
report = json.loads(path.read_text())
report["wire_sha256"] = digest.hexdigest()
report["wire_bytes"] = sum(len(c) for w in calls[0] for c in w)
path.write_text(json.dumps(report))
sys.exit(code)
'''


def test_transform_twin_matches_the_jax_gate(tmp_path):
    jax_out, twin_out = tmp_path / "jax.json", tmp_path / "twin.json"
    # The twin's `seeded_data_key`, computed here without importing the twin.
    rng = np.random.default_rng(42)
    key, aad = rng.bytes(32), rng.bytes(32)
    jax, twin = run_pair(
        ["-c", _JAX_WRAPPER, str(jax_out), key.hex(), aad.hex()],
        ["tools/torch_transform_demo.py", "--out", str(twin_out)],
        jax_out, twin_out,
    )
    assert jax["ok"] and twin["ok"], (jax["checks"], twin["checks"])
    assert {COUNTERPARTS.get(k, k): v for k, v in jax["checks"].items()} == twin["checks"]
    exempt = {"hbm_roundtrips", "hbm_roundtrips_per_window"}
    assert {k: v for k, v in jax["dispatch_stats"].items() if k not in exempt} == {
        k: v for k, v in twin["dispatch_stats"].items() if k not in exempt}
    assert jax["ops_level_dispatches"] == twin["ops_level_dispatches"] == 4
    assert jax["dispatch_stats"]["hbm_roundtrips"] == 4
    assert twin["dispatch_stats"]["hbm_roundtrips"] == twin["ops_level_hbm_roundtrips"] == 10
    assert twin["batched_dispatch_stats"]["hbm_roundtrips_per_window"] <= 2.5
    assert jax["wire_bytes"] == twin["wire_bytes"]
    assert jax["wire_sha256"] == twin["wire_sha256"]
