"""Mutation testing of the PyTorch/CUDA port: the counterpart of
tools/mutation_test.py over `tieredstorage_tpu_torch`.

Each of the 37 default targets of tools/mutation_test.py has its twin here:
the port module that holds the same pure logic, and the
`tests/test_torch_*.py` file that owns it (imports it and holds it against
the JAX package). 35 sit at the same path in the port; `transform/tpu.py`
becomes `transform/cuda.py`, and `ops/ghash_pallas.py` becomes
`ops/ghash_cuda.py`, where the GHASH tree's host-side tiling and
eligibility arithmetic live (`use_ghash_tree`, the level-1 / tree split,
the slice and row-tile sizes).

The machinery is tools/mutation_test.py's own, imported from it (that file
imports neither JAX nor the JAX package): the same AST site finder and
mutator (comparison, arithmetic and boolean swaps), the same in-place
rewrite with backup, restore hooks and refusal of files with uncommitted
changes, the same baseline run and kill-rate threshold, and the same flags.
Only the default targets differ.

    python tools/torch_mutation_test.py --list
    python tools/torch_mutation_test.py --budget 40
    python tools/torch_mutation_test.py --module tieredstorage_tpu_torch/utils/varint.py \\
        --tests tests/test_torch_wire_codecs.py --budget 4 --repo /path/to/a/copy

Mutants rewrite the target in place: point `--repo` at a copy of the tree
to leave the working tree alone while the mutants run.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

#: (port module, owning tests), in the order of tools/mutation_test.py's
#: DEFAULT_TARGETS, whose module each row is the twin of.
TARGETS = [
    ("tieredstorage_tpu_torch/manifest/codec.py", ["tests/test_torch_wire_codecs.py"]),
    ("tieredstorage_tpu_torch/manifest/chunk_index.py", ["tests/test_torch_chunk_index.py"]),
    ("tieredstorage_tpu_torch/storage/core.py", ["tests/test_torch_storage_contract.py"]),
    ("tieredstorage_tpu_torch/utils/varint.py", ["tests/test_torch_wire_codecs.py"]),
    ("tieredstorage_tpu_torch/object_key.py", ["tests/test_torch_wire_codecs.py"]),
    ("tieredstorage_tpu_torch/utils/ratelimit.py", ["tests/test_torch_scrub.py"]),
    ("tieredstorage_tpu_torch/custom_metadata.py", ["tests/test_torch_wire_codecs.py"]),
    ("tieredstorage_tpu_torch/kafka_records.py", ["tests/test_torch_wire_codecs.py"]),
    ("tieredstorage_tpu_torch/utils/caching.py", ["tests/test_torch_fetch_caches.py"]),
    ("tieredstorage_tpu_torch/fetch/enumeration.py", ["tests/test_torch_wire_codecs.py"]),
    ("tieredstorage_tpu_torch/transform/thuff.py", ["tests/test_torch_thuff.py"]),
    ("tieredstorage_tpu_torch/transform/lzhuff.py", ["tests/test_torch_lzhuff.py"]),
    ("tieredstorage_tpu_torch/ops/lz.py", ["tests/test_torch_lzhuff.py"]),
    ("tieredstorage_tpu_torch/transform/cuda.py", ["tests/test_torch_transform.py"]),
    ("tieredstorage_tpu_torch/ops/gf128.py", ["tests/test_torch_ops.py"]),
    ("tieredstorage_tpu_torch/security/aes.py", ["tests/test_torch_transform.py"]),
    ("tieredstorage_tpu_torch/security/rsa.py", ["tests/test_torch_security.py"]),
    ("tieredstorage_tpu_torch/security/keys.py", ["tests/test_torch_security.py"]),
    ("tieredstorage_tpu_torch/metadata.py", ["tests/test_torch_rsm.py"]),
    ("tieredstorage_tpu_torch/analysis/core.py", ["tests/test_torch_static_analysis.py"]),
    ("tieredstorage_tpu_torch/utils/locks.py", ["tests/test_torch_locks.py"]),
    ("tieredstorage_tpu_torch/analysis/races.py", ["tests/test_torch_race_checker.py"]),
    ("tieredstorage_tpu_torch/analysis/dispatch.py", ["tests/test_torch_dispatch_checker.py"]),
    ("tieredstorage_tpu_torch/fleet/ring.py", ["tests/test_torch_fleet.py"]),
    ("tieredstorage_tpu_torch/fleet/gossip.py", ["tests/test_torch_fleet_gossip.py"]),
    ("tieredstorage_tpu_torch/fetch/cache/device_hot.py", ["tests/test_torch_fetch_caches.py"]),
    ("tieredstorage_tpu_torch/ops/ghash_cuda.py", ["tests/test_torch_ops.py"]),
    ("tieredstorage_tpu_torch/utils/flightrecorder.py", ["tests/test_torch_flight_recorder.py"]),
    ("tieredstorage_tpu_torch/metrics/slo.py", ["tests/test_torch_slo.py"]),
    ("tieredstorage_tpu_torch/transform/batcher.py", ["tests/test_torch_batcher.py"]),
    ("tieredstorage_tpu_torch/transform/scheduler.py", ["tests/test_torch_batcher.py"]),
    ("tieredstorage_tpu_torch/metrics/timeline.py", ["tests/test_torch_timeline.py"]),
    ("tieredstorage_tpu_torch/fetch/readahead.py", ["tests/test_torch_fetch_caches.py"]),
    ("tieredstorage_tpu_torch/utils/retry.py", ["tests/test_torch_breakers.py"]),
    ("tieredstorage_tpu_torch/utils/faults.py", ["tests/test_torch_faults.py"]),
    ("tieredstorage_tpu_torch/storage/lifecycle.py", ["tests/test_torch_lifecycle.py"]),
    ("tieredstorage_tpu_torch/scrub/sweeper.py", ["tests/test_torch_lifecycle.py"]),
]


def harness():
    """tools/mutation_test.py as a module (its `main` guarded)."""
    spec = importlib.util.spec_from_file_location("mutation_test", REPO / "tools" / "mutation_test.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> int:
    """tools/mutation_test.py's `main` with the port's targets as its
    defaults; `argv` as its command line (default: this one's)."""
    module = harness()
    module.DEFAULT_TARGETS = TARGETS
    saved = sys.argv
    sys.argv = [saved[0], *(saved[1:] if argv is None else argv)]
    try:
        return module.main()
    finally:
        sys.argv = saved


if __name__ == "__main__":
    sys.exit(main())
