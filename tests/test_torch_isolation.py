"""The port imports neither JAX nor anything of the JAX package.

A subprocess installs a meta-path hook that refuses `jax`, `jaxlib` and
`tieredstorage_tpu` (but not `tieredstorage_tpu_torch`), then imports every
module of the port and chip_smoke.py.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = r'''
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "tieredstorage_tpu")

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import tieredstorage_tpu_torch
import tieredstorage_tpu_torch.rsm
names = [m.name for m in pkgutil.walk_packages(
    tieredstorage_tpu_torch.__path__, "tieredstorage_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(" ".join(names))
print(len(names))
'''

#: Modules of the scheduler and scrub plane, named so that a module left out
#: of the walk (a missing __init__) fails here.
_SCHEDULER_AND_SCRUB = (
    "tieredstorage_tpu_torch.transform.batcher",
    "tieredstorage_tpu_torch.ops.crc32c",
    "tieredstorage_tpu_torch.scrub.scrubber",
    "tieredstorage_tpu_torch.scrub.scheduler",
    "tieredstorage_tpu_torch.utils.retry",
    "tieredstorage_tpu_torch.utils.ratelimit",
)

#: Modules of the compression slice: the native host library and the codecs.
_COMPRESSION = (
    "tieredstorage_tpu_torch.native",
    "tieredstorage_tpu_torch.ops.huffman",
    "tieredstorage_tpu_torch.ops.lz",
    "tieredstorage_tpu_torch.transform.thuff",
    "tieredstorage_tpu_torch.transform.lzhuff",
    "tieredstorage_tpu_torch.transform.native_backend",
    "tieredstorage_tpu_torch.transform.cpu",
)


def test_port_and_chip_smoke_import_without_jax():
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    *_, names, count = res.stdout.strip().splitlines()
    assert int(count) >= 36 + len(_COMPRESSION)  # every module was imported
    assert set(_SCHEDULER_AND_SCRUB) <= set(names.split())
    assert set(_COMPRESSION) <= set(names.split())


def test_chip_smoke_refuses_without_cuda():
    """Without a card the smoke exits non-zero and prints no result line."""
    probe = (
        "import sys, torch; torch.cuda.is_available = lambda: False; "
        "sys.argv = ['chip_smoke.py']; import chip_smoke; sys.exit(chip_smoke.main())"
    )
    res = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
