#!/usr/bin/env python3
"""The Huffman decode kernel's launch shape, and its time beside another tree's, on one GPU.

    python3 tools/torch_huffman_probe.py [--variants threads=64,split=never,...] [--trees A,.,.,A]

1. For each variant, builds a copy of csrc/huffman.cu with one constant
   changed, in a temporary directory (the source is not changed): threads=N
   sets the threads a block (`kThreads`), split=never and split=always set
   the lanes up to which a call splits (`kSplitLanes`) to 0 or to all. It
   prints what `-Xptxas -v` says of each, checks its output against the
   package's kernel and times it with `chip_smoke.time_cuda` (20 launches
   behind a sleep kernel) on the smoke's decode operands: 16, 4, 3, 2 and 1
   rows of 4 MiB Kafka-shaped chunks.
2. For each tree of `--trees`, in that order, runs that tree's
   `chip_smoke.decode_kernel_phase` in a process of its own, which builds
   that tree's kernels: an earlier kernel and this one timed in one call on
   one card (order them earlier, this, this, earlier).
Prints the card and one JSON line per result. Needs a CUDA device and nvcc;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from tieredstorage_tpu_torch.ops import _cuda, huffman  # noqa: E402
from tieredstorage_tpu_torch.transform import thuff  # noqa: E402

CHILD = """
import json, sys, torch
sys.path.insert(0, '.')
import chip_smoke
rec = chip_smoke.decode_kernel_phase({seed}, torch.device('cuda:0'))
keep = ('ms', 'bound_ms', 'max_abs', 'table', 'threads', 'blocks')
print('RESULT ' + json.dumps({{k: v for k, v in rec.items() if k.startswith(keep)}}))
"""


SUBSTITUTIONS = {
    "threads": (r"constexpr int kThreads = \d+;", "constexpr int kThreads = {};"),
    "split": (r"constexpr int kSplitLanes = [^;]+;", "constexpr int kSplitLanes = {};"),
}
SPLIT = {"never": "0", "always": "INT_MAX"}


def build_variants(variants: list[str], work: Path) -> dict[str, ctypes.CDLL]:
    """One shared library per variant, compiled in parallel."""
    text = (_cuda.CSRC / "huffman.cu").read_text()
    procs = {}
    for name in variants:
        key, value = name.split("=")
        pattern, repl = SUBSTITUTIONS[key]
        src, lib = work / f"huffman_{key}_{value}.cu", work / f"libhuffman_{key}_{value}.so"
        variant, n = re.subn(pattern, repl.format(SPLIT.get(value, value)), text)
        assert n == 1, f"{key} not found in csrc/huffman.cu"
        src.write_text(variant)
        cmd = [_cuda._nvcc(), *_cuda.ARCH_FLAGS, *_cuda.CFLAGS, "-shared", str(src), "-o", str(lib)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip()}")
        handle = ctypes.CDLL(str(lib))
        handle.tst_huffman_decode.argtypes = [*_cuda._SIGNATURES["huffman_decode"][1], ctypes.c_void_p]
        handle.tst_huffman_decode.restype = ctypes.c_int
        libs[name] = handle
    return libs


def variant_decode(lib: ctypes.CDLL, ops: list[torch.Tensor]):
    words, jump, first, counts, base, perm = ops
    rows, w = words.shape
    n_blocks = jump.shape[1]
    tables = torch.empty((rows, huffman.TABLE_ENTRIES), dtype=torch.int16, device=words.device)
    symbols = torch.empty((rows, n_blocks * huffman.JUMP_BLOCK), dtype=torch.uint8, device=words.device)
    final = torch.empty((rows, n_blocks), dtype=torch.int32, device=words.device)
    rc = lib.tst_huffman_decode(
        words.data_ptr(), w, jump.data_ptr(), n_blocks, first.data_ptr(), counts.data_ptr(),
        base.data_ptr(), perm.data_ptr(), rows, tables.data_ptr(), symbols.data_ptr(),
        final.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"variant launch failed ({rc})")
    return symbols, final


def shapes(seed: int, variants: list[str]) -> None:
    device = torch.device("cuda:0")
    chunks = list(chip_smoke.make_segment(16, chip_smoke.CHUNK, seed))
    _, coded = thuff.parse_frames(thuff.compress_batch(chunks, device=device))
    ops16 = thuff.decode_operands(coded, device)
    with tempfile.TemporaryDirectory(prefix="huffman_probe_") as tmp:
        libs = build_variants(variants, Path(tmp))
        for rows in (16, 4, 3, 2, 1):
            ops = [t[:rows] for t in ops16]
            want = huffman.decode_batch(*ops)
            ms = chip_smoke.time_cuda(lambda ops=ops: huffman.decode_batch(*ops), 20)
            print("variant: " + json.dumps({"variant": "package", "rows": rows, "ms": ms}))
            for name, lib in libs.items():
                got = variant_decode(lib, ops)
                torch.cuda.synchronize()
                same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                ms = chip_smoke.time_cuda(lambda lib=lib, ops=ops: variant_decode(lib, ops), 20)
                print("variant: " + json.dumps({"variant": name, "rows": rows, "ms": ms, "equal": same}))
                if not same:
                    raise SystemExit(f"{name} disagrees with the package's kernel")


def trees(seed: int, paths: list[str]) -> None:
    env = {k: v for k, v in os.environ.items() if k != "TSTORCH_BUILD_DIR"}
    for path in paths:
        res = subprocess.run([sys.executable, "-c", CHILD.format(seed=seed)], cwd=path, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
        if res.returncode != 0 or not lines:
            raise SystemExit(f"decode phase failed in {path}:\n{res.stdout[-4000:]}")
        print(f"tree {path}: " + lines[-1][len("RESULT "):])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--variants", default="threads=64,split=never,split=always")
    parser.add_argument("--trees", default="", help="comma-separated tree roots, run in order")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_huffman_probe: CUDA is not available", file=sys.stderr)
        return 2
    print(f"card: {chip_smoke.card_line()}")
    if args.variants:
        shapes(args.seed, args.variants.split(","))
    if args.trees:
        trees(args.seed, args.trees.split(","))
    return 0


if __name__ == "__main__":
    sys.exit(main())
