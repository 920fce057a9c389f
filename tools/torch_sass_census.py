#!/usr/bin/env python3
"""Count the SASS instructions of a CUDA source of the port, by opcode.

    python3 tools/torch_sass_census.py [csrc/aes_ctr.cu ...]

Compiles each source (default: the AES keystream kernel) to a cubin for
sm_90a with the port's nvcc and flags, disassembles it with `cuobjdump
-sass`, and prints for every kernel its instruction count by opcode (the
part before the first dot: LOP3, SHFL, PRMT, ...) over the whole function
and over its largest loop (the instructions from a backward branch's target
to the branch: for the AES kernel, one round). Needs nvcc and cuobjdump,
not a card; imports nothing of JAX.
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tieredstorage_tpu_torch.ops import _cuda  # noqa: E402

_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)(?:\.\S*)?\s*(.*?);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def parse(sass: str) -> dict[str, list[tuple[int, str, str]]]:
    """{function: [(address, opcode, operands)]}, branch targets given as
    labels resolved to addresses."""
    functions: dict[str, list[tuple[int, str, str]]] = {}
    current, labels, pending = None, {}, []
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            current = functions.setdefault(m.group(1), [])
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m and current is not None:
            addr = int(m.group(1), 16)
            labels.update((name, addr) for name in pending)
            pending.clear()
            current.append((addr, m.group(2), m.group(3)))
    return {
        name: [(a, op, re.sub(r"\.L_x_\d+", lambda t: hex(labels.get(t.group(0), a)), args))
               for a, op, args in instrs]
        for name, instrs in functions.items()
    }


def largest_loop(instrs: list[tuple[int, str, str]]) -> list[tuple[int, str, str]]:
    best: list[tuple[int, str, str]] = []
    for addr, op, args in instrs:
        m = _TARGET.search(args) if op in ("BRA", "JMP") else None
        if m and int(m.group(1), 16) < addr:
            body = [i for i in instrs if int(m.group(1), 16) <= i[0] <= addr]
            if len(body) > len(best):
                best = body
    return best


def census(instrs) -> str:
    counts = collections.Counter(op for _, op, _ in instrs)
    return f"{len(instrs)} instructions: " + ", ".join(f"{op} {n}" for op, n in counts.most_common())


def functions(name: str) -> dict[str, list[tuple[int, str, str]]]:
    """The parsed SASS of csrc/<name>, built with the port's flags."""
    nvcc = _cuda._nvcc()
    cuobjdump = shutil.which("cuobjdump") or str(Path(nvcc).parent / "cuobjdump")
    src = _cuda.CSRC / Path(name).name
    with tempfile.TemporaryDirectory(prefix="sass_census_") as work:
        cubin = Path(work) / (src.stem + ".cubin")
        flags = [f for f in _cuda.CFLAGS if f not in ("-Xcompiler", "-fPIC")]
        subprocess.run([nvcc, *_cuda.ARCH_FLAGS, *flags, "-cubin", str(src), "-o", str(cubin)],
                       check=True)
        sass = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True,
                              stdout=subprocess.PIPE, text=True).stdout
    return parse(sass)


def main(argv=None) -> int:
    sources = (argv if argv is not None else sys.argv[1:]) or ["aes_ctr.cu"]
    for name in sources:
        for function, instrs in functions(name).items():
            print(f"{Path(name).name} {function}")
            print(f"  whole: {census(instrs)}")
            loop = largest_loop(instrs)
            if loop:
                print(f"  largest loop ({loop[0][0]:#x}-{loop[-1][0]:#x}): {census(loop)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
