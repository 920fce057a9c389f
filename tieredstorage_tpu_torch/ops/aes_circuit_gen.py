"""Generate the CUDA S-box circuit (csrc/aes_sbox_circuit.cuh) from `_sbox_planes`.

The CUDA keystream kernel evaluates SubBytes as straight-line boolean code.
Rather than transcribing gates by hand, this script runs the port's own
`aes_bitsliced._sbox_planes` over symbolic values that record each XOR / AND
/ NOT, merges repeated gates, drops gates no output needs, and renders the
rest as one `__device__` function. A CPU test regenerates the header and
compares it with the committed file.

    python -m tieredstorage_tpu_torch.ops.aes_circuit_gen          # rewrite
    python -m tieredstorage_tpu_torch.ops.aes_circuit_gen --check  # compare
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from tieredstorage_tpu_torch.ops.aes_bitsliced import _sbox_planes, _tower

HEADER = Path(__file__).resolve().parent.parent / "csrc" / "aes_sbox_circuit.cuh"


class _Circuit:
    def __init__(self) -> None:
        self.gates: list[tuple[str, str, str]] = []  # (op, a, b) by index
        self._seen: dict[tuple[str, str, str], "_Sym"] = {}

    def gate(self, op: str, a: "_Sym", b: "_Sym | None" = None) -> "_Sym":
        names = (a.name, b.name) if b is not None else (a.name, "")
        if op != "~":
            names = tuple(sorted(names))  # ^ and & commute
        key = (op,) + names
        if key not in self._seen:
            self._seen[key] = _Sym(self, f"t{len(self.gates)}")
            self.gates.append(key)
        return self._seen[key]


class _Sym:
    def __init__(self, circuit: _Circuit, name: str) -> None:
        self.circuit = circuit
        self.name = name

    def __xor__(self, other: "_Sym") -> "_Sym":
        return self.circuit.gate("^", self, other)

    def __and__(self, other: "_Sym") -> "_Sym":
        return self.circuit.gate("&", self, other)

    def __invert__(self) -> "_Sym":
        return self.circuit.gate("~", self)


def sbox_gates() -> tuple[list[tuple[str, str, str, str]], list[str]]:
    """Live gates [(out, op, a, b)] in evaluation order and the 8 output names."""
    circuit = _Circuit()
    outputs = [s.name for s in _sbox_planes(_tower(), [_Sym(circuit, f"x{i}") for i in range(8)])]
    if not all(name.startswith("t") for name in outputs):
        raise AssertionError("an S-box output is an input plane")
    live = set(outputs)
    for idx in range(len(circuit.gates) - 1, -1, -1):
        if f"t{idx}" in live:
            _op, a, b = circuit.gates[idx]
            live.update(n for n in (a, b) if n)
    gates = [
        (f"t{i}",) + g for i, g in enumerate(circuit.gates) if f"t{i}" in live
    ]
    return gates, outputs


def render() -> str:
    gates, outputs = sbox_gates()
    lines = [
        "// Generated by tieredstorage_tpu_torch/ops/aes_circuit_gen.py from",
        "// ops/aes_bitsliced._sbox_planes (the AES S-box as a GF((2^4)^2) tower",
        "// circuit). Do not edit: rerun the generator.",
        "#pragma once",
        "#include <cstdint>",
        "",
        f"#define TST_SBOX_GATES {len(gates)}",
        "",
        "// x0..x7: bit-planes of one byte position, LSB first; each word carries",
        "// 32 blocks. Replaced in place by the planes of S(x).",
        "__device__ __forceinline__ void tst_sbox(",
        "    uint32_t& x0, uint32_t& x1, uint32_t& x2, uint32_t& x3,",
        "    uint32_t& x4, uint32_t& x5, uint32_t& x6, uint32_t& x7) {",
    ]
    for out, op, a, b in gates:
        expr = f"~{a}" if op == "~" else f"{a} {op} {b}"
        lines.append(f"  const uint32_t {out} = {expr};")
    for i, name in enumerate(outputs):
        lines.append(f"  x{i} = {name};")
    lines.append("}")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true", help="fail if the header is stale")
    args = parser.parse_args(argv)
    text = render()
    if args.check:
        if HEADER.read_text() != text:
            print(f"{HEADER} is out of date: rerun the generator", file=sys.stderr)
            return 1
        return 0
    HEADER.write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
