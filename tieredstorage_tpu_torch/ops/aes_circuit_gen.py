"""Generate the CUDA S-box circuit (csrc/aes_sbox_circuit.cuh) from a gate list.

The CUDA keystream kernel evaluates SubBytes as straight-line boolean code:
Boyar and Peralta's 115-gate AES S-box circuit (32 AND, 79 XOR, 4 XNOR),
from J. Boyar and R. Peralta, "A new combinational logic minimization
technique with applications to cryptology", SEA 2010 (LNCS 6049). `_BP_SBOX`
below is that circuit as the paper writes it: inputs U0..U7 and outputs
S0..S7, most significant bit first.

The kernel runs it as 74 three-input LOP3 instructions: `_LOP3_ROOTS` names
the gates whose values are kept, and each one is computed from the nearest
kept gates or inputs below it (at most three) by one LOP3 whose truth table
is that cone of gates. The set is the least that covers the circuit this
way, as an integer program over the gates' three-input cuts finds it
(tools/torch_lop3_cover.py). `render` writes the cover as one `__device__`
function over the kernel's least-significant-first planes. CPU tests run the
gate list and the cover over all 256 inputs against the FIPS-197 table and
the JAX package's tower circuit, and compare the committed header with a
fresh rendering.

    python -m tieredstorage_tpu_torch.ops.aes_circuit_gen           # rewrite
    python -m tieredstorage_tpu_torch.ops.aes_circuit_gen --check   # compare
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

HEADER = Path(__file__).resolve().parent.parent / "csrc" / "aes_sbox_circuit.cuh"

# Top linear layer (23 XOR), shared non-linear middle (30 XOR, 32 AND),
# bottom linear layer (26 XOR, 4 XNOR). `~^` is XNOR.
_BP_SBOX = """
y14 = U3 ^ U5
y13 = U0 ^ U6
y9 = U0 ^ U3
y8 = U0 ^ U5
t0 = U1 ^ U2
y1 = t0 ^ U7
y4 = y1 ^ U3
y12 = y13 ^ y14
y2 = y1 ^ U0
y5 = y1 ^ U6
y3 = y5 ^ y8
t1 = U4 ^ y12
y15 = t1 ^ U5
y20 = t1 ^ U1
y6 = y15 ^ U7
y10 = y15 ^ t0
y11 = y20 ^ y9
y7 = U7 ^ y11
y17 = y10 ^ y11
y19 = y10 ^ y8
y16 = t0 ^ y11
y21 = y13 ^ y16
y18 = U0 ^ y16
t2 = y12 & y15
t3 = y3 & y6
t4 = t3 ^ t2
t5 = y4 & U7
t6 = t5 ^ t2
t7 = y13 & y16
t8 = y5 & y1
t9 = t8 ^ t7
t10 = y2 & y7
t11 = t10 ^ t7
t12 = y9 & y11
t13 = y14 & y17
t14 = t13 ^ t12
t15 = y8 & y10
t16 = t15 ^ t12
t17 = t4 ^ t14
t18 = t6 ^ t16
t19 = t9 ^ t14
t20 = t11 ^ t16
t21 = t17 ^ y20
t22 = t18 ^ y19
t23 = t19 ^ y21
t24 = t20 ^ y18
t25 = t21 ^ t22
t26 = t21 & t23
t27 = t24 ^ t26
t28 = t25 & t27
t29 = t28 ^ t22
t30 = t23 ^ t24
t31 = t22 ^ t26
t32 = t31 & t30
t33 = t32 ^ t24
t34 = t23 ^ t33
t35 = t27 ^ t33
t36 = t24 & t35
t37 = t36 ^ t34
t38 = t27 ^ t36
t39 = t29 & t38
t40 = t25 ^ t39
t41 = t40 ^ t37
t42 = t29 ^ t33
t43 = t29 ^ t40
t44 = t33 ^ t37
t45 = t42 ^ t41
z0 = t44 & y15
z1 = t37 & y6
z2 = t33 & U7
z3 = t43 & y16
z4 = t40 & y1
z5 = t29 & y7
z6 = t42 & y11
z7 = t45 & y17
z8 = t41 & y10
z9 = t44 & y12
z10 = t37 & y3
z11 = t33 & y4
z12 = t43 & y13
z13 = t40 & y5
z14 = t29 & y2
z15 = t42 & y9
z16 = t45 & y14
z17 = t41 & y8
t46 = z15 ^ z16
t47 = z10 ^ z11
t48 = z5 ^ z13
t49 = z9 ^ z10
t50 = z2 ^ z12
t51 = z2 ^ z5
t52 = z7 ^ z8
t53 = z0 ^ z3
t54 = z6 ^ z7
t55 = z16 ^ z17
t56 = z12 ^ t48
t57 = t50 ^ t53
t58 = z4 ^ t46
t59 = z3 ^ t54
t60 = t46 ^ t57
t61 = z14 ^ t57
t62 = t52 ^ t58
t63 = t49 ^ t58
t64 = z4 ^ t59
t65 = t61 ^ t62
t66 = z1 ^ t63
S0 = t59 ^ t63
S6 = t56 ~^ t62
S7 = t48 ~^ t60
t67 = t64 ^ t65
S3 = t53 ^ t66
S4 = t51 ^ t66
S5 = t47 ^ t65
S1 = t64 ~^ S3
S2 = t55 ~^ t67
"""

#: The gates computed as LOP3 results (the rest live inside their cones).
_LOP3_ROOTS = """
S0 S1 S2 S3 S4 S5 S6 S7 t10 t12 t14 t16 t18 t19 t20 t21 t22 t23 t24 t27 t29 t3
t31 t33 t36 t37 t39 t4 t40 t41 t42 t44 t46 t48 t49 t5 t52 t53 t54 t55 t57 t6
t61 t62 t63 t64 t65 t66 t7 t8 y1 y10 y11 y12 y13 y14 y15 y16 y17 y2 y20 y5 y6
y8 y9 z10 z11 z12 z16 z2 z3 z4 z5 z7
""".split()


def sbox_gates() -> tuple[list[tuple[str, str, str, str]], list[str]]:
    """The published circuit: gates [(out, op, a, b)] in evaluation order, op
    one of "^", "&", "~^" (XNOR), over inputs x0..x7 (least significant bit
    first), and the names of the 8 output planes, least significant first."""
    rename = {f"U{i}": f"x{7 - i}" for i in range(8)}
    gates = []
    for line in _BP_SBOX.strip().splitlines():
        out, expr = (s.strip() for s in line.split("="))
        a, op, b = expr.split()
        gates.append((out, op, rename.get(a, a), rename.get(b, b)))
    return gates, [f"S{7 - i}" for i in range(8)]


def _apply(op: str, a: int, b: int, ones: int) -> int:
    return a ^ b if op == "^" else a & b if op == "&" else ~(a ^ b) & ones


def sbox_lop3() -> tuple[list[tuple[str, int, tuple[str, str, str]]], list[str]]:
    """The cover the kernel runs: [(out, truth table, (a, b, c))] in
    evaluation order, out = LOP3(a, b, c) with table bit 4a + 2b + c, and
    the 8 output names, least significant first."""
    gates, outputs = sbox_gates()
    node = {out: (op, a, b) for out, op, a, b in gates}
    roots = set(_LOP3_ROOTS)
    rank = {f"x{i}": i for i in range(8)} | {out: 8 + i for i, (out, *_) in enumerate(gates)}

    def leaves(name: str, top: bool = False) -> set[str]:
        if name not in node or (name in roots and not top):
            return {name}
        _op, a, b = node[name]
        return leaves(a) | leaves(b)

    def value(name: str, env: dict[str, int]) -> int:
        if name not in env:
            op, a, b = node[name]
            env[name] = _apply(op, value(a, env), value(b, env), 0xFF)
        return env[name]

    luts = []
    for out, *_ in gates:
        if out in roots:
            ins = sorted(leaves(out, top=True), key=rank.__getitem__)
            if len(ins) > 3:
                raise AssertionError(f"the cone of {out} has {len(ins)} inputs")
            ins = (ins * 3)[:3]  # a function of fewer inputs ignores the repeats
            table = value(out, dict(zip(ins, (0xF0, 0xCC, 0xAA))))
            luts.append((out, table, tuple(ins)))
    return luts, outputs


def render() -> str:
    luts, outputs = sbox_lop3()
    lines = [
        "// Generated by tieredstorage_tpu_torch/ops/aes_circuit_gen.py: Boyar and",
        "// Peralta's 115-gate AES S-box (32 AND, 79 XOR, 4 XNOR; SEA 2010) as",
        f"// {len(luts)} three-input LOP3s. Do not edit: rerun the generator.",
        "#pragma once",
        "#include <cstdint>",
        "",
        "// d = the function of (a, b, c) whose truth table is kTable, bit 4a + 2b + c.",
        "template <unsigned kTable>",
        "__device__ __forceinline__ uint32_t tst_lop3(uint32_t a, uint32_t b, uint32_t c) {",
        "  uint32_t d;",
        '  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(kTable));',
        "  return d;",
        "}",
        "",
        "// x0..x7: bit-planes of one byte position, LSB first; each word carries",
        "// 32 blocks. Replaced in place by the planes of S(x).",
        "__device__ __forceinline__ void tst_sbox(",
        "    uint32_t& x0, uint32_t& x1, uint32_t& x2, uint32_t& x3,",
        "    uint32_t& x4, uint32_t& x5, uint32_t& x6, uint32_t& x7) {",
    ]
    for out, table, (a, b, c) in luts:
        lines.append(f"  const uint32_t {out} = tst_lop3<0x{table:02x}>({a}, {b}, {c});")
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
