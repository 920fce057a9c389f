#!/usr/bin/env python3
"""How the AES keystream kernel's S-box maps onto LOP3, and what a LOP3 is worth.

    python3 tools/torch_lop3_cover.py

Prints two facts the port relies on, neither needing a card:
- the least set of gates of Boyar and Peralta's 115-gate S-box circuit to
  keep so that every kept gate is one LOP3 of kept gates or inputs: an
  integer program (scipy's `milp`) over each gate's cuts of at most three
  inputs. Its answer is `_LOP3_ROOTS` in
  tieredstorage_tpu_torch/ops/aes_circuit_gen.py (74 gates), which the
  generator renders into csrc/aes_sbox_circuit.cuh;
- the most two-input gates any function of three inputs needs, by
  exhaustive search over circuits: 4. One LOP3 computes one such function,
  so it does at most 4 gates' work; chip_smoke.py's `GATES_PER_LOP3` rests
  on it.
Imports nothing of JAX.
"""

from __future__ import annotations

import functools
import itertools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tieredstorage_tpu_torch.ops import aes_circuit_gen  # noqa: E402


def derive_lop3_roots() -> list[str]:
    """The least set of gates to keep so that every kept gate is one LOP3 of
    kept gates or inputs: one cut of at most three inputs chosen per kept
    gate, every output kept, the gates of a chosen cut kept."""
    import numpy as np
    from scipy.optimize import Bounds, LinearConstraint, milp
    from scipy.sparse import lil_matrix

    gates, outputs = aes_circuit_gen.sbox_gates()
    cuts: dict[str, set[frozenset[str]]] = {f"x{i}": {frozenset([f"x{i}"])} for i in range(8)}
    for out, _op, a, b in gates:
        cuts[out] = {frozenset([out])} | {
            u for ca in cuts[a] for cb in cuts[b] if len(u := ca | cb) <= 3
        }
    names = [out for out, *_ in gates]
    keep = {name: i for i, name in enumerate(names)}
    choices = [(out, cut) for out in names for cut in sorted(cuts[out], key=sorted)
               if cut != {out}]
    n = len(names) + len(choices)
    chosen: dict[str, list[tuple[int, int]]] = {out: [(keep[out], 1)] for out in names}
    for j, (out, _cut) in enumerate(choices):
        chosen[out].append((len(names) + j, -1))
    rows = [(coefs, 0, 0) for coefs in chosen.values()]  # kept <=> one cut chosen
    rows += [([(keep[out], 1)], 1, 1) for out in outputs]
    for j, (_out, cut) in enumerate(choices):
        rows += [([(len(names) + j, 1), (keep[leaf], -1)], -np.inf, 0)
                 for leaf in cut if leaf in keep]
    a = lil_matrix((len(rows), n))
    for r, (coefs, _lo, _hi) in enumerate(rows):
        for col, v in coefs:
            a[r, col] = v
    cost = np.zeros(n)
    cost[: len(names)] = 1
    res = milp(cost, integrality=np.ones(n), bounds=Bounds(0, 1), constraints=LinearConstraint(
        a.tocsr(), [r[1] for r in rows], [r[2] for r in rows]))
    if not res.success:
        raise RuntimeError(f"the cover's integer program failed: {res.message}")
    return sorted(name for name in names if res.x[keep[name]] > 0.5)


def most_gates_for_three_inputs() -> int:
    """The largest least number of two-input gates (any of the 16 functions
    of two signals) that computes a function of three inputs: a breadth-first
    search over the sets of signals that k gates can compute, until all 256
    truth tables are reached."""
    ones = 0xFF
    base = frozenset((0, ones, 0xF0, 0xCC, 0xAA))  # the constants and the three inputs

    @functools.lru_cache(maxsize=None)
    def gate(a: int, b: int) -> frozenset[int]:
        minterms = (a & b, a & ~b & ones, ~a & b & ones, ~(a | b) & ones)
        return frozenset(sum(m for i, m in enumerate(minterms) if table >> i & 1)
                         for table in range(16))

    reached = set(base)
    level, k = {frozenset()}, 0
    while True:
        k += 1
        nxt = set()
        for signals in level:
            for a, b in itertools.combinations(base | signals, 2):
                for f in gate(a, b) - base - signals:
                    reached.add(f)
                    if len(reached) == 256:
                        return k
                    nxt.add(signals | {f})
        level = nxt


def main() -> int:
    roots = derive_lop3_roots()
    print(f"least LOP3 cover of the S-box: {len(roots)} gates "
          f"(the committed `_LOP3_ROOTS`: {len(aes_circuit_gen._LOP3_ROOTS)})")
    print(" ".join(roots))
    print(f"most two-input gates a three-input function needs: {most_gates_for_three_inputs()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
