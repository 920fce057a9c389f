"""Host-side GF(2^128) math for GHASH, in GCM's reflected-bit convention.

GHASH multiplication by a FIXED field element C is linear over GF(2), so it
is exactly a 128x128 bit-matrix apply. The device-side GHASH reduction
(ops/gcm.py) is a grouped-power contraction — each level multiplies up to
128 slots by precomputed powers of H in one MXU matmul; this module builds
the stacked per-level operands (ghash_agg_matrices, per segment key) so the
entire reduction becomes int8 matmuls (mod 2) — no carryless-multiply
instruction needed, which TPUs don't have.

Conventions: a field element is a 128-bit Python int whose bit i (from the
MSB end) is the coefficient of x^i — i.e. int.from_bytes(block, "big") with
GCM's bit-reflected polynomial P(x) = x^128 + x^7 + x^2 + x + 1, where the
block's first byte's MSB is the x^0 coefficient. In this int encoding the
x^0 coefficient sits at bit 127 and multiplication by x is a right shift
with conditional reduction by R = 0xE1 << 120.
"""

from __future__ import annotations

import numpy as np

_R = 0xE1000000000000000000000000000000  # reduction constant (reflected P)


def gcm_mult(x: int, y: int) -> int:
    """GF(2^128) product in GCM convention (both operands as 128-bit ints)."""
    z = 0
    v = x
    for i in range(127, -1, -1):
        if (y >> i) & 1:
            z ^= v
        if v & 1:
            v = (v >> 1) ^ _R
        else:
            v >>= 1
    return z


def mult_by_x(v: int) -> int:
    """Multiply by x (one reflected shift step)."""
    if v & 1:
        return (v >> 1) ^ _R
    return v >> 1


def gcm_pow(h: int, exponent: int) -> int:
    """H^exponent by square-and-multiply."""
    result = 1 << 127  # the field's multiplicative identity in this encoding
    base = h
    e = exponent
    while e:
        if e & 1:
            result = gcm_mult(result, base)
        base = gcm_mult(base, base)
        e >>= 1
    return result


def _int_to_bits(v: int) -> np.ndarray:
    """128-bit int -> uint8[128] bit vector, index 0 = MSB (byte-order bits)."""
    return np.frombuffer(v.to_bytes(16, "big"), dtype=np.uint8)[:, None] >> np.arange(
        7, -1, -1, dtype=np.uint8
    ).reshape(1, 8) & 1


def int_to_bitvec(v: int) -> np.ndarray:
    return _int_to_bits(v).reshape(128).astype(np.uint8)


def bitvec_to_int(bits: np.ndarray) -> int:
    packed = np.packbits(bits.astype(np.uint8).reshape(16, 8), axis=1, bitorder="big")
    return int.from_bytes(packed.tobytes(), "big")


def mult_matrix(c: int) -> np.ndarray:
    """uint8[128,128] matrix M with bits(a*c) = M @ bits(a) mod 2.

    Column i is c * x^i, built incrementally with 128 shift-reduce steps
    (c * x^(i+1) = (c * x^i) * x), so matrix construction is O(128) field
    steps, not O(128) full multiplications. The 128 columns are unpacked
    to bits in one call: a context build makes a few hundred of these
    matrices, on the window dispatch path of every new segment key.
    """
    cols = []
    col = c
    for _ in range(128):
        cols.append(col.to_bytes(16, "big"))
        col = mult_by_x(col)
    rows = np.frombuffer(b"".join(cols), dtype=np.uint8).reshape(128, 16)
    return np.ascontiguousarray(np.unpackbits(rows, axis=1).T)


def ghash_agg_plan(m: int, max_k: int = 128) -> list[tuple[int, int]]:
    """Level plan for grouped GHASH aggregation over m blocks.

    Returns [(k, padded_count), ...] per level: each level left-pads the
    current block count to a multiple of k (leading zero blocks don't change
    the polynomial) and contracts k slots at a time until one remains. With
    max_k=128 the contraction is a [B*G, k*128] x [k*128, 128] int8 matmul —
    one MXU-sized kernel per level instead of the former log2(m) sequential
    pairwise tree levels (PROFILE.md round-3 consequence 2)."""
    plan = []
    cur = max(1, m)
    while cur > 1:
        k = min(max_k, cur)
        padded = -(-cur // k) * k
        plan.append((k, padded))
        cur = padded // k
    if not plan:
        plan.append((1, 1))
    return plan


def ghash_agg_matrices(h: int, m: int, max_k: int = 128) -> tuple[np.ndarray, ...]:
    """Per-level grouped-GHASH operands; composed they give
    T(C) = sum_i C_i * H^(m-1-i) — exactly what the former pairwise tree
    computed, so the surrounding final-mat/const folding is unchanged.

    Level 1 is int8[8, k_1*16, 128], contracted against the 8 BYTE-bit planes
    of the raw chunk bytes (plane kbit = (bytes >> kbit) & 1): entry
    [kbit, s*16+p, o] is the o-th output bit's coefficient for block-slot s,
    byte p, byte-bit kbit (GCM bit index p*8 + 7 - kbit). This keeps every
    device intermediate's minor dimension large — a [B, m, 128]-bit layout
    would tile-pad its [.., 16, 8] expansion 16x in HBM (the round-3 OOM).

    Levels >= 2 are int8[k_L*128, 128]: out = bits[g, :] @ W_L (mod 2), slot
    j carrying P_L^(k_L-1-j), P_1 = H, P_{L+1} = P_L^(k_L)."""
    mats = []
    p = h
    for lvl, (k, _padded) in enumerate(ghash_agg_plan(m, max_k)):
        acc = 1 << 127  # multiplicative identity
        powers = [None] * k
        for j in range(k - 1, -1, -1):
            powers[j] = acc
            acc = gcm_mult(acc, p)
        w = np.concatenate(
            [mult_matrix(x).T.astype(np.int8) for x in powers], axis=0
        )
        if lvl == 0:
            w4 = w.reshape(k, 16, 8, 128)  # [slot, byte, bitpos, out]
            w = np.stack(
                [w4[:, :, 7 - kbit, :].reshape(k * 16, 128) for kbit in range(8)]
            )
        mats.append(np.ascontiguousarray(w))
        p = gcm_pow(p, k)
    return tuple(mats)


def ghash_step_matrix(h: int, k: int) -> np.ndarray:
    """int8[128,128] transposed multiply-by-H^k matrix: ``bits @ M`` (mod 2)
    multiplies a row of node bits by H^k — the between-group fold of the
    fused Pallas GHASH tree kernel (ops/ghash_pallas.ghash_tree_pallas).
    Folding sequentially over G groups of k blocks,
    ``T = (T * H^k) ^ node_g``, yields exactly
    ``sum_g node_g * H^(k*(G-1-g))`` — the same T(C) the grouped-power
    ladder computes level by level, with no per-level HBM materialization.
    Same transposed row-vector convention as the ladder operands and
    ``mult_matrix(...).T`` final fold in ops/gcm.py."""
    return np.ascontiguousarray(mult_matrix(gcm_pow(h, k)).T.astype(np.int8))


def ghash_reference(h: int, blocks: list[bytes]) -> int:
    """Straightforward serial GHASH for testing: Y_i = (Y_{i-1} ^ X_i) * H."""
    y = 0
    for b in blocks:
        y = gcm_mult(y ^ int.from_bytes(b.ljust(16, b"\x00"), "big"), h)
    return y
