"""AES-256 host half: S-box, key schedule, and a numpy single-block cipher.

Counterpart of the host half of tieredstorage_tpu/ops/aes.py. The S-box and
round constants are generated from the field definition (FIPS-197 math, not
copied tables). `encrypt_block` is the plain table cipher used once per key
to derive the GHASH key H = E_K(0^128) (ops/gcm.py); the device keystream is
the bitsliced circuit of ops/aes_bitsliced.py, which has no table lookups.
"""

from __future__ import annotations

import functools

import numpy as np


def _gf8_mult(a: int, b: int) -> int:
    p = 0
    while b:
        if b & 1:
            p ^= a
        a <<= 1
        if a & 0x100:
            a ^= 0x11B  # x^8 + x^4 + x^3 + x + 1
        b >>= 1
    return p


@functools.cache
def _sbox() -> np.ndarray:
    inv = [0] * 256
    for x in range(1, 256):
        # Multiplicative inverse by exponentiation: x^254.
        y = 1
        for _ in range(254):
            y = _gf8_mult(y, x)
        inv[x] = y
    table = np.zeros(256, dtype=np.uint8)
    for x in range(256):
        v = inv[x]
        b = 0
        for i in range(8):
            bit = (
                (v >> i) ^ (v >> ((i + 4) % 8)) ^ (v >> ((i + 5) % 8))
                ^ (v >> ((i + 6) % 8)) ^ (v >> ((i + 7) % 8)) ^ (0x63 >> i)
            ) & 1
            b |= bit << i
        table[x] = b
    return table


SBOX = _sbox()

_NR = 14  # rounds for AES-256

# ShiftRows permutation over the 16-byte state in FIPS column-major layout:
# byte index = 4*col + row; row r rotates left by r columns.
_SHIFT_ROWS = np.array(
    [4 * ((c + r) % 4) + r for c in range(4) for r in range(4)], dtype=np.int32
)


def key_expansion(key: bytes) -> np.ndarray:
    """AES-256 key schedule -> uint8[15, 16] round keys (FIPS-197 §5.2)."""
    if len(key) != 32:
        raise ValueError("AES-256 key must be 32 bytes")
    nk = 8
    words = [list(key[4 * i : 4 * i + 4]) for i in range(nk)]
    rcon = 1
    for i in range(nk, 4 * (_NR + 1)):
        temp = list(words[i - 1])
        if i % nk == 0:
            temp = temp[1:] + temp[:1]
            temp = [int(SBOX[t]) for t in temp]
            temp[0] ^= rcon
            rcon = _gf8_mult(rcon, 2)
        elif i % nk == 4:
            temp = [int(SBOX[t]) for t in temp]
        words.append([a ^ b for a, b in zip(words[i - nk], temp)])
    return np.array(words, dtype=np.uint8).reshape(_NR + 1, 16)


def _xtime(x: np.ndarray) -> np.ndarray:
    return (((x.astype(np.uint16) << 1) & 0xFF) ^ ((x >> 7) * 0x1B)).astype(np.uint8)


def _mix_columns(state: np.ndarray) -> np.ndarray:
    s = state.reshape(4, 4)  # [col, row]
    rot1, rot2, rot3 = (np.roll(s, -k, axis=1) for k in (1, 2, 3))
    # out_r = 2*s_r ^ 3*s_{r+1} ^ s_{r+2} ^ s_{r+3}
    return (_xtime(s) ^ _xtime(rot1) ^ rot1 ^ rot2 ^ rot3).reshape(16)


def encrypt_block(round_keys: np.ndarray, block: bytes) -> bytes:
    """One AES-256 block on the host: uint8[15, 16] round keys, 16 bytes in."""
    state = np.frombuffer(block, dtype=np.uint8) ^ round_keys[0]
    for rnd in range(1, _NR + 1):
        state = SBOX[state][_SHIFT_ROWS]
        if rnd != _NR:
            state = _mix_columns(state)
        state = state ^ round_keys[rnd]
    return state.tobytes()
