"""AES-256: S-box, key schedule, a numpy single-block cipher, and table
ciphers as torch ops.

Counterpart of tieredstorage_tpu/ops/aes.py. The S-box and round constants
are generated from the field definition (FIPS-197 math, not copied tables).
`encrypt_block` is the plain table cipher used once per key to derive the
GHASH key H = E_K(0^128) (ops/gcm.py). `aes_encrypt_blocks`,
`aes_decrypt_blocks` and `ctr_keystream` are the JAX module's table ciphers
as torch ops on any device (the inverse cipher is unused by CTR mode and
kept for tests); the window path's keystream is the bitsliced CUDA kernel of
ops/aes_bitsliced.py, which has no table lookups.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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


@functools.cache
def _inv_sbox() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint8)
    table[_sbox()] = np.arange(256, dtype=np.uint8)
    return table


SBOX = _sbox()
INV_SBOX = _inv_sbox()

_NR = 14  # rounds for AES-256

# ShiftRows permutation over the 16-byte state in FIPS column-major layout:
# byte index = 4*col + row; row r rotates left by r columns.
_SHIFT_ROWS = np.array(
    [4 * ((c + r) % 4) + r for c in range(4) for r in range(4)], dtype=np.int32
)
_INV_SHIFT_ROWS = np.argsort(_SHIFT_ROWS).astype(np.int32)


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


# --- table ciphers as torch ops ---


def _xtime_t(x: torch.Tensor) -> torch.Tensor:
    """GF(2^8) doubling on int32 tensors holding bytes."""
    return ((x << 1) & 0xFF) ^ ((x >> 7) * 0x1B)


def _mix_columns_t(s: torch.Tensor) -> torch.Tensor:
    """s: int32[..., 4, 4] ([col, row]); out_r = 2 s_r ^ 3 s_{r+1} ^ s_{r+2} ^ s_{r+3}."""
    rot1, rot2, rot3 = (torch.roll(s, -k, dims=-1) for k in (1, 2, 3))
    return _xtime_t(s) ^ (_xtime_t(rot1) ^ rot1) ^ rot2 ^ rot3


def _inv_mix_columns_t(s: torch.Tensor) -> torch.Tensor:
    x2 = _xtime_t(s)
    x4 = _xtime_t(x2)
    x8 = _xtime_t(x4)
    m9, m11 = x8 ^ s, x8 ^ x2 ^ s
    m13, m14 = x8 ^ x4 ^ s, x8 ^ x4 ^ x2
    return (m14 ^ torch.roll(m11, -1, dims=-1) ^ torch.roll(m13, -2, dims=-1)
            ^ torch.roll(m9, -3, dims=-1))


def _table_cipher(round_keys: torch.Tensor, blocks: torch.Tensor, *, inverse: bool) -> torch.Tensor:
    device = blocks.device
    rk = round_keys.to(device=device, dtype=torch.int32)
    box = torch.from_numpy((INV_SBOX if inverse else SBOX).astype(np.int64)).to(device)
    perm = torch.from_numpy((_INV_SHIFT_ROWS if inverse else _SHIFT_ROWS).astype(np.int64)).to(device)
    shape = blocks.shape
    state = blocks.to(torch.int32).reshape(-1, 16)

    def sub_shift(st):
        if inverse:
            return box[st[:, perm].long()].to(torch.int32)
        return box[st.long()].to(torch.int32)[:, perm]

    def mix(st, fn):
        return fn(st.reshape(-1, 4, 4)).reshape(-1, 16)

    if inverse:
        state = state ^ rk[_NR]
        for rnd in range(_NR - 1, 0, -1):
            state = mix(sub_shift(state) ^ rk[rnd], _inv_mix_columns_t)
        state = sub_shift(state) ^ rk[0]
    else:
        state = state ^ rk[0]
        for rnd in range(1, _NR):
            state = mix(sub_shift(state), _mix_columns_t) ^ rk[rnd]
        state = sub_shift(state) ^ rk[_NR]
    return state.to(torch.uint8).reshape(shape)


def aes_encrypt_blocks(round_keys: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """Encrypt uint8[..., 16] blocks on their device; round_keys uint8[15, 16]."""
    return _table_cipher(round_keys, blocks, inverse=False)


def aes_decrypt_blocks(round_keys: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """Inverse cipher (unused by CTR mode; provided for completeness/tests)."""
    return _table_cipher(round_keys, blocks, inverse=True)


def ctr_keystream(
    round_keys: torch.Tensor, iv: torch.Tensor, first_counter: int, n_blocks: int
) -> torch.Tensor:
    """Keystream blocks uint8[n_blocks, 16] for a 12-byte IV, on the IV's
    device. Counter block = IV || big-endian32(first_counter + i)."""
    device = iv.device
    counters = (first_counter + torch.arange(n_blocks, dtype=torch.int64, device=device)) & 0xFFFFFFFF
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64, device=device)
    ctr_bytes = ((counters[:, None] >> shifts) & 0xFF).to(torch.uint8)
    blocks = torch.cat([iv.to(torch.uint8).expand(n_blocks, 12), ctr_bytes], dim=1)
    return aes_encrypt_blocks(round_keys, blocks)
