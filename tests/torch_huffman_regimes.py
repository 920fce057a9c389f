"""Decoder operands that drive every rule of the Huffman scan.

The decode kernel (csrc/huffman.cu) takes a register-buffer path only where
a lane's whole block provably reads the stream's true bits, and the scan's
exact step everywhere else. These cases put lanes on both sides of that
guard and into every corrupt-input rule: the clamp of the word index at
W - 2, a negative index that wraps once or reads the all-ones fill, int32
bit positions that wrap, tables not derived from any length set, and tables
of one symbol, of 15-bit codes and of fixed-length codes.

`regimes` maps base operands (numpy: words uint32[B, W], jump int32[B, J]
and the four tables) to {name: (words, jump, tables)}. It needs numpy and
the port only, so the CPU tests (against JAX) and the card tests (against
the plain version) share it.
"""

from __future__ import annotations

import numpy as np

from tieredstorage_tpu_torch.ops.huffman import JUMP_BLOCK, MAX_CODE_LEN
from tieredstorage_tpu_torch.transform import thuff

INT32_MAX = 2**31 - 1
#: Words one block can span, as the kernel's guard counts them.
BLOCK_WORDS = -(-JUMP_BLOCK * MAX_CODE_LEN // 32)

REGIMES = ("clamp at W-2", "negative jumps", "int32 wrap", "random tables",
           "one-symbol and 15-bit tables", "fixed-length codes", "guard edge")


def _tables_for(lengths: np.ndarray, batch: int) -> list[np.ndarray]:
    return [np.tile(np.asarray(t, np.int32), (batch, 1)) for t in thuff.decode_tables(lengths)]


def fib_lengths() -> np.ndarray:
    """Code lengths of Fibonacci frequencies: the limit binds at 15 bits."""
    freqs = np.zeros(256, np.int64)
    a, b = 1, 1
    for sym in range(24):
        freqs[sym] = a
        a, b = b, a + b
    lengths = thuff.limited_huffman_lengths(freqs)
    assert lengths.max() == MAX_CODE_LEN
    return lengths


def long_code_stream(rng, batch: int, n_words: int) -> np.ndarray:
    """uint32[batch, n_words]: each row a seeded sequence of the 15-bit codes
    of `fib_lengths`, so a lane that starts on a code boundary reads 15 bits
    a step and every word differs from its neighbours."""
    lengths = fib_lengths()
    codes_rev = np.asarray(thuff.encode_tables(lengths), np.int64)
    longest = np.flatnonzero(lengths == MAX_CODE_LEN)
    n_codes = -(-n_words * 32 // MAX_CODE_LEN)
    picks = codes_rev[rng.choice(longest, (batch, n_codes))]
    bits = (picks[:, :, None] >> np.arange(MAX_CODE_LEN)) & 1  # stream order, LSB first
    packed = np.packbits(bits.reshape(batch, -1).astype(np.uint8), axis=1, bitorder="little")
    return packed[:, : n_words * 4].copy().view("<u4").astype(np.uint32)


def _spread(jump: np.ndarray, values: list[int]) -> np.ndarray:
    flat = jump.astype(np.int64).reshape(-1).copy()
    flat[:] = [values[i % len(values)] for i in range(flat.size)]
    return flat.astype(np.int32).reshape(jump.shape)


def regimes(words: np.ndarray, jump: np.ndarray, tables, seed: int = 0) -> dict:
    words = np.ascontiguousarray(words, np.uint32)
    jump = np.ascontiguousarray(jump, np.int32)
    tables = [np.ascontiguousarray(t, np.int32) for t in tables]
    batch, w = words.shape
    assert w > BLOCK_WORDS + 8, "base rows too short for the guard-edge case"
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 1 << 32, words.shape, dtype=np.uint64).astype(np.uint32)
    one = np.zeros(256, np.int32)
    one[0x41] = 1
    one_symbol, fifteen = _tables_for(one, batch), _tables_for(fib_lengths(), batch)
    mixed = [np.where((np.arange(batch) % 2 == 0)[:, None], a, b) for a, b in zip(one_symbol, fifteen)]
    random_tables = [
        rng.integers(-40, 1 << 15, (batch, 16)).astype(np.int32),   # first: ranges that overlap
        rng.integers(-5, 2000, (batch, 16)).astype(np.int32),       # counts: some empty or negative
        rng.integers(-300, 600, (batch, 16)).astype(np.int32),      # base: indices clipped both ways
        rng.integers(0, 256, (batch, 256)).astype(np.int32),
    ]
    # Lanes on code boundaries around the guard's last fast start read 15
    # bits a step, so those past it reach the clamp at W - 2.
    last_fast = (w - 4 - BLOCK_WORDS) * 32 + 31
    on_code = last_fast - last_fast % MAX_CODE_LEN
    return {
        "clamp at W-2": (words[:, :600].copy(), jump, tables),
        "negative jumps": (words, _spread(jump, [
            -5, -31, -32 * w + 100, -32 * w - 200, -32 * (w + 50), -3000, -(2**31)]), tables),
        "int32 wrap": (words, _spread(jump, [
            INT32_MAX, INT32_MAX - 100, INT32_MAX - 30_000, INT32_MAX - JUMP_BLOCK * MAX_CODE_LEN,
            INT32_MAX - JUMP_BLOCK * MAX_CODE_LEN + 1]), tables),
        "random tables": (words, jump, random_tables),
        "one-symbol and 15-bit tables": (noise, jump, mixed),
        "fixed-length codes": (noise, jump, _tables_for(np.full(256, 8, np.int32), batch)),
        "guard edge": (long_code_stream(rng, batch, w), _spread(
            jump, [on_code + MAX_CODE_LEN * k for k in (0, 1, 2, 3, 5, 7, 9, -1)]), fifteen),
    }
