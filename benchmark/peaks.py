"""The card's peaks and the least time AES-256-GCM needs for a payload.

Frozen copies of the repository's smoke constants (chip_smoke.py, the H100
peaks and AES gate count above `time_cuda`), so that a later change to the
program cannot move the yardstick.
"""

from __future__ import annotations

#: H100 SXM HBM3 bytes/s (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
#: int8 tensor-core ops/s (NVIDIA data sheet, dense).
INT8_TC_OPS_PER_S = 1.979e15
#: LOP3 instructions/s on the CUDA cores: 64 results of 32-bit bitwise
#: AND/OR/XOR per SM per clock (CUDA C++ Programming Guide, arithmetic
#: instruction throughput, compute capability 9.0), 132 SMs at the 1.98 GHz
#: boost clock.
LOP3_PER_S = 64 * 132 * 1.98e9
#: Two-input gates one LOP3 can stand for: any function of three inputs
#: takes at most 4 two-input gates.
GATES_PER_LOP3 = 4
#: Two-input gates/s on 32-bit words (32 bit-gates each).
LOGIC_GATES_PER_S = GATES_PER_LOP3 * LOP3_PER_S
#: Two-input gates per AES-256-CTR block at the smallest published circuits
#: (the S-box at 113 gates, Boyar and Peralta; MixColumns at 92 XORs a
#: column, Maximov, IACR ePrint 2019/833; one XOR a key bit), leaving out
#: the work that an aligned group of 32 counters shares: 4 + 12 x 16
#: S-boxes, 11 x 4 MixColumns columns and 13 x 128 key XORs. A lower bound.
AES_GATES_PER_BLOCK = (4 + 12 * 16) * 113 + 11 * 4 * 92 + 13 * 128
#: b1 tensor-core AND+popc bit-products/s. NVIDIA publishes no H100 figure:
#: this is `mma.sync m16n8k256 .b1 .and.popc` as measured on an H100 80GB
#: HBM3 at 700 W by the repository's tools/torch_mma_rate_probe.py.
B1_TC_BIT_PRODUCTS_PER_S = 4.082e15

BLOCK = 16


def gcm_least_seconds(payload_bytes: int, chunks: int, aad_bytes: int = 32) -> dict:
    """The least time one H100 could take for AES-256-GCM over `chunks`
    chunks holding `payload_bytes` in all (the bytes encrypted or decrypted,
    not the padded rows a program may stage): the larger of the bytes moved
    once (payload in, payload out, each chunk's IV and tag) at the HBM rate
    and the slowest of the operation counts, each at its unit's peak.
    AES-CTR's gates run on the logic units; GHASH's 128 x 128 bit-products
    per block run at the fastest of the b1 tensor core, the int8 tensor core
    (two ops a product) and the logic units (two gates per 32 products). The
    two could overlap, so the bound takes the larger, not the sum. Blocks
    are counted from the total, which is never more than the chunks' own
    rounded counts, so the result stays a lower bound."""
    data_blocks = -(-int(payload_bytes) // BLOCK)
    aes_blocks = data_blocks + chunks                  # the keystream and each tag's mask
    ghash_blocks = data_blocks + chunks * (-(-aad_bytes // BLOCK) + 1)
    moved = 2 * int(payload_bytes) + chunks * (12 + 16)
    aes_s = aes_blocks * AES_GATES_PER_BLOCK / 32 / LOGIC_GATES_PER_S
    products = ghash_blocks * 128 * 128
    ghash_s = min(products / B1_TC_BIT_PRODUCTS_PER_S, 2 * products / INT8_TC_OPS_PER_S,
                  products / 16 / LOGIC_GATES_PER_S)
    bytes_s = moved / HBM_BYTES_PER_S
    least = max(aes_s, ghash_s, bytes_s)
    by = "bytes" if least == bytes_s else ("aes" if least == aes_s else "ghash")
    return {"seconds": least, "by": by, "aes_s": aes_s, "ghash_s": ghash_s, "bytes_s": bytes_s}
