"""The PyTorch/CUDA port's GCM ops against the JAX package, bit for bit.

Inputs are made with numpy from a seed and handed to both packages; every
comparison is exact (tolerance 0). The JAX side runs on the CPU: the Pallas
kernels in interpret mode or through their plain references, as the JAX
package's own tests run them. The port's wrappers take their plain PyTorch
versions here because the tensors lie on the CPU; the CUDA kernels
themselves are checked on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tieredstorage_tpu.ops import aes_bitsliced as jax_bitsliced
from tieredstorage_tpu.ops import aes_pallas as jax_aes_pallas
from tieredstorage_tpu.ops import gcm as jax_gcm
from tieredstorage_tpu.ops import gf128 as jax_gf128
from tieredstorage_tpu.ops import ghash_pallas as jax_ghash
from tieredstorage_tpu.ops.aes import key_expansion as jax_key_expansion
from tieredstorage_tpu_torch.ops import _cuda, aes_circuit_gen, gf128
from tieredstorage_tpu_torch.ops import aes_bitsliced, gcm, ghash_cuda
from tieredstorage_tpu_torch.ops.aes import SBOX, _SHIFT_ROWS, encrypt_block, key_expansion

VECTORS = json.loads(
    (Path(__file__).parent / "vectors" / "gcm_aes256_vectors.json").read_text()
)["vectors"]


def _rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------------- AES


def test_key_schedule_and_single_block_match_jax():
    key = _rng(1).bytes(32)
    rk = key_expansion(key)
    assert np.array_equal(rk, jax_key_expansion(key))
    # FIPS-197 C.3 (AES-256).
    fips_key = bytes(range(32))
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    assert encrypt_block(key_expansion(fips_key), pt).hex() == "8ea2b7ca516745bfeafc49904b496089"


def test_circuit_matches_jax_planes():
    rng = _rng(2)
    key = rng.bytes(32)
    state = rng.integers(0, 2**32, (16, 8, 7), dtype=np.uint32)
    want = np.asarray(jax_bitsliced.aes_encrypt_planes(
        jnp.asarray(jax_bitsliced.make_rk_planes(key)), jnp.asarray(state)
    ))
    rk = aes_bitsliced.rk_planes_from_round_keys(_t(key_expansion(key)))
    got = aes_bitsliced.aes_encrypt_planes(rk, _t(state.view(np.int32))).numpy()
    assert np.array_equal(got.view(np.uint32), want)


def test_circuit_matches_pallas_kernel_body():
    """One whole Pallas grid step (the kernel body with plain-array refs)."""
    rng = _rng(3)
    key = rng.bytes(32)
    w = jax_aes_pallas.WORDS_PER_STEP
    state = rng.integers(0, 2**32, (16, 8, w), dtype=np.uint32)
    rk_jax = jax_bitsliced.rk_planes_from_round_keys(jnp.asarray(jax_key_expansion(key)))
    want = np.asarray(jax_aes_pallas.kernel_body_reference(rk_jax, jnp.asarray(state)))
    want = want.view(np.uint32)  # the reference's masks may come back as int32
    rk = aes_bitsliced.rk_planes_from_round_keys(_t(key_expansion(key)))
    got = aes_bitsliced.aes_encrypt_planes(rk, _t(state.view(np.int32))).numpy()
    assert np.array_equal(got.view(np.uint32), want)


@functools.lru_cache(maxsize=1)
def _jax_keystream():
    """The JAX keystream once at the largest (B, n_blocks) of the grid below:
    the keystream of (iv, counter) does not depend on the batch around it,
    so each smaller case is a slice of this one JAX evaluation."""
    rng = _rng(11)
    rk = key_expansion(rng.bytes(32))
    ivs = rng.integers(0, 256, (3, 12), dtype=np.uint8)
    first = int(rng.integers(0, 2**20))
    ks = np.asarray(jax_bitsliced.ctr_keystream_batch(
        jnp.asarray(rk), jnp.asarray(ivs), first, 257
    ))
    return rk, ivs, first, ks


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("n_blocks", [1, 33, 257])
def test_ctr_keystream_matches_jax(batch, n_blocks):
    rk, ivs, first, want = _jax_keystream()
    got = aes_bitsliced.ctr_keystream_batch(_t(rk), _t(ivs[:batch]), first, n_blocks).numpy()
    assert got.shape == (batch, n_blocks, 16)
    assert np.array_equal(got, want[:batch, :n_blocks])


def test_ctr_keystream_counter_wraps_mod_2_32():
    rng = _rng(4)
    rk = key_expansion(rng.bytes(32))
    ivs = rng.integers(0, 256, (2, 12), dtype=np.uint8)
    got = aes_bitsliced.ctr_keystream_batch(_t(rk), _t(ivs), 2**32 - 3, 6).numpy()
    for r in range(2):
        for i in range(6):
            ctr = ((2**32 - 3 + i) % 2**32).to_bytes(4, "big")
            assert got[r, i].tobytes() == encrypt_block(rk, ivs[r].tobytes() + ctr)


def _byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """CUDA `__byte_perm(x, y, sel)` for selectors whose nibbles are below 8:
    byte n of the result is byte (sel >> 4n) & 7 of the pair y:x."""
    out = np.zeros(np.broadcast_shapes(np.shape(x), np.shape(y)), np.uint32)
    for n in range(4):
        s = (sel >> (4 * n)) & 7
        src = x if s < 4 else y
        out |= ((src >> np.uint32(8 * (s & 3))) & np.uint32(0xFF)) << np.uint32(8 * n)
    return out


def _transpose32(a: np.ndarray) -> np.ndarray:
    """csrc/aes_ctr.cu `transpose32` over the last axis (32 words): two
    byte-permute stages, then three mask-and-shift swap stages."""
    a = a.astype(np.uint32)
    for s, lo_sel, hi_sel in ((16, 0x5410, 0x7632), (8, 0x6240, 0x7351)):
        i = np.array([i for i in range(32) if not i & s])
        lo, hi = a[..., i], a[..., i + s]
        a[..., i], a[..., i + s] = _byte_perm(lo, hi, lo_sel), _byte_perm(lo, hi, hi_sel)
    for s, mask in ((4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555)):
        i = np.array([i for i in range(32) if not i & s])
        t = ((a[..., i] >> np.uint32(s)) ^ a[..., i + s]) & np.uint32(mask)
        a[..., i + s] ^= t
        a[..., i] ^= t << np.uint32(s)
    return a


def _eval_sbox_gates(x: list, ones) -> list:
    """The published S-box gate list over 8 planes (LSB first); `ones` is
    the all-ones value of the planes' type (for XNOR)."""
    gates, outputs = aes_circuit_gen.sbox_gates()
    env = {f"x{i}": x[i] for i in range(8)}
    for out, op, a, b in gates:
        if op == "^":
            env[out] = env[a] ^ env[b]
        elif op == "&":
            env[out] = env[a] & env[b]
        else:
            assert op == "~^", op
            env[out] = env[a] ^ env[b] ^ ones
    return [env[n] for n in outputs]


def _eval_sbox_lop3(x: list, ones) -> list:
    """The kernel's S-box, its LOP3 cover, over 8 planes (LSB first): each
    LOP3 is the OR of the minterms its truth table selects (bit 4a + 2b + c)."""
    luts, outputs = aes_circuit_gen.sbox_lop3()
    env = {f"x{i}": x[i] for i in range(8)}
    for out, table, names in luts:
        a, b, c = (env[n] for n in names)
        acc = a & ~a
        for m in range(8):
            if (table >> m) & 1:
                acc = acc | ((a if m & 4 else a ^ ones) & (b if m & 2 else b ^ ones)
                             & (c if m & 1 else c ^ ones))
        env[out] = acc
    return [env[n] for n in outputs]


def _emulate_aes_ctr_kernel(rk: np.ndarray, iv: np.ndarray, first: int, n_blocks: int):
    """csrc/aes_ctr.cu for one row, all warps and lanes at once in numpy:
    lane (q, c) of a warp holds column c of blocks base + 8j + q (word bit
    j) as 32 planes built by `transpose32` from the IV and counter words;
    14 rounds of the generated S-box, ShiftRows as the quad shuffles,
    MixColumns + AddRoundKey with the kernel's formula and round-key masks;
    `transpose32` back and the kernel's masked stores."""
    warps = -(-n_blocks // 256)
    lane = np.arange(32)
    q, c = lane >> 2, lane & 3
    bits = (rk.reshape(15, 4, 4, 1).astype(np.uint32) >> np.arange(8, dtype=np.uint32)) & 1
    key = (np.uint32(0) - bits).reshape(15, 4, 32)[:, c]  # [round, lane, plane]
    base = 256 * np.arange(warps, dtype=np.int64)[:, None, None]
    ctr = ((first + base + q[:, None] + 8 * np.arange(32)) & 0xFFFFFFFF).astype(np.uint32)
    iv_words = iv.astype(np.uint8).view("<u4")[np.minimum(c, 2)][:, None]
    words = np.where((c == 3)[:, None], _byte_perm(ctr, np.uint32(0), 0x0123), iv_words)
    s = _transpose32(words) ^ key[0]  # [warp, lane, plane 8r + b]
    ones = np.uint32(0xFFFFFFFF)
    for rnd in range(1, 15):
        for r in range(4):
            planes = _eval_sbox_lop3([s[..., 8 * r + b] for b in range(8)], ones)
            s[..., 8 * r : 8 * r + 8] = np.stack(planes, axis=-1)
        for r in range(1, 4):
            src = (lane & ~3) | ((lane + r) & 3)
            s[..., 8 * r : 8 * r + 8] = s[:, src, 8 * r : 8 * r + 8]
        if rnd != 14:  # MixColumns + AddRoundKey as the kernel groups its XORs
            a = s.reshape(warps, 32, 4, 8).copy()
            all4 = a[:, :, 0] ^ a[:, :, 1] ^ a[:, :, 2] ^ a[:, :, 3]
            for r in range(4):
                ar, an, k = a[:, :, r], a[:, :, (r + 1) & 3], key[rnd][:, 8 * r : 8 * r + 8]
                for b in range(8):
                    t = all4[..., b] ^ ar[..., b] ^ k[:, b]
                    if b == 0:
                        t = t ^ ar[..., 7] ^ an[..., 7]
                    else:
                        t = t ^ ar[..., b - 1] ^ an[..., b - 1]
                        if b in (1, 3, 4):
                            t = t ^ ar[..., 7] ^ an[..., 7]
                    s[..., 8 * r + b] = t
        else:
            s ^= key[rnd]
    words = _transpose32(s)  # [warp, lane, j]: column c of block base + 8j + q
    out = np.zeros((warps * 256, 4), np.uint32)
    block = (base + q[:, None] + 8 * np.arange(32)).reshape(-1)
    out[block, np.broadcast_to(c[:, None], (warps, 32, 32)).reshape(-1)] = words.reshape(-1)
    return out[:n_blocks].view(np.uint8).reshape(n_blocks, 16)


def test_transpose32_is_the_bit_matrix_transpose():
    a = _rng(6).integers(0, 2**32, (3, 32), dtype=np.uint64).astype(np.uint32)
    bits = (a[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1  # [.., i, k]
    want = np.bitwise_or.reduce(bits.swapaxes(-1, -2) << np.arange(32, dtype=np.uint32), axis=-1)
    assert np.array_equal(_transpose32(a), want)
    assert np.array_equal(_transpose32(_transpose32(a)), a)


def test_aes_kernel_logic_emulated():
    """The counter wraps mod 2^32 inside the words (blocks 40-44 of 45)."""
    rng = _rng(5)
    rk = key_expansion(rng.bytes(32))
    ivs = rng.integers(0, 256, (1, 12), dtype=np.uint8)
    first = 2**32 - 40
    got = _emulate_aes_ctr_kernel(rk, ivs[0], first, 45)
    want = aes_bitsliced.ctr_keystream_batch(_t(rk), _t(ivs), first, 45).numpy()[0]
    assert np.array_equal(got, want)
    jax_ks = np.asarray(jax_bitsliced.ctr_keystream_batch(
        jnp.asarray(rk), jnp.asarray(ivs), np.uint32(first), 45))[0]
    assert np.array_equal(got, jax_ks)


@pytest.mark.parametrize("n_blocks", [1, 31, 33, 45, 257])
def test_aes_kernel_schedule_matches_plain_and_jax(n_blocks):
    """The kernel's schedule (emulated) at block counts that leave a warp's
    256 blocks, a quad's 32 and the 8 quads partly empty, and past one
    warp, against the plain version and the JAX keystream, per row."""
    rk, ivs, first, want = _jax_keystream()
    plain = aes_bitsliced.ctr_keystream_batch_plain(_t(rk), _t(ivs), first, n_blocks).numpy()
    for row in range(ivs.shape[0]):
        got = _emulate_aes_ctr_kernel(rk, ivs[row], first, n_blocks)
        assert np.array_equal(got, plain[row])
        assert np.array_equal(got, want[row, :n_blocks])


@pytest.mark.parametrize("form", ["gates", "lop3"])
def test_generated_sbox_circuit_is_the_sbox(form):
    """The published 115-gate circuit and the kernel's 74-LOP3 cover of it,
    on all 256 inputs, against the FIPS-197 table."""
    gates, _ = aes_circuit_gen.sbox_gates()
    assert len(gates) == 115 and sum(op == "&" for _, op, _, _ in gates) == 32
    assert len(aes_circuit_gen.sbox_lop3()[0]) == 74
    evaluate = _eval_sbox_gates if form == "gates" else _eval_sbox_lop3
    for x in range(256):
        out = evaluate([(x >> i) & 1 for i in range(8)], 1)
        assert sum(bit << i for i, bit in enumerate(out)) == SBOX[x]


@pytest.mark.parametrize("form", ["gates", "lop3"])
def test_sbox_circuit_matches_jax_tower_circuit(form):
    """All 256 inputs at once, as planes: the circuit and its cover against
    the JAX package's tower-field `_sbox_planes`."""
    x = np.arange(256, dtype=np.uint32)
    planes = [np.uint32(0) - ((x >> i) & 1) for i in range(8)]  # full-word masks
    evaluate = _eval_sbox_gates if form == "gates" else _eval_sbox_lop3
    got = evaluate(planes, np.uint32(0xFFFFFFFF))
    want = jax_bitsliced._sbox_planes(jax_bitsliced._tower(), [jnp.asarray(p) for p in planes])
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w).astype(np.uint32))


def test_aes_bound_gates_per_lop3_is_the_most_a_three_input_function_needs():
    """chip_smoke.py converts the AES bound's gate count into LOP3s at the
    most two-input gates any three-input function needs: majority needs 4,
    and the exhaustive search finds none that needs more."""
    import chip_smoke
    from tools.torch_lop3_cover import most_gates_for_three_inputs

    assert most_gates_for_three_inputs() == chip_smoke.GATES_PER_LOP3 == 4
    assert chip_smoke.AES_GATES_PER_BLOCK == 196 * 113 + 44 * 92 + 13 * 128


def test_generated_header_is_up_to_date():
    assert aes_circuit_gen.HEADER.read_text() == aes_circuit_gen.render()


def test_shift_rows_index_matches_kernel_formula():
    assert [4 * (((p >> 2) + (p & 3)) & 3) + (p & 3) for p in range(16)] == list(_SHIFT_ROWS)


# --------------------------------------------------------------- GHASH

K, G, B = 256, 3, 5


def _ghash_operands(seed: int):
    rng = _rng(seed)
    data = rng.integers(0, 256, (B, G * K), dtype=np.uint8)
    w1 = rng.integers(0, 2, (8, K, 128), dtype=np.int8)
    step = rng.integers(0, 2, (128, 128), dtype=np.int8)
    return data, w1, step


def test_ghash_tree_matches_pallas_interpret():
    data, w1, step = _ghash_operands(20)
    want = np.asarray(jax_ghash.ghash_tree_pallas(
        jnp.asarray(data), jnp.asarray(w1), jnp.asarray(step), interpret=True
    ))
    ops = ghash_cuda.GhashOperands.build(_t(w1), _t(step))
    got = ghash_cuda.ghash_tree(_t(data), ops).numpy()
    assert np.array_equal(got, want.astype(np.uint8))


def test_ghash_level1_matches_pallas_interpret():
    data, w1, _ = _ghash_operands(21)
    rows = data.reshape(B * G, K)
    want = np.asarray(jax_ghash.ghash_level1_pallas(
        jnp.asarray(rows), jnp.asarray(w1), interpret=True
    ))
    ops = ghash_cuda.GhashOperands.build(_t(w1), None)
    got = ghash_cuda.ghash_level1(_t(rows), ops).numpy()
    assert np.array_equal(got, want.astype(np.uint8))


#: Groups per block of the tree kernel: csrc/ghash.cu kSlice, the m16 of its
#: b1 mma (the card tests read it from the built kernel).
SLICE = 16


def _parity(x: np.ndarray) -> np.ndarray:
    """Parity of each uint32 (popc & 1)."""
    x = x.astype(np.uint32)
    for shift in (16, 8, 4, 2, 1):
        x = x ^ (x >> np.uint32(shift))
    return x & np.uint32(1)


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """uint32 bits [..., 128] -> words [..., 4] (bit l of word w = bit 32w + l),
    as the kernel's ballots pack them."""
    lanes = bits.reshape(*bits.shape[:-1], 4, 32).astype(np.uint32)
    return np.bitwise_or.reduce(lanes << np.arange(32, dtype=np.uint32), axis=-1)


def _unpack_words(words: np.ndarray) -> np.ndarray:
    bits = (words[..., :, None] >> np.arange(32, dtype=np.uint32)) & np.uint32(1)
    return bits.reshape(*words.shape[:-1], 128).astype(np.uint8)


def _emulate_slice_nodes(group_words: np.ndarray, w1_words: np.ndarray) -> np.ndarray:
    """csrc/ghash.cu `slice_nodes` over packed operands: group_words
    uint32[N, K/16, 4] -> node words uint32[N, 4]. The b1 tensor-core
    product sums popc(data & w1) per (group, output); warp k of each output
    half takes k-step k (quads 2k, 2k + 1) of every 8-quad w1 tile, and the
    low bits of the four warps' sums meet by XOR. (The low bit of a popcount
    sum is the parity of the XOR of the words counted.)"""
    n, n_quads, _ = group_words.shape
    out = np.zeros((n, 128), np.uint32)
    step_of_quad = (np.arange(n_quads) % 8) // 2
    for lo in range(0, n, 64):  # bound the [groups, quads, 128, 4] product
        words = group_words[lo : lo + 64]
        per_quad = np.bitwise_xor.reduce(words[:, :, None, :] & w1_words[None], axis=3)
        for k in range(4):
            if (step_of_quad == k).any():
                warp_sum = np.bitwise_xor.reduce(per_quad[:, step_of_quad == k], axis=1)
                out[lo : lo + 64] ^= _parity(warp_sum)
    return _pack_bits(out)


def _emulate_fold(t_words: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """T · M for packed T words [..., 4] and packed columns cols [128, 4]
    (`fold`: lane l, column l + 32r, ballot per r)."""
    x = np.bitwise_xor.reduce(t_words[..., None, :] & cols, axis=-1)  # [..., 128]
    return _pack_bits(_parity(x))


def _fold_in_order(items: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """items uint32[..., n, 4] -> T = (T · M) ^ item over the n items in
    order, from T = 0 (the kernel's serial fold)."""
    t = np.zeros(items.shape[:-2] + (4,), np.uint32)
    for i in range(items.shape[-2]):
        t = _emulate_fold(t, cols) ^ items[..., i, :]
    return t


def _front_pad(items: np.ndarray, width: int) -> np.ndarray:
    """Zero items in front of axis 1 up to a multiple of `width`, split into
    [rows, n / width, width, ...] (the kernel counts its tiles from the end)."""
    n = items.shape[1]
    lead = -(-n // width) * width - n
    padded = np.concatenate([np.zeros((items.shape[0], lead) + items.shape[2:], items.dtype), items], 1)
    return padded.reshape(items.shape[0], -1, width, *items.shape[2:])


def _emulate_ghash_kernels(data: np.ndarray, w1: np.ndarray, step: np.ndarray):
    """csrc/ghash.cu in numpy over the packed operands the wrapper builds on
    the card (pack_w1, pack_step, and M^SLICE from step_power): the row's
    groups cut into slices of SLICE counted from the end (the first slice's
    missing groups are zeros), each slice's nodes folded in order with the
    step matrix M, then the row's slice partials folded in order with
    M^SLICE. Returns (tree bits uint8[B, 128], level-1 bits
    uint8[B, G, 128])."""
    w1_words = ghash_cuda.pack_w1(_t(w1)).numpy().view(np.uint32)  # [K/16, 128, 4]
    step_words = ghash_cuda.pack_step(_t(step)).numpy().view(np.uint32)  # [128, 4]
    slice_step = ghash_cuda.step_power(_t(step), SLICE)
    slice_step_words = ghash_cuda.pack_step(slice_step).numpy().view(np.uint32)
    k = w1.shape[1]
    rows, total = data.shape
    groups = total // k
    slices = _front_pad(data.reshape(rows, groups, k), SLICE)  # [B, n_slices, SLICE, K]
    words = np.ascontiguousarray(slices).view("<u4").reshape(-1, k // 16, 4)
    nodes = _emulate_slice_nodes(words, w1_words).reshape(rows, -1, SLICE, 4)
    partials = _fold_in_order(nodes, step_words)
    t = _fold_in_order(partials, slice_step_words)
    level1 = _unpack_words(nodes.reshape(rows, -1, 4)[:, -groups:])
    return _unpack_words(t), level1


def test_ghash_kernel_logic_emulated():
    data, w1, step = _ghash_operands(22)
    tree, nodes = _emulate_ghash_kernels(data, w1, step)
    assert np.array_equal(tree, ghash_cuda.ghash_tree_plain(_t(data), _t(w1), _t(step)).numpy())
    assert np.array_equal(
        nodes.reshape(B * G, 128),
        ghash_cuda.ghash_level1_plain(_t(data.reshape(B * G, K)), _t(w1)).numpy(),
    )


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize(
    "groups", [2, SLICE - 1, SLICE, SLICE + 1, 3 * SLICE + 5, 32 * SLICE + 3]
)
def test_ghash_tree_schedule_matches_plain_and_pallas(groups, rows):
    """The kernel's schedule (emulated) against the plain version and the
    Pallas kernel in interpret mode, bit for bit, around the slice width and
    past the 32 partials one warp of the combine holds at a time."""
    k = 128
    rng = _rng(100 * groups + rows)
    data = rng.integers(0, 256, (rows, groups * k), dtype=np.uint8)
    w1 = rng.integers(0, 2, (8, k, 128), dtype=np.int8)
    step = rng.integers(0, 2, (128, 128), dtype=np.int8)
    tree, _ = _emulate_ghash_kernels(data, w1, step)
    plain = ghash_cuda.ghash_tree_plain(_t(data), _t(w1), _t(step)).numpy()
    pallas = np.asarray(jax_ghash.ghash_tree_pallas(
        jnp.asarray(data), jnp.asarray(w1), jnp.asarray(step), interpret=True
    )).astype(np.uint8)
    assert np.array_equal(tree, plain)
    assert np.array_equal(tree, pallas)


@pytest.mark.parametrize("k", [48, 128, 2048])
def test_ghash_level1_node_routine_emulated(k):
    """The shared node routine at widths that leave the last w1 tile short
    (48 B: 3 of 8 quads) and at whole tiles, over a row count that leaves
    the last block short."""
    rng = _rng(k)
    rows = SLICE + 3
    data = rng.integers(0, 256, (rows, k), dtype=np.uint8)
    w1 = rng.integers(0, 2, (8, k, 128), dtype=np.int8)
    w1_words = ghash_cuda.pack_w1(_t(w1)).numpy().view(np.uint32)
    got = _unpack_words(_emulate_slice_nodes(data.view("<u4").reshape(rows, k // 16, 4), w1_words))
    assert np.array_equal(got, ghash_cuda.ghash_level1_plain(_t(data), _t(w1)).numpy())


_CHUNK_KEY = _rng(31).bytes(64)  # AES-256 key, then the AAD


@functools.lru_cache(maxsize=1)
def _jax_chunk_context():
    return jax_gcm.make_context(_CHUNK_KEY[:32], _CHUNK_KEY[32:], 4 << 20)


def test_slice_fold_matrix_is_the_power_of_h():
    """M^SLICE, derived from the context's step matrix as GhashOperands.build
    derives it on the card, is the JAX package's step matrix of
    H^(k1·SLICE), on a real key."""
    ctx = _jax_chunk_context()
    _, h = jax_gcm._derive_h(_CHUNK_KEY[:32])
    k1 = np.asarray(ctx.agg_mats[0]).shape[1] // 16
    step = np.asarray(ctx.step_mat)
    assert np.array_equal(step, jax_gf128.ghash_step_matrix(h, k1))
    want = jax_gf128.ghash_step_matrix(h, k1 * SLICE)
    assert np.array_equal(ghash_cuda.step_power(_t(step), SLICE).numpy(), want)


def test_step_power_refuses_other_exponents():
    with pytest.raises(ValueError, match="power of two"):
        ghash_cuda.step_power(torch.zeros((128, 128), dtype=torch.int8), 12)


def test_ghash_tree_schedule_on_a_jax_4mib_context():
    """A JAX 4 MiB GcmContext carried across by context_from_numpy drives
    the kernel's schedule (emulated) to the plain version's bits: two rows
    of 2048 groups of 2048 bytes, 128 slices each."""
    ctx = gcm.context_from_numpy(_jax_chunk_context())
    w1, step = np.asarray(ctx.agg_mats[0]), np.asarray(ctx.step_mat)
    k = w1.shape[1]
    assert k == 2048 and ctx.chunk_bytes == 4 << 20
    data = _rng(32).integers(0, 256, (2, ctx.chunk_bytes), dtype=np.uint8)
    tree, _ = _emulate_ghash_kernels(data, w1, step)
    assert np.array_equal(tree, ghash_cuda.ghash_tree_plain(_t(data), _t(w1), _t(step)).numpy())


def test_ghash_tree_on_real_operands_matches_serial_ghash():
    """Operands of a real context: T(C) * H equals the serial GHASH."""
    rng = _rng(23)
    h = int.from_bytes(rng.bytes(16), "big")
    m = 300  # blocks: two aggregation levels, G = 3 groups of 128
    mats = gf128.ghash_agg_matrices(h, m)
    step = gf128.ghash_step_matrix(h, mats[0].shape[1] // 16)
    data = rng.integers(0, 256, (2, m * 16), dtype=np.uint8)
    k_bytes = mats[0].shape[1]
    groups = -(-m * 16 // k_bytes)
    padded = np.zeros((2, groups * k_bytes), np.uint8)
    padded[:, groups * k_bytes - m * 16 :] = data
    ops = ghash_cuda.GhashOperands.build(_t(mats[0]), _t(step))
    bits = ghash_cuda.ghash_tree(_t(padded), ops).numpy()
    for r in range(2):
        t_c = gf128.bitvec_to_int(bits[r])
        blocks = [data[r, i * 16 : (i + 1) * 16].tobytes() for i in range(m)]
        assert gf128.gcm_mult(t_c, h) == jax_gf128.ghash_reference(h, blocks)


# ------------------------------------------------------------- contexts


def _assert_contexts_equal(ours, theirs):
    for field in ("round_keys", "agg_mats", "step_mat"):
        a, b = getattr(ours, field), getattr(theirs, field)
        if field == "agg_mats":
            assert len(a) == len(b)
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            assert np.array_equal(a, b), field
    names = (
        ("h_mat", "aad_blocks", "aad_bit_len", "max_bytes", "m_max", "m_cap")
        if hasattr(theirs, "m_cap")
        else ("final_mat", "const_bits", "chunk_bytes", "n_blocks")
    )
    for field in names:
        assert np.array_equal(getattr(ours, field), getattr(theirs, field)), field


@pytest.mark.parametrize("chunk_bytes", [1, 100, 2048, 4096 + 7])
def test_fixed_context_field_by_field(chunk_bytes):
    rng = _rng(chunk_bytes)
    key, aad = rng.bytes(32), rng.bytes(32)
    theirs = jax_gcm.make_context(key, aad, chunk_bytes)
    _assert_contexts_equal(gcm.make_context(key, aad, chunk_bytes), theirs)
    _assert_contexts_equal(gcm.context_from_numpy(theirs), theirs)


@pytest.mark.parametrize("max_bytes", [17, 5000])
def test_varlen_context_field_by_field(max_bytes):
    rng = _rng(max_bytes)
    key, aad = rng.bytes(32), rng.bytes(20)
    theirs = jax_gcm.make_varlen_context(key, aad, max_bytes)
    _assert_contexts_equal(gcm.make_varlen_context(key, aad, max_bytes), theirs)
    _assert_contexts_equal(gcm.context_from_numpy(theirs), theirs)
    assert gcm.bucket_max_bytes(max_bytes) == jax_gcm.bucket_max_bytes(max_bytes)


# ------------------------------------------------------- packed windows


def _fixed_window(rng, rows, n):
    packed = np.zeros((rows, n + 16), np.uint8)
    packed[:, : n + 12] = rng.integers(0, 256, (rows, n + 12))
    return packed


def test_fixed_packed_window_encrypt_decrypt_match_jax():
    rows, n = 2, 4096 * 2 + 5  # three aggregation levels' worth of blocks, a partial tail block
    rng = _rng(rows * n)
    key, aad = rng.bytes(32), rng.bytes(32)
    jctx = jax_gcm.make_context(key, aad, n)
    ctx = gcm.context_from_numpy(jctx)
    packed = _fixed_window(rng, rows, n)
    want = np.asarray(jax_gcm.gcm_window_packed(jctx, None, jnp.asarray(packed), decrypt=False))
    staged = _t(packed)
    got = gcm.gcm_window_packed(ctx, None, staged, decrypt=False, donate=True)
    assert got.data_ptr() == staged.data_ptr()  # written in place
    assert np.array_equal(got.numpy(), want)

    ct = want.copy()
    ct[:, n : n + 12] = packed[:, n : n + 12]
    got_pt = gcm.gcm_window_packed(ctx, None, _t(ct), decrypt=True).numpy()
    assert np.array_equal(got_pt[:, :n], packed[:, :n])
    assert np.array_equal(got_pt[:, n:], want[:, n:])  # expected tag == the JAX tag


def test_varlen_packed_window_encrypt_decrypt_match_jax():
    lengths = [5000, 17, 0, 4096 * 3]
    rng = _rng(sum(lengths))
    key, aad = rng.bytes(32), rng.bytes(32)
    jctx = jax_gcm.make_varlen_context(key, aad, max(lengths))
    ctx = gcm.context_from_numpy(jctx)
    mb = jctx.max_bytes
    packed = np.zeros((len(lengths), mb + 16), np.uint8)
    for i, length in enumerate(lengths):
        packed[i, :length] = rng.integers(0, 256, length)
    packed[:, mb : mb + 12] = rng.integers(0, 256, (len(lengths), 12))
    packed[:, mb + 12 :] = np.asarray(lengths, "<u4").view(np.uint8).reshape(-1, 4)
    want = np.asarray(jax_gcm.gcm_varlen_window_packed(
        jctx, None, jnp.asarray(packed), None, decrypt=False
    ))
    got = gcm.gcm_varlen_window_packed(ctx, None, _t(packed), None, decrypt=False).numpy()
    assert np.array_equal(got, want)

    ct = want.copy()
    ct[:, mb:] = packed[:, mb:]
    got_pt = gcm.gcm_varlen_window_packed(ctx, None, _t(ct), None, decrypt=True).numpy()
    assert np.array_equal(got_pt[:, :mb], packed[:, :mb])
    assert np.array_equal(got_pt[:, mb:], want[:, mb:])


def test_context_without_fold_matrix_takes_level1_and_ladder():
    rng = _rng(30)
    key, aad = rng.bytes(32), rng.bytes(32)
    n = 4096 * 2
    jctx = jax_gcm.make_context(key, aad, n)
    ctx = gcm.context_from_numpy(jctx)
    no_step = gcm.GcmContext(**{**ctx.__dict__, "step_mat": None})
    packed = _fixed_window(rng, 2, n)
    want = gcm.gcm_window_packed(ctx, None, _t(packed), decrypt=False).numpy()
    got = gcm.gcm_window_packed(no_step, None, _t(packed), decrypt=False).numpy()
    assert np.array_equal(got, want)
    assert gcm.planned_hbm_roundtrips(no_step, 2) == gcm.planned_hbm_roundtrips(ctx, 2) + 1


def _vec(v):
    return {k: bytes.fromhex(v[k]) for k in ("key", "iv", "aad", "plaintext", "ciphertext", "tag")}


@pytest.mark.parametrize("raw", VECTORS, ids=[v["name"] for v in VECTORS])
def test_published_vectors(raw):
    v = _vec(raw)
    n = len(v["plaintext"])
    iv = np.frombuffer(v["iv"], np.uint8)
    if n:
        ctx = gcm.make_context(v["key"], v["aad"], n)
        packed = np.zeros((1, n + 16), np.uint8)
        packed[0, :n] = np.frombuffer(v["plaintext"], np.uint8)
        packed[0, n : n + 12] = iv
        out = gcm.gcm_window_packed(ctx, None, _t(packed), decrypt=False).numpy()[0]
        assert out[:n].tobytes() == v["ciphertext"]
        assert out[n:].tobytes() == v["tag"]
    vctx = gcm.make_varlen_context(v["key"], v["aad"], max(n, 1))
    mb = vctx.max_bytes
    packed = np.zeros((1, mb + 16), np.uint8)
    packed[0, :n] = np.frombuffer(v["plaintext"], np.uint8)
    out = gcm.gcm_varlen_window_packed(vctx, iv[None], _t(packed), [n], decrypt=False).numpy()[0]
    assert out[:n].tobytes() == v["ciphertext"]
    assert out[mb:].tobytes() == v["tag"]


def test_device_len_blocks_match_host_layout():
    lengths = np.array([0, 1, 4096, 2**31 - 1, 2**33 + 5], np.int64)
    got = gcm._device_len_blocks(_t(lengths), 256).numpy()
    for row, length in zip(got, lengths):
        assert row.tobytes() == (256).to_bytes(8, "big") + (int(length) * 8).to_bytes(8, "big")


def test_cpu_wrappers_launch_nothing():
    before = _cuda.launch_counts()
    rng = _rng(31)
    ctx = gcm.make_context(rng.bytes(32), rng.bytes(32), 4096 * 2)
    gcm.gcm_window_packed(ctx, None, _t(_fixed_window(rng, 2, 4096 * 2)), decrypt=False)
    assert _cuda.launch_counts() == before
