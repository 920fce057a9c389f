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


def _emulate_aes_ctr_kernel(rk: np.ndarray, iv: np.ndarray, first: int, n_blocks: int):
    """csrc/aes_ctr.cu, thread by thread, in Python ints: the counter packing,
    ShiftRows indexing, MixColumns formula and byte transpose as the kernel
    writes them, with the generated S-box gates."""
    gates, outputs = aes_circuit_gen.sbox_gates()
    mask = 0xFFFFFFFF

    def sbox(x):
        env = {f"x{i}": x[i] for i in range(8)}
        for out, op, a, b in gates:
            env[out] = (~env[a] & mask) if op == "~" else (
                env[a] ^ env[b] if op == "^" else env[a] & env[b])
        return [env[n] for n in outputs]

    def sr(p):
        return 4 * (((p >> 2) + (p & 3)) & 3) + (p & 3)

    rkm = [[mask if (rk[r, p] >> b) & 1 else 0 for p in range(16) for b in range(8)]
           for r in range(15)]
    out = np.zeros((n_blocks, 16), np.uint8)
    for w in range((n_blocks + 31) // 32):
        s = [0] * 128
        for p in range(12):
            for b in range(8):
                s[p * 8 + b] = mask if (int(iv[p]) >> b) & 1 else 0
        base = (first + 32 * w) & mask
        for j in range(32):
            c = (base + j) & mask
            for q in range(4):
                for b in range(8):
                    s[(12 + q) * 8 + b] |= ((c >> (8 * (3 - q) + b)) & 1) << j
        s = [a ^ k for a, k in zip(s, rkm[0])]
        for rnd in range(1, 15):
            for p in range(16):
                s[p * 8 : p * 8 + 8] = sbox(s[p * 8 : p * 8 + 8])
            s = [s[sr(p) * 8 + b] for p in range(16) for b in range(8)]
            if rnd != 14:
                for col in range(4):
                    a = [s[(col * 4 + r) * 8 : (col * 4 + r) * 8 + 8] for r in range(4)]
                    all4 = [a[0][b] ^ a[1][b] ^ a[2][b] ^ a[3][b] for b in range(8)]
                    for r in range(4):
                        x = [a[r][b] ^ a[(r + 1) & 3][b] for b in range(8)]
                        xt = [x[7], x[0] ^ x[7], x[1], x[2] ^ x[7], x[3] ^ x[7], x[4], x[5], x[6]]
                        for b in range(8):
                            s[(col * 4 + r) * 8 + b] = xt[b] ^ a[r][b] ^ all4[b]
            s = [a ^ k for a, k in zip(s, rkm[rnd])]
        for j in range(min(32, n_blocks - 32 * w)):
            for p in range(16):
                out[32 * w + j, p] = sum(((s[p * 8 + b] >> j) & 1) << b for b in range(8))
    return out


def test_aes_kernel_logic_emulated():
    rng = _rng(5)
    rk = key_expansion(rng.bytes(32))
    ivs = rng.integers(0, 256, (1, 12), dtype=np.uint8)
    first = 2**32 - 40  # the counter wraps inside the second thread's words
    want = aes_bitsliced.ctr_keystream_batch(_t(rk), _t(ivs), first, 45).numpy()[0]
    assert np.array_equal(_emulate_aes_ctr_kernel(rk, ivs[0], first, 45), want)


def test_generated_sbox_circuit_is_the_sbox():
    gates, outputs = aes_circuit_gen.sbox_gates()
    for x in range(256):
        env = {f"x{i}": (x >> i) & 1 for i in range(8)}
        for out, op, a, b in gates:
            env[out] = 1 - env[a] if op == "~" else (
                env[a] ^ env[b] if op == "^" else env[a] & env[b])
        assert sum(env[n] << i for i, n in enumerate(outputs)) == SBOX[x]


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


def _emulate_ghash_kernels(data: np.ndarray, w1: np.ndarray, step: np.ndarray):
    """csrc/ghash.cu in numpy over the packed operands the wrapper builds:
    16-byte words, four slices XOR-combined, popcount parity, ballot-word
    fold. Returns (tree bits, level-1 bits of every group)."""
    w1_words = ghash_cuda.pack_w1(_t(w1)).numpy().view(np.uint32)  # [K/16, 128, 4]
    step_words = ghash_cuda.pack_step(_t(step)).numpy().view(np.uint32)  # [128, 4]
    rows, total = data.shape
    groups = total // K
    words = data.reshape(rows, groups, K // 16, 4, 4).view("<u4")[..., 0]  # [r, g, q, j]

    def parity(v):
        return np.array([bin(int(x)).count("1") & 1 for x in v.ravel()]).reshape(v.shape)

    nodes = np.zeros((rows, groups, 128), np.uint32)
    for r in range(rows):
        for g in range(groups):
            partial = np.zeros((4, 128), np.uint32)
            for q in range(K // 16):
                s = q % 4
                partial[s] ^= np.bitwise_xor.reduce(words[r, g, q][None, :] & w1_words[q], axis=1)
            nodes[r, g] = parity(np.bitwise_xor.reduce(partial, axis=0))
    tree = np.zeros((rows, 128), np.uint32)
    for r in range(rows):
        bit = nodes[r, 0]
        for g in range(1, groups):
            t_words = np.array([
                sum(int(bit[32 * w + lane]) << lane for lane in range(32)) for w in range(4)
            ], np.uint32)
            x = np.bitwise_xor.reduce(t_words[None, :] & step_words, axis=1)
            bit = parity(x) ^ nodes[r, g]
        tree[r] = bit
    return tree.astype(np.uint8), nodes.astype(np.uint8)


def test_ghash_kernel_logic_emulated():
    data, w1, step = _ghash_operands(22)
    tree, nodes = _emulate_ghash_kernels(data, w1, step)
    assert np.array_equal(tree, ghash_cuda.ghash_tree_plain(_t(data), _t(w1), _t(step)).numpy())
    assert np.array_equal(
        nodes.reshape(B * G, 128),
        ghash_cuda.ghash_level1_plain(_t(data.reshape(B * G, K)), _t(w1)).numpy(),
    )


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
