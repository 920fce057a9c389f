"""The op-level entry points of the port's ops against their JAX twins:
`ops/gcm.py`'s `gcm_encrypt_chunks`, `gcm_decrypt_chunks`,
`gcm_encrypt_varlen`, `gcm_decrypt_varlen` and `device_hbm_roundtrips`;
`ops/aes.py`'s table ciphers; `ops/aes_bitsliced.py`'s keystream and round-key
planes; `ops/crc32c.py`'s device CRC. Seeded inputs, no tolerance. On the CPU
the wrappers take the kernels' plain versions (device="cpu")."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tieredstorage_tpu.ops import aes as jax_aes
from tieredstorage_tpu.ops import aes_bitsliced as jax_bitsliced
from tieredstorage_tpu.ops import crc32c as jax_crc32c
from tieredstorage_tpu.ops import gcm as jax_gcm
from tieredstorage_tpu_torch.ops import aes, aes_bitsliced, crc32c, gcm


def _counts(mod) -> tuple:
    return mod.device_dispatches(), mod.device_hbm_roundtrips()


def _delta(mod, before) -> tuple:
    now = _counts(mod)
    return now[0] - before[0], now[1] - before[1]


@pytest.mark.parametrize("chunk_bytes,rows", [(4096, 5), (32 << 10, 4), (1000, 3)])
def test_gcm_chunks_equal_jax(chunk_bytes, rows):
    rng = np.random.default_rng(chunk_bytes + rows)
    key, aad = rng.bytes(32), rng.bytes(32)
    jctx = jax_gcm.make_context(key, aad, chunk_bytes)
    ctx = gcm.context_from_numpy(jctx)
    pt = rng.integers(0, 256, (rows, chunk_bytes), dtype=np.uint8)
    ivs = rng.integers(0, 256, (rows, 12), dtype=np.uint8)

    jct, jtags = jax_gcm.gcm_encrypt_chunks(jctx, ivs, pt)
    before = _counts(gcm)
    ct, tags = gcm.gcm_encrypt_chunks(ctx, ivs, pt, device="cpu")
    assert _delta(gcm, before) == (1, gcm.planned_hbm_roundtrips(ctx, rows, packed=False))
    assert np.array_equal(ct.numpy(), np.asarray(jct))
    assert np.array_equal(tags.numpy(), np.asarray(jtags))

    jback, jexp = jax_gcm.gcm_decrypt_chunks(jctx, ivs, np.asarray(jct))
    back, expected = gcm.gcm_decrypt_chunks(ctx, ivs, ct, device="cpu")
    assert np.array_equal(back.numpy(), pt) and np.array_equal(back.numpy(), np.asarray(jback))
    assert np.array_equal(expected.numpy(), np.asarray(jexp))
    assert np.array_equal(ct.numpy(), np.asarray(jct))  # the caller's tensor is not written


@pytest.mark.parametrize("max_bytes,rows", [(4096, 6), (20_000, 3)])
def test_gcm_varlen_equal_jax(max_bytes, rows):
    rng = np.random.default_rng(max_bytes)
    key, aad = rng.bytes(32), rng.bytes(20)
    jctx = jax_gcm.make_varlen_context(key, aad, max_bytes)
    ctx = gcm.context_from_numpy(jctx)
    lengths = rng.integers(1, max_bytes, rows)
    lengths[-1] = 7
    pt = np.zeros((rows, jctx.max_bytes), np.uint8)
    for i, n in enumerate(lengths):
        pt[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    ivs = rng.integers(0, 256, (rows, 12), dtype=np.uint8)
    assert np.array_equal(gcm._host_len_blocks(ctx, lengths), jax_gcm._host_len_blocks(jctx, lengths))

    jct, jtags = jax_gcm.gcm_encrypt_varlen(jctx, ivs, pt, lengths)
    before = _counts(gcm)
    ct, tags = gcm.gcm_encrypt_varlen(ctx, ivs, pt, lengths, device="cpu")
    assert _delta(gcm, before) == (1, gcm.planned_hbm_roundtrips(ctx, rows))
    assert np.array_equal(ct.numpy(), np.asarray(jct))
    assert np.array_equal(tags.numpy(), np.asarray(jtags))

    jback, jexp = jax_gcm.gcm_decrypt_varlen(jctx, ivs, np.asarray(jct), lengths)
    back, expected = gcm._run_varlen(ctx, ivs, ct, lengths, True, device="cpu")
    assert np.array_equal(back.numpy(), pt) and np.array_equal(back.numpy(), np.asarray(jback))
    assert np.array_equal(expected.numpy(), np.asarray(jexp))


def test_hbm_roundtrips_equal_jax_on_the_kernel_path(monkeypatch):
    """Each call counts one dispatch in both packages. The round trips are
    each package's plan of its own program: JAX counts its CPU XLA path
    (the int8 plane expansion and one trip per ladder level) unless its
    Pallas kernels are on, which is the path the port always runs; there,
    on whole-group chunks, the two plans are the keystream handoff alone."""
    rng = np.random.default_rng(9)
    key, aad = rng.bytes(32), rng.bytes(32)
    jctx = jax_gcm.make_context(key, aad, 32 << 10)
    ctx = gcm.context_from_numpy(jctx)
    pt = rng.integers(0, 256, (4, 32 << 10), dtype=np.uint8)
    ivs = rng.integers(0, 256, (4, 12), dtype=np.uint8)
    jbefore, before = _counts(jax_gcm), _counts(gcm)
    jax_gcm.gcm_encrypt_chunks(jctx, ivs, pt)
    gcm.gcm_encrypt_chunks(ctx, ivs, pt, device="cpu")
    jdelta, delta = _delta(jax_gcm, jbefore), _delta(gcm, before)
    assert delta[0] == jdelta[0] == 1
    assert jdelta[1] == jax_gcm.planned_hbm_roundtrips(jctx, 4)
    monkeypatch.setenv("TIEREDSTORAGE_TPU_PALLAS_GHASH_TREE", "1")
    assert delta[1] == jax_gcm.planned_hbm_roundtrips(jctx, 4) == 1


def test_op_level_entry_points_default_to_the_card():
    ctx = gcm.make_context(bytes(32), bytes(16), 1024)
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gcm.gcm_encrypt_chunks(ctx, np.zeros((1, 12), np.uint8), np.zeros((1, 1024), np.uint8))
    # A CPU tensor runs where it lies.
    ct, _ = gcm.gcm_encrypt_chunks(ctx, torch.zeros((1, 12), dtype=torch.uint8),
                                   torch.zeros((1, 1024), dtype=torch.uint8))
    assert ct.device.type == "cpu"


# --------------------------------------------------------------------- AES
def test_aes_tables_and_block_ciphers_equal_jax():
    assert np.array_equal(aes.INV_SBOX, jax_aes.INV_SBOX)
    assert np.array_equal(aes.SBOX[aes.INV_SBOX], np.arange(256))
    rng = np.random.default_rng(11)
    rk = aes.key_expansion(rng.bytes(32))
    blocks = rng.integers(0, 256, (7, 3, 16), dtype=np.uint8)
    enc = aes.aes_encrypt_blocks(torch.from_numpy(rk), torch.from_numpy(blocks))
    assert np.array_equal(enc.numpy(), np.asarray(
        jax_aes.aes_encrypt_blocks(jnp.asarray(rk), jnp.asarray(blocks))))
    dec = aes.aes_decrypt_blocks(torch.from_numpy(rk), enc)
    assert np.array_equal(dec.numpy(), blocks)
    assert np.array_equal(dec.numpy(), np.asarray(
        jax_aes.aes_decrypt_blocks(jnp.asarray(rk), jnp.asarray(enc.numpy()))))


@pytest.mark.parametrize("first,n", [(2, 1), (1, 40), (2**31 - 3, 6)])
def test_ctr_keystreams_equal_jax(first, n):
    rng = np.random.default_rng(first % 1000 + n)
    key = rng.bytes(32)
    iv = rng.integers(0, 256, 12, dtype=np.uint8)
    rk = aes.key_expansion(key)
    want = np.asarray(jax_aes.ctr_keystream(jnp.asarray(rk), jnp.asarray(iv), first, n))
    got = aes.ctr_keystream(torch.from_numpy(rk), torch.from_numpy(iv), first, n)
    assert np.array_equal(got.numpy(), want)
    planes = aes_bitsliced.make_rk_planes(key)
    assert planes.dtype == np.uint32
    assert np.array_equal(planes, jax_bitsliced.make_rk_planes(key))
    assert np.array_equal(aes_bitsliced.round_key_planes(rk), jax_bitsliced.round_key_planes(rk))
    jbits = np.asarray(jax_bitsliced.ctr_keystream_bitsliced(
        jnp.asarray(planes), jnp.asarray(iv), first, n))
    bits = aes_bitsliced.ctr_keystream_bitsliced(planes, iv, first, n, device="cpu")
    assert np.array_equal(bits.numpy(), jbits) and np.array_equal(jbits, want)


# ------------------------------------------------------------------ CRC32C
@pytest.mark.parametrize("chunk_bytes,rows", [(16, 3), (4096, 5), (48, 2)])
def test_crc32c_device_equals_jax(chunk_bytes, rows):
    rng = np.random.default_rng(chunk_bytes)
    data = rng.integers(0, 256, (rows, chunk_bytes), dtype=np.uint8)
    jconsts = jax_crc32c.crc32c_constants(chunk_bytes)
    consts = crc32c.crc32c_constants(chunk_bytes, "cpu")
    assert consts[2:4] == jconsts[2:4] and consts[4] == jconsts[4]
    assert np.array_equal(consts[0].numpy(), np.asarray(jconsts[0]).astype(np.float32))
    assert np.array_equal(consts[1].numpy(), np.asarray(jconsts[1]).astype(np.float32))
    want = np.asarray(jax_crc32c.crc32c_chunks_device(jnp.asarray(data), *jconsts))
    got = crc32c.crc32c_chunks_device(torch.from_numpy(data), *consts)
    assert got.device.type == "cpu"
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert [int(v) for v in got] == [crc32c.crc32c_host(bytes(r)) for r in data]
    with pytest.raises(ValueError, match="multiple of 16"):
        crc32c.crc32c_constants(chunk_bytes + 1, "cpu")
