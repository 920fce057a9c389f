"""CRC32C (Castagnoli) as a GF(2) linear-map tree in torch ops.

Counterpart of tieredstorage_tpu/ops/crc32c.py. CRC with init=0/xorout=0
("crc0") is linear over GF(2) in the message bits, so each 16-byte block
contributes a 32x128 bit matrix times its bits, and a left span combines
with a right span of k bytes as `Z^k(left) ^ right`, where Z is the 32x32
zero-byte state-evolution matrix. A log-tree with per-level matrices
(Z^(16*2^j), squared on the host) reduces a batch of chunks with bit
products mod 2.

The standard CRC32C (init 0xFFFFFFFF, xorout 0xFFFFFFFF) is recovered with a
length-dependent offset: crc(M) = crc0(M) ^ crc(0^len), the latter computed
on the host in O(log len) matrix powers. The scrubber verifies stored chunks
against these values, and uploads record them in the manifest
(`scrub.checksums.enabled`).

The bit products are float32 `torch.matmul` of 0/1 operands, whose sums
(at most 128) are exact; TF32 is kept off as in ops/ghash_cuda.py. The
tree runs on an explicit device. Its intermediates are bounded: the leaf
products run over slabs of `_SLAB_BLOCKS` blocks, and each level combines
its pairs in slabs of the same size, so a 16 x 4 MiB batch never expands to
bits all at once. Odd levels are left-padded by one zero state, which is the
JAX program's left padding to a power of two done one level at a time (a
zero state contributes nothing: Z^k(0) = 0).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from tieredstorage_tpu_torch.utils.locks import new_lock

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_POLY_REFLECTED = 0x82F63B78


def crc32c_reference(data: bytes, init: int = 0xFFFFFFFF, xorout: int = 0xFFFFFFFF) -> int:
    """Bitwise software CRC32C (host oracle)."""
    crc = init
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (_POLY_REFLECTED if crc & 1 else 0)
    return crc ^ xorout


def _crc0(data: bytes) -> int:
    return crc32c_reference(data, init=0, xorout=0)


_HOST_TABLE: list | None = None


def crc32c_host(data: bytes) -> int:
    """Table-driven host CRC32C, the path of small groups. The bitwise
    `crc32c_reference` above stays the independent oracle."""
    global _HOST_TABLE
    if _HOST_TABLE is None:
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (_POLY_REFLECTED if crc & 1 else 0)
            table.append(crc)
        _HOST_TABLE = table
    crc = 0xFFFFFFFF
    table = _HOST_TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _bits32(v: int) -> np.ndarray:
    return np.frombuffer(v.to_bytes(4, "big"), dtype=np.uint8)[:, None] >> np.arange(
        7, -1, -1, dtype=np.uint8
    ) & 1


def _bits32_vec(v: int) -> np.ndarray:
    return _bits32(v).reshape(32).astype(np.uint8)


def _vec32_to_int(bits: np.ndarray) -> int:
    packed = np.packbits(bits.astype(np.uint8).reshape(4, 8), axis=1, bitorder="big")
    return int.from_bytes(packed.tobytes(), "big")


@functools.cache
def _leaf_matrix() -> np.ndarray:
    """uint8[32,128]: bits32(crc0(block)) = L @ bits(block), MSB-first bits."""
    m = np.zeros((32, 128), dtype=np.uint8)
    for bit in range(128):
        block = bytearray(16)
        block[bit // 8] = 0x80 >> (bit % 8)
        m[:, bit] = _bits32_vec(_crc0(bytes(block)))
    return m


@functools.cache
def _zero_byte_matrix() -> np.ndarray:
    """uint8[32,32]: state evolution over ONE zero byte."""
    m = np.zeros((32, 32), dtype=np.uint8)
    for bit in range(32):
        # Column for basis state e_bit (MSB-first indexing of the uint32),
        # evolved through one zero byte with the bitwise step.
        crc_val = 1 << (31 - bit)
        for _ in range(8):
            crc_val = (crc_val >> 1) ^ (_POLY_REFLECTED if crc_val & 1 else 0)
        m[:, bit] = _bits32_vec(crc_val)
    return m


def _mat_mod2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a.astype(np.int64) @ b.astype(np.int64) % 2).astype(np.uint8)


def _mat_pow(m: np.ndarray, e: int) -> np.ndarray:
    result = np.eye(m.shape[0], dtype=np.uint8)
    base = m
    while e:
        if e & 1:
            result = _mat_mod2(result, base)
        base = _mat_mod2(base, base)
        e >>= 1
    return result


@functools.cache
def _level_matrices(levels: int) -> np.ndarray:
    """int8[levels,32,32] transposed: level j combines spans of 16*2^j bytes."""
    z16 = _mat_pow(_zero_byte_matrix(), 16)
    mats = np.zeros((levels, 32, 32), dtype=np.int8)
    m = z16
    for j in range(levels):
        mats[j] = m.T.astype(np.int8)
        m = _mat_mod2(m, m)
    return mats


@functools.cache
def _length_offset(length: int) -> int:
    """crc32c of `length` zero bytes, via matrix powers (O(log n))."""
    state = _mat_pow(_zero_byte_matrix(), length) @ _bits32_vec(0xFFFFFFFF) % 2
    return _vec32_to_int(state) ^ 0xFFFFFFFF


#: Blocks (rows of bit products) per slab: bounds the float32 intermediates
#: at about _SLAB_BLOCKS x 1.2 KiB on the leaf level.
_SLAB_BLOCKS = 1 << 17

_CONSTS: dict = {}
_CONSTS_MU = new_lock("crc32c._CONSTS_MU")


def _device_consts(levels: int, device: torch.device) -> tuple:
    """(leaf float32[128, 32], level matrices float32[levels, 32, 32],
    bit shifts uint8[8]) on `device`, built once per (levels, device)."""
    key = (levels, str(device))
    with _CONSTS_MU:
        if key in _CONSTS:
            return _CONSTS[key]
    consts = (
        torch.from_numpy(_leaf_matrix().T.astype(np.float32)).to(device),
        torch.from_numpy(_level_matrices(levels).astype(np.float32)).to(device),
        torch.arange(7, -1, -1, dtype=torch.uint8, device=device),
    )
    with _CONSTS_MU:
        return _CONSTS.setdefault(key, consts)


def _mod2_matmul(bits: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """uint8 0/1 [N, k] x float32 0/1 [k, 32] -> uint8 0/1 [N, 32], mod 2."""
    return ((bits.to(torch.float32) @ mat).to(torch.int32) & 1).to(torch.uint8)


def _crc0_batch(data: torch.Tensor, levels: int, mats=None) -> torch.Tensor:
    """uint8[batch, chunk_bytes] on its device -> crc0 state bits
    uint8[batch, 32] (MSB first), through the leaf products and `levels`
    tree levels (`mats`: the (leaf, level matrices) to use, default this
    device's cached ones)."""
    batch, chunk_bytes = data.shape
    n_blocks = chunk_bytes // 16
    leaf, level_mats, shifts = _device_consts(levels, data.device)
    if mats is not None:
        leaf, level_mats = mats
    blocks = data.reshape(batch * n_blocks, 16)
    vals = torch.empty((batch * n_blocks, 32), dtype=torch.uint8, device=data.device)
    for s in range(0, batch * n_blocks, _SLAB_BLOCKS):
        slab = blocks[s : s + _SLAB_BLOCKS]
        bits = ((slab[..., None] >> shifts) & 1).reshape(-1, 128)
        vals[s : s + _SLAB_BLOCKS] = _mod2_matmul(bits, leaf)
    vals = vals.reshape(batch, n_blocks, 32)
    for j in range(levels):
        if vals.shape[1] % 2:
            pad = torch.zeros((batch, 1, 32), dtype=torch.uint8, device=data.device)
            vals = torch.cat([pad, vals], dim=1)
        pairs = vals.reshape(batch, -1, 2, 32)
        left = pairs[:, :, 0, :].reshape(-1, 32)
        out = pairs[:, :, 1, :].reshape(-1, 32).clone()
        for s in range(0, left.shape[0], _SLAB_BLOCKS):
            out[s : s + _SLAB_BLOCKS] ^= _mod2_matmul(left[s : s + _SLAB_BLOCKS], level_mats[j])
        vals = out.reshape(batch, -1, 32)
    return vals[:, 0, :]


def crc32c_chunks(data, device) -> np.ndarray:
    """uint32[batch] CRC32C of each row of uint8[batch, chunk_bytes] (a numpy
    array, or a uint8 tensor), computed on `device`.

    chunk_bytes must be a multiple of 16 (callers left-pad; see
    `crc32c_batch`)."""
    device = torch.device(device)
    if isinstance(data, torch.Tensor):
        rows = data.to(device)
    else:
        rows = torch.from_numpy(np.require(data, np.uint8, ["C", "W"])).to(device)
    batch, chunk_bytes = rows.shape
    if chunk_bytes % 16:
        raise ValueError("chunk_bytes must be a multiple of 16")
    levels = max(1, (chunk_bytes // 16 - 1).bit_length())
    bits = _crc0_batch(rows, levels)
    weights = torch.tensor([1 << (31 - i) for i in range(32)], dtype=torch.int64).to(device)
    crc0_vals = (bits.to(torch.int64) * weights).sum(dim=1).cpu().numpy().astype(np.uint64)
    # crc(M) = crc0(M) ^ crc(0^len); crc(0^len) already includes init+xorout.
    return (crc0_vals ^ np.uint64(_length_offset(chunk_bytes))).astype(np.uint32)


def crc32c_constants(chunk_bytes: int, device=None):
    """Host-precomputed constants for `crc32c_chunks_device` at a chunk size,
    placed on `device` (default `cuda:0`; pass "cpu" for the plain run):
    (leaf float32[128, 32], level matrices float32[levels, 32, 32],
    chunk_bytes, levels, the length offset as numpy uint32). The JAX
    package's matrices are int8 for its MXU; these are the 0/1 float32
    operands of this module's exact float matmuls."""
    from tieredstorage_tpu_torch.transform.api import DEFAULT_DEVICE, resolve_device

    if chunk_bytes % 16:
        raise ValueError("chunk_bytes must be a multiple of 16")
    levels = max(1, (chunk_bytes // 16 - 1).bit_length())
    leaf, level_mats, _ = _device_consts(levels, resolve_device(device or DEFAULT_DEVICE))
    return leaf, level_mats, chunk_bytes, levels, np.uint32(_length_offset(chunk_bytes))


def crc32c_chunks_device(data, leaf_t, level_mats, chunk_bytes, levels, length_offset):
    """Device-resident CRC32C: uint8[batch, chunk_bytes] -> int64[batch]
    holding the uint32 CRCs, on the constants' device (unlike
    `crc32c_chunks`, which returns them on the host). A numpy `data` is
    copied there first."""
    device = leaf_t.device
    if isinstance(data, torch.Tensor):
        rows = data.to(device)
    else:
        rows = torch.from_numpy(np.require(data, np.uint8, ["C", "W"])).to(device)
    if tuple(rows.shape[1:]) != (chunk_bytes,):
        raise ValueError(f"rows must be uint8[B, {chunk_bytes}], got {tuple(rows.shape)}")
    bits = _crc0_batch(rows, levels, (leaf_t, level_mats))
    weights = torch.ones(32, dtype=torch.int64, device=device) << torch.arange(
        31, -1, -1, dtype=torch.int64, device=device)
    return (bits.to(torch.int64) * weights).sum(dim=1) ^ int(length_offset)


#: Below this many total bytes in a same-length group, a device launch costs
#: more than the table loop; the host path takes over (the JAX package's
#: size policy).
_BATCH_MIN_BYTES = 1 << 16


def crc32c_batch(chunks, device) -> list[int]:
    """CRC32C of each chunk in a heterogeneous batch (the scrubber's and
    the upload checksums' primitive), with device work on `device`.

    Same-length groups are LEFT-zero-padded to a 16-byte multiple and
    reduced through the tree in one `crc32c_chunks` call — left padding is
    free for the math (crc0(0^k || M) = crc0(M)), so only the length-offset
    term is swapped: crc(M) = tree(0^k||M) ^ crc(0^lenP) ^ crc(0^lenM).
    Groups under `_BATCH_MIN_BYTES` in all take the host table."""
    chunks = list(chunks)
    out: list[Optional[int]] = [None] * len(chunks)
    groups: dict[int, list[int]] = {}
    for i, c in enumerate(chunks):
        groups.setdefault(len(c), []).append(i)
    for length, idxs in groups.items():
        if length == 0:
            for i in idxs:
                out[i] = 0  # crc32c(b"") == 0
            continue
        padded = -(-length // 16) * 16
        if length * len(idxs) < _BATCH_MIN_BYTES:
            for i in idxs:
                out[i] = crc32c_host(chunks[i])
            continue
        mat = np.zeros((len(idxs), padded), dtype=np.uint8)
        for row, i in enumerate(idxs):
            mat[row, padded - length:] = np.frombuffer(chunks[i], dtype=np.uint8)
        crcs = crc32c_chunks(mat, device)
        fix = 0 if padded == length else (_length_offset(padded) ^ _length_offset(length))
        for row, i in enumerate(idxs):
            out[i] = int(crcs[row]) ^ fix
    return out  # type: ignore[return-value]
