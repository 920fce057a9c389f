"""Batched AES-256-GCM over packed chunk windows on torch tensors.

Counterpart of tieredstorage_tpu/ops/gcm.py. One window call encrypts or
decrypts uint8[B, n + 16] rows (`payload || tail`) with per-row IVs and a
shared key + AAD (the per-segment DEK + AAD), producing the same bytes as the
JAX package and the host AES-GCM oracle:

- CTR keystream: the CUDA bitsliced cipher (`aes_bitsliced.ctr_keystream_batch`)
  over all counter blocks of the window at once; counter 1 yields the tag
  mask E(J0), counters 2.. encrypt the data (NIST SP 800-38D).
- GHASH: T(C) = Σ C_i H^(m-1-i) by the CUDA tree kernel when the block count
  needs more than one aggregation level, else by the level-1 kernel (plus the
  torch ladder for contexts without a fold matrix). The per-segment constants
  (AAD contribution, length block) fold into one host-computed 128-bit vector.

The glue between the kernels stays torch ops: the XOR with the keystream,
the varlen sequence assembly (length block one-hot, row rotation by gather),
the ladder levels ≥ 2, the final ×H² / ×H fold and the bit-to-byte packing.
Bit products run as float32 matmuls with exact sums (ops/ghash_cuda.py turns
TF32 off). The output is written IN PLACE into the staged window when the
caller donates it — the counterpart of XLA buffer donation.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import threading
import weakref
from typing import Optional

import numpy as np
import torch

from tieredstorage_tpu_torch.ops import gf128
from tieredstorage_tpu_torch.ops.aes import encrypt_block, key_expansion
from tieredstorage_tpu_torch.ops.aes_bitsliced import ctr_keystream_batch
from tieredstorage_tpu_torch.ops.ghash_cuda import (
    GhashOperands,
    ghash_level1,
    ghash_tree,
    use_ghash_tree,
)
from tieredstorage_tpu_torch.utils.locks import new_lock

TAG_SIZE = 16


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: weakly cacheable
class GcmContext:
    """Host-precomputed per-(key, aad, chunk_size) constants for the kernels."""

    round_keys: np.ndarray       # uint8[15,16]
    agg_mats: tuple              # per-level int8[k*128,128] grouped operands
    final_mat: np.ndarray        # int8[128,128] transposed mult-by-H^2 matrix
    const_bits: np.ndarray       # uint8[128] = bits(T(A)*H^(mC+2) ^ L*H)
    chunk_bytes: int
    n_blocks: int                # ceil(chunk_bytes/16)
    #: int8[128,128] transposed mult-by-H^k1 between-group fold matrix of
    #: the GHASH tree kernel (gf128.ghash_step_matrix).
    step_mat: np.ndarray = None


@functools.lru_cache(maxsize=16)
def _derive_h(key: bytes) -> tuple[np.ndarray, int]:
    """Round keys and the GHASH key H = E_K(0^128) for an AES-256 key."""
    round_keys = key_expansion(key)
    return round_keys, int.from_bytes(encrypt_block(round_keys, bytes(16)), "big")


class _ContextCache:
    """The GCM contexts most recently used, under one lock. The caller
    builds a missing context outside the lock, so a hit never waits behind
    another key's build; two threads that miss one key at once both build,
    and `put` keeps the first stored context and hands it to both."""

    def __init__(self, maxsize: int = 64) -> None:
        self._maxsize = maxsize
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._lock = new_lock("gcm._ContextCache._lock")

    def get(self, key: tuple):
        """The cached context (now the most recently used), or None."""
        with self._lock:
            ctx = self._entries.get(key)
            if ctx is not None:
                self._entries.move_to_end(key)
            return ctx

    def put(self, key: tuple, ctx):
        """Store a built context, evicting the least recently used beyond
        the capacity; returns the context kept for the key."""
        with self._lock:
            ctx = self._entries.setdefault(key, ctx)
            self._entries.move_to_end(key)
            while len(self._entries) > self._maxsize:
                self._entries.popitem(last=False)
            return ctx


def _context_cached(key: bytes, aad: bytes, chunk_bytes: int) -> GcmContext:
    round_keys, h = _derive_h(key)

    m_c = _ceil_div(chunk_bytes, 16)
    agg_mats = gf128.ghash_agg_matrices(h, m_c)

    # T(A) = sum_i A_i H^(mA-i) over the AAD blocks (zero-padded).
    aad_blocks = [aad[i : i + 16] for i in range(0, len(aad), 16)]
    t_a = 0
    for i, blk in enumerate(aad_blocks):
        power = gf128.gcm_pow(h, len(aad_blocks) - 1 - i)
        t_a ^= gf128.gcm_mult(int.from_bytes(blk.ljust(16, b"\x00"), "big"), power)

    # Length block: 64-bit bit-lengths of AAD and ciphertext.
    len_block = int.from_bytes(
        (len(aad) * 8).to_bytes(8, "big") + (chunk_bytes * 8).to_bytes(8, "big"), "big"
    )
    # GHASH(A||C||L) = T(A)*H^(mC+2) ^ T(C)*H^2 ^ L*H.
    const = gf128.gcm_mult(t_a, gf128.gcm_pow(h, m_c + 2)) ^ gf128.gcm_mult(
        len_block, h
    )
    final_mat = gf128.mult_matrix(gf128.gcm_mult(h, h))  # H^2

    return GcmContext(
        round_keys=round_keys,
        agg_mats=agg_mats,
        final_mat=np.ascontiguousarray(final_mat.T.astype(np.int8)),
        const_bits=gf128.int_to_bitvec(const),
        chunk_bytes=chunk_bytes,
        n_blocks=m_c,
        step_mat=gf128.ghash_step_matrix(h, agg_mats[0].shape[1] // 16),
    )


_CONTEXTS = _ContextCache()


def lookup_context(key: bytes, aad: bytes, chunk_bytes: int) -> tuple[GcmContext, bool]:
    """`make_context`, and whether this call built the context (a miss of
    the cache of the 64 most recently used)."""
    if len(key) != 32:
        raise ValueError("AES-256 key required")
    if chunk_bytes <= 0:
        raise ValueError("chunk_bytes must be positive")
    cache_key = (bytes(key), bytes(aad), chunk_bytes)
    ctx = _CONTEXTS.get(cache_key)
    if ctx is not None:
        return ctx, False
    return _CONTEXTS.put(cache_key, _context_cached(*cache_key)), True


def make_context(key: bytes, aad: bytes, chunk_bytes: int) -> GcmContext:
    return lookup_context(key, aad, chunk_bytes)[0]


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: weakly cacheable
class GcmVarlenContext:
    round_keys: np.ndarray   # uint8[15,16]
    aad_blocks: np.ndarray   # uint8[m_A,16] zero-padded AAD blocks
    agg_mats: tuple          # per-level int8[k*128,128] grouped operands
    h_mat: np.ndarray        # int8[128,128] transposed mult-by-H matrix
    aad_bit_len: int
    max_bytes: int
    m_max: int               # max data blocks
    m_cap: int               # sequence slots (AAD + data + length block)
    step_mat: np.ndarray = None


def _varlen_context_cached(key: bytes, aad: bytes, max_bytes: int) -> GcmVarlenContext:
    round_keys, h = _derive_h(key)
    m_max = _ceil_div(max_bytes, 16)
    m_a = _ceil_div(len(aad), 16)
    seq_len = m_a + m_max + 1
    aad_padded = np.frombuffer(
        aad + b"\x00" * (m_a * 16 - len(aad)), dtype=np.uint8
    ).reshape(m_a, 16) if m_a else np.zeros((0, 16), np.uint8)
    agg_mats = gf128.ghash_agg_matrices(h, seq_len)
    return GcmVarlenContext(
        round_keys=round_keys,
        aad_blocks=aad_padded,
        agg_mats=agg_mats,
        h_mat=np.ascontiguousarray(gf128.mult_matrix(h).T.astype(np.int8)),
        aad_bit_len=len(aad) * 8,
        max_bytes=max_bytes,
        m_max=m_max,
        m_cap=seq_len,
        step_mat=gf128.ghash_step_matrix(h, agg_mats[0].shape[1] // 16),
    )


def bucket_max_bytes(n: int) -> int:
    """Round a varlen window's max chunk size up to a bounded ladder (eighth
    steps of the next power of two, at least 1024). Few distinct shapes mean
    few contexts and few staging-buffer shapes: the backend's pinned staging
    pool (transform/cuda.py) reuses one buffer per shape."""
    if n <= 1024:
        return 1024
    step = 1 << max(4, (n - 1).bit_length() - 3)
    return step * _ceil_div(n, step)


_VARLEN_CONTEXTS = _ContextCache()


def lookup_varlen_context(
    key: bytes, aad: bytes, max_bytes: int
) -> tuple[GcmVarlenContext, bool]:
    """`make_varlen_context`, and whether this call built the context."""
    if len(key) != 32:
        raise ValueError("AES-256 key required")
    cache_key = (bytes(key), bytes(aad), bucket_max_bytes(max_bytes))
    ctx = _VARLEN_CONTEXTS.get(cache_key)
    if ctx is not None:
        return ctx, False
    return _VARLEN_CONTEXTS.put(cache_key, _varlen_context_cached(*cache_key)), True


def make_varlen_context(key: bytes, aad: bytes, max_bytes: int) -> GcmVarlenContext:
    return lookup_varlen_context(key, aad, max_bytes)[0]


def context_from_numpy(src):
    """This package's context from the numpy fields of an equivalent context
    object (e.g. the JAX package's GcmContext / GcmVarlenContext): the way
    state is carried across, so both packages run on identical operands."""
    mats = tuple(np.ascontiguousarray(np.asarray(m, dtype=np.int8)) for m in src.agg_mats)
    step = None if src.step_mat is None else np.ascontiguousarray(
        np.asarray(src.step_mat, dtype=np.int8)
    )
    rk = np.ascontiguousarray(np.asarray(src.round_keys, dtype=np.uint8))
    if hasattr(src, "m_cap"):
        return GcmVarlenContext(
            round_keys=rk,
            aad_blocks=np.ascontiguousarray(np.asarray(src.aad_blocks, dtype=np.uint8)),
            agg_mats=mats,
            h_mat=np.ascontiguousarray(np.asarray(src.h_mat, dtype=np.int8)),
            aad_bit_len=int(src.aad_bit_len),
            max_bytes=int(src.max_bytes),
            m_max=int(src.m_max),
            m_cap=int(src.m_cap),
            step_mat=step,
        )
    return GcmContext(
        round_keys=rk,
        agg_mats=mats,
        final_mat=np.ascontiguousarray(np.asarray(src.final_mat, dtype=np.int8)),
        const_bits=np.ascontiguousarray(np.asarray(src.const_bits, dtype=np.uint8)),
        chunk_bytes=int(src.chunk_bytes),
        n_blocks=int(src.n_blocks),
        step_mat=step,
    )


# --- device-resident constants (once per context and device) ---


@dataclasses.dataclass
class _DeviceConsts:
    round_keys: torch.Tensor        # uint8[15, 16]
    ghash: GhashOperands            # level-1 operand + fold matrix (+ packings)
    ladder: tuple                   # float32 levels >= 2 (only without a fold matrix)
    fold: torch.Tensor              # float32[128,128]: ×H² (fixed) or ×H (varlen)
    const_bits: Optional[torch.Tensor]  # uint8[128] (fixed)
    aad_blocks: Optional[torch.Tensor]  # uint8[m_A, 16] (varlen)


_DEVICE_CONSTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_CONSTS_MU = new_lock("gcm._CONSTS_MU")


def _host_tensor(array, dtype, device: torch.device) -> torch.Tensor:
    """A host array (caller-supplied IVs or lengths, a context's numpy
    constants) copied to `device` as a fresh tensor of numpy `dtype` (None
    keeps the array's own)."""
    return torch.from_numpy(np.array(array, dtype=dtype)).to(device)


def _device_consts(ctx, device: torch.device) -> _DeviceConsts:
    key = str(device)
    with _CONSTS_MU:
        per_device = _DEVICE_CONSTS.setdefault(ctx, {})
        if key in per_device:
            return per_device[key]

    def put(a, dtype=None):
        t = _host_tensor(a, None, device)
        return t if dtype is None else t.to(dtype)

    step = None if ctx.step_mat is None else put(ctx.step_mat)
    varlen = isinstance(ctx, GcmVarlenContext)
    consts = _DeviceConsts(
        round_keys=put(ctx.round_keys),
        ghash=GhashOperands.build(put(ctx.agg_mats[0]), step),
        ladder=() if step is not None else tuple(
            put(m, torch.float32) for m in ctx.agg_mats[1:]
        ),
        fold=put(ctx.h_mat if varlen else ctx.final_mat, torch.float32),
        const_bits=None if varlen else put(ctx.const_bits),
        aad_blocks=put(ctx.aad_blocks) if varlen else None,
    )
    with _CONSTS_MU:
        _DEVICE_CONSTS.setdefault(ctx, {})[key] = consts
    return consts


# --- glue ---

def _bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """uint8[B, 8n] bits (MSB first per byte) -> uint8[B, n], without shifts.
    The weights 128..1 are made on the device: a tensor built from a Python
    list is a pageable host->device copy, which would make the host wait for
    the window's kernels and stall the staging pipeline."""
    b = bits.reshape(bits.shape[0], -1, 8).to(torch.int32)
    weights = 2 ** torch.arange(7, -1, -1, dtype=torch.int32, device=bits.device)
    return (b * weights).sum(dim=-1).to(torch.uint8)


def _mod2_matmul(bits: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """uint8 bits [N, k] x float32 0/1 matrix [k, n] -> uint8 bits [N, n] (mod 2;
    sums ≤ k ≤ 16384 are exact in float32)."""
    return ((bits.to(torch.float32) @ mat).to(torch.int32) & 1).to(torch.uint8)


def _ghash_grouped(data: torch.Tensor, dc: _DeviceConsts) -> torch.Tensor:
    """data uint8[B, L] -> T(C) = Σ C_i H^(m-1-i) as bits uint8[B, 128], where
    C is the L bytes zero-padded to m = ceil(L/16) blocks.

    The blocks are left-padded with zero blocks to G groups of k1 blocks
    (leading zero blocks are the polynomial's identity). With more than one
    aggregation level the CUDA tree kernel does the whole reduction; else
    the level-1 kernel makes the group nodes and the torch ladder
    contracts them k blocks at a time (gf128.ghash_agg_matrices)."""
    batch, length = data.shape
    k_bytes = dc.ghash.k_bytes
    k1 = k_bytes // 16
    m = _ceil_div(length, 16)
    g = _ceil_div(m, k1)
    padded_len = g * k_bytes
    if padded_len == length and data.is_contiguous():
        padded = data
    else:
        pad = (g * k1 - m) * 16
        padded = torch.zeros((batch, padded_len), dtype=torch.uint8, device=data.device)
        padded[:, pad : pad + length] = data
    if dc.ghash.step is not None and g > 1 and use_ghash_tree(batch, g, k_bytes):
        return ghash_tree(padded, dc.ghash)
    x = ghash_level1(padded.reshape(batch * g, k_bytes), dc.ghash).reshape(batch, g, 128)
    if g > 1 and not dc.ladder:
        raise ValueError(f"{g} groups need the tree kernel or ladder operands")
    for w in dc.ladder:
        k = w.shape[0] // 128
        cur = x.shape[1]
        groups = _ceil_div(cur, k)
        pad = groups * k - cur
        if pad:
            x = torch.cat(
                [torch.zeros((batch, pad, 128), dtype=torch.uint8, device=x.device), x], dim=1
            )
        x = _mod2_matmul(x.reshape(batch * groups, k * 128), w).reshape(batch, groups, 128)
    return x[:, 0, :]


def _gcm_process_batch(
    dc: _DeviceConsts, ivs: torch.Tensor, data: torch.Tensor, *,
    chunk_bytes: int, n_blocks: int, decrypt: bool,
) -> torch.Tensor:
    """Fixed-size core: data uint8[B, chunk_bytes] (may be a strided view of
    the packed window) is replaced IN PLACE by the output; returns the tags
    uint8[B, 16], always computed over the ciphertext (the input when
    decrypting, the output when encrypting)."""
    batch = data.shape[0]
    ks = ctr_keystream_batch(dc.round_keys, ivs, 1, n_blocks + 1)  # [B, n_blocks+1, 16]
    tag_mask = ks[:, 0, :]
    keystream = ks[:, 1:, :].reshape(batch, n_blocks * 16)[:, :chunk_bytes]
    if decrypt:
        t_c = _ghash_grouped(data, dc)
        data.bitwise_xor_(keystream)
    else:
        data.bitwise_xor_(keystream)
        t_c = _ghash_grouped(data, dc)
    ghash = _mod2_matmul(t_c, dc.fold) ^ dc.const_bits
    return _bits_to_bytes(ghash) ^ tag_mask


def _device_len_blocks(lengths: torch.Tensor, aad_bit_len: int) -> torch.Tensor:
    """uint8[B, 16] GCM length blocks: 64-bit big-endian AAD and ciphertext
    bit lengths, computed in int64 (no uint32 shifts) and wholly on the
    device (no host->device copy, which would wait for earlier kernels)."""
    device = lengths.device
    aad_bits = torch.full_like(lengths, aad_bit_len, dtype=torch.int64)
    halves = torch.stack([aad_bits, lengths.to(torch.int64) * 8], dim=1)  # [B, 2]
    shifts = torch.arange(56, -8, -8, dtype=torch.int64, device=device)
    return ((halves[:, :, None] >> shifts) & 0xFF).to(torch.uint8).reshape(-1, 16)


def _gcm_varlen_batch(
    dc: _DeviceConsts, ivs: torch.Tensor, data: torch.Tensor, lengths: torch.Tensor,
    len_blocks: torch.Tensor, *, max_bytes: int, m_max: int, m_a: int, m_cap: int,
    decrypt: bool,
) -> torch.Tensor:
    """Variable-length core: data uint8[B, max_bytes] left-aligned with a zero
    tail, lengths int64[B]. The data is replaced IN PLACE by the masked
    output; returns the tags uint8[B, 16].

    Each row's GHASH sequence [AAD blocks, C blocks, length block] is built
    left-aligned, then rotated right so it ends at the last slot — leading
    zero blocks don't change the polynomial, so one fixed-shape reduction
    tags every row whatever its length."""
    batch = data.shape[0]
    device = data.device
    ks = ctr_keystream_batch(dc.round_keys, ivs, 1, m_max + 1)
    tag_mask = ks[:, 0, :]
    keystream = ks[:, 1:, :].reshape(batch, m_max * 16)[:, :max_bytes]
    byte_mask = (
        torch.arange(max_bytes, device=device)[None, :] < lengths[:, None]
    ).to(torch.uint8)

    def sequence(ct: torch.Tensor) -> torch.Tensor:
        seq = torch.zeros((batch, m_cap, 16), dtype=torch.uint8, device=device)
        seq[:, :m_a] = dc.aad_blocks
        seq[:, m_a : m_a + m_max] = ct.reshape(batch, m_max, 16)
        return seq

    if decrypt:
        seq = sequence(data)  # the ciphertext, before it is overwritten
        data.bitwise_xor_(keystream).mul_(byte_mask)
    else:
        data.bitwise_xor_(keystream).mul_(byte_mask)
        seq = sequence(data)
    # Place each row's length block right after its data blocks.
    l_pos = m_a + (lengths + 15) // 16
    rows = torch.arange(batch, device=device)
    seq[rows, l_pos] ^= len_blocks
    # Rotate right so the sequence ends at slot m_cap-1.
    shift = m_cap - (l_pos + 1)
    idx = (torch.arange(m_cap, device=device)[None, :] - shift[:, None]) % m_cap
    seq = torch.gather(seq, 1, idx[:, :, None].expand(batch, m_cap, 16))
    t = _ghash_grouped(seq.reshape(batch, m_cap * 16), dc)
    return _bits_to_bytes(_mod2_matmul(t, dc.fold)) ^ tag_mask


# --- dispatch accounting ---

#: Window-program launches issued by this module's entry points (each is
#: keystream kernel + GHASH kernel + glue) and the payload-scale
#: intermediates they planned. The process-wide totals are guarded (the
#: fetch tiers decrypt on pool threads, which would tear a bare increment);
#: the per-thread counts are the backend's delta source, so one window never
#: absorbs a sibling thread's launches into its own count.
_DISPATCHES = [0]
_ROUNDTRIPS = [0]
_DISPATCH_MU = new_lock("gcm._DISPATCH_MU")
_COUNTERS = threading.local()


def device_dispatches() -> int:
    """Total GCM window-program launches issued so far in this process, on
    every thread."""
    with _DISPATCH_MU:
        return _DISPATCHES[0]


def thread_dispatches() -> int:
    """GCM launches issued by the CALLING thread."""
    return getattr(_COUNTERS, "dispatches", 0)


def device_hbm_roundtrips() -> int:
    """Total payload-scale intermediates planned so far in this process, on
    every thread."""
    with _DISPATCH_MU:
        return _ROUNDTRIPS[0]


def thread_hbm_roundtrips() -> int:
    return getattr(_COUNTERS, "roundtrips", 0)


def _count_dispatch() -> None:
    with _DISPATCH_MU:
        _DISPATCHES[0] += 1
    _COUNTERS.dispatches = thread_dispatches() + 1


def _count_roundtrips(n: int) -> None:
    with _DISPATCH_MU:
        _ROUNDTRIPS[0] += n
    _COUNTERS.roundtrips = thread_hbm_roundtrips() + n


def planned_hbm_roundtrips(ctx, rows: int, *, packed: bool = True) -> int:
    """Payload-scale intermediates one window program writes to device memory
    besides its in-place output (static host logic that mirrors the branches
    above; `rows` is the rows ONE program runs — a member's rows under a
    mesh — and only decides tree eligibility):

    - 1 — the keystream, written by the AES kernel and read by the XOR;
    - fixed windows: +1 for the GHASH input, copied from the packed rows
      into the [B, G*K] layout the kernels read (``packed=False``, the
      op-level entry points' contiguous rows, copy only to left-pad to
      whole groups);
    - varlen windows: +2 for the assembled and the rotated sequence, and +1
      more when the sequence must be left-padded to whole groups;
    - +1 per ladder level ≥ 2 when the tree kernel does not engage (a
      context without a fold matrix)."""
    varlen = isinstance(ctx, GcmVarlenContext)
    m = ctx.m_cap if varlen else ctx.n_blocks
    k1 = ctx.agg_mats[0].shape[1] // 16
    g = _ceil_div(m, k1)
    count = 1
    if varlen:
        count += 2 + (1 if g * k1 != m else 0)
    elif packed or g * k1 != m:
        count += 1
    tree = ctx.step_mat is not None and g > 1 and use_ghash_tree(rows, g, k1 * 16)
    if not tree:
        count += len(ctx.agg_mats) - 1
    return count


# --- op-level entry points (host arrays in, tensors out) ---


def _op_device(array, device) -> torch.device:
    """Where an op-level call runs: `device` when given, else a tensor
    argument's own device, else `cuda:0` (without CUDA that raises; pass
    device="cpu" for the plain versions)."""
    from tieredstorage_tpu_torch.transform.api import DEFAULT_DEVICE, resolve_device

    if device is None:
        device = array.device if isinstance(array, torch.Tensor) else DEFAULT_DEVICE
    return resolve_device(device)


def _rows_on(array, device: torch.device) -> torch.Tensor:
    """A fresh uint8 tensor of `array`'s rows on `device` (the programs write
    their output in place, so the caller's array is never aliased)."""
    if isinstance(array, torch.Tensor):
        return array.to(device=device, dtype=torch.uint8, copy=True)
    return torch.from_numpy(np.array(array, dtype=np.uint8)).to(device)


def _chunks(ctx: GcmContext, ivs, data, device, *, decrypt: bool):
    device = _op_device(data, device)
    rows = _rows_on(data, device)
    if rows.dim() != 2 or rows.shape[1] != ctx.chunk_bytes:
        raise ValueError(f"chunks must be uint8[B, {ctx.chunk_bytes}], got {tuple(rows.shape)}")
    dc = _device_consts(ctx, device)
    _count_dispatch()
    _count_roundtrips(planned_hbm_roundtrips(ctx, rows.shape[0], packed=False))
    tags = _gcm_process_batch(
        dc, _rows_on(ivs, device), rows, chunk_bytes=ctx.chunk_bytes,
        n_blocks=ctx.n_blocks, decrypt=decrypt,
    )
    return rows, tags


def gcm_encrypt_chunks(ctx: GcmContext, ivs, plaintext, *, device=None):
    """plaintext uint8[B, ctx.chunk_bytes], ivs uint8[B, 12] ->
    (ciphertext uint8[B, chunk_bytes], tags uint8[B, 16]) as tensors on
    the device the call ran on (`device`, else the input tensor's, else
    `cuda:0`). One dispatch: the CUDA keystream and GHASH kernels."""
    return _chunks(ctx, ivs, plaintext, device, decrypt=False)


def gcm_decrypt_chunks(ctx: GcmContext, ivs, ciphertext, *, device=None):
    """Returns (plaintext uint8[B, chunk_bytes], expected_tags uint8[B, 16]).
    The caller compares expected_tags against the received tags."""
    return _chunks(ctx, ivs, ciphertext, device, decrypt=True)


def _host_len_blocks(ctx: GcmVarlenContext, lengths: np.ndarray) -> np.ndarray:
    out = np.zeros((len(lengths), 16), dtype=np.uint8)
    for i, n in enumerate(lengths):
        out[i] = np.frombuffer(
            ctx.aad_bit_len.to_bytes(8, "big") + (int(n) * 8).to_bytes(8, "big"),
            dtype=np.uint8,
        )
    return out


def _run_varlen(ctx: GcmVarlenContext, ivs, data, lengths, decrypt: bool, device=None):
    device = _op_device(data, device)
    lengths = np.asarray(
        lengths.cpu().numpy() if isinstance(lengths, torch.Tensor) else lengths, dtype=np.int64
    )
    rows = _rows_on(data, device)
    if rows.dim() != 2 or rows.shape[1] != ctx.max_bytes:
        raise ValueError(f"rows must be uint8[B, {ctx.max_bytes}], got {tuple(rows.shape)}")
    dc = _device_consts(ctx, device)
    _count_dispatch()
    _count_roundtrips(planned_hbm_roundtrips(ctx, len(lengths)))
    tags = _gcm_varlen_batch(
        dc, _rows_on(ivs, device), rows, torch.from_numpy(lengths).to(device),
        torch.from_numpy(_host_len_blocks(ctx, lengths)).to(device),
        max_bytes=ctx.max_bytes, m_max=ctx.m_max, m_a=ctx.aad_blocks.shape[0],
        m_cap=ctx.m_cap, decrypt=decrypt,
    )
    return rows, tags


def gcm_encrypt_varlen(ctx: GcmVarlenContext, ivs, plaintext, lengths, *, device=None):
    """plaintext uint8[B, ctx.max_bytes] (rows zero-padded past their length)
    -> (masked ciphertext, tags) as tensors (device as `gcm_encrypt_chunks`)."""
    return _run_varlen(ctx, ivs, plaintext, lengths, decrypt=False, device=device)


def gcm_decrypt_varlen(ctx: GcmVarlenContext, ivs, ciphertext, lengths, *, device=None):
    """Returns (plaintext, expected_tags) — caller verifies tags."""
    return _run_varlen(ctx, ivs, ciphertext, lengths, decrypt=True, device=device)


# --- packed windows (the transform backend's path) ---


def _window_target(data_packed: torch.Tensor, donate: bool) -> torch.Tensor:
    if data_packed.dtype != torch.uint8 or data_packed.dim() != 2:
        raise ValueError("packed windows are uint8[B, n_bytes + 16]")
    return data_packed if donate else data_packed.clone()


def _fixed_window(ctx: GcmContext, ivs, data_packed: torch.Tensor, *, decrypt: bool,
                  donate: bool) -> torch.Tensor:
    """One fixed-size window program on one device (uncounted)."""
    n = ctx.chunk_bytes
    if data_packed.shape[1] != n + TAG_SIZE:
        raise ValueError(f"packed width {data_packed.shape[1]} != {n + TAG_SIZE}")
    device = data_packed.device
    dc = _device_consts(ctx, device)
    if ivs is None:
        ivs = data_packed[:, n : n + 12].contiguous()
    else:
        ivs = _host_tensor(ivs, np.uint8, device)
    target = _window_target(data_packed, donate)
    tags = _gcm_process_batch(
        dc, ivs, target[:, :n], chunk_bytes=n, n_blocks=ctx.n_blocks, decrypt=decrypt
    )
    target[:, n:] = tags
    return target


def _varlen_window(ctx: GcmVarlenContext, ivs, data_packed: torch.Tensor, lengths, *,
                   decrypt: bool, donate: bool) -> torch.Tensor:
    """One variable-length window program on one device (uncounted)."""
    mb = ctx.max_bytes
    if data_packed.shape[1] != mb + TAG_SIZE:
        raise ValueError(f"packed width {data_packed.shape[1]} != {mb + TAG_SIZE}")
    device = data_packed.device
    dc = _device_consts(ctx, device)
    if ivs is None:
        ivs = data_packed[:, mb : mb + 12].contiguous()
    else:
        ivs = _host_tensor(ivs, np.uint8, device)
    if lengths is None:
        lb = data_packed[:, mb + 12 : mb + 16].to(torch.int64)
        lengths = lb[:, 0] | (lb[:, 1] << 8) | (lb[:, 2] << 16) | (lb[:, 3] << 24)
    else:
        lengths = _host_tensor(lengths, np.int64, device)
    target = _window_target(data_packed, donate)
    tags = _gcm_varlen_batch(
        dc, ivs, target[:, :mb], lengths, _device_len_blocks(lengths, ctx.aad_bit_len),
        max_bytes=mb, m_max=ctx.m_max, m_a=ctx.aad_blocks.shape[0], m_cap=ctx.m_cap,
        decrypt=decrypt,
    )
    target[:, mb:] = tags
    return target


def _require_tail_metadata(*side_args) -> None:
    if any(a is not None for a in side_args):
        raise ValueError(
            "sharded packed windows read per-row metadata from the packed "
            "tail columns: pass ivs=None (and lengths=None) so the window "
            "crosses the host->device link as one row-sharded buffer"
        )


def _sharded(mesh, ctx, program):
    """Run `program(shard)` on every member of `mesh` over its own rows (the
    JAX package's shard_map over the row axis). Every row is independent —
    keystream, XOR, GHASH and tag are row-local — so no collective is
    needed. The constants are made per device before the fan-out (members
    on one device share them), on the caller's stream, which each member's
    stream waits for."""
    from tieredstorage_tpu_torch.parallel.mesh import run_on_members

    def run(shards):
        for device in dict.fromkeys(mesh.devices):
            _device_consts(ctx, device)
        return run_on_members(mesh, program, shards)

    return run


def _packed_fixed_sharded(mesh, ctx: GcmContext, *, decrypt: bool, donate: bool):
    """`gcm_window_packed` fanned out over a mesh: each member's program
    writes its output into its own staged rows, so a donated window stays
    donated at any mesh size."""
    return _sharded(mesh, ctx, lambda shard: _fixed_window(
        ctx, None, shard, decrypt=decrypt, donate=donate))


def _packed_varlen_sharded(mesh, ctx: GcmVarlenContext, *, decrypt: bool, donate: bool):
    """Varlen counterpart of `_packed_fixed_sharded`: per-row lengths ride
    the packed tail, so each member rebuilds its own GCM length blocks and
    no exchange between members is needed."""
    return _sharded(mesh, ctx, lambda shard: _varlen_window(
        ctx, None, shard, None, decrypt=decrypt, donate=donate))


def _mesh_shards(mesh, data_packed) -> list:
    from tieredstorage_tpu_torch.parallel.mesh import shard_rows

    if isinstance(data_packed, torch.Tensor):
        return shard_rows(mesh, data_packed)
    shards = list(data_packed)
    if len(shards) != mesh.size or len({s.shape[0] for s in shards}) != 1:
        raise ValueError(f"a split window needs {mesh.size} shards of equal rows")
    return shards


def gcm_window_packed(
    ctx: GcmContext, ivs, data_packed, *, decrypt: bool, donate: bool = False,
    mesh=None,
):
    """Fixed-size window: data_packed uint8[B, chunk_bytes + 16] -> packed
    uint8[B, chunk_bytes + 16] where row i is `output_i || tag_i`. With
    ivs=None the per-row IV is read from the tail (bytes [chunk_bytes,
    chunk_bytes + 12)); otherwise the tail is ignored. The tag is over the
    ciphertext in both directions (expected tag on decrypt; the caller
    verifies). `donate=True` writes the result into data_packed itself.

    With `mesh` (a `parallel.mesh.DeviceMesh`; metadata in the tail) the
    window is row-split over the members: data_packed is the list of
    per-member shards (`shard_rows`), or a tensor to split, and the result
    is the list of per-member outputs in row order. It is ONE logical
    dispatch at any mesh size; `_cuda.launch_counts()` counts each
    member's kernel launches."""
    if mesh is not None:
        _require_tail_metadata(ivs)
        shards = _mesh_shards(mesh, data_packed)
        _count_dispatch()
        _count_roundtrips(planned_hbm_roundtrips(ctx, shards[0].shape[0]))
        return _packed_fixed_sharded(mesh, ctx, decrypt=decrypt, donate=donate)(shards)
    _count_dispatch()
    _count_roundtrips(planned_hbm_roundtrips(ctx, data_packed.shape[0]))
    return _fixed_window(ctx, ivs, data_packed, decrypt=decrypt, donate=donate)


def gcm_varlen_window_packed(
    ctx: GcmVarlenContext, ivs, data_packed, lengths, *,
    decrypt: bool, donate: bool = False, mesh=None,
):
    """Variable-length window: data_packed uint8[B, max_bytes + 16] (rows
    left-aligned with a ZERO payload tail — GHASH requires it) -> packed
    `masked output || tag` rows. With ivs=None and lengths=None the per-row
    metadata rides the tail ([iv 12 B][length u32 LE 4 B]) and the GCM
    length blocks are rebuilt on the device. Same single-dispatch, donation
    and `mesh` contract as `gcm_window_packed` (split windows require the
    tail-metadata form)."""
    if mesh is not None:
        _require_tail_metadata(ivs, lengths)
        shards = _mesh_shards(mesh, data_packed)
        _count_dispatch()
        _count_roundtrips(planned_hbm_roundtrips(ctx, shards[0].shape[0]))
        return _packed_varlen_sharded(mesh, ctx, decrypt=decrypt, donate=donate)(shards)
    _count_dispatch()
    _count_roundtrips(planned_hbm_roundtrips(ctx, data_packed.shape[0]))
    return _varlen_window(ctx, ivs, data_packed, lengths, decrypt=decrypt, donate=donate)
