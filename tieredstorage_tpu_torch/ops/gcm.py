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


@functools.lru_cache(maxsize=64)
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


def make_context(key: bytes, aad: bytes, chunk_bytes: int) -> GcmContext:
    if len(key) != 32:
        raise ValueError("AES-256 key required")
    if chunk_bytes <= 0:
        raise ValueError("chunk_bytes must be positive")
    return _context_cached(bytes(key), bytes(aad), chunk_bytes)


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


@functools.lru_cache(maxsize=64)
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


def make_varlen_context(key: bytes, aad: bytes, max_bytes: int) -> GcmVarlenContext:
    if len(key) != 32:
        raise ValueError("AES-256 key required")
    return _varlen_context_cached(bytes(key), bytes(aad), bucket_max_bytes(max_bytes))


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
_CONSTS_MU = threading.Lock()


def _device_consts(ctx, device: torch.device) -> _DeviceConsts:
    key = str(device)
    with _CONSTS_MU:
        per_device = _DEVICE_CONSTS.setdefault(ctx, {})
        if key in per_device:
            return per_device[key]

    def put(a, dtype=None):
        t = torch.from_numpy(np.array(a)).to(device)
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

#: Window-program launches issued by this module's packed entry points
#: (each is keystream kernel + GHASH kernel + glue) and the payload-scale
#: intermediates they planned. The process-wide launch total is guarded (the
#: fetch tiers decrypt on pool threads, which would tear a bare increment);
#: the per-thread counts are the backend's delta source, so one window never
#: absorbs a sibling thread's launches into its own count.
_DISPATCHES = [0]
_DISPATCH_MU = threading.Lock()
_COUNTERS = threading.local()


def device_dispatches() -> int:
    """Total GCM window-program launches issued so far in this process, on
    every thread."""
    with _DISPATCH_MU:
        return _DISPATCHES[0]


def thread_dispatches() -> int:
    """GCM launches issued by the CALLING thread."""
    return getattr(_COUNTERS, "dispatches", 0)


def thread_hbm_roundtrips() -> int:
    return getattr(_COUNTERS, "roundtrips", 0)


def _count_dispatch(roundtrips: int) -> None:
    with _DISPATCH_MU:
        _DISPATCHES[0] += 1
    _COUNTERS.dispatches = thread_dispatches() + 1
    _COUNTERS.roundtrips = thread_hbm_roundtrips() + roundtrips


def planned_hbm_roundtrips(ctx, rows: int) -> int:
    """Payload-scale intermediates one window program writes to device memory
    besides its in-place output (static host logic that mirrors the branches
    above; `rows` only decides tree eligibility):

    - 1 — the keystream, written by the AES kernel and read by the XOR;
    - fixed windows: +1 for the GHASH input, copied from the packed rows
      into the [B, G*K] layout the kernels read;
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
    else:
        count += 1
    tree = ctx.step_mat is not None and g > 1 and use_ghash_tree(rows, g, k1 * 16)
    if not tree:
        count += len(ctx.agg_mats) - 1
    return count


# --- packed windows (the transform backend's path) ---


def _window_target(data_packed: torch.Tensor, donate: bool) -> torch.Tensor:
    if data_packed.dtype != torch.uint8 or data_packed.dim() != 2:
        raise ValueError("packed windows are uint8[B, n_bytes + 16]")
    return data_packed if donate else data_packed.clone()


def gcm_window_packed(
    ctx: GcmContext, ivs, data_packed: torch.Tensor, *, decrypt: bool,
    donate: bool = False,
) -> torch.Tensor:
    """Fixed-size window: data_packed uint8[B, chunk_bytes + 16] -> packed
    uint8[B, chunk_bytes + 16] where row i is `output_i || tag_i`. With
    ivs=None the per-row IV is read from the tail (bytes [chunk_bytes,
    chunk_bytes + 12)); otherwise the tail is ignored. The tag is over the
    ciphertext in both directions (expected tag on decrypt; the caller
    verifies). `donate=True` writes the result into data_packed itself."""
    n = ctx.chunk_bytes
    if data_packed.shape[1] != n + TAG_SIZE:
        raise ValueError(f"packed width {data_packed.shape[1]} != {n + TAG_SIZE}")
    device = data_packed.device
    dc = _device_consts(ctx, device)
    _count_dispatch(planned_hbm_roundtrips(ctx, data_packed.shape[0]))
    if ivs is None:
        ivs = data_packed[:, n : n + 12].contiguous()
    else:
        ivs = torch.from_numpy(np.array(ivs, dtype=np.uint8)).to(device)
    target = _window_target(data_packed, donate)
    tags = _gcm_process_batch(
        dc, ivs, target[:, :n], chunk_bytes=n, n_blocks=ctx.n_blocks, decrypt=decrypt
    )
    target[:, n:] = tags
    return target


def gcm_varlen_window_packed(
    ctx: GcmVarlenContext, ivs, data_packed: torch.Tensor, lengths, *,
    decrypt: bool, donate: bool = False,
) -> torch.Tensor:
    """Variable-length window: data_packed uint8[B, max_bytes + 16] (rows
    left-aligned with a ZERO payload tail — GHASH requires it) -> packed
    `masked output || tag` rows. With ivs=None and lengths=None the per-row
    metadata rides the tail ([iv 12 B][length u32 LE 4 B]) and the GCM
    length blocks are rebuilt on the device."""
    mb = ctx.max_bytes
    if data_packed.shape[1] != mb + TAG_SIZE:
        raise ValueError(f"packed width {data_packed.shape[1]} != {mb + TAG_SIZE}")
    device = data_packed.device
    dc = _device_consts(ctx, device)
    _count_dispatch(planned_hbm_roundtrips(ctx, data_packed.shape[0]))
    if ivs is None:
        ivs = data_packed[:, mb : mb + 12].contiguous()
    else:
        ivs = torch.from_numpy(np.array(ivs, dtype=np.uint8)).to(device)
    if lengths is None:
        lb = data_packed[:, mb + 12 : mb + 16].to(torch.int64)
        lengths = lb[:, 0] | (lb[:, 1] << 8) | (lb[:, 2] << 16) | (lb[:, 3] << 24)
    else:
        lengths = torch.from_numpy(np.array(lengths, dtype=np.int64)).to(device)
    target = _window_target(data_packed, donate)
    tags = _gcm_varlen_batch(
        dc, ivs, target[:, :mb], lengths, _device_len_blocks(lengths, ctx.aad_bit_len),
        max_bytes=mb, m_max=ctx.m_max, m_a=ctx.aad_blocks.shape[0], m_cap=ctx.m_cap,
        decrypt=decrypt,
    )
    target[:, mb:] = tags
    return target
