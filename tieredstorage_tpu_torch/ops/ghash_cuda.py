"""GHASH reductions: the CUDA tree and level-1 kernels, and their plain versions.

Counterpart of tieredstorage_tpu/ops/ghash_pallas.py. Both reductions
contract a row's bytes against the level-1 operand w1 int8[8, K, 128]
(gf128.ghash_agg_matrices): node bit o of a K-byte group is the parity of
Σ_{p,k} bit_p(byte_k) · w1[p, k, o].

- `ghash_level1(data, ops)`: data uint8[R, K] -> node bits uint8[R, 128]
  (csrc/ghash.cu `ghash_level1_kernel`, replacing `_ghash_l1_kernel`).
- `ghash_tree(data, ops)`: data uint8[B, G*K] -> T(C) bits uint8[B, 128], the
  whole reduction T = Σ_g node_g · M^(G-1-g), M = M_{H^(K/16)}: slices of S
  groups (the kernel's `_cuda.tree_slice()`), counted from the end of the
  row, each folded with M; then the row's slice partials folded in order
  with M^S (csrc/ghash.cu `ghash_tree_slices_kernel` +
  `ghash_tree_combine_kernel`, one launch call, replacing
  `_ghash_tree_kernel`). Zero groups in front of a row are the fold's
  identity.

`GhashOperands` carries w1 and the fold matrix on one device and, on a CUDA
device, their bit-column packings for the kernels and the packed power M^S
(built once per context, on that device).
For a CPU tensor each wrapper takes its plain version — float32 matmuls
whose sums (at most 8K ≤ 16384, and 128 for the fold) are exact.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# The plain versions and the GCM glue contract bits with float32 matmuls,
# which are exact only in full float32: keep TF32 off for both matmul paths.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: The fused tree's group width limit: the aggregation plan caps a level-1
#: group at 128 blocks = 2048 bytes.
MAX_TREE_K = 2048


def use_ghash_tree(batch: int, groups: int, k_bytes: int) -> bool:
    """Shape eligibility of the tree kernel (same rule as the JAX package's
    `use_pallas_ghash_tree`): a group width the level-1 plan can produce,
    and at least two groups — one group is a plain level-1 pass."""
    return (
        0 < k_bytes <= MAX_TREE_K
        and k_bytes % 128 == 0
        and groups >= 2
        and batch >= 1
    )


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 bit pattern -> int32 with the same bits."""
    return (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def pack_w1(w1: torch.Tensor) -> torch.Tensor:
    """int8[8, K, 128] -> int32[K/16, 128, 4]: entry [q, o, j] holds, at bit
    8*i + p, w1[p, 16*q + 4*j + i, o] (the layout csrc/ghash.cu reads)."""
    _, k, _ = w1.shape
    bits = w1.to(torch.int64).reshape(8, k // 4, 4, 128)  # [p, word, i, o]
    shift = (8 * torch.arange(4, device=w1.device)[:, None]
             + torch.arange(8, device=w1.device)[None, :])  # [i, p]
    words = (bits.permute(1, 3, 2, 0) << shift).sum(dim=(2, 3))  # [word, o]
    return _to_int32(words).reshape(k // 16, 4, 128).permute(0, 2, 1).contiguous()


def pack_step(step: torch.Tensor) -> torch.Tensor:
    """int8[128, 128] fold matrix -> int32[128, 4]: [o, w] bit l = step[32w + l, o]."""
    bits = step.to(torch.int64).t().reshape(128, 4, 32)
    shift = torch.arange(32, device=step.device)
    return _to_int32((bits << shift).sum(dim=2)).contiguous()


def step_power(step: torch.Tensor, exponent: int) -> torch.Tensor:
    """int8[128, 128] fold matrix M -> M^exponent (mod 2) for a power-of-two
    exponent, by repeated squaring in float32 on step's device (sums ≤ 128
    are exact; TF32 is off)."""
    if exponent < 1 or exponent & (exponent - 1):
        raise ValueError(f"exponent must be a power of two, got {exponent}")
    m = step.to(torch.float32)
    for _ in range(exponent.bit_length() - 1):
        m = torch.remainder(m @ m, 2)
    return m.to(torch.int8)


@dataclasses.dataclass(frozen=True)
class GhashOperands:
    """w1 int8[8, K, 128] and the fold matrix M int8[128, 128] (or None) on
    one device, plus, when that device is a GPU, their packed forms and the
    packed power M^S for the tree kernel's S groups per slice."""

    w1: torch.Tensor
    step: Optional[torch.Tensor] = None
    w1_words: Optional[torch.Tensor] = None
    step_words: Optional[torch.Tensor] = None
    slice_step_words: Optional[torch.Tensor] = None

    @staticmethod
    def build(w1: torch.Tensor, step: Optional[torch.Tensor]) -> "GhashOperands":
        if w1.dim() != 3 or w1.shape[0] != 8 or w1.shape[2] != 128 or w1.shape[1] % 16:
            raise ValueError(f"w1 must be int8[8, K, 128] with K a multiple of 16, got {tuple(w1.shape)}")
        if w1.device.type != "cuda":
            return GhashOperands(w1, step)
        if step is None:
            return GhashOperands(w1, None, pack_w1(w1))
        from tieredstorage_tpu_torch.ops import _cuda

        return GhashOperands(
            w1, step, pack_w1(w1), pack_step(step), pack_step(step_power(step, _cuda.tree_slice()))
        )

    @property
    def k_bytes(self) -> int:
        return self.w1.shape[1]


# --- plain versions ---


def ghash_level1_plain(data: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """data uint8[R, K], w1 int8[8, K, 128] -> node bits uint8[R, 128]."""
    acc = None
    w = w1.to(torch.float32)
    for p in range(8):
        plane = ((data >> p) & 1).to(torch.float32)
        part = plane @ w[p]
        acc = part if acc is None else acc + part
    return (acc.to(torch.int32) & 1).to(torch.uint8)


def ghash_tree_plain(
    data: torch.Tensor, w1: torch.Tensor, step: torch.Tensor
) -> torch.Tensor:
    """data uint8[B, G*K] -> T(C) bits uint8[B, 128]: level 1 over every
    group, then the sequential fold T = (T · step) ^ node_g."""
    rows, total = data.shape
    k = w1.shape[1]
    groups = total // k
    nodes = ghash_level1_plain(data.reshape(rows * groups, k), w1).reshape(rows, groups, 128)
    step_f = step.to(torch.float32)
    acc = nodes[:, 0].to(torch.float32)
    for g in range(1, groups):
        folded = (acc @ step_f).to(torch.int32) & 1
        acc = (folded ^ nodes[:, g].to(torch.int32)).to(torch.float32)
    return acc.to(torch.uint8)


# --- kernel wrappers ---


def _check_data(data: torch.Tensor, ops: GhashOperands) -> None:
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data must be uint8[rows, bytes], got {data.dtype} {tuple(data.shape)}")
    if data.shape[0] < 1:
        raise ValueError("rows must be positive")
    if data.device != ops.w1.device:
        raise ValueError(f"data on {data.device}, operands on {ops.w1.device}")
    if data.device.type == "cuda":
        if not data.is_contiguous() or data.data_ptr() % 16:
            raise ValueError("the GHASH kernels read 16-byte aligned contiguous rows")
        if ops.w1_words is None:
            raise ValueError("operands were built for another device")


def ghash_level1(data: torch.Tensor, ops: GhashOperands) -> torch.Tensor:
    """data uint8[R, K] -> node bits uint8[R, 128] (kernel wrapper)."""
    _check_data(data, ops)
    if data.shape[1] != ops.k_bytes:
        raise ValueError(f"data width {data.shape[1]} != K={ops.k_bytes}")
    if data.device.type == "cpu":
        return ghash_level1_plain(data, ops.w1)
    from tieredstorage_tpu_torch.ops import _cuda

    out = torch.empty((data.shape[0], 128), dtype=torch.uint8, device=data.device)
    _cuda.launch(
        "ghash_level1", data.data_ptr(), data.shape[0], ops.k_bytes,
        ops.w1_words.data_ptr(), out.data_ptr(), rows=data.shape[0],
    )
    return out


def ghash_tree(data: torch.Tensor, ops: GhashOperands) -> torch.Tensor:
    """data uint8[B, G*K] (leading zero-block padding already applied) ->
    T(C) bits uint8[B, 128] (kernel wrapper)."""
    _check_data(data, ops)
    if ops.step is None:
        raise ValueError("the tree needs the fold matrix")
    k = ops.k_bytes
    if data.shape[1] % k or data.shape[1] == 0:
        raise ValueError(f"data width {data.shape[1]} does not tile into K={k} groups")
    if data.device.type == "cpu":
        return ghash_tree_plain(data, ops.w1, ops.step)
    from tieredstorage_tpu_torch.ops import _cuda

    rows, groups = data.shape[0], data.shape[1] // k
    if rows > 65535:
        raise ValueError(f"the tree kernel takes at most 65535 rows, got {rows}")
    n_slices = -(-groups // _cuda.tree_slice())
    partials = torch.empty((rows, n_slices, 4), dtype=torch.int32, device=data.device)
    out = torch.empty((rows, 128), dtype=torch.uint8, device=data.device)
    _cuda.launch(
        "ghash_tree", data.data_ptr(), rows, groups, k, ops.w1_words.data_ptr(),
        ops.step_words.data_ptr(), ops.slice_step_words.data_ptr(), partials.data_ptr(),
        out.data_ptr(), rows=rows,
    )
    return out
