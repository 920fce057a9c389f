"""Batched canonical-Huffman encode/decode on the device (the tpu-huff-v1 core).

Counterpart of tieredstorage_tpu/ops/huffman.py. An order-0,
length-limited canonical Huffman coder batched over whole chunk windows:

- `encode_batch`: torch ops on the data's device. Per-symbol (code, length)
  is a per-row 256-entry gather, bit positions are one exclusive `cumsum`,
  and packing is two scatter-adds into uint32 words (held in int64, since
  torch has no uint32 arithmetic). Contributions of one symbol never overlap
  in bits, so add == or.
- `decode_batch`: block-parallel. The frame records the absolute bit offset
  of every JUMP_BLOCK-symbol block, so each (row, block) lane decodes its
  block's symbols in sequence while all lanes run at once. On a CUDA tensor
  the wrapper launches csrc/huffman.cu (a per-row table of every 15-bit
  window's (length, symbol), then JUMP_BLOCK dependent steps of a
  shared-memory lookup per lane, or, for calls of few lanes, 16 threads per
  lane that split its bits and resynchronise); on a CPU tensor it takes
  `decode_batch_plain`, the same scan as JUMP_BLOCK steps of torch ops.

Codes are stored bit-reversed so the stream reads MSB-first; the canonical
(first_code, counts, base, perm) tables per row make length detection a
15-way range test, no tree walk. Host-side table construction
(length-limited package-merge) lives in transform/thuff.py.
"""

from __future__ import annotations

import torch

#: Symbols per independently-decodable block (the frame stores one absolute
#: bit offset per block; 4 B per 4096 symbols ≈ 0.1% overhead).
JUMP_BLOCK = 4096

MAX_CODE_LEN = 15

#: Entries of the kernel's per-row decode table: one per 15-bit window.
TABLE_ENTRIES = 1 << MAX_CODE_LEN

#: Hard per-chunk cap of the v1 frame format: bit positions are int32
#: (worst case MAX_CODE_LEN bits/symbol -> 128 MiB * 15 < 2^31) and the
#: jump-table count is u16 (128 MiB / JUMP_BLOCK = 32768 <= 65535).
MAX_CHUNK_BYTES = 128 << 20

_U32 = 0xFFFFFFFF


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def max_words(n_max: int) -> int:
    """Worst-case payload words for n_max symbols (15 bits each)."""
    return _ceil_div(n_max * MAX_CODE_LEN, 32) + 1


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 with the same bit patterns."""
    return (((x & _U32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def encode_batch(
    data: torch.Tensor,       # uint8[B, n_max], zero-padded past n_sym
    n_sym: torch.Tensor,      # int[B]
    codes_rev: torch.Tensor,  # int[B, 256] bit-reversed canonical codes
    lengths: torch.Tensor,    # int[B, 256] code lengths (0 for absent syms)
):
    """Returns (words int64[B, W] holding uint32 values, total_bits int64[B],
    jump int64[B, J]), all on data's device, W = max_words(n_max).

    jump[b, j] is the absolute bit offset of symbol j*JUMP_BLOCK — the
    per-block entry points the parallel decoder starts from. As in the JAX
    op, padding positions past n_sym add their symbol's code at the stream's
    end bit (the bits past total_bits are not part of the frame)."""
    batch, n_max = data.shape
    device = data.device
    idx = data.long()
    lengths = lengths.to(device=device, dtype=torch.int64)
    codes_rev = codes_rev.to(device=device, dtype=torch.int64)
    n_sym = n_sym.to(device=device, dtype=torch.int64)
    sym_len = torch.gather(lengths, 1, idx)
    sym_code = torch.gather(codes_rev, 1, idx)
    del idx
    valid = torch.arange(n_max, device=device)[None, :] < n_sym[:, None]
    sym_len = torch.where(valid, sym_len, 0)
    del valid

    end_bits = torch.cumsum(sym_len, dim=1)
    bitpos = end_bits - sym_len  # exclusive prefix sum
    del sym_len
    total_bits = end_bits[:, -1].clone()
    del end_bits

    w = max_words(n_max)
    word_idx = bitpos >> 5
    shift = bitpos & 31
    lo = (sym_code << shift) & _U32
    # code >> (32 - s); s == 0 must yield 0 (no spill into the next word).
    hi = torch.where(shift == 0, 0, sym_code >> (32 - shift.clamp(min=1)))
    del shift, sym_code
    # One spare column takes the drops of the JAX op's out-of-range adds.
    words = torch.zeros((batch, w + 1), dtype=torch.int64, device=device)
    words.scatter_add_(1, word_idx, lo)
    words.scatter_add_(1, word_idx + 1, hi)
    del lo, hi, word_idx
    words = words[:, :w] & _U32

    jump = bitpos[:, ::JUMP_BLOCK].clone()
    return words, total_bits, jump


def _bitrev15(v: torch.Tensor) -> torch.Tensor:
    """Reverse the low 15 bits of a uint32 held in int64 (result in the low
    15 bits)."""
    v = ((v & 0x55555555) << 1) | ((v >> 1) & 0x55555555)
    v = ((v & 0x33333333) << 2) | ((v >> 2) & 0x33333333)
    v = ((v & 0x0F0F0F0F) << 4) | ((v >> 4) & 0x0F0F0F0F)
    v = ((v & 0x00FF00FF) << 8) | ((v >> 8) & 0x00FF00FF)
    v = ((v << 16) | (v >> 16)) & _U32
    return v >> 17  # 32-bit reversal, keep the top 15 of the reversed low 15


def _check_decode_operands(words, jump, first_code, counts, base, perm) -> None:
    batch = words.shape[0]
    if words.dim() != 2 or words.shape[1] < 2:
        raise ValueError(f"words must be [B, W >= 2], got {tuple(words.shape)}")
    if jump.dim() != 2 or jump.shape[0] != batch:
        raise ValueError(f"jump must be [B={batch}, J], got {tuple(jump.shape)}")
    for name, t, width in (("first_code", first_code, 16), ("counts", counts, 16),
                           ("base", base, 16), ("perm", perm, 256)):
        if tuple(t.shape) != (batch, width):
            raise ValueError(f"{name} must be [{batch}, {width}], got {tuple(t.shape)}")
    devices = {t.device for t in (words, jump, first_code, counts, base, perm)}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")


def decode_batch(words, jump, first_code, counts, base, perm):
    """words uint32[B, W] as int32 bit patterns (or int64 values), jump
    int32[B, J] absolute bit offsets per block, the canonical tables int32
    [B, 16] x 3 and perm int32[B, 256] -> (symbols uint8[B, J * JUMP_BLOCK],
    final_bitpos int32[B, J]) (kernel wrapper).

    Pad rows and tails are garbage; callers slice to their per-row n_sym.
    final_bitpos[b, j] is the bit position after block j's JUMP_BLOCK
    symbols — for full blocks it must equal jump[b, j+1] (and the frame's
    total bits for an exactly-full last block), which is the decoder's
    corruption check. CPU tensors take `decode_batch_plain`; CUDA tensors
    launch csrc/huffman.cu or raise."""
    _check_decode_operands(words, jump, first_code, counts, base, perm)
    if words.device.type == "cpu":
        return decode_batch_plain(words, jump, first_code, counts, base, perm)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    from tieredstorage_tpu_torch.ops import _cuda

    batch, w = words.shape
    n_blocks = jump.shape[1]
    words = to_int32_bits(words) if words.dtype == torch.int64 else words
    ops = [t.to(torch.int32).contiguous() for t in (words, jump, first_code, counts, base, perm)]
    symbols = torch.empty((batch, n_blocks * JUMP_BLOCK), dtype=torch.uint8, device=words.device)
    final_bitpos = torch.empty((batch, n_blocks), dtype=torch.int32, device=words.device)
    if batch and n_blocks:
        words32, jump32, first32, counts32, base32, perm32 = ops
        if words32.data_ptr() % 16:  # the kernel reads the words 16 bytes at a time
            words32 = words32.clone()
        # uint16 entries, (symbol << 8) | length, built by the call itself.
        tables = torch.empty((batch, TABLE_ENTRIES), dtype=torch.int16, device=words.device)
        with torch.cuda.device(words.device):
            _cuda.launch(
                "huffman_decode", words32.data_ptr(), w, jump32.data_ptr(), n_blocks,
                first32.data_ptr(), counts32.data_ptr(), base32.data_ptr(), perm32.data_ptr(),
                batch, tables.data_ptr(), symbols.data_ptr(), final_bitpos.data_ptr(), rows=batch,
            )
    return symbols, final_bitpos


def decode_batch_plain(words, jump, first_code, counts, base, perm):
    """`decode_batch` as JUMP_BLOCK steps of torch ops (the JAX op's scan,
    step for step): the plain version the kernel is held against.

    Every lane reproduces the scan exactly, corrupt input included: the
    word index is clamped to W - 2 from above, a negative one wraps once
    and otherwise reads all ones (the JAX gather's fill), a window with no
    matching length takes length index 0 (argmax of all-false), and the
    symbol index is clipped to [0, 255]. bitpos is int32 and wraps."""
    batch, w = words.shape
    n_blocks = jump.shape[1]
    device = words.device
    words = words.long() & _U32
    # The JAX gather's index rules as one gather: word i of the row sits at
    # i + W + 1 of [fill, words, words], so a negative index wraps once and
    # one below -W reads the fill (all ones); the index never exceeds W - 1.
    ext = torch.cat([torch.full((batch, 1), _U32, dtype=torch.int64, device=device),
                     words, words], dim=1)
    rev15 = _bitrev15(torch.arange(1 << MAX_CODE_LEN, device=device))
    first = first_code.long()[:, 1:].unsqueeze(1)   # [B, 1, 15]
    cnt = counts.long()[:, 1:].unsqueeze(1)
    bse = base.long()[:, 1:].unsqueeze(1)
    perm = perm.long()
    shifts = (MAX_CODE_LEN - torch.arange(1, MAX_CODE_LEN + 1, device=device))[None, None, :]

    bitpos = jump.to(torch.int32).clone()
    syms = torch.empty((JUMP_BLOCK, batch, n_blocks), dtype=torch.uint8, device=device)
    for t in range(JUMP_BLOCK):
        bp = bitpos.long()
        at = torch.clamp(bp >> 5, max=w - 2) + (w + 1)
        s = bp & 31
        w0 = torch.gather(ext, 1, at.clamp(min=0))
        w1 = torch.gather(ext, 1, (at + 1).clamp(min=0))
        # Only the window's low 15 bits are read, and w1 << 32 (s == 0)
        # leaves none of them set.
        u15 = rev15[((w0 >> s) | ((w1 & 0x7FFF) << (32 - s))) & 0x7FFF]
        u_l = u15.unsqueeze(2) >> shifts                      # [B, J, 15]
        ok = (u_l >= first) & (u_l < first + cnt)
        l_sel = torch.argmax(ok.to(torch.uint8), dim=2, keepdim=True)  # first max
        u_sel = torch.gather(u_l, 2, l_sel)
        f_sel = torch.gather(first.expand_as(u_l), 2, l_sel)
        b_sel = torch.gather(bse.expand_as(u_l), 2, l_sel)
        idx = torch.clamp(b_sel + u_sel - f_sel, 0, 255).squeeze(2)
        syms[t] = torch.gather(perm, 1, idx).to(torch.uint8)
        bitpos = bitpos + (l_sel.squeeze(2) + 1).to(torch.int32)
    # [steps, B, J] -> [B, J, steps] -> [B, J*steps]
    return syms.permute(1, 2, 0).reshape(batch, n_blocks * JUMP_BLOCK), bitpos
