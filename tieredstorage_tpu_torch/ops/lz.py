"""Batched LZ match-finding on the device — the match layer of `tpu-lzhuff-v1`.

Counterpart of tieredstorage_tpu/ops/lz.py, whole, as torch ops on the
data's device (a CPU tensor runs on the CPU); the outputs equal the JAX
op's. uint32 grams are held in int64, and the multiplicative hash splits
the gram into 16-bit halves so no product overflows; the table updates are
`scatter_reduce_(..., "amax")`, and the parse's reachability mask is uint8
(torch has no bool scatter-max).

The reference's codec is zstd: sequential hash-chain match-finding plus
entropy coding, on the JVM heap (core/.../transform/
CompressionChunkEnumeration.java:50-63). A TPU has no sequential match
finder, so this module re-states LZ77 as three data-parallel passes over a
whole window of chunks at once:

1. **Candidates** — a rolling 4-byte gram is hashed at every position; a
   per-row hash table is built block by block in a loop of n/SCAN_BLOCK
   steps (the only sequential axis): each step gathers the previous
   blocks' last-position-per-hash as the candidate set for its block, then
   scatter-**max**es its own positions in (positions grow monotonically, so
   max == last-wins without ordered-scatter semantics).
2. **Match lengths** — for each position, the candidate (and a distance-1
   probe that catches runs, which block-stepping can't see) is extended by
   comparing 4-byte grams word-at-a-time, MATCH_WORDS words deep; the first
   differing word's leading equal bytes come from its XOR's high bytes.
   Everything is gathers + elementwise ops; no scan.
3. **Parse** — greedy token selection (`next[i] = i + max(len[i], 1)`) is a
   path through the position graph; the path is materialized in O(log n)
   rounds of pointer doubling (gather ptr[ptr] + scatter-max of the
   reachability mask), not an O(n) walk.

Per-position lengths are capped at MAX_MATCH; the host serializer merges
adjacent same-distance tokens back into arbitrarily long matches, so runs
cost one sequence, as they do in zstd. Entropy coding of the resulting
streams is the existing device Huffman stage (ops/huffman.py).
"""


from __future__ import annotations

import torch

HASH_BITS = 16
TABLE_SIZE = 1 << HASH_BITS
#: Below this a match loses to the sequence record it would emit: a record
#: is 6 bytes pre-entropy but ~2 bytes after the per-field Huffman
#: (transform/lzhuff.py), so 5-byte matches still pay.
MIN_MATCH = 5
#: Per-position cap; the serializer's same-distance merge rebuilds longer
#: matches, so this bounds device compare work, not the format.
MATCH_WORDS = 16
MAX_MATCH = MATCH_WORDS * 4
#: Table-update granularity: candidates for a block come from strictly
#: earlier blocks, so in-block-only repeats shorter than this are invisible
#: to the hash probe (the distance-1 probe still catches runs).
SCAN_BLOCK = 512
#: Match offsets are u16 in the sequence record.
MAX_DIST = 65535
#: Per-row dominant distances probed in the second pass (see
#: lz_analyze_batch); more buys little once the offset alphabet collapses.
TOP_DISTANCES = 4

_U32 = 0xFFFFFFFF


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def lz_shape(n: int) -> int:
    """Row width for a batch whose longest chunk is n bytes."""
    return max(SCAN_BLOCK, _ceil_div(n, SCAN_BLOCK) * SCAN_BLOCK)


def _mul32(g: torch.Tensor, m: int) -> torch.Tensor:
    """(g * m) mod 2^32 for uint32 g held in int64: g's 16-bit halves times
    m stay below 2^48, so no product overflows."""
    lo = (g & 0xFFFF) * m
    hi = ((g >> 16) * m) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def _grams(data: torch.Tensor, n: int) -> torch.Tensor:
    """uint32[B, n] in int64: big-endian 4-byte gram starting at every
    position (zero-padded past the row end, so tail grams are
    well-defined)."""
    batch = data.shape[0]
    d = torch.cat(
        [data, torch.zeros((batch, 3), dtype=torch.uint8, device=data.device)], dim=1
    ).long()
    return (
        (d[:, :n] << 24) | (d[:, 1 : n + 1] << 16) | (d[:, 2 : n + 2] << 8) | d[:, 3 : n + 3]
    )


def _match_lengths(g: torch.Tensor, cand: torch.Tensor, valid: torch.Tensor, n: int):
    """Equal-byte run length between each position and its candidate,
    capped at MAX_MATCH, via word-granular compares (no [n, MAX_MATCH]
    byte tensor in device memory)."""
    idx = torch.arange(n, device=g.device)[None, :]
    lens = torch.zeros(cand.shape, dtype=torch.int32, device=g.device)
    alive = valid
    c = torch.clamp(cand, 0, n - 1).long()
    for t in range(MATCH_WORDS):
        gi = torch.gather(g, 1, torch.clamp(idx + 4 * t, max=n - 1).expand_as(c))
        gc = torch.gather(g, 1, torch.clamp(c + 4 * t, max=n - 1))
        x = gi ^ gc
        eq_word = x == 0
        # Grams are big-endian, so the first differing byte is the highest
        # non-zero byte of the XOR.
        b0 = (x >> 24) == 0
        b1 = b0 & (((x >> 16) & 0xFF) == 0)
        b2 = b1 & (((x >> 8) & 0xFF) == 0)
        partial = b0.int() + b1.int() + b2.int()
        lens = lens + torch.where(alive, torch.where(eq_word, 4, partial), 0).int()
        alive = alive & eq_word
    return lens


def lz_analyze_batch(data: torch.Tensor, n_sym: torch.Tensor):
    """data uint8[B, n_max] (n_max % SCAN_BLOCK == 0, zero-padded past each
    row's n_sym) -> (lens int32[B, n_max], dists int32[B, n_max],
    sel bool[B, n_max]), on data's device.

    lens[i] > 0 marks a usable match of that many bytes at distance
    dists[i] (always in [1, MAX_DIST], source strictly earlier in the same
    chunk); sel marks the greedy parse's token starts. Padding rows/tails
    carry garbage — the serializer slices to n_sym."""
    batch, n = data.shape
    if n % SCAN_BLOCK:
        raise ValueError(f"n_max={n} not a multiple of {SCAN_BLOCK}")
    device = data.device
    n_sym = n_sym.to(device=device, dtype=torch.int64)
    rows = torch.arange(batch, device=device)[:, None]
    idx = torch.arange(n, device=device)[None, :]

    g = _grams(data, n)
    # Two candidate tables, zstd-double-fast style: the 4-byte gram finds
    # short/nearby repeats but its most-recent hit is often an unrelated
    # common gram (`":"…`), truncating the match; the 8-byte gram is
    # selective enough that its hit is usually the true long repeat
    # (the previous record in log-structured data).
    h4 = _mul32(g, 2654435761) >> (32 - HASH_BITS)
    g_next = torch.cat([g[:, 4:], torch.zeros((batch, 4), dtype=g.dtype, device=device)], dim=1)
    h8 = (_mul32(g, 2654435761) ^ _mul32(g_next, 2246822519)) >> (32 - HASH_BITS)
    del g_next

    t4 = torch.full((batch, TABLE_SIZE), -1, dtype=torch.int32, device=device)
    t8 = torch.full((batch, TABLE_SIZE), -1, dtype=torch.int32, device=device)
    cand4 = torch.empty((batch, n), dtype=torch.int32, device=device)
    cand8 = torch.empty((batch, n), dtype=torch.int32, device=device)
    pos = torch.arange(n, dtype=torch.int32, device=device)[None, :].expand(batch, n)
    for k in range(0, n, SCAN_BLOCK):
        hk4, hk8 = h4[:, k : k + SCAN_BLOCK], h8[:, k : k + SCAN_BLOCK]
        p = pos[:, k : k + SCAN_BLOCK]
        cand4[:, k : k + SCAN_BLOCK] = torch.gather(t4, 1, hk4)
        cand8[:, k : k + SCAN_BLOCK] = torch.gather(t8, 1, hk8)
        t4.scatter_reduce_(1, hk4, p, "amax", include_self=True)
        t8.scatter_reduce_(1, hk8, p, "amax", include_self=True)
    del t4, t8, h4, h8
    cand4, cand8 = cand4.long(), cand8.long()

    len4 = _match_lengths(g, cand4, (cand4 >= 0) & (idx - cand4 <= MAX_DIST), n)
    len8 = _match_lengths(g, cand8, (cand8 >= 0) & (idx - cand8 <= MAX_DIST), n)
    len_run = _match_lengths(g, (idx - 1).expand(batch, n), (idx >= 1).expand(batch, n), n)

    # Longest wins; ties prefer the shorter distance (run, then 4-gram —
    # its most-recent hit is at most as far as the 8-gram table's).
    lens = len_run
    dists = torch.ones_like(lens)
    use4 = len4 > lens
    lens = torch.where(use4, len4, lens)
    dists = torch.where(use4, (idx - cand4).int(), dists)
    use8 = len8 > lens
    lens = torch.where(use8, len8, lens)
    dists = torch.where(use8, (idx - cand8).int(), dists)
    del len4, len8, len_run, cand4, cand8, use4, use8
    tail = n_sym[:, None] - idx

    def clamp(lens):
        lens = torch.minimum(lens, torch.clamp(tail, min=0).int())
        return torch.where(lens >= MIN_MATCH, lens, 0)

    def parse(lens):
        # Greedy parse via pointer doubling: ptr[i] = next token start
        # after i; the parse is the set of positions reachable from 0.
        nxt = torch.clamp(idx + torch.where(lens > 0, lens, 1), max=n)
        ptr = torch.cat([nxt, torch.full((batch, 1), n, dtype=nxt.dtype, device=device)], dim=1)
        reach = torch.zeros((batch, n + 1), dtype=torch.uint8, device=device)
        reach[:, 0] = 1
        for _ in range(max(1, n.bit_length())):
            reach = reach.scatter_reduce(1, ptr, reach, "amax", include_self=True)
            ptr = torch.gather(ptr, 1, ptr)
        return reach[:, :n].bool()

    lens = clamp(lens)
    sel = parse(lens)

    # Dominant-distance pass — zstd's rep-offset insight restated for a
    # parallel matcher. Sequential rep codes (repeat the PREVIOUS match's
    # offset) assume consecutive matches share a distance; in
    # multi-field structured data they instead cycle through several
    # periodicities, so the parallel equivalent is GLOBAL: histogram the
    # parse-1 match distances per row, take the top-K, probe those
    # distances at every position, and prefer them on near-ties (up to 1
    # byte shorter still wins — collapsing the offset alphabet to a few
    # values is worth more than the lost byte). The serializer's
    # same-offset sentinel plus the per-field Huffman then make the
    # dominant offsets nearly free. Re-parse with the adjusted matches.
    sel_match = sel & (lens > 0)
    hist = torch.zeros((batch, MAX_DIST + 1), dtype=torch.int32, device=device)
    hist.scatter_add_(1, torch.where(sel_match, dists, 0).long(), sel_match.int())
    hist[:, 0] = 0
    # Pick the best of the top-K by STRICT length first (so a rarer later
    # distance can't steal near-ties from a more dominant earlier one and
    # chain length degradation), then apply the 1-byte near-tie preference
    # once, against the pass-1 candidate.
    top_len = torch.zeros_like(lens)
    top_dist = torch.zeros_like(dists)
    for _ in range(TOP_DISTANCES):
        top = torch.argmax(hist, dim=1)  # [B], the first maximum
        hist[rows[:, 0], top] = 0
        pk = top[:, None]
        len_k = clamp(
            _match_lengths(g, (idx - pk).expand(batch, n), (pk >= 1) & (idx - pk >= 0), n)
        )
        better = len_k > top_len
        top_len = torch.where(better, len_k, top_len)
        top_dist = torch.where(better, pk.int(), top_dist)
    use_top = (top_len > 0) & (top_len + 1 >= lens)
    lens = torch.where(use_top, top_len, lens)
    dists = torch.where(use_top, top_dist, dists)
    sel = parse(lens)
    return lens, dists, sel
