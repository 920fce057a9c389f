"""Bitsliced AES-256-CTR keystream: boolean circuit, no table lookups.

Counterpart of tieredstorage_tpu/ops/aes_bitsliced.py. SubBytes is a
composite-field boolean circuit (GF(2^8) inverse computed in GF((2^4)^2)),
derived here from the field definitions (FIPS-197 polynomial 0x11B, GF(16)
polynomial y^4+y+1): the whole cipher is XOR/AND/NOT on 32-bit words that
each carry one bit of 32 blocks, so no memory access depends on key or data.

Layout: a state is int32[16, 8, W] — byte position (FIPS column-major), bit
index (LSB first), and W words, word w bit j = block 32*w + j. The words are
int32 holding uint32 bit patterns (torch has no `>>` for uint32 on the CPU);
every shift is followed by a mask.

`ctr_keystream_batch` is the kernel wrapper: for a CUDA tensor it launches
the hand-written CUDA kernel (csrc/aes_ctr.cu, whose S-box is Boyar and
Peralta's 115-gate circuit, rendered by ops/aes_circuit_gen.py); for a CPU
tensor it runs `ctr_keystream_batch_plain`, this module's tower circuit as
torch ops. `ctr_keystream_bitsliced` (one IV) runs through the same
wrapper; `round_key_planes` and `make_rk_planes` are the JAX module's host
helpers (the JAX module's `pallas_aes_available` has no twin: the port has
no preflight, a CUDA tensor launches the kernel or raises).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tieredstorage_tpu_torch.ops.aes import _NR, _SHIFT_ROWS, _gf8_mult, key_expansion

# ---------------------------------------------------------------------------
# Host-side derivation of the tower-field S-box circuit (numpy, cached)
# ---------------------------------------------------------------------------


def _gf16_mult(a: int, b: int) -> int:
    p = 0
    while b:
        if b & 1:
            p ^= a
        a <<= 1
        if a & 0x10:
            a ^= 0x13  # y^4 + y + 1
        b >>= 1
    return p


def _gf8_pow(a: int, n: int) -> int:
    r = 1
    while n:
        if n & 1:
            r = _gf8_mult(r, a)
        a = _gf8_mult(a, a)
        n >>= 1
    return r


@functools.cache
def _tower() -> dict:
    """Derive the GF(256) ≅ GF((2^4)^2) isomorphism and circuit constants."""
    # Generator of GF(256)*.
    g = next(
        c for c in range(2, 256)
        if len({_gf8_pow(c, i) for i in range(255)}) == 255
    )
    # The subfield GF(16) inside GF(256) is {0} ∪ {g^(17k)}; find an element u
    # with u^4 + u + 1 = 0 so GF(2)[y]/(y^4+y+1) maps y ↦ u.
    u = next(
        x
        for k in range(1, 15)
        for x in [_gf8_pow(g, 17 * k)]
        if _gf8_pow(x, 4) ^ x ^ 1 == 0
    )

    def embed16(v: int) -> int:
        """GF(16) element (bits over y) → GF(256) element (bits over x)."""
        out = 0
        for i in range(4):
            if (v >> i) & 1:
                out ^= _gf8_pow(u, i)
        return out

    # λ ∈ GF(16) such that t^2 + t + λ is irreducible over GF(16) and a root
    # V exists in GF(256): V^2 + V = embed(λ). Search both.
    lam, V = next(
        (l, v)
        for l in range(1, 16)
        for v in range(1, 256)
        if _gf8_mult(v, v) ^ v == embed16(l)
        and all(_gf16_mult(w, w) ^ w ^ l != 0 for w in range(16))
    )

    # Basis of GF(256) over GF(2): b ⊕ a·V with a,b ∈ GF(16) on basis u^i.
    # M maps composite coords (b0..b3, a0..a3) → AES bits.
    M = np.zeros((8, 8), dtype=np.uint8)
    for i in range(4):
        col_b = embed16(1 << i)
        col_a = _gf8_mult(embed16(1 << i), V)
        for bit in range(8):
            M[bit, i] = (col_b >> bit) & 1
            M[bit, 4 + i] = (col_a >> bit) & 1
    Minv = _gf2_inv(M)

    # AES affine layer: S(x) = Aff(inv(x)) (FIPS-197 §5.1.1).
    A = np.zeros((8, 8), dtype=np.uint8)
    for i in range(8):
        for j in (0, 4, 5, 6, 7):
            A[i, (i + j) % 8] ^= 1

    # GF(16) multiply tensor: out_k = XOR_{i,j} T[k,i,j] u_i v_j.
    T = np.zeros((4, 4, 4), dtype=np.uint8)
    for i in range(4):
        for j in range(4):
            prod = _gf16_mult(1 << i, 1 << j)
            for k in range(4):
                T[k, i, j] = (prod >> k) & 1

    # x ↦ λ·x² over GF(16): linear (Frobenius + scale), as a 4×4 bit matrix.
    SqLam = np.zeros((4, 4), dtype=np.uint8)
    for i in range(4):
        v = _gf16_mult(lam, _gf16_mult(1 << i, 1 << i))
        for k in range(4):
            SqLam[k, i] = (v >> k) & 1

    # GF(16) inverse as algebraic normal form (Möbius transform of the truth
    # table): inv_anf[k] = set of monomial masks whose XOR gives bit k.
    inv_table = [0] + [next(y for y in range(16) if _gf16_mult(x, y) == 1)
                       for x in range(1, 16)]
    inv_anf: list[list[int]] = []
    for k in range(4):
        f = [(inv_table[x] >> k) & 1 for x in range(16)]
        coeff = list(f)
        for i in range(4):
            for mask in range(16):
                if mask & (1 << i):
                    coeff[mask] ^= coeff[mask ^ (1 << i)]
        inv_anf.append([m for m in range(16) if coeff[m]])

    return {
        "lin_in": Minv % 2,
        "lin_out": (A @ M) % 2,
        "const": 0x63,
        "mult": T,
        "sq_lam": SqLam,
        "inv_anf": inv_anf,
    }


def _gf2_inv(m: np.ndarray) -> np.ndarray:
    n = m.shape[0]
    aug = np.concatenate([m.copy() % 2, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = next(r for r in range(col, n) if aug[r, col])
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= aug[col]
    return aug[:, n:]


@functools.cache
def _sq_matrix() -> np.ndarray:
    m = np.zeros((4, 4), dtype=np.uint8)
    for i in range(4):
        v = _gf16_mult(1 << i, 1 << i)
        for k in range(4):
            m[k, i] = (v >> k) & 1
    return m


# ---------------------------------------------------------------------------
# The circuit over bit-planes, on torch tensors (the CUDA kernel's S-box is
# another circuit, from ops/aes_circuit_gen.py; the tests hold the two
# against each other and the FIPS-197 table).
# ---------------------------------------------------------------------------


def _linear4(mat: np.ndarray, bits: list) -> list:
    """Apply a GF(2) matrix (rows = outputs) to a list of planes via XORs."""
    out = []
    for row in mat:
        terms = [bits[i] for i in range(len(bits)) if row[i]]
        acc = terms[0]
        for t in terms[1:]:
            acc = acc ^ t
        out.append(acc)
    return out


def _gf16_mul_planes(t: np.ndarray, u: list, v: list) -> list:
    prods = {}
    out = []
    for k in range(4):
        acc = None
        for i in range(4):
            for j in range(4):
                if t[k, i, j]:
                    if (i, j) not in prods:
                        prods[(i, j)] = u[i] & v[j]
                    acc = prods[(i, j)] if acc is None else acc ^ prods[(i, j)]
        out.append(acc)
    return out


def _gf16_inv_planes(anf: list[list[int]], x: list) -> list:
    # inv(0) = 0, so no bit's normal form holds the constant monomial 0 and
    # every bit has at least one monomial: no all-ones or all-zeros plane.
    monomials: dict[int, object] = {}
    for m in range(1, 16):
        low = m & (-m)
        if m ^ low == 0:
            monomials[m] = x[low.bit_length() - 1]
    for m in range(1, 16):
        if m not in monomials:
            low = m & (-m)
            monomials[m] = monomials[m ^ low] & monomials[low]
    out = []
    for k in range(4):
        acc = None
        for m in anf[k]:
            acc = monomials[m] if acc is None else acc ^ monomials[m]
        out.append(acc)
    return out


def _sbox_planes(tw: dict, bits: list) -> list:
    """S-box over 8 bit-planes (LSB first) via the tower circuit."""
    comp = _linear4(tw["lin_in"], bits)  # (b0..b3, a0..a3)
    b, a = comp[:4], comp[4:]
    # Δ = λa² ⊕ ab ⊕ b²
    a_sq_lam = _linear4(tw["sq_lam"], a)
    ab = _gf16_mul_planes(tw["mult"], a, b)
    b_sq = _linear4(_sq_matrix(), b)
    delta = [a_sq_lam[i] ^ ab[i] ^ b_sq[i] for i in range(4)]
    dinv = _gf16_inv_planes(tw["inv_anf"], delta)
    a_out = _gf16_mul_planes(tw["mult"], a, dinv)
    apb = [a[i] ^ b[i] for i in range(4)]
    b_out = _gf16_mul_planes(tw["mult"], apb, dinv)
    res = _linear4(tw["lin_out"], b_out + a_out)
    const = tw["const"]
    return [~res[i] if (const >> i) & 1 else res[i] for i in range(8)]


# ---------------------------------------------------------------------------
# Plain PyTorch cipher on int32 bit-planes
# ---------------------------------------------------------------------------

_SHIFT_ROWS_LIST = [int(p) for p in _SHIFT_ROWS]


def _mix_columns_planes(state: torch.Tensor) -> torch.Tensor:
    """state int32[16, 8, W]. Per column: out_r = xtime(a_r ^ a_{r+1}) ^ a_r
    ^ (a_0 ^ a_1 ^ a_2 ^ a_3), with xtime a rotation of the bit index that
    feeds bit 7 into bits {0, 1, 3, 4} (poly 0x11B)."""
    s = state.reshape((4, 4) + state.shape[1:])  # [col, row, bit, W]
    x = s ^ torch.roll(s, -1, dims=1)
    xt = torch.roll(x, 1, dims=2)  # xt[b] = x[b-1], xt[0] = x[7]
    xt[:, :, [1, 3, 4]] ^= x[:, :, 7:8]
    all4 = s[:, 0] ^ s[:, 1] ^ s[:, 2] ^ s[:, 3]
    return (xt ^ s ^ all4[:, None]).reshape(state.shape)


def rk_planes_from_round_keys(round_keys: torch.Tensor) -> torch.Tensor:
    """uint8[15, 16] round keys -> int32[15, 16, 8] full-word masks (0 / -1)."""
    bits = (round_keys.to(torch.int32)[..., None] >> torch.arange(
        8, dtype=torch.int32, device=round_keys.device
    )) & 1
    return -bits


def aes_encrypt_planes(rk_planes: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Encrypt a bitsliced state int32[16, 8, W] with AES-256."""
    tw = _tower()
    state = state ^ rk_planes[0][..., None]
    for rnd in range(1, _NR + 1):
        planes = _sbox_planes(tw, [state[:, b] for b in range(8)])
        state = torch.stack(planes, dim=1)[_SHIFT_ROWS_LIST]
        if rnd != _NR:
            state = _mix_columns_planes(state)
        state = state ^ rk_planes[rnd][..., None]
    return state


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 bit pattern -> int32 with the same bits."""
    return (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def ctr_keystream_batch_plain(
    round_keys: torch.Tensor, ivs: torch.Tensor, first_counter: int, n_blocks: int
) -> torch.Tensor:
    """Keystream uint8[B, n_blocks, 16]: block i of row r is
    AES_K(iv_r || big-endian32(first_counter + i mod 2^32)). The plain
    version of the CUDA keystream kernel, in the JAX package's layout: the
    batch is folded into the word axis and the whole batch is one circuit
    evaluation."""
    device = ivs.device
    rk_planes = rk_planes_from_round_keys(round_keys)
    batch = ivs.shape[0]
    w = (n_blocks + 31) // 32
    total = w * 32
    n = (first_counter + torch.arange(total, dtype=torch.int64, device=device)) & 0xFFFFFFFF
    n = n.reshape(w, 32)
    weights = torch.ones(32, dtype=torch.int64, device=device) << torch.arange(
        32, dtype=torch.int64, device=device
    )
    ctr = torch.stack([
        torch.stack([
            _to_int32(((((n >> shift) & 0xFF) >> b & 1) * weights).sum(dim=1))
            for b in range(8)
        ])
        for shift in (24, 16, 8, 0)
    ])  # [4, 8, w]
    iv_bits = (ivs.to(torch.int32)[..., None] >> torch.arange(
        8, dtype=torch.int32, device=device
    )) & 1
    iv_planes = -iv_bits  # [B, 12, 8] full-word masks
    state = torch.cat(
        [
            iv_planes[..., None].expand(batch, 12, 8, w),
            ctr[None].expand(batch, 4, 8, w),
        ],
        dim=1,
    )  # [B, 16, 8, w]
    state = state.permute(1, 2, 0, 3).reshape(16, 8, batch * w)
    out = aes_encrypt_planes(rk_planes, state).reshape(16, 8, batch, w)
    # Unpack: byte[pos, block 32w'+j] = Σ_b ((plane[pos, b, w'] >> j) & 1) << b.
    j = torch.arange(32, dtype=torch.int32, device=device)
    acc = torch.zeros((16, batch, w, 32), dtype=torch.int32, device=device)
    for b in range(8):
        acc |= ((out[:, b, :, :, None] >> j) & 1) << b
    ks = acc.permute(1, 2, 3, 0).reshape(batch, total, 16).to(torch.uint8)
    return ks[:, :n_blocks]


def ctr_keystream_batch(
    round_keys: torch.Tensor, ivs: torch.Tensor, first_counter: int, n_blocks: int
) -> torch.Tensor:
    """Keystream uint8[B, n_blocks, 16] for a batch of per-chunk IVs.

    The wrapper of the CUDA keystream kernel (csrc/aes_ctr.cu, which
    replaces the Pallas `_aes_kernel` together with the counter packing and
    byte unpacking around it): round_keys uint8[15, 16] and ivs uint8[B, 12]
    on one device. CUDA tensors launch the kernel or raise; CPU tensors take
    `ctr_keystream_batch_plain`."""
    if round_keys.dtype != torch.uint8 or tuple(round_keys.shape) != (_NR + 1, 16):
        raise ValueError(f"round keys must be uint8[15, 16], got {round_keys.dtype} {tuple(round_keys.shape)}")
    if ivs.dtype != torch.uint8 or ivs.dim() != 2 or ivs.shape[1] != 12:
        raise ValueError(f"ivs must be uint8[B, 12], got {ivs.dtype} {tuple(ivs.shape)}")
    if ivs.device != round_keys.device:
        raise ValueError("round keys and ivs must be on one device")
    if not 0 <= first_counter < 1 << 32 or n_blocks < 1:
        raise ValueError("first_counter must fit 32 bits and n_blocks be positive")
    if not 1 <= ivs.shape[0] <= 65535:
        raise ValueError(f"batch must be 1..65535 rows (the kernel's grid y), got {ivs.shape[0]}")
    if ivs.device.type == "cpu":
        return ctr_keystream_batch_plain(round_keys, ivs, first_counter, n_blocks)
    from tieredstorage_tpu_torch.ops import _cuda

    rk = round_keys.contiguous()
    ivs = ivs.contiguous()
    out = torch.empty((ivs.shape[0], n_blocks, 16), dtype=torch.uint8, device=ivs.device)
    _cuda.launch(
        "aes_ctr_keystream", rk.data_ptr(), ivs.data_ptr(), first_counter,
        n_blocks, ivs.shape[0], out.data_ptr(), rows=ivs.shape[0],
    )
    return out


def round_key_planes(round_keys: np.ndarray) -> np.ndarray:
    """uint8[15,16] round keys → uint32[15,16,8] full-word bit masks."""
    bits = (np.asarray(round_keys)[..., None] >> np.arange(8)) & 1
    return (bits.astype(np.uint32) * 0xFFFFFFFF).astype(np.uint32)


def make_rk_planes(key: bytes) -> np.ndarray:
    return round_key_planes(key_expansion(key))


def ctr_keystream_bitsliced(
    rk_planes, iv, first_counter: int, n_blocks: int, *, device=None
) -> torch.Tensor:
    """Keystream uint8[n_blocks, 16] for one 12-byte IV, from the round keys'
    bit planes (uint32[15, 16, 8] masks, numpy or tensor): one row of
    `ctr_keystream_batch`, so a CUDA device launches the keystream kernel.
    Runs on `device`, else the IV tensor's device, else `cuda:0`."""
    from tieredstorage_tpu_torch.transform.api import DEFAULT_DEVICE, resolve_device

    if device is None:
        device = iv.device if isinstance(iv, torch.Tensor) else DEFAULT_DEVICE
    device = resolve_device(device)
    planes = rk_planes.cpu().numpy() if isinstance(rk_planes, torch.Tensor) else np.asarray(rk_planes)
    round_keys = ((planes.astype(np.uint64) & 1) << np.arange(8, dtype=np.uint64)).sum(axis=-1)
    ivs = iv.cpu().numpy() if isinstance(iv, torch.Tensor) else np.asarray(iv)
    return ctr_keystream_batch(
        torch.from_numpy(round_keys.astype(np.uint8)).to(device),
        torch.from_numpy(ivs.astype(np.uint8).reshape(1, 12)).to(device),
        first_counter, n_blocks,
    )[0]
