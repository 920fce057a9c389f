"""Plain AES-256-GCM (FIPS 197, NIST SP 800-38D) in PyTorch, batched over chunks.

The benchmark's own reference cipher. It runs on any torch device: the CPU in
the tests, the card after a run's window has closed. AES is the textbook
T-table form on 32-bit columns held in int64; GHASH multiplies by fixed
powers of H through byte tables, pairing neighbours in a tree (leading zero
blocks leave GHASH unchanged, so rows of unequal length are left-padded).
Nothing here is taken from the program under test.
"""

from __future__ import annotations

import torch

IV_BYTES, TAG_BYTES, KEY_BYTES = 12, 16, 32
ENVELOPE_BYTES = IV_BYTES + TAG_BYTES
_R = 0xE1 << 120
_MASK64 = (1 << 64) - 1


def _xtime(b: int) -> int:
    b <<= 1
    return (b ^ 0x11B) if b & 0x100 else b


def _make_sbox() -> list[int]:
    """The S-box from its definition (FIPS 197, 5.1.1): walk GF(2^8) by
    powers of 3 and their inverses, then the affine map."""
    def rotl(x: int, k: int) -> int:
        return ((x << k) | (x >> (8 - k))) & 0xFF

    out = [0] * 256
    p = q = 1
    while True:
        p = p ^ ((p << 1) & 0xFF) ^ (0x1B if p & 0x80 else 0)
        q ^= q << 1
        q ^= q << 2
        q ^= q << 4
        q &= 0xFF
        if q & 0x80:
            q ^= 0x09
        out[p] = q ^ rotl(q, 1) ^ rotl(q, 2) ^ rotl(q, 3) ^ rotl(q, 4) ^ 0x63
        if p == 1:
            break
    out[0] = 0x63
    return out


SBOX = _make_sbox()


def _ror32(w: int, n: int) -> int:
    return ((w >> n) | (w << (32 - n))) & 0xFFFFFFFF


_T0 = [(_xtime(s) << 24) | (s << 16) | (s << 8) | (_xtime(s) ^ s) for s in SBOX]
_TABLES = [_T0] + [[_ror32(w, 8 * k) for w in _T0] for k in (1, 2, 3)]


def expand_key(key: bytes) -> list[int]:
    """AES-256 key schedule: 60 round-key words."""
    if len(key) != KEY_BYTES:
        raise ValueError(f"AES-256 needs a {KEY_BYTES}-byte key, got {len(key)}")

    def sub_word(t: int) -> int:
        return int.from_bytes(bytes(SBOX[b] for b in t.to_bytes(4, "big")), "big")

    w = [int.from_bytes(key[4 * i: 4 * i + 4], "big") for i in range(8)]
    rcon = 1
    for i in range(8, 60):
        t = w[i - 1]
        if i % 8 == 0:
            t = sub_word(((t << 8) & 0xFFFFFFFF) | (t >> 24)) ^ (rcon << 24)
            rcon = _xtime(rcon)
        elif i % 8 == 4:
            t = sub_word(t)
        w.append(w[i - 8] ^ t)
    return w


class Aes256:
    """Block encryption of many blocks at once, as four int64 column words."""

    def __init__(self, key: bytes, device) -> None:
        self.device = torch.device(device)
        self.rk = expand_key(key)
        self.t = [torch.tensor(t, dtype=torch.int64, device=self.device) for t in _TABLES]
        self.s = torch.tensor(SBOX, dtype=torch.int64, device=self.device)

    def encrypt_words(self, cols: list[torch.Tensor]) -> list[torch.Tensor]:
        rk, t, s = self.rk, self.t, self.s
        st = [c ^ rk[i] for i, c in enumerate(cols)]
        for r in range(1, 14):
            st = [
                t[0][st[c] >> 24] ^ t[1][(st[(c + 1) % 4] >> 16) & 255]
                ^ t[2][(st[(c + 2) % 4] >> 8) & 255] ^ t[3][st[(c + 3) % 4] & 255]
                ^ rk[4 * r + c]
                for c in range(4)
            ]
        return [
            ((s[st[c] >> 24] << 24) | (s[(st[(c + 1) % 4] >> 16) & 255] << 16)
             | (s[(st[(c + 2) % 4] >> 8) & 255] << 8) | s[st[(c + 3) % 4] & 255])
            ^ rk[56 + c]
            for c in range(4)
        ]

    def encrypt_block(self, block: bytes) -> bytes:
        cols = [torch.tensor([int.from_bytes(block[4 * i: 4 * i + 4], "big")],
                             dtype=torch.int64, device=self.device) for i in range(4)]
        return b"".join(int(c.item()).to_bytes(4, "big") for c in self.encrypt_words(cols))


def _words_to_bytes(cols: list[torch.Tensor]) -> torch.Tensor:
    """Four column words per block -> uint8[n, 16], big-endian."""
    parts = [(c >> sh) & 255 for c in cols for sh in (24, 16, 8, 0)]
    return torch.stack(parts, dim=1).to(torch.uint8)


def gf_mul(x: int, y: int) -> int:
    """Multiplication in GCM's GF(2^128) (SP 800-38D, Algorithm 1)."""
    z, v = 0, y
    for i in range(128):
        if (x >> (127 - i)) & 1:
            z ^= v
        v = (v >> 1) ^ (_R if v & 1 else 0)
    return z


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


class _ConstMul:
    """Multiplication by a fixed element c through 16 tables of 256 entries:
    byte j of x contributes T_j[x_j] = (x_j at byte j) * c."""

    def __init__(self, c: int, device) -> None:
        basis = [c]
        for _ in range(127):
            v = basis[-1]
            basis.append((v >> 1) ^ (_R if v & 1 else 0))
        hi, lo = [], []
        for j in range(16):
            row = [0] * 256
            for b in range(1, 256):
                low = b & -b
                row[b] = row[b ^ low] ^ basis[8 * j + 7 - (low.bit_length() - 1)]
            hi.append([_signed64(v >> 64) for v in row])
            lo.append([_signed64(v & _MASK64) for v in row])
        self.hi = torch.tensor(hi, dtype=torch.int64, device=device)
        self.lo = torch.tensor(lo, dtype=torch.int64, device=device)

    def __call__(self, xh: torch.Tensor, xl: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        rh = torch.zeros_like(xh)
        rl = torch.zeros_like(xl)
        for j in range(16):
            word = xh if j < 8 else xl
            byte = (word >> (56 - 8 * (j % 8))) & 255
            rh ^= self.hi[j][byte]
            rl ^= self.lo[j][byte]
        return rh, rl


def _blocks(data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8[..., 16k] -> (hi, lo) int64[..., k] of the big-endian halves."""
    b = data.reshape(*data.shape[:-1], -1, 2, 8).flip(-1).contiguous()
    v = b.view(torch.int64).squeeze(-1)
    return v[..., 0], v[..., 1]


def _tensor(data: bytes, device) -> torch.Tensor:
    if not data:
        return torch.empty(0, dtype=torch.uint8, device=device)
    return torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device)


class Gcm:
    """AES-256-GCM with 96-bit IVs for one key and AAD."""

    def __init__(self, key: bytes, aad: bytes, device) -> None:
        self.device = torch.device(device)
        self.aes = Aes256(key, device)
        self.aad = aad
        self.h = int.from_bytes(self.aes.encrypt_block(bytes(16)), "big")
        self._powers: dict[int, _ConstMul] = {}

    def _mul_by_h_power(self, span: int) -> _ConstMul:
        """The multiplier by H^span (span a power of two)."""
        if span not in self._powers:
            p, n = self.h, 1
            while n < span:
                p, n = gf_mul(p, p), n * 2
            self._powers[span] = _ConstMul(p, self.device)
        return self._powers[span]

    def _keystream(self, ivs: list[bytes], n_blocks: int, first_counter: int) -> torch.Tensor:
        """uint8[rows, n_blocks * 16]: E_K(IV || counter) for counters from
        `first_counter` on, one row per IV."""
        rows = len(ivs)
        iv_words = torch.tensor(
            [[int.from_bytes(iv[4 * i: 4 * i + 4], "big") for i in range(3)] for iv in ivs],
            dtype=torch.int64, device=self.device,
        )
        counters = torch.arange(first_counter, first_counter + n_blocks,
                                dtype=torch.int64, device=self.device) & 0xFFFFFFFF
        cols = [iv_words[:, i: i + 1].expand(rows, n_blocks).reshape(-1) for i in range(3)]
        cols.append(counters.repeat(rows))
        return _words_to_bytes(self.aes.encrypt_words(cols)).reshape(rows, n_blocks * 16)

    def _ghash(self, cts: list[torch.Tensor]) -> list[int]:
        """GHASH(AAD, C) of each ciphertext (uint8 tensors on the device)."""
        a_blocks = -(-len(self.aad) // 16)
        lens = [int(c.numel()) for c in cts]
        m = max(a_blocks + -(-n // 16) + 1 for n in lens)
        rows = torch.zeros(len(cts), m * 16, dtype=torch.uint8, device=self.device)
        aad = torch.tensor(list(self.aad), dtype=torch.uint8, device=self.device)
        for r, (ct, n) in enumerate(zip(cts, lens)):
            seq = a_blocks + -(-n // 16) + 1
            start = (m - seq) * 16
            rows[r, start: start + len(self.aad)] = aad
            start += a_blocks * 16
            rows[r, start: start + n] = ct
            start += -(-n // 16) * 16
            tail = (len(self.aad) * 8).to_bytes(8, "big") + (n * 8).to_bytes(8, "big")
            rows[r, start: start + 16] = torch.tensor(list(tail), dtype=torch.uint8,
                                                      device=self.device)
        xh, xl = _blocks(rows)
        xh, xl = self._mul_by_h_power(1)(xh, xl)
        span = 1
        while xh.shape[1] > 1:
            if xh.shape[1] % 2:
                pad = torch.zeros(xh.shape[0], 1, dtype=torch.int64, device=self.device)
                xh, xl = torch.cat([pad, xh], 1), torch.cat([pad, xl], 1)
            lh, ll = self._mul_by_h_power(span)(xh[:, 0::2], xl[:, 0::2])
            xh, xl = lh ^ xh[:, 1::2], ll ^ xl[:, 1::2]
            span *= 2
        return [((int(h) & _MASK64) << 64) | (int(l) & _MASK64)
                for h, l in zip(xh[:, 0].tolist(), xl[:, 0].tolist())]

    def _tags(self, ivs: list[bytes], cts: list[torch.Tensor]) -> list[bytes]:
        masks = self._keystream(ivs, 1, 1)
        out = []
        for r, g in enumerate(self._ghash(cts)):
            mask = int.from_bytes(bytes(masks[r].tolist()), "big")
            out.append((g ^ mask).to_bytes(16, "big"))
        return out

    def _ctr(self, ivs: list[bytes], data: list[torch.Tensor]) -> list[torch.Tensor]:
        n_blocks = max(-(-int(d.numel()) // 16) for d in data) if data else 0
        stream = self._keystream(ivs, max(n_blocks, 1), 2)
        return [d ^ stream[r, : d.numel()] for r, d in enumerate(data)]

    def open(self, envelopes: list[bytes]) -> list[tuple[bytes, bool]]:
        """Decrypt `IV || ciphertext || tag` envelopes: (plaintext, tag ok)
        for each. An envelope shorter than IV and tag opens to (b"", False)."""
        out: list = [None] * len(envelopes)
        good = [i for i, e in enumerate(envelopes) if len(e) >= ENVELOPE_BYTES]
        for i in range(len(envelopes)):
            if i not in good:
                out[i] = (b"", False)
        if good:
            ivs = [envelopes[i][:IV_BYTES] for i in good]
            cts = [_tensor(envelopes[i][IV_BYTES:-TAG_BYTES], self.device) for i in good]
            tags = self._tags(ivs, cts)
            plains = self._ctr(ivs, cts)
            for k, i in enumerate(good):
                ok = tags[k] == envelopes[i][-TAG_BYTES:]
                out[i] = (plains[k].cpu().numpy().tobytes(), ok)
        return out

    def seal(self, iv: bytes, plaintext: bytes) -> bytes:
        """`IV || ciphertext || tag` of one plaintext (tests and controls)."""
        pt = _tensor(plaintext, self.device)
        [ct] = self._ctr([iv], [pt])
        [tag] = self._tags([iv], [ct])
        return iv + ct.cpu().numpy().tobytes() + tag
