"""RSA key pairs made from a seed, their PEM files, and RSA-OAEP unwrapping.

The benchmark makes the key-encryption key pair that it hands the program
(X.509 SubjectPublicKeyInfo and PKCS#8 PEM files, the formats the upstream
plugin's key reader loads), and unwraps each manifest's data key with it to
check what the program stored. OAEP follows RFC 8017 (7.1.2) with SHA3-512
and MGF1-SHA3-512 and an empty label, as the upstream plugin configures it.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import random
from pathlib import Path

_HASH = hashlib.sha3_512
_SMALL_PRIMES = [p for p in range(3, 2000) if all(p % q for q in range(2, int(p ** 0.5) + 1))]


@dataclasses.dataclass(frozen=True)
class KeyPair:
    n: int
    e: int
    d: int
    p: int
    q: int

    @property
    def k(self) -> int:
        return (self.n.bit_length() + 7) // 8


def _probable_prime(n: int, rng: random.Random, rounds: int = 24) -> bool:
    if any(n % p == 0 for p in _SMALL_PRIMES):
        return n in _SMALL_PRIMES
    d, s = n - 1, 0
    while d % 2 == 0:
        d, s = d // 2, s + 1
    for _ in range(rounds):
        x = pow(rng.randrange(2, n - 2), d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = pow(x, 2, n)
            if x == n - 1:
                break
        else:
            return False
    return True


def _prime(bits: int, e: int, rng: random.Random) -> int:
    while True:
        cand = rng.getrandbits(bits) | (3 << (bits - 2)) | 1
        if (cand - 1) % e and _probable_prime(cand, rng):
            return cand


def generate(seed: int, bits: int = 2048, e: int = 65537) -> KeyPair:
    """The same pair for the same seed."""
    rng = random.Random(f"rsa-{seed}")
    while True:
        p, q = _prime(bits // 2, e, rng), _prime(bits // 2, e, rng)
        if p != q and (p * q).bit_length() == bits:
            break
    d = pow(e, -1, (p - 1) * (q - 1))
    return KeyPair(p * q, e, d, p, q)


def _tlv(tag: int, body: bytes) -> bytes:
    n = len(body)
    if n < 0x80:
        head = bytes([n])
    else:
        raw = n.to_bytes((n.bit_length() + 7) // 8, "big")
        head = bytes([0x80 | len(raw)]) + raw
    return bytes([tag]) + head + body


def _int(v: int) -> bytes:
    return _tlv(0x02, v.to_bytes(v.bit_length() // 8 + 1, "big"))


_RSA_ALGORITHM = _tlv(0x30, _tlv(0x06, bytes.fromhex("2a864886f70d010101")) + b"\x05\x00")


def _pem(label: str, der: bytes) -> bytes:
    b64 = base64.b64encode(der).decode()
    lines = [b64[i: i + 64] for i in range(0, len(b64), 64)]
    return (f"-----BEGIN {label}-----\n" + "\n".join(lines) + f"\n-----END {label}-----\n").encode()


def write_pem_files(pair: KeyPair, directory: Path) -> tuple[Path, Path]:
    """(public, private) PEM files in `directory`."""
    public = _tlv(0x30, _RSA_ALGORITHM + _tlv(0x03, b"\x00" + _tlv(0x30, _int(pair.n) + _int(pair.e))))
    p, q, d = pair.p, pair.q, pair.d
    rsa_private = _tlv(0x30, b"".join(_int(v) for v in (
        0, pair.n, pair.e, d, p, q, d % (p - 1), d % (q - 1), pow(q, -1, p))))
    private = _tlv(0x30, _int(0) + _RSA_ALGORITHM + _tlv(0x04, rsa_private))
    pub_path, priv_path = directory / "kek-public.pem", directory / "kek-private.pem"
    pub_path.write_bytes(_pem("PUBLIC KEY", public))
    priv_path.write_bytes(_pem("PRIVATE KEY", private))
    return pub_path, priv_path


def _mgf1(seed: bytes, length: int) -> bytes:
    out = b""
    counter = 0
    while len(out) < length:
        out += _HASH(seed + counter.to_bytes(4, "big")).digest()
        counter += 1
    return out[:length]


def oaep_decrypt(pair: KeyPair, ciphertext: bytes) -> bytes:
    """RSAES-OAEP-DECRYPT; raises ValueError on any padding fault."""
    k, h_len = pair.k, _HASH().digest_size
    if len(ciphertext) != k:
        raise ValueError("ciphertext length is not the modulus length")
    em = pow(int.from_bytes(ciphertext, "big"), pair.d, pair.n).to_bytes(k, "big")
    masked_seed, masked_db = em[1: 1 + h_len], em[1 + h_len:]
    seed = bytes(a ^ b for a, b in zip(masked_seed, _mgf1(masked_db, h_len)))
    db = bytes(a ^ b for a, b in zip(masked_db, _mgf1(seed, k - h_len - 1)))
    rest = db[h_len:].lstrip(b"\x00")
    if em[0] != 0 or db[:h_len] != _HASH(b"").digest() or not rest.startswith(b"\x01"):
        raise ValueError("OAEP padding check failed")
    return rest[1:]
