"""RSA key-encryption-key ring with OAEP(SHA3-512, MGF1-SHA3-512) enveloping.

Counterpart of tieredstorage_tpu/security/rsa.py with no `cryptography`
dependency: PEM/DER key files are read and written here (X.509
SubjectPublicKeyInfo public keys, PKCS#8 private keys — the formats the
reference's RsaKeyReader loads; PKCS#1 "RSA ... KEY" blocks are read too),
key pairs are generated with Python's `pow` and Miller–Rabin, and the padding
is RFC 8017 EME-OAEP with an empty label and MGF1 sharing the OAEP digest.
The same private operation signs the GCS service-account JWTs
(RSASSA-PKCS1-v1_5 with SHA-256, `sign_pkcs1v15_sha256`).
Key files and wrapped data keys are byte-compatible with the JAX package's.
Enveloping happens once per segment, so speed does not matter here.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import hmac
import math
import os
import secrets
from pathlib import Path
from typing import Mapping

from tieredstorage_tpu_torch.security.keys import EncryptedDataKey

_HASH = hashlib.sha3_512

#: DER of the rsaEncryption AlgorithmIdentifier (OID 1.2.840.113549.1.1.1, NULL).
_RSA_ALGORITHM_ID = bytes.fromhex("300d06092a864886f70d0101010500")


@dataclasses.dataclass(frozen=True)
class RsaPublicKey:
    n: int
    e: int

    @property
    def key_size(self) -> int:
        return self.n.bit_length()


@dataclasses.dataclass(frozen=True)
class RsaPrivateKey:
    n: int
    e: int
    d: int
    p: int
    q: int
    dmp1: int
    dmq1: int
    iqmp: int

    @property
    def key_size(self) -> int:
        return self.n.bit_length()

    def public_key(self) -> RsaPublicKey:
        return RsaPublicKey(self.n, self.e)


@dataclasses.dataclass(frozen=True)
class KeyPair:
    public_key: RsaPublicKey
    private_key: RsaPrivateKey


# --- DER (the subset RSA key files use) ---


def _der_read(data: bytes, pos: int, tag: int) -> tuple[bytes, int]:
    """One TLV at `pos` with the expected tag -> (content, next position)."""
    if pos + 2 > len(data) or data[pos] != tag:
        raise ValueError(f"DER: expected tag 0x{tag:02x} at offset {pos}")
    length = data[pos + 1]
    pos += 2
    if length & 0x80:
        n = length & 0x7F
        if n == 0 or n > 4 or pos + n > len(data):
            raise ValueError("DER: bad length")
        length = int.from_bytes(data[pos : pos + n], "big")
        pos += n
    if pos + length > len(data):
        raise ValueError("DER: truncated value")
    return data[pos : pos + length], pos + length


def _der_ints(seq: bytes, count: int) -> list[int]:
    out, pos = [], 0
    for _ in range(count):
        raw, pos = _der_read(seq, pos, 0x02)
        out.append(int.from_bytes(raw, "big", signed=True))
    return out


def _der_tlv(tag: int, content: bytes) -> bytes:
    n = len(content)
    if n < 0x80:
        return bytes([tag, n]) + content
    raw = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([tag, 0x80 | len(raw)]) + raw + content


def _der_int(v: int) -> bytes:
    return _der_tlv(0x02, v.to_bytes(v.bit_length() // 8 + 1, "big", signed=True))


def _pkcs1_public(der: bytes) -> RsaPublicKey:
    seq, _ = _der_read(der, 0, 0x30)
    n, e = _der_ints(seq, 2)
    return RsaPublicKey(n, e)


def _pkcs1_private(der: bytes) -> RsaPrivateKey:
    seq, _ = _der_read(der, 0, 0x30)
    version, n, e, d, p, q, dp, dq, qi = _der_ints(seq, 9)
    if version != 0:
        raise ValueError("Only two-prime RSA private keys are supported")
    return RsaPrivateKey(n, e, d, p, q, dp, dq, qi)


def _spki_public(der: bytes) -> RsaPublicKey:
    seq, _ = _der_read(der, 0, 0x30)
    alg, pos = _der_read(seq, 0, 0x30)
    if _der_tlv(0x30, alg) != _RSA_ALGORITHM_ID:
        raise ValueError("Key pair files must contain RSA keys")
    bits, _ = _der_read(seq, pos, 0x03)
    if not bits or bits[0] != 0:
        raise ValueError("DER: unexpected unused bits in the public key")
    return _pkcs1_public(bits[1:])


def _pkcs8_private(der: bytes) -> RsaPrivateKey:
    seq, _ = _der_read(der, 0, 0x30)
    version, pos = _der_read(seq, 0, 0x02)
    if int.from_bytes(version, "big") != 0:
        raise ValueError("Unsupported PKCS#8 version")
    alg, pos = _der_read(seq, pos, 0x30)
    if _der_tlv(0x30, alg) != _RSA_ALGORITHM_ID:
        raise ValueError("Key pair files must contain RSA keys")
    inner, _ = _der_read(seq, pos, 0x04)
    return _pkcs1_private(inner)


def _pem_blocks(pem: bytes) -> tuple[str, bytes]:
    text = pem.decode("ascii")
    begin = text.find("-----BEGIN ")
    if begin < 0:
        raise ValueError("No PEM block found")
    label_end = text.index("-----", begin + 11)
    label = text[begin + 11 : label_end]
    end = text.index(f"-----END {label}-----", label_end)
    body = "".join(text[label_end + 5 : end].split())
    return label, base64.b64decode(body)


def load_pem_public_key(pem: bytes) -> RsaPublicKey:
    label, der = _pem_blocks(pem)
    if label == "PUBLIC KEY":
        return _spki_public(der)
    if label == "RSA PUBLIC KEY":
        return _pkcs1_public(der)
    raise ValueError(f"Unsupported public key PEM block {label!r}")


def load_pem_private_key(pem: bytes) -> RsaPrivateKey:
    label, der = _pem_blocks(pem)
    if label == "PRIVATE KEY":
        return _pkcs8_private(der)
    if label == "RSA PRIVATE KEY":
        return _pkcs1_private(der)
    raise ValueError(f"Unsupported private key PEM block {label!r}")


def _pem(label: str, der: bytes) -> bytes:
    b64 = base64.b64encode(der).decode("ascii")
    lines = [b64[i : i + 64] for i in range(0, len(b64), 64)]
    return (
        f"-----BEGIN {label}-----\n" + "\n".join(lines) + f"\n-----END {label}-----\n"
    ).encode("ascii")


def public_key_pem(key: RsaPublicKey) -> bytes:
    rsa_pub = _der_tlv(0x30, _der_int(key.n) + _der_int(key.e))
    spki = _der_tlv(0x30, _RSA_ALGORITHM_ID + _der_tlv(0x03, b"\x00" + rsa_pub))
    return _pem("PUBLIC KEY", spki)


def private_key_pem(key: RsaPrivateKey) -> bytes:
    fields = (0, key.n, key.e, key.d, key.p, key.q, key.dmp1, key.dmq1, key.iqmp)
    rsa_priv = _der_tlv(0x30, b"".join(_der_int(v) for v in fields))
    pkcs8 = _der_tlv(
        0x30, _der_int(0) + _RSA_ALGORITHM_ID + _der_tlv(0x04, rsa_priv)
    )
    return _pem("PRIVATE KEY", pkcs8)


# --- key generation ---

_SMALL_PRIMES = [p for p in range(3, 2000) if all(p % d for d in range(2, int(p**0.5) + 1))]


def _is_probable_prime(n: int, rounds: int = 40) -> bool:
    """Trial division by small primes, then Miller–Rabin with random bases."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for _ in range(rounds):
        a = 2 + secrets.randbelow(n - 3)
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = pow(x, 2, n)
            if x == n - 1:
                break
        else:
            return False
    return True


def _random_prime(bits: int, e: int) -> int:
    while True:
        # Top two bits set so that p*q has exactly 2*bits bits; odd.
        candidate = secrets.randbits(bits) | (3 << (bits - 2)) | 1
        if math.gcd(e, candidate - 1) == 1 and _is_probable_prime(candidate):
            return candidate


def generate_private_key(key_size: int = 2048, e: int = 65537) -> RsaPrivateKey:
    if key_size < 1024 or key_size % 2:
        raise ValueError("RSA key size must be an even number of at least 1024 bits")
    while True:
        p = _random_prime(key_size // 2, e)
        q = _random_prime(key_size // 2, e)
        if p == q:
            continue
        if p < q:
            p, q = q, p
        lam = (p - 1) * (q - 1) // math.gcd(p - 1, q - 1)
        d = pow(e, -1, lam)
        return RsaPrivateKey(
            n=p * q, e=e, d=d, p=p, q=q,
            dmp1=d % (p - 1), dmq1=d % (q - 1), iqmp=pow(q, -1, p),
        )


class RsaKeyReader:
    """PEM files -> KeyPair (X509/SubjectPublicKeyInfo public, PKCS8 private)."""

    @staticmethod
    def read(public_key_path: str | Path, private_key_path: str | Path) -> KeyPair:
        try:
            pub_pem = Path(public_key_path).read_bytes()
            priv_pem = Path(private_key_path).read_bytes()
        except OSError as e:
            raise ValueError(f"Couldn't read RSA key pair paths: {e}") from e
        return KeyPair(load_pem_public_key(pub_pem), load_pem_private_key(priv_pem))


# --- RFC 8017 EME-OAEP with SHA3-512 ---

def _mgf1(seed: bytes, length: int, hash_fn=_HASH) -> bytes:
    h_len = hash_fn(b"").digest_size
    out = bytearray()
    for counter in range(-(-length // h_len)):
        out += hash_fn(seed + counter.to_bytes(4, "big")).digest()
    return bytes(out[:length])


def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


def _oaep_encode(message: bytes, k: int, hash_fn=_HASH) -> bytes:
    h_len = hash_fn(b"").digest_size
    max_len = k - 2 * h_len - 2
    if len(message) > max_len:
        raise ValueError(f"Message too long for OAEP: {len(message)} > {max_len}")
    l_hash = hash_fn(b"").digest()
    ps = b"\x00" * (k - len(message) - 2 * h_len - 2)
    db = l_hash + ps + b"\x01" + message
    seed = os.urandom(h_len)
    masked_db = _xor(db, _mgf1(seed, k - h_len - 1, hash_fn))
    masked_seed = _xor(seed, _mgf1(masked_db, h_len, hash_fn))
    return b"\x00" + masked_seed + masked_db


def _oaep_decode(em: bytes, k: int, hash_fn=_HASH) -> bytes:
    """EME-OAEP decode with every padding check folded into one error (the
    same single-exit structure as the JAX package's copy: distinct early
    exits would tell a Manger-style oracle which check failed)."""
    h_len = hash_fn(b"").digest_size
    if len(em) != k or k < 2 * h_len + 2:
        raise ValueError("Decryption error")
    y, masked_seed, masked_db = em[0], em[1 : 1 + h_len], em[1 + h_len :]
    seed = _xor(masked_seed, _mgf1(masked_db, h_len, hash_fn))
    db = _xor(masked_db, _mgf1(seed, k - h_len - 1, hash_fn))
    l_hash = hash_fn(b"").digest()
    bad = y != 0
    bad |= not hmac.compare_digest(db[:h_len], l_hash)
    sep = -1
    seen_nonzero_before_sep = False
    for i in range(h_len, len(db)):
        b = db[i]
        if sep < 0:
            if b == 1:
                sep = i
            elif b != 0:
                seen_nonzero_before_sep = True
    bad |= sep < 0
    bad |= seen_nonzero_before_sep
    if bad:
        raise ValueError("Decryption error")
    return db[sep + 1 :]


def _rsa_private_op(key: RsaPrivateKey, data: int) -> int:
    # CRT: two half-size exponentiations instead of pow(data, d, n).
    m1 = pow(data % key.p, key.dmp1, key.p)
    m2 = pow(data % key.q, key.dmq1, key.q)
    h = ((m1 - m2) * key.iqmp) % key.p
    return m2 + h * key.q


#: DER prefix of the DigestInfo for SHA-256 (RFC 8017 §9.2, note 1).
_SHA256_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")


def sign_pkcs1v15_sha256(key: RsaPrivateKey, message: bytes) -> bytes:
    """RSASSA-PKCS1-v1_5 signature of `message` with SHA-256 (RFC 8017 §8.2,
    EMSA-PKCS1-v1_5 of §9.2): the RS256 of a JWT. Deterministic, so equal to
    any other correct signer's output for the same key and message."""
    k = (key.key_size + 7) // 8
    t = _SHA256_DIGEST_INFO + hashlib.sha256(message).digest()
    if k < len(t) + 11:
        raise ValueError("RSA key too short for a SHA-256 PKCS#1 v1.5 signature")
    em = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    return _rsa_private_op(key, int.from_bytes(em, "big")).to_bytes(k, "big")


class RsaEncryptionProvider:
    """KEK ring with one active key for encryption; any ring key can decrypt."""

    def __init__(self, active_key_id: str, keyring: Mapping[str, KeyPair]):
        if active_key_id not in keyring:
            raise ValueError(f"Active key id {active_key_id!r} not in keyring {sorted(keyring)}")
        self.active_key_id = active_key_id
        self._keyring = dict(keyring)

    @staticmethod
    def from_pem_files(
        active_key_id: str, key_pair_paths: Mapping[str, tuple[str | Path, str | Path]]
    ) -> "RsaEncryptionProvider":
        keyring = {
            key_id: RsaKeyReader.read(pub, priv)
            for key_id, (pub, priv) in key_pair_paths.items()
        }
        return RsaEncryptionProvider(active_key_id, keyring)

    def encrypt_data_key(self, data_key: bytes) -> EncryptedDataKey:
        public_key = self._keyring[self.active_key_id].public_key
        k = (public_key.key_size + 7) // 8
        em = _oaep_encode(data_key, k)
        c = pow(int.from_bytes(em, "big"), public_key.e, public_key.n)
        return EncryptedDataKey(self.active_key_id, c.to_bytes(k, "big"))

    def decrypt_data_key(self, encrypted: EncryptedDataKey) -> bytes:
        key_pair = self._keyring.get(encrypted.key_encryption_key_id)
        if key_pair is None:
            raise ValueError(
                f"Unknown key encryption key id: {encrypted.key_encryption_key_id!r}"
            )
        k = (key_pair.private_key.key_size + 7) // 8
        m = _rsa_private_op(
            key_pair.private_key, int.from_bytes(encrypted.encrypted_data_key, "big")
        )
        return _oaep_decode(m.to_bytes(k, "big"), k)

    # --- manifest serde hooks (manifest.segment_manifest DataKeyEncoder/Decoder) ---
    def data_key_encoder(self, data_key: bytes) -> str:
        return self.encrypt_data_key(data_key).serialize()

    def data_key_decoder(self, s: str) -> bytes:
        return self.decrypt_data_key(EncryptedDataKey.parse(s))


def generate_key_pair_pem_files(
    directory: str | Path, key_size: int = 2048, prefix: str = "test"
) -> tuple[Path, Path]:
    """Generate an RSA pair and write PEM files; returns (public, private) paths."""
    directory = Path(directory)
    private_key = generate_private_key(key_size)
    pub_path = directory / f"{prefix}_public.pem"
    priv_path = directory / f"{prefix}_private.pem"
    pub_path.write_bytes(public_key_pem(private_key.public_key()))
    priv_path.write_bytes(private_key_pem(private_key))
    return pub_path, priv_path
