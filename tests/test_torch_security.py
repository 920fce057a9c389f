"""The port's RSA key handling without `cryptography`, checked against it.

The port reads and writes PEM/DER key files and generates key pairs itself;
`cryptography` (and the JAX package's RSA provider, built on it) is the
oracle here. Skipped, like the JAX package's own tests, where it is missing.
"""

from __future__ import annotations

import hashlib

import pytest

pytest.importorskip("cryptography")

from cryptography.hazmat.primitives import hashes, serialization  # noqa: E402
from cryptography.hazmat.primitives.asymmetric import padding, rsa  # noqa: E402

from tieredstorage_tpu.security import rsa as jax_rsa  # noqa: E402
from tieredstorage_tpu_torch.security import rsa as port_rsa  # noqa: E402
from tieredstorage_tpu_torch.security.keys import EncryptedDataKey  # noqa: E402


@pytest.fixture(scope="module")
def key_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("keys")
    return {
        "port": port_rsa.generate_key_pair_pem_files(d, prefix="port"),
        "jax": jax_rsa.generate_key_pair_pem_files(d, prefix="jax"),
    }


def test_port_pems_load_in_cryptography(key_files):
    pub, priv = key_files["port"]
    private = serialization.load_pem_private_key(priv.read_bytes(), password=None)
    public = serialization.load_pem_public_key(pub.read_bytes())
    assert isinstance(private, rsa.RSAPrivateKey) and private.key_size == 2048
    numbers = private.private_numbers()
    ours = port_rsa.load_pem_private_key(priv.read_bytes())
    assert (numbers.p * numbers.q, numbers.d, numbers.iqmp) == (ours.n, ours.d, ours.iqmp)
    assert public.public_numbers().n == ours.n and public.public_numbers().e == 65537
    # Re-serialised by cryptography, byte for byte the same files.
    assert private.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    ) == priv.read_bytes()
    assert public.public_bytes(
        serialization.Encoding.PEM, serialization.PublicFormat.SubjectPublicKeyInfo
    ) == pub.read_bytes()


def test_cryptography_pems_load_in_port(key_files):
    pub, priv = key_files["jax"]
    pair = port_rsa.RsaKeyReader.read(pub, priv)
    numbers = serialization.load_pem_private_key(priv.read_bytes(), password=None).private_numbers()
    assert pair.private_key.n == numbers.public_numbers.n
    assert (pair.private_key.p, pair.private_key.q) == (numbers.p, numbers.q)
    assert pair.public_key.n == pair.private_key.n
    # PKCS#1 blocks too.
    key = serialization.load_pem_private_key(priv.read_bytes(), password=None)
    pkcs1 = key.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption(),
    )
    assert port_rsa.load_pem_private_key(pkcs1) == pair.private_key


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_data_keys_cross_decrypt(key_files, writer):
    paths = {"a": key_files["port"], "b": key_files["jax"]}
    ours = port_rsa.RsaEncryptionProvider.from_pem_files("a", paths)
    theirs = jax_rsa.RsaEncryptionProvider.from_pem_files("a", paths)
    data_key = bytes(range(32))
    if writer == "port":
        assert theirs.data_key_decoder(ours.data_key_encoder(data_key)) == data_key
    else:
        assert ours.data_key_decoder(theirs.data_key_encoder(data_key)) == data_key
    for active in ("a", "b"):
        ring = port_rsa.RsaEncryptionProvider(active, ours._keyring)
        assert ring.decrypt_data_key(ring.encrypt_data_key(data_key)) == data_key


def test_oaep_structure_matches_cryptography_with_sha256(key_files):
    """cryptography has no SHA3 OAEP; with SHA-256 injected the same EME-OAEP
    code must agree with it both ways."""
    pub, priv = key_files["port"]
    key = serialization.load_pem_private_key(priv.read_bytes(), password=None)
    ours = port_rsa.load_pem_private_key(priv.read_bytes())
    k = 256
    msg = b"data-key-material-32-bytes-long!"
    oaep = padding.OAEP(mgf=padding.MGF1(hashes.SHA256()), algorithm=hashes.SHA256(), label=None)
    em = port_rsa._oaep_encode(msg, k, hashlib.sha256)
    c = pow(int.from_bytes(em, "big"), ours.e, ours.n).to_bytes(k, "big")
    assert key.decrypt(c, oaep) == msg
    c2 = key.public_key().encrypt(msg, oaep)
    m = port_rsa._rsa_private_op(ours, int.from_bytes(c2, "big"))
    assert port_rsa._oaep_decode(m.to_bytes(k, "big"), k, hashlib.sha256) == msg


def test_tampered_wrapped_key_is_refused(key_files):
    ours = port_rsa.RsaEncryptionProvider.from_pem_files("a", {"a": key_files["port"]})
    wrapped = ours.encrypt_data_key(b"k" * 32)
    bad = bytearray(wrapped.encrypted_data_key)
    bad[-1] ^= 1
    with pytest.raises(ValueError, match="Decryption error"):
        ours.decrypt_data_key(EncryptedDataKey("a", bytes(bad)))
    with pytest.raises(ValueError, match="RSA keys|PEM"):
        port_rsa.load_pem_public_key(b"-----BEGIN CERTIFICATE-----\nAAAA\n-----END CERTIFICATE-----\n")
