"""The reference's AES-256-GCM against published vectors, its RSA-OAEP
against the program's key reader, and its chunk-size codec."""

import base64
import os

import pytest

from benchmark.reference import aes_gcm, check, rsa_oaep

K15 = bytes.fromhex("feffe9928665731c6d6a8f9467308308feffe9928665731c6d6a8f9467308308")
IV15 = bytes.fromhex("cafebabefacedbaddecaf888")
P15 = bytes.fromhex(
    "d9313225f88406e5a55909c5aff5269a86a7a9531534f7da2e4c303d8a318a72"
    "1c3c0c95956809532fcf0e2449a6b525b16aedf5aa0de657ba637b391aafd255")
C15 = bytes.fromhex(
    "522dc1f099567d07f47f37a32a84427d643a8cdcbfe5c0c97598a2bd2555d1aa"
    "8cb08e48590dbb3da7b08b1056828838c5f61e6393ba7a0abcc9f662898015ad")

# McGrew and Viega, "The Galois/Counter Mode of Operation", test cases 13-16
# (the AES-256 ones), as (key, IV, AAD, plaintext, ciphertext, tag).
GCM_VECTORS = [
    (bytes(32), bytes(12), b"", b"", b"", "530f8afbc74536b9a963b4f1c4cb738b"),
    (bytes(32), bytes(12), b"", bytes(16), bytes.fromhex("cea7403d4d606b6e074ec5d3baf39d18"),
     "d0d1c8a799996bf0265b98b5d48ab919"),
    (K15, IV15, b"", P15, C15, "b094dac5d93471bdec1a502270e3cc6c"),
    (K15, IV15, bytes.fromhex("feedfacedeadbeeffeedfacedeadbeefabaddad2"), P15[:60], C15[:60],
     "76fc6ece0f4e1768cddf8853bb2d551b"),
]


def test_aes256_block_fips197():
    aes = aes_gcm.Aes256(bytes(range(32)), "cpu")
    got = aes.encrypt_block(bytes.fromhex("00112233445566778899aabbccddeeff"))
    assert got.hex() == "8ea2b7ca516745bfeafc49904b496089"


@pytest.mark.parametrize("case", range(len(GCM_VECTORS)), ids=["tc13", "tc14", "tc15", "tc16"])
def test_gcm_published_vectors(case):
    key, iv, aad, plain, cipher, tag = GCM_VECTORS[case]
    gcm = aes_gcm.Gcm(key, aad, "cpu")
    sealed = gcm.seal(iv, plain)
    assert sealed == iv + cipher + bytes.fromhex(tag)
    [(opened, ok)] = gcm.open([sealed])
    assert ok and opened == plain


def test_gcm_open_batches_rows_of_unequal_length_and_flags_a_flipped_tag():
    key, aad = os.urandom(32), os.urandom(32)
    gcm = aes_gcm.Gcm(key, aad, "cpu")
    plains = [os.urandom(n) for n in (1, 4096, 70_001, 33)]
    sealed = [gcm.seal(os.urandom(12), p) for p in plains]
    sealed[2] = sealed[2][:-1] + bytes([sealed[2][-1] ^ 1])
    opened = gcm.open(sealed + [b"short"])
    assert [ok for _, ok in opened] == [True, True, False, True, False]
    assert [p for p, _ in opened[:4]] == plains


def test_rsa_pair_is_seeded_and_read_by_the_program(tmp_path):
    from tieredstorage_tpu_torch.security.rsa import RsaEncryptionProvider

    pair = rsa_oaep.generate(2**31 + 7)
    assert pair == rsa_oaep.generate(2**31 + 7) and pair.n.bit_length() == 2048
    pub, priv = rsa_oaep.write_pem_files(pair, tmp_path)
    provider = RsaEncryptionProvider.from_pem_files("kek", {"kek": (pub, priv)})
    data_key = os.urandom(32)
    wrapped = provider.encrypt_data_key(data_key).encrypted_data_key
    assert rsa_oaep.oaep_decrypt(pair, wrapped) == data_key
    with pytest.raises(ValueError):
        rsa_oaep.oaep_decrypt(pair, wrapped[:-1] + bytes([wrapped[-1] ^ 1]))


@pytest.mark.parametrize("sizes", [[], [7], [4194332, 4194332, 12], [3000000, 2990000, 3100000, 5]])
def test_chunk_size_codec_matches_the_program(sizes):
    from tieredstorage_tpu_torch.manifest.codec import encode_chunk_sizes

    assert check.decode_chunk_sizes(encode_chunk_sizes(sizes)) == sizes
    assert base64.b64decode(base64.b64encode(encode_chunk_sizes(sizes)))
