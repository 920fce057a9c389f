"""Envelope encryption: AES-256-GCM data keys wrapped by RSA KEKs."""

from tieredstorage_tpu_torch.security.aes import AesEncryptionProvider, DataKeyAndAAD
from tieredstorage_tpu_torch.security.keys import EncryptedDataKey
from tieredstorage_tpu_torch.security.rsa import RsaEncryptionProvider, RsaKeyReader

__all__ = [
    "AesEncryptionProvider",
    "DataKeyAndAAD",
    "EncryptedDataKey",
    "RsaEncryptionProvider",
    "RsaKeyReader",
]
