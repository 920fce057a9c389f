"""Native host transform backend: C++ batched zstd + AES-256-GCM.

Counterpart of tieredstorage_tpu/transform/native_backend.py. A
`transform.backend.class` option next to cpu (Python libs) and cuda (the
GPU kernels): whole chunk windows cross into the native library
(tieredstorage_tpu_torch/native) once and are processed by a C++ thread
pool — the answer to the JNI layer the reference's hot loop bottoms out in
(zstd-jni per chunk, CompressionChunkEnumeration.java:50-63; JDK AES-GCM,
EncryptionChunkEnumeration.java:66-81). Wire format identical to the CPU
backend and the reference.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from tieredstorage_tpu_torch import native
from tieredstorage_tpu_torch.security.aes import IV_SIZE
from tieredstorage_tpu_torch.transform.api import (
    ZSTD,
    AuthenticationError,
    DetransformOptions,
    TransformBackend,
    TransformOptions,
)


class NativeTransformBackend(TransformBackend):
    preferred_batch_chunks = 256

    def __init__(self, n_threads: int = 0):
        if not native.available():
            raise RuntimeError(
                "Native transform library unavailable (build failed or "
                "libcrypto not found); use the cpu or cuda backend"
            )
        self.n_threads = n_threads

    def configure(self, configs: dict) -> None:
        if "threads" in configs:
            self.n_threads = int(configs["threads"])

    def _check_codec(self, codec: str) -> None:
        if codec != ZSTD:
            raise ValueError(
                f"Native backend supports only the {ZSTD!r} codec, got {codec!r}"
            )

    def transform(self, chunks: Sequence[bytes], opts: TransformOptions) -> list[bytes]:
        out = list(chunks)
        if not out:
            return []
        if opts.compression:
            self._check_codec(opts.compression_codec)
            out = native.zstd_compress_batch(
                out, level=opts.compression_level, n_threads=self.n_threads
            )
        if opts.encryption is not None:
            enc = opts.encryption
            if opts.ivs is not None:
                ivs = np.stack(
                    [np.frombuffer(iv, dtype=np.uint8) for iv in opts.ivs[: len(out)]]
                )
            else:
                ivs = np.frombuffer(
                    os.urandom(IV_SIZE * len(out)), dtype=np.uint8
                ).reshape(len(out), IV_SIZE)
            out = native.aes_gcm_encrypt_batch(
                enc.data_key, enc.aad, ivs, out, n_threads=self.n_threads
            )
        return out

    def detransform(self, chunks: Sequence[bytes], opts: DetransformOptions) -> list[bytes]:
        out = list(chunks)
        if not out:
            return []
        if opts.encryption is not None:
            enc = opts.encryption
            try:
                out = native.aes_gcm_decrypt_batch(
                    enc.data_key, enc.aad, out, n_threads=self.n_threads
                )
            except native.NativeAuthenticationError as e:
                raise AuthenticationError(str(e)) from None
        if opts.compression:
            self._check_codec(opts.compression_codec)
            out = native.zstd_decompress_batch(
                out,
                max_decompressed=opts.max_original_chunk_size,
                n_threads=self.n_threads,
            )
        return out
