"""CPU transform backend: host zstd + AES-GCM; reference-wire-compatible oracle.

Counterpart of tieredstorage_tpu/transform/cpu.py (the JAX package's default
backend). The device codecs run their torch ops and plain versions on the
CPU here.

Per-chunk zstd frames carry the content size (the reference pledges source
size and sets content-size so the decompressor can size its output —
CompressionChunkEnumeration.java:50-63, DecompressionChunkEnumeration.java:39-46);
encryption produces IV || ciphertext || tag per chunk with a fresh IV
(EncryptionChunkEnumeration.java:66-81). Compose order: compress then encrypt
on upload; decrypt then decompress on fetch.
"""

from __future__ import annotations

from typing import Sequence

try:  # Optional dependency: only the zstd codec branches need it; identity
    # and device-codec (tpu-huff/tpu-lzhuff) pipelines work without it.
    import zstandard
except ImportError:  # pragma: no cover - exercised only without zstandard
    zstandard = None

from tieredstorage_tpu_torch.security.aes import AesEncryptionProvider, InvalidTag
from tieredstorage_tpu_torch.transform.api import (
    THUFF,
    TLZHUFF,
    ZSTD,
    AuthenticationError,
    DetransformOptions,
    TransformBackend,
    TransformOptions,
)


def _require_zstd() -> None:
    if zstandard is None:
        raise ModuleNotFoundError(
            "The 'zstandard' package is required for the 'zstd' codec "
            "(compression.codec) but is not installed"
        )


class CpuTransformBackend(TransformBackend):
    def transform(self, chunks: Sequence[bytes], opts: TransformOptions) -> list[bytes]:
        out = list(chunks)
        if opts.compression:
            if opts.compression_codec == THUFF:
                # Device-codec segments stay readable/writable on hosts (the
                # codecs are torch ops; on the CPU backend they run on the CPU).
                from tieredstorage_tpu_torch.transform import thuff

                out = thuff.compress_batch(out)
            elif opts.compression_codec == TLZHUFF:
                from tieredstorage_tpu_torch.transform import lzhuff

                out = lzhuff.compress_batch(out)
            elif opts.compression_codec != ZSTD:
                raise ValueError(
                    f"CPU backend supports only {ZSTD!r}/{THUFF!r}/{TLZHUFF!r} "
                    f"codecs, got {opts.compression_codec!r}"
                )
            else:
                # A compressor per chunk size keeps the pledged-src-size
                # frames identical to the reference's per-chunk Zstd usage.
                _require_zstd()
                out = [
                    zstandard.ZstdCompressor(
                        level=opts.compression_level, write_content_size=True
                    ).compress(c)
                    for c in out
                ]
        if opts.encryption is not None:
            enc = opts.encryption
            ivs = opts.ivs
            out = [
                AesEncryptionProvider.encrypt_chunk(
                    c, enc.data_key, enc.aad, iv=None if ivs is None else ivs[i]
                )
                for i, c in enumerate(out)
            ]
        return out

    def detransform(self, chunks: Sequence[bytes], opts: DetransformOptions) -> list[bytes]:
        out = list(chunks)
        if opts.encryption is not None:
            enc = opts.encryption
            decrypted = []
            for i, c in enumerate(out):
                try:
                    decrypted.append(
                        AesEncryptionProvider.decrypt_chunk(c, enc.data_key, enc.aad)
                    )
                except InvalidTag:
                    raise AuthenticationError(
                        f"GCM tag mismatch on chunks [{i}]"
                    ) from None
            out = decrypted
        if opts.compression:
            if opts.compression_codec == THUFF:
                from tieredstorage_tpu_torch.transform import thuff

                out = thuff.decompress_batch(out, opts.max_original_chunk_size)
            elif opts.compression_codec == TLZHUFF:
                from tieredstorage_tpu_torch.transform import lzhuff

                out = lzhuff.decompress_batch(out, opts.max_original_chunk_size)
            elif opts.compression_codec != ZSTD:
                raise ValueError(
                    f"CPU backend supports only {ZSTD!r}/{THUFF!r}/{TLZHUFF!r} "
                    f"codecs, got {opts.compression_codec!r}"
                )
            else:
                from tieredstorage_tpu_torch.native import checked_frame_content_sizes

                _require_zstd()
                checked_frame_content_sizes(out, opts.max_original_chunk_size)
                dctx = zstandard.ZstdDecompressor()
                out = [dctx.decompress(c) for c in out]
        return out
