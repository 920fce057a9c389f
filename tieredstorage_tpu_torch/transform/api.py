"""The transform-backend seam: batch-of-chunks in, batch-of-chunks out.

This is the `transform.backend.class` pluggability point (the new seam this
framework adds next to the reference's `storage.backend.class` and
`fetch.chunk.cache.class`; see BASELINE notes). Backends are stateless with
respect to segments: every call carries the full cryptographic/codec context,
so calls can be batched, reordered, and sharded across chips freely.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Iterable, Iterator, Optional, Sequence

import torch

from tieredstorage_tpu_torch.security.aes import DataKeyAndAAD

#: The device the port's entry points run on unless the caller asks for
#: another (the CPU, for the plain versions).
DEFAULT_DEVICE = "cuda:0"


def resolve_device(spec=DEFAULT_DEVICE) -> torch.device:
    """`spec` as a torch.device. A CUDA device without CUDA, or one that does
    not exist, raises: nothing falls back to the CPU."""
    dev = torch.device(spec)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is not available; ask for the "
                "CPU (device='cpu', or transform.device=cpu in the RSM) to run "
                "the plain versions there"
            )
        if (dev.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(f"device {dev} does not exist")
    elif dev.type != "cpu":
        raise ValueError(f"Unsupported device {dev}")
    return dev


def checksum_device(backend, device=DEFAULT_DEVICE) -> torch.device:
    """Where CRC32C work next to `backend` runs (upload checksums, scrub
    verification, anti-entropy arbitration): the backend's own `device`, or,
    for a host backend without one, `device` (the RSM's `transform.device`)
    through `resolve_device` — `cuda:0` unless the CPU is asked for."""
    own = getattr(backend, "device", None)
    return own if own is not None else resolve_device(device)

#: Compression codec ids recordable in the manifest. "zstd" is the
#: reference-compatible default (zstd frame with content size, one frame per
#: chunk — CompressionChunkEnumeration.java:50-63). "tpu-huff-v1" is the
#: order-0 device codec: chunk-batched canonical Huffman encoded with torch
#: ops and decoded by a CUDA kernel (transform/thuff.py). "tpu-lzhuff-v1"
#: layers LZ match-finding under the same Huffman stage (ops/lz.py +
#: transform/lzhuff.py). All are recorded in the manifest's
#: compressionCodec field, and frames are the JAX package's byte for byte.
ZSTD = "zstd"
THUFF = "tpu-huff-v1"
TLZHUFF = "tpu-lzhuff-v1"


class AuthenticationError(ValueError):
    """GCM tag verification failed on detransform (corrupt or forged data).

    Part of the backend contract: every TransformBackend raises this type so
    callers see the same failure regardless of `transform.backend.class`.
    """


@dataclasses.dataclass(frozen=True)
class TransformOptions:
    """Per-segment transform context (upload direction)."""

    compression: bool = False
    compression_codec: str = ZSTD
    compression_level: int = 3
    encryption: Optional[DataKeyAndAAD] = None
    # Deterministic IVs for tests; None = fresh random IV per chunk (the
    # reference's behavior: fresh cipher per chunk,
    # EncryptionChunkEnumeration.java:66-81).
    ivs: Optional[Sequence[bytes]] = None

    @property
    def is_identity(self) -> bool:
        return not self.compression and self.encryption is None

    def fixed_transformed_size(self, original_size: int) -> Optional[int]:
        """Transformed size when it's statically known (null = variable).

        Mirrors TransformChunkEnumeration.transformedChunkSize() semantics
        (core/.../transform/TransformChunkEnumeration.java:20-42).
        """
        if self.compression:
            return None
        if self.encryption is not None:
            from tieredstorage_tpu_torch.security.aes import IV_SIZE, TAG_SIZE

            return IV_SIZE + original_size + TAG_SIZE
        return original_size


@dataclasses.dataclass(frozen=True)
class DetransformOptions:
    """Per-segment detransform context (fetch direction)."""

    compression: bool = False
    compression_codec: str = ZSTD
    encryption: Optional[DataKeyAndAAD] = None
    # Upper bound on any chunk's decompressed size (the segment's configured
    # chunk.size, known from the manifest). Backends use it to reject
    # corrupt/malicious frames that declare huge content sizes before
    # allocating output buffers from them.
    max_original_chunk_size: Optional[int] = None

    @staticmethod
    def from_manifest(manifest, aes_key: Optional[DataKeyAndAAD] = None) -> "DetransformOptions":
        enc = None
        if manifest.encryption is not None:
            enc = DataKeyAndAAD(manifest.encryption.data_key, manifest.encryption.aad)
        if aes_key is not None:
            enc = aes_key
        return DetransformOptions(
            compression=manifest.compression,
            compression_codec=manifest.compression_codec or ZSTD,
            encryption=enc,
            max_original_chunk_size=manifest.chunk_index.original_chunk_size,
        )


class TransformBackend(abc.ABC):
    """Maps batches of chunks through [compress] -> [encrypt] and back."""

    #: Preferred number of chunks per transform call; the pipeline feeds
    #: windows of roughly this size. TPU backends set this to fill the chip.
    preferred_batch_chunks: int = 64

    #: Byte cap per window (None = chunk count only). Device backends bound
    #: this so a window's staged arrays fit HBM and consecutive windows can
    #: overlap host and device work.
    preferred_batch_bytes: Optional[int] = None

    def configure(self, configs: dict) -> None:  # noqa: B027
        """Configure from the `transform.`-prefixed config subset."""

    def transform_windows(
        self, windows: Iterable[Sequence[bytes]], opts: TransformOptions
    ) -> Iterator[list[bytes]]:
        """Upload direction over a stream of chunk windows, 1:1 per window.

        Default: synchronous, one window at a time. Device backends override
        this to pipeline — host compression of window N+1 overlapping device
        encryption of window N (SURVEY §7 step 5's double-buffered staging).

        When `opts.ivs` is set (deterministic IVs, a flat per-chunk
        sequence), each window receives its own slice — reusing the list
        per window would repeat GCM nonces under one key.
        """
        iv_offset = 0
        for window in windows:
            w_opts = opts
            if opts.ivs is not None:
                w_opts = dataclasses.replace(
                    opts, ivs=opts.ivs[iv_offset : iv_offset + len(window)]
                )
                iv_offset += len(window)
            yield self.transform(window, w_opts)

    @abc.abstractmethod
    def transform(self, chunks: Sequence[bytes], opts: TransformOptions) -> list[bytes]:
        """Upload direction: original chunks -> transformed chunks (1:1)."""

    @abc.abstractmethod
    def detransform(self, chunks: Sequence[bytes], opts: DetransformOptions) -> list[bytes]:
        """Fetch direction: transformed chunks -> original chunks (1:1)."""

    def close(self) -> None:  # noqa: B027
        pass
