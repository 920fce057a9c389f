"""tieredstorage_tpu_torch — the PyTorch/CUDA port of tieredstorage_tpu.

A KIP-405 RemoteStorageManager whose AES-256-GCM chunk transform runs on an
NVIDIA H100: the block cipher, both GHASH reductions and the tpu-huff-v1
decoder are CUDA C++ kernels (csrc/), the glue between them is PyTorch. The package keeps the layout and
module names of `tieredstorage_tpu` so each module's counterpart is easy to
find, and it imports nothing of that package (nor JAX): the host-only modules
it needs are copied here.

Layer map:
  rsm.py            — orchestration: copy / fetch / fetch_index / delete
  transform/        — transform-backend seam, the CUDA backend (cuda.py), the
                      host backends and the device codecs (thuff, lzhuff)
  native/           — ctypes bindings of the C++ host library (zstd, AES-GCM)
  fetch/            — chunk manager + ranged range enumeration
  manifest/         — manifest + chunk-index data model, wire-compatible
  security/         — AES-GCM data keys, RSA envelope encryption (no deps)
  storage/          — storage backend SPI, the backends, the lifecycle journal
  scrub/            — scrubber, recovery sweeper, anti-entropy repair
  faults/           — fault-injecting storage backend (utils/faults.py: the
                      fault plane at the I/O seams)
  ops/              — GCM, CRC32C, Huffman and LZ on torch tensors; kernel
                      wrappers and plain versions
  csrc/             — the CUDA C++ kernels (built with nvcc at first use)

Entry points run on `cuda:0` unless the caller asks for the CPU
(`transform.device=cpu` or a `device=` argument); on the CPU every kernel
wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"
