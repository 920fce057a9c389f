"""End-to-end harness of the PyTorch/CUDA port: the in-process Kafka-broker
simulator of `tests/e2e/`, over `tieredstorage_tpu_torch` only.

Counterpart of tests/e2e: real Kafka v2 record batches in real rolled
segment files, a RemoteLogManager-style tiering loop driving the port's
RemoteStorageManager (or its sidecar client), and a __remote_log_metadata
state tracker. The batch CRC32C is a callable, so the same code computes it
with the host table in the CPU tests and with the port's batched CRC32C op
on the card. Nothing here imports JAX or the JAX package.
"""
