"""GCM on torch tensors, with the hand-written CUDA kernels behind wrappers.

- ops.gf128         — host-side GF(2^128) math (GHASH operands as bit matrices)
- ops.aes           — AES-256 key schedule and a numpy single-block cipher
- ops.aes_bitsliced — bitsliced AES-256 circuit; `ctr_keystream_batch`
                      launches the CUDA keystream kernel on CUDA tensors
- ops.ghash_cuda    — GHASH tree and level-1 reductions (CUDA kernels)
- ops.gcm           — batched AES-256-GCM packed windows
- ops.crc32c        — CRC32C of stored chunks (torch ops)
- ops.huffman       — tpu-huff-v1's encoder (torch ops) and decoder (the CUDA
                      decode kernel)
- ops.lz            — tpu-lzhuff-v1's LZ match analysis (torch ops)
- ops._cuda         — nvcc build, ctypes binding and launch counts

Every wrapper takes its plain PyTorch version for a CPU tensor and launches
its kernel (or raises) for a CUDA tensor.
"""
