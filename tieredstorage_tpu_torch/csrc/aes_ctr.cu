// AES-256-CTR keystream for GCM, bitsliced, for sm_90a.
//
// Replaces tieredstorage_tpu/ops/aes_pallas.py `_aes_kernel` (the Pallas
// bitsliced AES-256 circuit) together with the counter packing and byte
// unpacking that tieredstorage_tpu/ops/aes_bitsliced.py `ctr_keystream_batch`
// does around it in XLA.
//
// Function: out[r, i, :] = AES-256_K(iv[r] || be32(first_counter + i mod 2^32))
// for r < batch, i < n_blocks — the plain version is
// ops/aes_bitsliced.ctr_keystream_batch_plain.
//
// Design: one thread per 32 consecutive counter blocks of one row. The thread
// keeps the 16x8 bit-planes of its 32 blocks in 128 registers (word bit j =
// block j), packs the counters into planes itself, runs 14 rounds (SubBytes is
// the generated straight-line tower circuit of aes_sbox_circuit.cuh,
// ShiftRows is register relabelling, MixColumns is XORs, the round-key masks
// sit in shared memory), and transposes the planes back to bytes for one
// 16-byte store per block. The circuit is free of table lookups: no memory
// address depends on key or data, so there is no cache or bank timing channel
// (a T-table AES in shared memory would have one).
//
// Bound on the H100: integer operations. Per 32 blocks the circuit costs 14
// rounds x 16 S-boxes x TST_SBOX_GATES gates, 13 x 528 MixColumns XORs and
// 15 x 128 AddRoundKey XORs (about 53k 32-bit logic ops, ~100 ops per
// keystream byte), against 16 bytes written per block. The design spends no memory traffic beyond the
// one write of the output; what it does not yet do is use LOP3's three-input
// gates deliberately or overlap the byte transpose with the circuit.

#include <cstdint>
#include <cuda_runtime.h>

#include "aes_sbox_circuit.cuh"

namespace {

constexpr int kRounds = 14;
constexpr int kThreads = 128;

// ShiftRows in FIPS column-major layout: new[p] = old[sr(p)], p = 4*col + row.
__device__ __forceinline__ constexpr int sr(int p) {
  return 4 * (((p >> 2) + (p & 3)) & 3) + (p & 3);
}

__device__ __forceinline__ void sub_bytes(uint32_t (&s)[128]) {
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    tst_sbox(s[p * 8 + 0], s[p * 8 + 1], s[p * 8 + 2], s[p * 8 + 3],
             s[p * 8 + 4], s[p * 8 + 5], s[p * 8 + 6], s[p * 8 + 7]);
  }
}

__device__ __forceinline__ void shift_rows(uint32_t (&s)[128]) {
  uint32_t t[128];
#pragma unroll
  for (int p = 0; p < 16; ++p) {
#pragma unroll
    for (int b = 0; b < 8; ++b) t[p * 8 + b] = s[sr(p) * 8 + b];
  }
#pragma unroll
  for (int i = 0; i < 128; ++i) s[i] = t[i];
}

// out_r = xtime(a_r ^ a_{r+1}) ^ a_r ^ (a_0 ^ a_1 ^ a_2 ^ a_3); xtime on
// planes is [x7, x0^x7, x1, x2^x7, x3^x7, x4, x5, x6] (poly 0x11B).
__device__ __forceinline__ void mix_columns(uint32_t (&s)[128]) {
#pragma unroll
  for (int col = 0; col < 4; ++col) {
    uint32_t a[4][8];
    uint32_t all4[8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int b = 0; b < 8; ++b) a[r][b] = s[(col * 4 + r) * 8 + b];
    }
#pragma unroll
    for (int b = 0; b < 8; ++b) all4[b] = a[0][b] ^ a[1][b] ^ a[2][b] ^ a[3][b];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t x[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) x[b] = a[r][b] ^ a[(r + 1) & 3][b];
      const uint32_t xt[8] = {x[7], x[0] ^ x[7], x[1], x[2] ^ x[7],
                              x[3] ^ x[7], x[4], x[5], x[6]};
#pragma unroll
      for (int b = 0; b < 8; ++b) s[(col * 4 + r) * 8 + b] = xt[b] ^ a[r][b] ^ all4[b];
    }
  }
}

__device__ __forceinline__ void add_round_key(uint32_t (&s)[128], const uint32_t* rk) {
#pragma unroll
  for (int i = 0; i < 128; ++i) s[i] ^= rk[i];
}

__global__ void __launch_bounds__(kThreads) aes_ctr_kernel(
    const uint8_t* __restrict__ round_keys, const uint8_t* __restrict__ ivs,
    uint32_t first_counter, int n_blocks, int words_per_row,
    uint8_t* __restrict__ out) {
  // Round-key masks: rkm[rnd*128 + p*8 + b] = all ones if bit b of key byte
  // p of round rnd is set.
  __shared__ uint32_t rkm[(kRounds + 1) * 128];
  for (int i = threadIdx.x; i < (kRounds + 1) * 128; i += blockDim.x) {
    const int rnd = i >> 7, p = (i >> 3) & 15, b = i & 7;
    rkm[i] = 0u - ((uint32_t(round_keys[rnd * 16 + p]) >> b) & 1u);
  }
  __syncthreads();

  const int row = blockIdx.y;
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= words_per_row) return;

  uint32_t s[128];
  // IV bytes 0..11: the same for all 32 blocks -> full-word masks.
#pragma unroll
  for (int p = 0; p < 12; ++p) {
    const uint32_t byte = ivs[row * 12 + p];
#pragma unroll
    for (int b = 0; b < 8; ++b) s[p * 8 + b] = 0u - ((byte >> b) & 1u);
  }
  // Counter bytes 12..15, big-endian: plane (12+q, b) bit j is bit
  // 8*(3-q)+b of counter base+j.
#pragma unroll
  for (int i = 96; i < 128; ++i) s[i] = 0u;
  const uint32_t base = first_counter + 32u * uint32_t(w);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const uint32_t c = base + uint32_t(j);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int b = 0; b < 8; ++b) s[(12 + q) * 8 + b] |= ((c >> (8 * (3 - q) + b)) & 1u) << j;
    }
  }

  add_round_key(s, rkm);
#pragma unroll 1
  for (int rnd = 1; rnd < kRounds; ++rnd) {
    sub_bytes(s);
    shift_rows(s);
    mix_columns(s);
    add_round_key(s, rkm + rnd * 128);
  }
  sub_bytes(s);
  shift_rows(s);
  add_round_key(s, rkm + kRounds * 128);

  // Planes back to bytes: byte p of block j is sum_b ((s[p*8+b] >> j) & 1) << b.
  uint8_t* dst = out + (size_t(row) * size_t(n_blocks) + size_t(w) * 32u) * 16u;
  const int count = min(32, n_blocks - w * 32);
#pragma unroll 1
  for (int j = 0; j < count; ++j) {
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      uint32_t byte = 0u;
#pragma unroll
      for (int b = 0; b < 8; ++b) byte |= ((s[p * 8 + b] >> j) & 1u) << b;
      v[p >> 2] |= byte << (8 * (p & 3));
    }
    *reinterpret_cast<uint4*>(dst + size_t(j) * 16u) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

}  // namespace

extern "C" int tst_aes_ctr_keystream(const void* round_keys, const void* ivs,
                                     unsigned int first_counter, int n_blocks,
                                     int batch, void* out, void* stream) {
  const int words = (n_blocks + 31) / 32;
  const dim3 grid((words + kThreads - 1) / kThreads, batch);
  aes_ctr_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(round_keys), static_cast<const uint8_t*>(ivs),
      first_counter, n_blocks, words, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tst_aes_sbox_gates() { return TST_SBOX_GATES; }
