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
// Bound on the H100: logic operations (chip_smoke.py `AES_GATES_PER_BLOCK`,
// `LOGIC_GATES_PER_S`). Counted whatever computes them, at the smallest
// published circuits (a 113-gate S-box, Boyar and Peralta; a 92-XOR
// MixColumns, Maximov 2019), and leaving out what CTR makes the same for 32
// aligned counters (the IV, the counter's top 27 bits, so round 1 and most
// of round 2), a block costs 27 860 two-input gates. A LOP3 computes one
// function of three inputs, which never takes more than 4 such gates, and
// an SM retires 64 LOP3 per clock: at most 4 x 64 x 132 x 1.98 GHz =
// 66.9e12 gates/s on 32-bit words. The 16 bytes written per block take
// about a third of that time.
//
// Design. It replaces an earlier one-thread-per-word kernel (128 plane
// registers, 181 in all, so a 4 MiB row filled 65 SMs with one warp each; a
// 198-gate tower-field S-box; a bit-by-bit output transpose). Now a quad of
// lanes carries one 32-block word: lane c holds AES column c (byte positions
// 4c..4c+3) as 4 x 8 bit-planes in 32 registers, word bit j being block
// 8j + q of the warp's 256 blocks (q = the quad's index in the warp).
// - SubBytes, MixColumns and AddRoundKey are lane-local; ShiftRows brings
//   rows 1-3 from lanes c + 1..3 of the quad: 24 `__shfl_sync` per lane per
//   round.
// - SubBytes is Boyar and Peralta's 115-gate S-box as 74 three-input LOP3s
//   (aes_sbox_circuit.cuh, the least cover of that circuit by three-input
//   cuts); MixColumns plus AddRoundKey is 92 three-input XORs per column.
//   A round is 388 LOP3 per lane (4 x 74 + 92).
// - The counters enter and the keystream leaves through 32x32 bit-matrix
//   transposes (two byte-permute stages, three mask-and-shift stages), so
//   lane c ends with the 4 bytes of column c of each of its 32 blocks and
//   the warp stores 128 contiguous bytes per instruction.
// - One 4 MiB row (262 145 blocks) is 1025 warps over all 132 SMs, and 72
//   registers leave room for 7 blocks per SM when rows are many.
// - Round-key masks sit in shared memory at addresses that depend only on
//   round and column. No memory address depends on key or data, so there is
//   no cache or bank timing channel (a T-table AES in shared memory would
//   have one).

#include <cstdint>
#include <cuda_runtime.h>

#include "aes_sbox_circuit.cuh"

namespace {

constexpr int kRounds = 14;
constexpr int kThreads = 128;
constexpr int kBlocksPerWarp = 256;  // 8 quads x 32 blocks
// Words per (round, column) of round-key masks: 32, padded so that the four
// columns' 16-byte loads fall in different banks.
constexpr int kRkStride = 36;

template <int S>
__device__ __forceinline__ void swap_stage(uint32_t (&a)[32], uint32_t mask) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (i & S) continue;
    const uint32_t t = ((a[i] >> S) ^ a[i + S]) & mask;
    a[i + S] ^= t;
    a[i] ^= t << S;
  }
}

// 32x32 bit-matrix transpose in place: bit k of a[i] becomes bit i of a[k].
__device__ __forceinline__ void transpose32(uint32_t (&a)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t lo = a[i], hi = a[i + 16];
    a[i] = __byte_perm(lo, hi, 0x5410);
    a[i + 16] = __byte_perm(lo, hi, 0x7632);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (i & 8) continue;
    const uint32_t lo = a[i], hi = a[i + 8];
    a[i] = __byte_perm(lo, hi, 0x6240);
    a[i + 8] = __byte_perm(lo, hi, 0x7351);
  }
  swap_stage<4>(a, 0x0F0F0F0Fu);
  swap_stage<2>(a, 0x33333333u);
  swap_stage<1>(a, 0x55555555u);
}

// s[8r + b]: bit b of row r (byte position 4c + r) of this lane's column c.
__device__ __forceinline__ void sub_bytes(uint32_t (&s)[32]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    tst_sbox(s[8 * r + 0], s[8 * r + 1], s[8 * r + 2], s[8 * r + 3],
             s[8 * r + 4], s[8 * r + 5], s[8 * r + 6], s[8 * r + 7]);
  }
}

// Row r of column c comes from column (c + r) mod 4, the quad's lane c + r.
__device__ __forceinline__ void shift_rows(uint32_t (&s)[32], int lane) {
#pragma unroll
  for (int r = 1; r < 4; ++r) {
    const int src = (lane & ~3) | ((lane + r) & 3);
#pragma unroll
    for (int b = 0; b < 8; ++b) s[8 * r + b] = __shfl_sync(0xffffffffu, s[8 * r + b], src);
  }
}

// The 8 round-key masks of row r of this lane's column.
__device__ __forceinline__ void load_key_row(uint32_t (&k)[8], const uint32_t* rk, int r) {
  const uint4 lo = reinterpret_cast<const uint4*>(rk)[2 * r];
  const uint4 hi = reinterpret_cast<const uint4*>(rk)[2 * r + 1];
  k[0] = lo.x, k[1] = lo.y, k[2] = lo.z, k[3] = lo.w;
  k[4] = hi.x, k[5] = hi.y, k[6] = hi.z, k[7] = hi.w;
}

__device__ __forceinline__ void add_round_key(uint32_t (&s)[32], const uint32_t* rk) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t k[8];
    load_key_row(k, rk, r);
#pragma unroll
    for (int b = 0; b < 8; ++b) s[8 * r + b] ^= k[b];
  }
}

// MixColumns then AddRoundKey on this lane's column: out_r = xtime(a_r ^
// a_{r+1}) ^ a_r ^ (a_0 ^ a_1 ^ a_2 ^ a_3) ^ k_r, where xtime on planes is
// [x7, x0^x7, x1, x2^x7, x3^x7, x4, x5, x6] (poly 0x11B). As three-input
// XORs (LOP3 0x96): two per plane, three for the planes that take x7 too,
// beside two per bit for the column's a_0 ^ a_1 ^ a_2 ^ a_3: 92 per column.
__device__ __forceinline__ void mix_columns_add_key(uint32_t (&s)[32], const uint32_t* rk) {
  uint32_t a[32], all4[8];
#pragma unroll
  for (int i = 0; i < 32; ++i) a[i] = s[i];
#pragma unroll
  for (int b = 0; b < 8; ++b) all4[b] = tst_lop3<0x96>(a[b], a[8 + b], a[16 + b]) ^ a[24 + b];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t* ar = a + 8 * r;
    const uint32_t* an = a + 8 * ((r + 1) & 3);
    uint32_t k[8];
    load_key_row(k, rk, r);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const uint32_t t = tst_lop3<0x96>(all4[b], ar[b], k[b]);
      if (b == 0) {
        s[8 * r] = tst_lop3<0x96>(t, ar[7], an[7]);
      } else if (b == 1 || b == 3 || b == 4) {
        s[8 * r + b] = tst_lop3<0x96>(t, tst_lop3<0x96>(ar[b - 1], an[b - 1], ar[7]), an[7]);
      } else {
        s[8 * r + b] = tst_lop3<0x96>(t, ar[b - 1], an[b - 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) aes_ctr_kernel(
    const uint8_t* __restrict__ round_keys, const uint8_t* __restrict__ ivs,
    uint32_t first_counter, int n_blocks, uint8_t* __restrict__ out) {
  // Round-key masks: rkm[(rnd*4 + c)*kRkStride + 8r + b] = all ones if bit b
  // of key byte 4c + r of round rnd is set.
  __shared__ __align__(16) uint32_t rkm[(kRounds + 1) * 4 * kRkStride];
  for (int i = threadIdx.x; i < (kRounds + 1) * 128; i += blockDim.x) {
    const int rnd = i >> 7, c = (i >> 5) & 3, r = (i >> 3) & 3, b = i & 7;
    rkm[(rnd * 4 + c) * kRkStride + 8 * r + b] =
        0u - ((uint32_t(round_keys[rnd * 16 + 4 * c + r]) >> b) & 1u);
  }
  __syncthreads();

  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int base = warp * kBlocksPerWarp;
  if (base >= n_blocks) return;  // whole warps only: the shuffles need all 32 lanes
  const int q = lane >> 2, c = lane & 3;

  // Column c of block base + 8j + q as a little-endian word: IV bytes
  // 4c..4c+3 for c < 3, the big-endian counter for c = 3. Transposed, word
  // 8r + b holds bit b of byte 4c + r for the 32 blocks.
  const uint8_t* iv = ivs + row * 12 + 4 * min(c, 2);
  const uint32_t iv_word = uint32_t(iv[0]) | uint32_t(iv[1]) << 8 |
                           uint32_t(iv[2]) << 16 | uint32_t(iv[3]) << 24;
  const uint32_t ctr0 = first_counter + uint32_t(base + q);
  uint32_t s[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    s[j] = c == 3 ? __byte_perm(ctr0 + 8u * uint32_t(j), 0u, 0x0123) : iv_word;
  }
  transpose32(s);

  const uint32_t* rk = rkm + c * kRkStride;
  add_round_key(s, rk);
#pragma unroll 1
  for (int rnd = 1; rnd < kRounds; ++rnd) {
    sub_bytes(s);
    shift_rows(s, lane);
    mix_columns_add_key(s, rk + rnd * 4 * kRkStride);
  }
  sub_bytes(s);
  shift_rows(s, lane);
  add_round_key(s, rk + kRounds * 4 * kRkStride);

  // Back to bytes: word j is column c of block base + 8j + q. For each j the
  // warp writes the 16 bytes of 8 consecutive blocks.
  transpose32(s);
  uint32_t* dst = reinterpret_cast<uint32_t*>(out) + size_t(row) * size_t(n_blocks) * 4u;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int i = base + 8 * j + q;
    if (i < n_blocks) dst[size_t(i) * 4u + c] = s[j];
  }
}

}  // namespace

extern "C" int tst_aes_ctr_keystream(const void* round_keys, const void* ivs,
                                     unsigned int first_counter, int n_blocks,
                                     int batch, void* out, void* stream) {
  const int warps = (n_blocks + kBlocksPerWarp - 1) / kBlocksPerWarp;
  const dim3 grid((warps + kThreads / 32 - 1) / (kThreads / 32), batch);
  aes_ctr_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(round_keys), static_cast<const uint8_t*>(ivs),
      first_counter, n_blocks, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
