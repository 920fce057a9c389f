// Block-parallel canonical-Huffman decode (tpu-huff-v1), for sm_90a.
//
// Replaces the jnp program tieredstorage_tpu/ops/huffman.py `decode_batch`:
// a lax.scan of JUMP_BLOCK = 4096 dependent steps over [B, J] lanes, which
// XLA compiles into one device loop and eager PyTorch would run as about 45
// launches per step. Here the whole scan is one launch.
//
// One thread per (row b, jump block j) lane. A block of kThreads lanes of
// one row keeps that row's canonical tables (first_code, counts, base: 16
// each; perm: 256) in shared memory. Each lane starts at bit jump[b, j] and
// runs 4096 steps: a 15-bit MSB-first window from two words of the row,
// bit-reversed; the length l is the first of 1..15 with
// first[l] <= window >> (15 - l) < first[l] + counts[l] (none: length index
// 0, one bit, as argmax of an all-false row); the symbol is
// perm[clip(base[l] + u - first[l], 0, 255)]; bitpos advances by l.
//
// The output equals the scan's on every input, corrupt ones included,
// because the corruption checks of transform/thuff.py compare final_bitpos:
// the word index is min(bitpos >> 5, W - 2) (arithmetic shift); a negative
// index wraps once by W and otherwise reads all ones, as the JAX gather's
// fill does; bitpos is int32 and wraps. Symbols are gathered four at a time
// into a word and written as 16-byte stores.
//
// Outputs: symbols uint8[B, J * 4096] (lane (b, j) writes bytes
// [j * 4096, (j + 1) * 4096) of row b) and final_bitpos int32[B, J].
//
// Bound on the H100: the bytes, the words and jump offsets read once and the
// symbols written once (a 4 MiB row moves about 7.5 MB). This simple kernel
// is far from it: latency-bound, each lane's 4096 steps are one dependent
// chain (two word loads, the 15-way test, the select), and a one-row fetch's
// 1024 lanes fill 8 of the 132 SMs. A bit buffer in registers refilled every
// 32 bits would shorten the chain; more, smaller blocks would spread a row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kJumpBlock = 4096;
constexpr int kMaxCodeLen = 15;
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t load_word(const uint32_t* row, int w, int i) {
  if (i < 0) i += w;
  return (i >= 0 && i < w) ? __ldg(row + i) : 0xFFFFFFFFu;
}

__global__ void __launch_bounds__(kThreads)
huffman_decode_kernel(const uint32_t* __restrict__ words, int w, const int32_t* __restrict__ jump,
                      int n_blocks, const int32_t* __restrict__ first_code,
                      const int32_t* __restrict__ counts, const int32_t* __restrict__ base,
                      const int32_t* __restrict__ perm, uint8_t* __restrict__ symbols,
                      int32_t* __restrict__ final_bitpos) {
  __shared__ int32_t s_first[16];
  __shared__ int32_t s_end[16];   // first + counts
  __shared__ int32_t s_base[16];
  __shared__ uint8_t s_perm[256];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    s_perm[i] = static_cast<uint8_t>(perm[b * 256 + i]);
    if (i < 16) {
      s_first[i] = first_code[b * 16 + i];
      s_end[i] = first_code[b * 16 + i] + counts[b * 16 + i];
      s_base[i] = base[b * 16 + i];
    }
  }
  __syncthreads();
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n_blocks) return;

  const uint32_t* row = words + static_cast<size_t>(b) * w;
  uint4* out = reinterpret_cast<uint4*>(symbols + (static_cast<size_t>(b) * n_blocks + j) * kJumpBlock);
  uint32_t bitpos = static_cast<uint32_t>(jump[static_cast<size_t>(b) * n_blocks + j]);
  // The range test's bounds in registers (every index below is a constant).
  int first[kMaxCodeLen + 1], end[kMaxCodeLen + 1];
#pragma unroll
  for (int l = 1; l <= kMaxCodeLen; ++l) {
    first[l] = s_first[l];
    end[l] = s_end[l];
  }
  for (int t0 = 0; t0 < kJumpBlock; t0 += 16) {
    uint32_t packed[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int bp = static_cast<int>(bitpos);
      const int widx = min(bp >> 5, w - 2);
      const uint32_t s = bitpos & 31u;
      const uint32_t w0 = load_word(row, w, widx);
      const uint32_t w1 = load_word(row, w, widx + 1);
      const uint32_t window = (w0 >> s) | (s == 0 ? 0u : (w1 << (32u - s)));
      const int u15 = static_cast<int>(__brev(window & 0x7FFFu) >> 17);
      int l_sel = 0;  // index into lengths 1..15; stays 0 when none matches
#pragma unroll
      for (int l = kMaxCodeLen; l >= 1; --l) {
        const int u = u15 >> (kMaxCodeLen - l);
        if (u >= first[l] && u < end[l]) l_sel = l - 1;
      }
      const int l = l_sel + 1;
      const int u = u15 >> (kMaxCodeLen - l);
      const int idx = min(max(s_base[l] + u - s_first[l], 0), 255);
      packed[k >> 2] |= static_cast<uint32_t>(s_perm[idx]) << (8 * (k & 3));
      bitpos += static_cast<uint32_t>(l);
    }
    out[t0 >> 4] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
  final_bitpos[static_cast<size_t>(b) * n_blocks + j] = static_cast<int32_t>(bitpos);
}

}  // namespace

// words: uint32[rows, w] (int32 bit patterns); jump: int32[rows, n_blocks];
// first_code, counts, base: int32[rows, 16]; perm: int32[rows, 256];
// symbols: uint8[rows, n_blocks * 4096]; final_bitpos: int32[rows, n_blocks].
extern "C" int tst_huffman_decode(const void* words, int w, const void* jump, int n_blocks,
                                  const void* first_code, const void* counts, const void* base,
                                  const void* perm, int rows, void* symbols, void* final_bitpos,
                                  void* stream) {
  const dim3 grid((n_blocks + kThreads - 1) / kThreads, rows);
  huffman_decode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), w, static_cast<const int32_t*>(jump), n_blocks,
      static_cast<const int32_t*>(first_code), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(base), static_cast<const int32_t*>(perm),
      static_cast<uint8_t*>(symbols), static_cast<int32_t*>(final_bitpos));
  return static_cast<int>(cudaGetLastError());
}
