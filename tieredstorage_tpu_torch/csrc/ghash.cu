// GHASH reductions over GF(2) bit matrices, for sm_90a.
//
// Replaces tieredstorage_tpu/ops/ghash_pallas.py `_ghash_tree_kernel` (the
// whole T(C) reduction in one kernel) and `_ghash_l1_kernel` (level 1 only).
//
// Level-1 node of a K-byte group: node[o] = parity over (byte k, bit p) of
// bit_p(data[k]) * w1[p, k, o], for the 128 output bits o. The Pallas
// kernels compute it as 8 f32 MXU matmuls; here it is AND + XOR + popcount on
// 32-bit words. The wrapper (ops/ghash_cuda.py) packs w1 once per context
// into bit-columns: w1_words[q][o][j] holds, at bit 8*i + p, the coefficient
// w1[p, 16*q + 4*j + i, o] — so the data row, read as little-endian uint32
// words, lines up bit for bit and node[o] = popc(XOR_q (data & w1)) & 1.
//
// Tree: the sequential group axis of the Pallas grid becomes a loop inside
// the block. One block per row walks its G groups in order and folds
// T = (T * M_{H^k}) ^ node_g between them; the step matrix is packed the
// same way (step_words[o][w] bit l = step[32*w + l, o]). Only the final
// [rows, 128] bits leave the kernel.
//
// Design: 512 threads per block = 4 slices x 128 output bits. Thread (s, o)
// XOR-accumulates data & w1 over the group's 16-byte words q = s, s+4, ...;
// the four slices' partial words meet in shared memory (double-buffered, one
// barrier per group), and the 128 threads of slice 0 take the parity, fold,
// and rebuild T as four ballot words.
//
// Bound on the H100: integer operations — 2 logic ops (AND, XOR) per 32 data
// bits per output bit, i.e. 64 ops per data byte, against reading each data
// byte once. Known weaknesses, left for a later change: the packed w1 is
// 256 KiB at K = 2048, more than the 227 KB of shared memory a block has, so
// it is read through L2 for every group; and the tree runs one block per row,
// so a 16-row window occupies 16 of the 132 SMs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBits = 128;
constexpr int kSlices = 4;
constexpr int kThreads = kBits * kSlices;

// This thread's partial word for output bit o over 16-byte words q = s, s+4, ...
__device__ __forceinline__ uint32_t node_partial(const uint4* __restrict__ group,
                                                 const uint4* __restrict__ w1,
                                                 int n_quads, int s, int o) {
  uint32_t acc = 0u;
#pragma unroll 4
  for (int q = s; q < n_quads; q += kSlices) {
    const uint4 d = group[q];
    const uint4 w = w1[q * kBits + o];
    acc ^= (d.x & w.x) ^ (d.y & w.y) ^ (d.z & w.z) ^ (d.w & w.w);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads) ghash_level1_kernel(
    const uint8_t* __restrict__ data, int k_bytes,
    const uint4* __restrict__ w1, uint8_t* __restrict__ out) {
  __shared__ uint32_t partial[kSlices][kBits];
  const int row = blockIdx.x;
  const int s = threadIdx.x / kBits, o = threadIdx.x % kBits;
  const uint4* group = reinterpret_cast<const uint4*>(data + size_t(row) * size_t(k_bytes));
  partial[s][o] = node_partial(group, w1, k_bytes / 16, s, o);
  __syncthreads();
  if (s == 0) {
    const uint32_t acc = partial[0][o] ^ partial[1][o] ^ partial[2][o] ^ partial[3][o];
    out[size_t(row) * kBits + o] = uint8_t(__popc(acc) & 1);
  }
}

__global__ void __launch_bounds__(kThreads) ghash_tree_kernel(
    const uint8_t* __restrict__ data, int groups, int k_bytes,
    const uint4* __restrict__ w1, const uint32_t* __restrict__ step,
    uint8_t* __restrict__ out) {
  __shared__ uint32_t partial[2][kSlices][kBits];
  __shared__ uint32_t t_words[2][kBits / 32];
  const int row = blockIdx.x;
  const int s = threadIdx.x / kBits, o = threadIdx.x % kBits;
  const int n_quads = k_bytes / 16;
  const uint8_t* row_data = data + size_t(row) * size_t(groups) * size_t(k_bytes);

  uint32_t step_col[4] = {0u, 0u, 0u, 0u};
  if (s == 0) {
#pragma unroll
    for (int w = 0; w < 4; ++w) step_col[w] = step[o * 4 + w];
  }

  uint32_t bit = 0u;
  for (int g = 0; g < groups; ++g) {
    const int buf = g & 1;
    const uint4* group = reinterpret_cast<const uint4*>(row_data + size_t(g) * size_t(k_bytes));
    partial[buf][s][o] = node_partial(group, w1, n_quads, s, o);
    __syncthreads();
    if (s == 0) {
      const uint32_t acc = partial[buf][0][o] ^ partial[buf][1][o] ^
                           partial[buf][2][o] ^ partial[buf][3][o];
      const uint32_t node = __popc(acc) & 1;
      if (g == 0) {
        bit = node;
      } else {
        const uint32_t* t = t_words[buf];
        const uint32_t x = (t[0] & step_col[0]) ^ (t[1] & step_col[1]) ^
                           (t[2] & step_col[2]) ^ (t[3] & step_col[3]);
        bit = (__popc(x) & 1) ^ node;
      }
      // Slice 0 is warps 0..3: lane l of warp w carries bit o = 32*w + l.
      const uint32_t word = __ballot_sync(0xffffffffu, bit);
      if ((o & 31) == 0) t_words[buf ^ 1][o >> 5] = word;
    }
  }
  if (s == 0) out[size_t(row) * kBits + o] = uint8_t(bit);
}

}  // namespace

extern "C" int tst_ghash_level1(const void* data, int rows, int k_bytes,
                                const void* w1_words, void* out, void* stream) {
  ghash_level1_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), k_bytes, static_cast<const uint4*>(w1_words),
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tst_ghash_tree(const void* data, int rows, int groups, int k_bytes,
                              const void* w1_words, const void* step_words, void* out,
                              void* stream) {
  ghash_tree_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), groups, k_bytes,
      static_cast<const uint4*>(w1_words), static_cast<const uint32_t*>(step_words),
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tst_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
