// GHASH reductions over GF(2) bit matrices, for sm_90a.
//
// Replaces tieredstorage_tpu/ops/ghash_pallas.py `_ghash_tree_kernel` (the
// whole T(C) reduction) and `_ghash_l1_kernel` (level 1 only).
//
// Level-1 node of a K-byte group: node[o] = parity over (byte k, bit p) of
// bit_p(data[k]) * w1[p, k, o], for the 128 output bits o. The Pallas
// kernels compute it as 8 f32 MXU matmuls; here it is the tensor cores' b1
// product (mma m16n8k256 .and.popc: popc(A_row & B_col) summed over 256-bit
// k-steps) and the low bit of the sum. The wrapper (ops/ghash_cuda.py) packs
// w1 once per context into bit-columns: w1_words[q][o][j] holds, at bit
// 8*i + p, the coefficient w1[p, 16*q + 4*j + i, o] — so the data row, read
// as little-endian uint32 words, is the A operand as it is, bit for bit
// against B.
//
// Nodes (`slice_nodes`, shared by both kernels): one block of 256 threads
// takes kSlice = 16 groups, one m16 tile: a bit-GEMM of M = 16 groups by
// N = 128 outputs over 8K bits. w1 streams through shared memory in tiles
// of 8 quads (16 KiB, 4 k-steps), three stages deep with cp.async, beside
// the same 8 quads of the 16 groups (quad-major: quad q of the groups side
// by side). Each w1 tile is used against all 16 groups before the next one
// lands, so w1 crosses L2 once per 16 groups rather than once per group.
// Warp w takes one k-step of each tile and half of the 16 n-tiles; the low
// bits of the four k-step warps' sums meet by XOR after ballots regroup
// them into node words. Every fragment load is a conflict-free 128-byte row
// of shared memory.
//
// Tree: the Pallas grid's sequential group axis is gone. The fold is linear,
// T = sum_g node_g * M^(G-1-g) with M = M_{H^(K/16)}, so the groups are cut
// into slices of kSlice counted from the end of the row (the first slice's
// missing groups read as zeros, the polynomial's identity) and the grid is
// ceil(G / kSlice) x rows blocks: a one-row fetch of G = 2048 runs 128.
// Each block folds its slice in order with M (one warp, T held as four
// ballot words, starting from T = 0 so the first fold is the identity) into
// a 16-byte partial. A second small launch, one warp per row, folds the
// row's partials in order with M^kSlice, which the wrapper derives from M
// once per context. Both launches are one `tst_ghash_tree` call.
//
// Bound on the H100: 8 x 128 bit-products per data byte. The b1 product
// does them without unpacking bit planes, at a rate (measured by
// tools/torch_mma_rate_probe.py) that leaves the bytes — each data byte and
// w1 read once — as the least time; the kernel reads w1 from L2 once per
// block (256 KiB at K = 2048) and adds the serial folds and their latency.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBits = 128;
constexpr int kSlice = 16;                 // groups per slice (S): the m16 of the b1 mma
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileQuads = kWarps;         // w1 quads per tile: 4 k-steps of 256 bits
constexpr int kTileWords = kTileQuads * kBits;  // uint4 per w1 tile
constexpr int kStages = 3;                 // depth of the cp.async ring
constexpr int kNTilesPerWarp = kBits / 8 / 2;  // two warps share the 16 n-tiles of a k-step
// A stage: a w1 tile, then the same 8 quads of the slice's 16 groups.
constexpr int kStageWords = kTileWords + kTileQuads * kSlice;

// Dynamic shared memory of the node kernels: the ring of stages.
constexpr size_t kNodeSmemBytes = size_t(kStages) * kStageWords * sizeof(uint4);

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

// Bits 0..3 of x to bits 0, 2, 4, 6.
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return (x & 1u) | ((x & 2u) << 1) | ((x & 4u) << 2) | ((x & 8u) << 3);
}

__device__ __forceinline__ uint4 shfl4(uint4 v, int lane) {
  return make_uint4(__shfl_sync(0xffffffffu, v.x, lane), __shfl_sync(0xffffffffu, v.y, lane),
                    __shfl_sync(0xffffffffu, v.z, lane), __shfl_sync(0xffffffffu, v.w, lane));
}

// Node words of kSlice groups: group i is group `first + i` of `src`
// (n_quads 16-byte words each), and groups outside [0, limit) are zeros. On
// return nodes[i][w] bit l is node bit 32w + l of group i (all threads of
// the block must call it; it ends on a barrier).
__device__ void slice_nodes(const uint4* __restrict__ src, long long first, long long limit, int n_quads,
                            const uint4* __restrict__ w1, uint4* smem,
                            uint8_t (*red)[kSlice][kNTilesPerWarp], uint32_t (*nodes)[4]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (n_quads + kTileQuads - 1) / kTileQuads;

  // Stage t % kStages: w1 quads 8t .. 8t + 7 ([quad][output]), then the same
  // quads of the groups ([quad][group]). For the data, neighbouring threads
  // take the same quad of neighbouring groups: 32-byte sectors from L2,
  // consecutive 16-byte words in shared memory.
  auto load_tile = [&](int t) {
    const int quads = min(kTileQuads, n_quads - t * kTileQuads);
    uint4* stage = smem + (t % kStages) * kStageWords;
    const uint4* from = w1 + size_t(t) * kTileWords;
    for (int idx = tid; idx < quads * kBits; idx += kThreads) cp_async16(stage + idx, from + idx);
    uint4* to = stage + kTileWords;
    for (int idx = tid; idx < quads * kSlice; idx += kThreads) {
      const long long gg = first + idx % kSlice;
      const int q = t * kTileQuads + idx / kSlice;
      if (gg >= 0 && gg < limit) {
        cp_async16(to + idx, src + gg * n_quads + q);
      } else {
        to[idx] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();
  }

  // Warp w takes k-step w % 4 of each tile (quads 2k, 2k + 1: 256 bits) and
  // output n-tiles 8 * (w / 4) .. + 7. Lane (g, t): A rows g and g + 8,
  // B column g, 32-bit k-slots t and t + 4 (the m16n8k256 fragments).
  const int g = lane >> 2, t4 = lane & 3, ks = warp & 3, half = warp >> 2;
  int acc[kNTilesPerWarp][4];
#pragma unroll
  for (int n = 0; n < kNTilesPerWarp; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t has landed, and every warp is done with tile t - 1
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    cp_async_commit();
    const int q0 = t * kTileQuads + 2 * ks;
    if (q0 < n_quads) {
      // The second quad of a short last tile is absent: its slots read as 0.
      const bool second = q0 + 1 < n_quads;
      const uint32_t* stage = reinterpret_cast<const uint32_t*>(smem + (t % kStages) * kStageWords);
      const uint32_t* w0 = stage + ((2 * ks) * kBits + half * 64 + g) * 4 + t4;
      const uint32_t* d0 = stage + (kTileWords + (2 * ks) * kSlice + g) * 4 + t4;
      const uint32_t a0 = d0[0], a1 = d0[8 * 4];
      const uint32_t a2 = second ? d0[kSlice * 4] : 0u, a3 = second ? d0[kSlice * 4 + 8 * 4] : 0u;
#pragma unroll
      for (int n = 0; n < kNTilesPerWarp; ++n) {
        const uint32_t b0 = w0[n * 8 * 4], b1 = second ? w0[(kBits + n * 8) * 4] : 0u;
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(acc[n][0]), "+r"(acc[n][1]), "+r"(acc[n][2]), "+r"(acc[n][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }

  // acc[n][c] is the popcount for row g (+8 for c >= 2), column 2t + (c & 1)
  // of n-tile n; its low bit is this warp's share of the node bit. Ballots
  // regroup each row's 8 columns of an n-tile into one byte.
#pragma unroll
  for (int n = 0; n < kNTilesPerWarp; ++n) {
    uint32_t v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = __ballot_sync(0xffffffffu, acc[n][c] & 1);
    if (t4 == 0) {
      const int sh = 4 * g;
      red[warp][g][n] = uint8_t(spread4((v[0] >> sh) & 0xfu) | (spread4((v[1] >> sh) & 0xfu) << 1));
      red[warp][g + 8][n] = uint8_t(spread4((v[2] >> sh) & 0xfu) | (spread4((v[3] >> sh) & 0xfu) << 1));
    }
  }
  __syncthreads();
  // Node word w holds n-tiles 4w .. 4w + 3: half w / 2 of the outputs, whose
  // four k-step warps meet by XOR.
  if (tid < kSlice * 4) {
    const int m = tid >> 2, w = tid & 3, h = w >> 1;
    uint32_t v = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) v ^= *reinterpret_cast<const uint32_t*>(&red[4 * h + k][m][4 * (w & 1)]);
    nodes[m][w] = v;
  }
  __syncthreads();
}

// A fold matrix for one warp: lane l keeps the packed columns o = l + 32r
// (col[r][w] bit l' = M[32w + l', o]).
__device__ __forceinline__ void load_cols(const uint32_t* __restrict__ packed, uint32_t (&col)[4][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int w = 0; w < 4; ++w) col[r][w] = packed[(lane + 32 * r) * 4 + w];
}

// T * M for T held as the same four words in every lane of the warp.
__device__ __forceinline__ uint4 fold(uint4 t, const uint32_t (&col)[4][4]) {
  uint32_t out[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t x = (t.x & col[r][0]) ^ (t.y & col[r][1]) ^ (t.z & col[r][2]) ^ (t.w & col[r][3]);
    out[r] = __ballot_sync(0xffffffffu, __popc(x) & 1u);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// Level 1 over rows of one group each: a block takes kSlice rows.
__global__ void __launch_bounds__(kThreads, 1) ghash_level1_kernel(
    const uint4* __restrict__ data, int rows, int n_quads, const uint4* __restrict__ w1,
    uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  __shared__ __align__(4) uint8_t red[kWarps][kSlice][kNTilesPerWarp];
  __shared__ uint32_t nodes[kSlice][4];
  const long long first = static_cast<long long>(blockIdx.x) * kSlice;
  slice_nodes(data, first, rows, n_quads, w1, smem, red, nodes);
  for (int idx = threadIdx.x; idx < kSlice * kBits; idx += kThreads) {
    const int g = idx / kBits, o = idx % kBits;
    if (first + g < rows) out[(first + g) * kBits + o] = uint8_t((nodes[g][o >> 5] >> (o & 31)) & 1u);
  }
}

// Slice blockIdx.x of row blockIdx.y, folded with M into one partial.
__global__ void __launch_bounds__(kThreads, 1) ghash_tree_slices_kernel(
    const uint4* __restrict__ data, int groups, int n_quads, const uint4* __restrict__ w1,
    const uint32_t* __restrict__ step, uint4* __restrict__ partials) {
  extern __shared__ uint4 smem[];
  __shared__ __align__(4) uint8_t red[kWarps][kSlice][kNTilesPerWarp];
  __shared__ __align__(16) uint32_t nodes[kSlice][4];
  const int slice = blockIdx.x, n_slices = gridDim.x, row = blockIdx.y;
  const long long first = static_cast<long long>(groups) - static_cast<long long>(n_slices - slice) * kSlice;
  slice_nodes(data + size_t(row) * size_t(groups) * size_t(n_quads), first, groups, n_quads, w1, smem,
              red, nodes);
  if (threadIdx.x < 32) {
    uint32_t col[4][4];
    load_cols(step, col);
    uint4 t = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int i = 0; i < kSlice; ++i) t = xor4(fold(t, col), *reinterpret_cast<const uint4*>(nodes[i]));
    if (threadIdx.x == 0) partials[size_t(row) * n_slices + slice] = t;
  }
}

// One warp per row: the row's partials folded in order with M^kSlice. They
// are taken 32 at a time counted from the end of the row, so a short first
// batch is zeros in front (the fold's identity) and every batch is the same
// unrolled loop. Lane j holds partial j of its batch, and the next batch
// loads while this one folds, so the serial fold never waits on L2.
__global__ void __launch_bounds__(32) ghash_tree_combine_kernel(
    const uint4* __restrict__ partials, int n_slices, const uint32_t* __restrict__ slice_step,
    uint8_t* __restrict__ out) {
  const int row = blockIdx.x, lane = threadIdx.x;
  const uint4* p = partials + size_t(row) * n_slices;
  const int n_batches = (n_slices + 31) / 32, first = n_slices - 32 * n_batches;
  auto load = [&](int b) {
    const int s = first + 32 * b + lane;
    return s >= 0 ? p[s] : make_uint4(0u, 0u, 0u, 0u);
  };
  uint32_t col[4][4];
  load_cols(slice_step, col);
  uint4 next = load(0), t = make_uint4(0u, 0u, 0u, 0u);
  for (int b = 0; b < n_batches; ++b) {
    const uint4 mine = next;
    if (b + 1 < n_batches) next = load(b + 1);
#pragma unroll
    for (int j = 0; j < 32; ++j) t = xor4(fold(t, col), shfl4(mine, j));
  }
  const uint32_t words[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) out[size_t(row) * kBits + lane + 32 * r] = uint8_t((words[r] >> lane) & 1u);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

}  // namespace

extern "C" int tst_ghash_level1(const void* data, int rows, int k_bytes, const void* w1_words,
                                void* out, void* stream) {
  cudaError_t err = allow_smem(ghash_level1_kernel, kNodeSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ghash_level1_kernel<<<(rows + kSlice - 1) / kSlice, kThreads, kNodeSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(data), rows, k_bytes / 16, static_cast<const uint4*>(w1_words),
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Groups per slice: the wrapper sizes the partials by it and derives M^S.
extern "C" int tst_ghash_tree_slice() { return kSlice; }

// partials: uint4[rows, ceil(groups / kSlice)] scratch; slice_step_words:
// M^kSlice, packed as step_words.
extern "C" int tst_ghash_tree(const void* data, int rows, int groups, int k_bytes, const void* w1_words,
                              const void* step_words, const void* slice_step_words, void* partials,
                              void* out, void* stream) {
  const int n_slices = (groups + kSlice - 1) / kSlice;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_smem(ghash_tree_slices_kernel, kNodeSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ghash_tree_slices_kernel<<<dim3(n_slices, rows), kThreads, kNodeSmemBytes, s>>>(
      static_cast<const uint4*>(data), groups, k_bytes / 16, static_cast<const uint4*>(w1_words),
      static_cast<const uint32_t*>(step_words), static_cast<uint4*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ghash_tree_combine_kernel<<<rows, 32, 0, s>>>(
      static_cast<const uint4*>(partials), n_slices, static_cast<const uint32_t*>(slice_step_words),
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tst_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
