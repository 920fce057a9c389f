// Block-parallel canonical-Huffman decode (tpu-huff-v1), for sm_90a.
//
// Replaces the jnp program tieredstorage_tpu/ops/huffman.py `decode_batch`:
// a lax.scan of JUMP_BLOCK = 4096 dependent steps over [B, J] lanes, which
// XLA compiles into one device loop and eager PyTorch would run as about 45
// launches per step. Here the whole scan is one C call.
//
// The scan's step: a 15-bit MSB-first window from two words of the row at
// bitpos, bit-reversed (u15); the length l is the first of 1..15 with
// first[l] <= u15 >> (15 - l) < first[l] + counts[l] (none: length index 0,
// one bit, as argmax of an all-false row); the symbol is
// perm[clip(base[l] + u - first[l], 0, 255)]; bitpos advances by l. The
// corrupt-input rules are part of the function, because the corruption
// checks of transform/thuff.py compare final_bitpos: the word index is
// min(bitpos >> 5, W - 2) (arithmetic shift); a negative index wraps once by
// W and otherwise reads all ones, as the JAX gather's fill does; the symbol
// index is clipped to [0, 255]; bitpos is int32 and wraps.
//
// 1. huffman_table_kernel: (l, symbol) depends only on the window's raw low
//    15 bits and the row's tables, so one thread per (row, 15-bit value)
//    evaluates the step above once into a uint16 entry, symbol << 8 | l.
//    The table is exact for any tables, malformed ones too.
// 2. A decode kernel. A block copies its row's 64 KiB table into dynamic
//    shared memory, so a step is one shared load. A jump block whose every
//    step provably reads the stream's true bits (`fast_lane`: start >= 0,
//    never at the clamp, no int32 wrap) is read through `FastStream`: the
//    stream sits in a 64-bit register buffer fed from a ring of words in
//    shared memory, which global loads fill once per 16 steps, so a step's
//    dependent chain is the table load, a funnel shift by the entry (its
//    low 5 bits are l) and a mask. Any other jump block runs the scan's
//    exact step (two `load_word`s) and reads the same table.
//    - huffman_decode_kernel: one thread per jump block (a lane), packing
//      its symbols into 16-byte stores.
//    - huffman_split_kernel, for calls of few lanes (a one-row fetch has
//      1024): kSplit threads per jump block. The block's bits [start, end)
//      (end: the next block's jump offset where it is plausible) are cut
//      into kSplit regions; each thread decodes its region from the
//      region's first bit, a guess, to the first codeword start at or past
//      the next region. Then, until nothing changes, a thread whose start
//      differs from its left neighbour's end decodes again from that end.
//      Each step is a function of bitpos alone, so at the fixed point the
//      regions chain into the true decode from start, whatever the input:
//      a guess that lands on a codeword start of the true chain agrees with
//      it from there on (self-synchronisation). Prefix sums of the regions'
//      counts place their symbols, and the last thread decodes past end
//      when the regions hold fewer than 4096 symbols. Codes that never
//      synchronise (8-bit codes guessed off the byte grid) take a round per
//      region: still exact, and no faster than one thread.
//
// Outputs: symbols uint8[B, J * 4096] (lane (b, j) writes bytes
// [j * 4096, (j + 1) * 4096) of row b) and final_bitpos int32[B, J].
//
// Bound on the H100: the bytes, the coded words, jump offsets and tables
// read once and the symbols written once (a 4 MiB row moves about 7.5 MB).
// The decode is latency-bound: a thread's time is its steps times a step's
// latency, so a call takes about as long as its longest chain. Blocks of
// 128 threads and 80.5 KiB (per lane) or 112.5 KiB (split) of shared
// memory fit 2 an SM: 16 rows (128 blocks of lanes) run in one wave, and a
// one-row fetch splits into 16384 threads, 128 blocks.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kJumpBlock = 4096;
constexpr int kMaxCodeLen = 15;
constexpr int kTableEntries = 1 << kMaxCodeLen;
constexpr int kTableBytes = kTableEntries * 2;
constexpr int kBuildThreads = 256;
constexpr int kThreads = 128;
constexpr int kRing = 32;   // words a fast stream keeps in shared memory
constexpr int kFetch = 8;   // words it loads at once: 16 steps merge at most 8
constexpr int kRingMask = kRing - 1;
constexpr int kRingStride = kRing + 1;  // threads' rings start in different banks
constexpr int kSmemBytes = kTableBytes + kThreads * kRingStride * 4;
// Words a block can span: 4096 symbols of at most 15 bits.
constexpr int kBlockWords = (kJumpBlock * kMaxCodeLen + 31) / 32;
constexpr int kSplit = 16;  // threads per jump block in the split kernel
// The split kernel also stages each jump block's symbols.
constexpr int kSplitSmemBytes = kSmemBytes + kThreads / kSplit * kJumpBlock;
// An H100 SXM: 132 SMs of 228 KiB of shared memory, 1 KiB of it kept back
// for each resident block.
constexpr int kSms = 132;
constexpr int kSmemPerSm = 228 * 1024;
// Calls of at most this many lanes split: two waves of the split kernel.
// Its wave holds 2112 lanes and costs about a third of the per-lane
// kernel's one wave, so it is the faster up to about three.
constexpr int kSplitLanes = 2 * kSms * (kSmemPerSm / (kSplitSmemBytes + 1024)) * (kThreads / kSplit);
// How far past its start a region may end, so that every window a region's
// decode reads before it crosses its end is the stream's true bits.
constexpr int kSpanLimit = kJumpBlock * kMaxCodeLen - 256;

static_assert((kRing & kRingMask) == 0 && kThreads % kSplit == 0 && 32 % kSplit == 0, "shapes");

// Threads per jump block for a call of `lanes` (rows x jump blocks).
constexpr int split_for(int lanes) { return lanes <= kSplitLanes ? kSplit : 1; }

__device__ __forceinline__ uint32_t load_word(const uint32_t* row, int w, int i) {
  if (i < 0) i += w;
  return (i >= 0 && i < w) ? __ldg(row + i) : 0xFFFFFFFFu;
}

// One thread per (row, raw 15-bit window): the scan's step, once.
__global__ void __launch_bounds__(kBuildThreads)
huffman_table_kernel(const int32_t* __restrict__ first_code, const int32_t* __restrict__ counts,
                     const int32_t* __restrict__ base, const int32_t* __restrict__ perm,
                     uint16_t* __restrict__ tables) {
  const int b = blockIdx.y;
  const int index = blockIdx.x * kBuildThreads + threadIdx.x;
  const int32_t* first = first_code + b * 16;
  const int32_t* count = counts + b * 16;
  const int u15 = static_cast<int>(__brev(static_cast<uint32_t>(index)) >> 17);
  int l_sel = 0;  // index into lengths 1..15; stays 0 when none matches
  for (int l = kMaxCodeLen; l >= 1; --l) {
    const int u = u15 >> (kMaxCodeLen - l);
    const int f = __ldg(first + l);
    if (u >= f && u < f + __ldg(count + l)) l_sel = l - 1;
  }
  const int l = l_sel + 1;
  const int u = u15 >> (kMaxCodeLen - l);
  const int idx = min(max(__ldg(base + b * 16 + l) + u - __ldg(first + l), 0), 255);
  const uint32_t sym = static_cast<uint8_t>(__ldg(perm + b * 256 + idx));
  tables[static_cast<size_t>(b) * kTableEntries + index] = static_cast<uint16_t>(sym << 8 | l);
}

// Whether the scan's window at every step of a block from `start` is the
// stream's true bits (word index >= 0, below the clamp at W - 2, no wrap).
__device__ __forceinline__ bool fast_lane(int32_t start, int w) {
  return start >= 0 && start <= INT32_MAX - kJumpBlock * kMaxCodeLen &&
         (start >> 5) + kBlockWords + 2 <= w - 2;
}

// One thread's stream, from a bit of a fast lane's block on. The bits sit
// in hi:lo from bit 1 up, so lo & 0xFFFE is the entry's byte offset in the
// table; n1 - 1 bits are valid, at least 31 at each step and at most 62.
// Word i of the row sits at ring[i & kRingMask]: [merged, stored) are
// there, `word` holds word `merged`, the next to enter, and `fetched` the
// kFetch words from `stored` on while `pending`. Global loads happen
// only in `top`, once per 16 steps, and land in the ring at the next
// `top`, so no step waits for one. 16 steps merge at most kFetch words, so
// the ring fetches whenever kFetch more fit.
struct FastStream {
  const uint32_t* row;  // row - row_off is 16-byte aligned
  size_t row_off;
  int w;
  const char* tab;
  uint32_t* ring;
  uint32_t lo, hi, n1, word, offset;
  int merged, stored;
  bool pending;
  uint32_t fetched[kFetch];

  // kFetch words from `first` (row_off + first is a multiple of kFetch).
  __device__ __forceinline__ void fetch(int first, uint32_t (&dst)[kFetch]) const {
    if (first + kFetch <= w) {
      const uint4* src = reinterpret_cast<const uint4*>(row + first);
      const uint4 a = __ldg(src), b = __ldg(src + 1);
      dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
      dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < kFetch; ++i) dst[i] = __ldg(row + min(first + i, w - 1));
    }
  }

  __device__ __forceinline__ void store(const uint32_t (&src)[kFetch]) {
#pragma unroll
    for (int i = 0; i < kFetch; ++i) ring[(stored + i) & kRingMask] = src[i];
    stored += kFetch;
  }

  // Merges `word` where fewer than 31 bits are valid, without a branch: m
  // is all ones then, else 0 (n1 <= 63, so the sign of n1 - 32 decides).
  __device__ __forceinline__ void refill() {
    const uint32_t m = static_cast<uint32_t>(static_cast<int>(n1 - 32u) >> 31);
    lo |= __funnelshift_l(0u, word, n1) & m;  // word << n1
    hi |= __funnelshift_l(word, 0u, n1) & m;  // word >> (32 - n1)
    n1 += m & 32u;
    merged -= static_cast<int>(m);
    if (m) word = ring[merged & kRingMask];
  }

  __device__ __forceinline__ void init(uint32_t start) {
    const int at = static_cast<int>(start >> 5);
    stored = at - static_cast<int>((row_off + at) & (kFetch - 1));
    static_assert(kRing - kFetch == 3 * kFetch, "the prologue fills three fetches");
    uint32_t second[kFetch], third[kFetch];
    fetch(stored, fetched);
    fetch(stored + kFetch, second);
    fetch(stored + 2 * kFetch, third);
    store(fetched);
    store(second);
    store(third);
    pending = false;
    const uint32_t head = ring[at & kRingMask] >> (start & 31u);
    lo = head << 1;
    hi = head >> 31;
    n1 = 33u - (start & 31u);
    merged = at + 1;
    word = ring[merged & kRingMask];
    refill();
    offset = lo & 0xFFFEu;
  }

  // At the top of every 16 steps.
  __device__ __forceinline__ void top() {
    if (pending) store(fetched);
    pending = stored + kFetch - merged <= kRing;
    if (pending) fetch(stored, fetched);
  }

  // One step; returns its entry (symbol << 8 | l).
  __device__ __forceinline__ uint32_t step() {
    const uint32_t e = *reinterpret_cast<const uint16_t*>(tab + offset);
    lo = __funnelshift_r(lo, hi, e);  // shifts by e & 31 = l
    hi = __funnelshift_r(hi, 0u, e);
    // At least 16 bits are left, so the next offset does not wait for the
    // refill: the chain is the load, the shift and this mask.
    offset = lo & 0xFFFEu;
    n1 -= e & 15u;
    refill();
    return e;
  }

  __device__ __forceinline__ uint32_t pos() const {
    return static_cast<uint32_t>(merged) * 32u - (n1 - 1u);
  }
};

__device__ __forceinline__ void pack(uint32_t (&packed)[4], int k, uint32_t entry) {
  packed[k >> 2] |= (entry >> 8) << (8 * (k & 3));
}

__device__ __forceinline__ uint32_t decode_fast(FastStream& f, uint32_t start, uint4* __restrict__ out) {
  f.init(start);
  for (int t0 = 0; t0 < kJumpBlock; t0 += 16) {
    f.top();
    uint32_t packed[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 16; ++k) pack(packed, k, f.step());
    out[t0 >> 4] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
  return f.pos();
}

// The scan's exact step, for lanes that may leave the stream.
__device__ __forceinline__ uint32_t decode_exact(const uint32_t* __restrict__ row, int w,
                                                 uint32_t bitpos, const uint16_t* table,
                                                 uint4* __restrict__ out) {
  for (int t0 = 0; t0 < kJumpBlock; t0 += 16) {
    uint32_t packed[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int widx = min(static_cast<int>(bitpos) >> 5, w - 2);
      const uint32_t s = bitpos & 31u;
      const uint32_t w0 = load_word(row, w, widx);
      const uint32_t w1 = load_word(row, w, widx + 1);
      const uint32_t window = (w0 >> s) | (s == 0 ? 0u : (w1 << (32u - s)));
      const uint32_t e = table[window & 0x7FFFu];
      pack(packed, k, e);
      bitpos += e & 15u;
    }
    out[t0 >> 4] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
  return bitpos;
}

// The split kernel's one decode loop, for every pass (its 16-step body is
// long, so it is inlined once): decodes from `from`, writing the first n
// symbols to out[0, n), and counts the symbols before the first codeword
// start at or past `limit`. Returns that position in `end`, the count in
// `count`, and the position after the n symbols in `after`.
__device__ __forceinline__ void run(FastStream& f, uint32_t from, uint32_t limit, int n,
                                    uint8_t* out, uint32_t& end, int& count, uint32_t& after) {
  int rem = static_cast<int>(limit - from);
  uint32_t advanced = 0;
  count = 0;
  if (rem > 0 || n > 0) {
    f.init(from);
    for (int i0 = 0; rem > 0 || i0 < n; i0 += 16) {
      f.top();
      uint32_t packed[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const uint32_t e = f.step();
        const int l = static_cast<int>(e & 15u);
        pack(packed, k, e);
        advanced += i0 + k < n ? l : 0;
        count += rem > 0 ? 1 : 0;
        rem -= rem > 0 ? l : 0;
      }
      // Shared stores once per 16 steps, so that none sits between a step's
      // table load and the next (the compiler keeps loads behind stores).
      if (i0 < n) {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          if (i0 + k < n) out[i0 + k] = static_cast<uint8_t>(packed[k >> 2] >> (8 * (k & 3)));
        }
      }
    }
  }
  end = limit - static_cast<uint32_t>(min(rem, 0));
  after = from + advanced;
}

// Copies row b's table into shared memory; returns this thread's stream
// over the row, with its ring.
__device__ __forceinline__ FastStream block_setup(const uint32_t* words, int w,
                                                  const uint16_t* tables, uint4* s_dyn) {
  const int b = blockIdx.y;
  const uint4* src = reinterpret_cast<const uint4*>(tables + static_cast<size_t>(b) * kTableEntries);
#pragma unroll 16
  for (int i = threadIdx.x; i < kTableBytes / 16; i += kThreads) s_dyn[i] = __ldg(src + i);
  __syncthreads();
  FastStream f;
  f.row_off = static_cast<size_t>(b) * w;
  f.row = words + f.row_off;
  f.w = w;
  f.tab = reinterpret_cast<const char*>(s_dyn);
  f.ring = reinterpret_cast<uint32_t*>(s_dyn + kTableBytes / 16) + threadIdx.x * kRingStride;
  return f;
}

__global__ void __launch_bounds__(kThreads)
huffman_decode_kernel(const uint32_t* __restrict__ words, int w, const int32_t* __restrict__ jump,
                      int n_blocks, const uint16_t* __restrict__ tables,
                      uint8_t* __restrict__ symbols, int32_t* __restrict__ final_bitpos) {
  extern __shared__ uint4 s_dyn[];  // the table, then each thread's ring
  FastStream f = block_setup(words, w, tables, s_dyn);
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n_blocks) return;
  const size_t lane = static_cast<size_t>(blockIdx.y) * n_blocks + j;
  uint4* out = reinterpret_cast<uint4*>(symbols + lane * kJumpBlock);
  const int32_t start = jump[lane];
  const uint32_t bitpos =
      fast_lane(start, w)
          ? decode_fast(f, static_cast<uint32_t>(start), out)
          : decode_exact(f.row, w, static_cast<uint32_t>(start),
                         reinterpret_cast<const uint16_t*>(f.tab), out);
  final_bitpos[lane] = static_cast<int32_t>(bitpos);
}

__global__ void __launch_bounds__(kThreads)
huffman_split_kernel(const uint32_t* __restrict__ words, int w, const int32_t* __restrict__ jump,
                     int n_blocks, const uint16_t* __restrict__ tables,
                     uint8_t* __restrict__ symbols, int32_t* __restrict__ final_bitpos) {
  extern __shared__ uint4 s_dyn[];  // the table, each thread's ring, each group's symbols
  FastStream f = block_setup(words, w, tables, s_dyn);
  const int g = threadIdx.x / kSplit;
  const int j = blockIdx.x * (kThreads / kSplit) + g;
  const int k = threadIdx.x % kSplit;  // this thread's region
  if (j >= n_blocks) return;  // a whole group: the shuffles below stay inside one
  const unsigned group = ((1u << kSplit) - 1u) << (threadIdx.x % 32 / kSplit * kSplit);
  const size_t lane = static_cast<size_t>(blockIdx.y) * n_blocks + j;
  const int32_t start = jump[lane];
  if (!fast_lane(start, w)) {
    if (k == 0) {
      final_bitpos[lane] = static_cast<int32_t>(
          decode_exact(f.row, w, static_cast<uint32_t>(start),
                       reinterpret_cast<const uint16_t*>(f.tab),
                       reinterpret_cast<uint4*>(symbols + lane * kJumpBlock)));
    }
    return;
  }
  uint8_t* staged = reinterpret_cast<uint8_t*>(s_dyn + kSmemBytes / 16) + g * kJumpBlock;
  // The regions cut [start, end); end is the next block's offset (for the
  // last block, as far on as the block before it reached) where that is
  // plausible. Being right does not depend on it, only being fast.
  const long long hint = j + 1 < n_blocks ? jump[lane + 1]
                         : j > 0          ? 2LL * start - jump[lane - 1]
                                          : 0;
  const int32_t end = hint >= start + kJumpBlock && hint <= start + kSpanLimit
                          ? static_cast<int32_t>(hint)
                          : min(start + 8 * kJumpBlock, start + kSpanLimit);
  const uint32_t limit = static_cast<uint32_t>(start + (end - start) * (k + 1) / kSplit);
  uint32_t from = static_cast<uint32_t>(start + (end - start) * k / kSplit), region_end = 0;
  int count = 0, before = 0, total = 0;
  // Passes: decode the regions until they chain (a thread runs when its
  // start moved), then write each region's symbols, then the tail.
  enum { kChain, kWrite, kTail } pass = kChain;
  bool active = true;
  for (;;) {
    const uint32_t run_from = pass == kTail ? region_end : from;
    const int n = pass == kChain ? 0 : pass == kWrite ? min(count, kJumpBlock - before)
                                                     : kJumpBlock - total;
    uint32_t run_end, after;
    int run_count;
    if (active) {
      run(f, run_from, pass == kChain ? limit : run_from, n,
          staged + (pass == kTail ? total : before), run_end, run_count, after);
    }
    if (pass == kChain) {
      if (active) {
        region_end = run_end;
        count = run_count;
      }
      const uint32_t left_end = __shfl_up_sync(group, region_end, 1, kSplit);
      active = k > 0 && left_end != from;
      if (active) from = left_end;
      if (__any_sync(group, active)) continue;
      before = count;  // the inclusive prefix sum of the counts, then exclusive
#pragma unroll
      for (int d = 1; d < kSplit; d <<= 1) {
        const int v = __shfl_up_sync(group, before, d, kSplit);
        if (k >= d) before += v;
      }
      total = __shfl_sync(group, before, kSplit - 1, kSplit);
      before -= count;
      pass = kWrite;
      active = before < kJumpBlock;
    } else if (pass == kWrite) {
      if (active && before + count >= kJumpBlock) final_bitpos[lane] = static_cast<int32_t>(after);
      pass = kTail;
      active = k == kSplit - 1 && total < kJumpBlock;
    } else {
      if (active) final_bitpos[lane] = static_cast<int32_t>(after);
      break;
    }
  }
  __syncwarp(group);
  const uint4* from_stage = reinterpret_cast<const uint4*>(staged);
  uint4* out = reinterpret_cast<uint4*>(symbols + lane * kJumpBlock);
#pragma unroll
  for (int i = k; i < kJumpBlock / 16; i += kSplit) out[i] = from_stage[i];
}

}  // namespace

// Lanes per block of the decode kernels, and threads per lane for a call of
// `lanes` lanes (the launch shape).
extern "C" int tst_huffman_decode_threads() { return kThreads; }
extern "C" int tst_huffman_split(int lanes) { return split_for(lanes); }

// words: uint32[rows, w] (int32 bit patterns, 16-byte aligned); jump:
// int32[rows, n_blocks]; first_code, counts, base: int32[rows, 16]; perm:
// int32[rows, 256]; tables: uint16[rows, 32768] scratch; symbols:
// uint8[rows, n_blocks * 4096]; final_bitpos: int32[rows, n_blocks].
extern "C" int tst_huffman_decode(const void* words, int w, const void* jump, int n_blocks,
                                  const void* first_code, const void* counts, const void* base,
                                  const void* perm, int rows, void* tables, void* symbols,
                                  void* final_bitpos, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  huffman_table_kernel<<<dim3(kTableEntries / kBuildThreads, rows), kBuildThreads, 0, s>>>(
      static_cast<const int32_t*>(first_code), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(base), static_cast<const int32_t*>(perm),
      static_cast<uint16_t*>(tables));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int split = split_for(rows * n_blocks);
  const auto kernel = split > 1 ? huffman_split_kernel : huffman_decode_kernel;
  const int smem = split > 1 ? kSplitSmemBytes : kSmemBytes;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int lanes_per_block = kThreads / split;
  kernel<<<dim3((n_blocks + lanes_per_block - 1) / lanes_per_block, rows), kThreads, smem, s>>>(
      static_cast<const uint32_t*>(words), w, static_cast<const int32_t*>(jump), n_blocks,
      static_cast<const uint16_t*>(tables), static_cast<uint8_t*>(symbols),
      static_cast<int32_t*>(final_bitpos));
  return static_cast<int>(cudaGetLastError());
}
