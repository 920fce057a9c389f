"""ops/huffman.py of the port against the JAX op, with no tolerance.

The same seeded rows (shorter than, equal to and longer than JUMP_BLOCK, an
exactly-full last block, one-symbol rows, an empty row and a row whose code
reaches 15 bits) go through both encoders and both decoders: the words,
total bits, jump offsets, symbols and final bit positions must be equal,
also for a corrupted payload and for jump offsets that point outside the
stream, and for the regimes of tests/torch_huffman_regimes.py (the
clamp at W - 2, negative and wrapping jumps, random, one-symbol, 15-bit
and fixed-length tables, lanes on both sides of the kernel's fast-path
guard). The plain decoder runs JUMP_BLOCK torch steps per call, so the
cases share a few batched calls.

The CUDA kernel (csrc/huffman.cu) runs only on the card
(tests/test_torch_cuda.py); here its source is compiled for the host
under a thin shim (one std::thread per CUDA thread, a barrier for
__syncthreads, a buffer for the dynamic shared memory; the table kernel,
which has no barrier, runs its threads one after another) and held
against the plain version on the same batches.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tests.torch_huffman_regimes import REGIMES, regimes
from tests.torch_threads import one_torch_thread  # noqa: F401
from tieredstorage_tpu.ops import huffman as jax_huffman
from tieredstorage_tpu_torch.ops import huffman
from tieredstorage_tpu_torch.transform import thuff

JUMP = huffman.JUMP_BLOCK


def _fib_symbols(n: int) -> bytes:
    """Fibonacci frequencies: the length limit binds at 15 bits."""
    out, a, b = [], 1, 1
    for sym in range(24):
        out += [sym] * a
        a, b = b, a + b
    return bytes(np.array(out[:n], np.uint8))


def _rows() -> list[bytes]:
    rng = np.random.default_rng(2026)
    text = b"offset=%08d key=user-%04d value=" % (17, 3)
    return [
        (text * 400)[: JUMP - 100],                              # shorter than a block
        bytes(rng.integers(0, 8, JUMP, dtype=np.uint8)),         # exactly one block
        (text * 900)[: 2 * JUMP + 777],                          # longer, partial last block
        bytes(rng.integers(0, 256, 3 * JUMP, dtype=np.uint8)),   # exactly-full last block
        b"\x41" * (JUMP + 1),                                    # one symbol
        b"",                                                     # empty row
        _fib_symbols(2 * JUMP + 5),                              # 15-bit codes
    ]


def _tables(rows: list[bytes]):
    n_max = thuff._bucket(max(max(map(len, rows)), 1))
    batch = len(rows)
    data = np.zeros((batch, n_max), np.uint8)
    n_sym = np.zeros(batch, np.int32)
    lengths = np.zeros((batch, 256), np.int32)
    codes_rev = np.zeros((batch, 256), np.int32)
    dec = [np.zeros((batch, 16), np.int32) for _ in range(3)] + [np.zeros((batch, 256), np.int32)]
    for i, row in enumerate(rows):
        arr = np.frombuffer(row, np.uint8)
        data[i, : len(arr)] = arr
        n_sym[i] = len(arr)
        lengths[i] = thuff.limited_huffman_lengths(np.bincount(arr, minlength=256))
        codes_rev[i] = thuff.encode_tables(lengths[i])
        for k, t in enumerate(thuff.decode_tables(lengths[i])):
            dec[k][i] = t
    return n_max, data, n_sym, lengths, codes_rev, dec


@pytest.fixture(scope="module")
def encoded():
    rows = _rows()
    n_max, data, n_sym, lengths, codes_rev, dec = _tables(rows)
    assert lengths.max() == huffman.MAX_CODE_LEN
    ours = huffman.encode_batch(*(torch.from_numpy(a) for a in (data, n_sym, codes_rev, lengths)))
    theirs = jax_huffman.encode_batch(data, n_sym, codes_rev, lengths, n_max=n_max)
    return rows, n_max, dec, ours, [np.asarray(t) for t in theirs]


def test_encoder_equals_jax(encoded):
    _, n_max, _, (words, total_bits, jump), (j_words, j_bits, j_jump) = encoded
    assert words.shape == (len(j_words), huffman.max_words(n_max))
    np.testing.assert_array_equal(words.numpy(), j_words.astype(np.int64))
    np.testing.assert_array_equal(total_bits.numpy(), j_bits)
    np.testing.assert_array_equal(jump.numpy(), j_jump)
    as32 = huffman.to_int32_bits(words).numpy().view(np.uint32)
    np.testing.assert_array_equal(as32, j_words)


CASES = ["clean", "corrupt", "wild jumps", *REGIMES]


def _cases(encoded):
    """(name, words uint32, jump int32, tables): clean, corrupt payload,
    wild jumps, then the regimes."""
    _, _, dec, _, (j_words, _, j_jump) = encoded
    rng = np.random.default_rng(7)
    corrupt = j_words.copy()
    corrupt[:, 3:40] = rng.integers(0, 1 << 32, corrupt[:, 3:40].shape, dtype=np.uint64)
    corrupt[2, 500:520] ^= 0x10101
    wild = j_jump.astype(np.int32).copy()
    wild[:, 0] = -5
    wild[0, 0] = -(1 << 31)
    wild[2, 1] = (1 << 31) - 100  # bit positions that wrap
    wild[3, 2] = -40 * 32
    cases = [("clean", j_words, j_jump.astype(np.int32), dec),
             ("corrupt", corrupt, j_jump.astype(np.int32), dec), ("wild jumps", j_words, wild, dec)]
    regime = regimes(j_words, j_jump, dec, seed=11)
    return cases + [(name, *regime[name]) for name in REGIMES]


@pytest.fixture(scope="module")
def decoded(encoded):
    n_max = encoded[1]
    out = {}
    for name, words, jump, tabs in _cases(encoded):
        plain = huffman.decode_batch_plain(
            torch.from_numpy(words.view(np.int32).copy()), torch.from_numpy(jump),
            *(torch.from_numpy(t) for t in tabs))
        theirs = jax_huffman.decode_batch(words, jump, *tabs, n_max=n_max)
        out[name] = (words, jump, tabs, [t.numpy() for t in plain], [np.asarray(t) for t in theirs])
    return out


@pytest.mark.parametrize("case", CASES)
def test_plain_decoder_equals_jax(decoded, case):
    _, _, _, (symbols, final), (j_symbols, j_final) = decoded[case]
    np.testing.assert_array_equal(symbols, j_symbols)
    np.testing.assert_array_equal(final, j_final)
    assert final.dtype == np.int32 and symbols.dtype == np.uint8


def test_clean_decode_recovers_every_row(encoded, decoded):
    rows = encoded[0]
    total_bits = encoded[3][1].numpy()
    _, jump, _, (symbols, final), _ = decoded["clean"]
    for i, row in enumerate(rows):
        assert symbols[i, : len(row)].tobytes() == row
        n_jump = -(-len(row) // JUMP)
        # Every full block ends where the next one starts, and an
        # exactly-full last block at the stream's end: the codec's check.
        ends = list(jump[i, 1:n_jump])
        if len(row) and len(row) % JUMP == 0:
            ends.append(total_bits[i])
        assert list(final[i, : len(ends)]) == ends


def test_wrapper_takes_the_plain_version_on_cpu_and_checks_operands(encoded):
    _, _, dec, (words, _, jump), _ = encoded
    got = huffman.decode_batch(words, jump, *(torch.from_numpy(t) for t in dec))
    want = huffman.decode_batch_plain(words, jump, *(torch.from_numpy(t) for t in dec))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="perm must be"):
        huffman.decode_batch(words, jump, *(torch.from_numpy(t) for t in dec[:3]),
                             torch.zeros((1, 256), dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        huffman.decode_batch(*(t.to("meta") for t in (words, jump, *map(torch.from_numpy, dec))))


# ------------------------------------------- the kernel's source on the host
_SHIM = r'''
#include <algorithm>
#include <barrier>
#include <bit>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
struct dim3 { unsigned x = 1, y = 1, z = 1; };
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
thread_local dim3 blockIdx, threadIdx;
std::barrier<>* g_bar;            // the block's, for __syncthreads
std::barrier<>** g_group_bars;    // one per group of shuffling threads
uint64_t g_shfl[1024];            // one slot per thread of the block
uint4* g_dyn_smem;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
#define __restrict__
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned mask) { g_group_bars[threadIdx.x / std::popcount(mask)]->arrive_and_wait(); }
template <typename T> inline T __ldg(const T* p) { return *p; }
inline uint32_t __brev(uint32_t x) {
  uint32_t r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t shift) {
  return static_cast<uint32_t>((static_cast<uint64_t>(hi) << 32 | lo) >> (shift & 31u));
}
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t shift) {
  return static_cast<uint32_t>((static_cast<uint64_t>(hi) << 32 | lo) << (shift & 31u) >> 32);
}
// Warp shuffles within a group of `width` threads: every thread posts its
// value, the group meets, each reads its source, the group meets again.
template <typename T> inline T shfl_from(T v, int src_lane, int width) {
  const int base = threadIdx.x / width * width;
  std::barrier<>& bar = *g_group_bars[threadIdx.x / width];
  std::memcpy(&g_shfl[threadIdx.x], &v, sizeof(T));
  bar.arrive_and_wait();
  T out;
  std::memcpy(&out, &g_shfl[base + src_lane], sizeof(T));
  bar.arrive_and_wait();
  return out;
}
template <typename T> inline T __shfl_up_sync(unsigned, T v, unsigned delta, int width) {
  const int lane = threadIdx.x % width;
  return shfl_from(v, lane >= static_cast<int>(delta) ? lane - static_cast<int>(delta) : lane, width);
}
template <typename T> inline T __shfl_sync(unsigned, T v, int src_lane, int width) {
  return shfl_from(v, src_lane, width);
}
inline bool __any_sync(unsigned mask, bool pred) {
  const int width = std::popcount(mask);
  bool any = false;
  for (int i = 0; i < width; ++i) any |= shfl_from(pred, i, width);
  return any;
}
using std::max;
using std::min;
'''

_RUNNER = r'''
extern "C" void host_decode(const uint32_t* words, int w, const int32_t* jump, int n_blocks,
                            const int32_t* first, const int32_t* counts, const int32_t* base,
                            const int32_t* perm, int rows, uint8_t* symbols, int32_t* final_bitpos,
                            int split) {
  std::vector<uint16_t> tables(static_cast<size_t>(rows) * kTableEntries);
  for (int by = 0; by < rows; ++by) {
    for (int bx = 0; bx < kTableEntries / kBuildThreads; ++bx) {
      for (int t = 0; t < kBuildThreads; ++t) {
        blockIdx.x = bx;
        blockIdx.y = by;
        threadIdx.x = t;
        huffman_table_kernel(first, counts, base, perm, tables.data());
      }
    }
  }
  std::vector<uint4> smem(kSplitSmemBytes / sizeof(uint4));
  g_dyn_smem = smem.data();
  const int per_block = kThreads / split;
  const int gx = (n_blocks + per_block - 1) / per_block;
  for (int by = 0; by < rows; ++by) {
    for (int bx = 0; bx < gx; ++bx) {
      std::barrier<> bar(kThreads);
      g_bar = &bar;
      std::vector<std::unique_ptr<std::barrier<>>> groups;
      std::vector<std::barrier<>*> group_ptrs;
      for (int g = 0; g < kThreads / kSplit; ++g) {
        groups.emplace_back(new std::barrier<>(kSplit));
        group_ptrs.push_back(groups.back().get());
      }
      g_group_bars = group_ptrs.data();
      std::vector<std::thread> threads;
      for (int t = 0; t < kThreads; ++t) {
        threads.emplace_back([&, t] {
          blockIdx.x = bx;
          blockIdx.y = by;
          threadIdx.x = t;
          if (split > 1) {
            huffman_split_kernel(words, w, jump, n_blocks, tables.data(), symbols, final_bitpos);
          } else {
            huffman_decode_kernel(words, w, jump, n_blocks, tables.data(), symbols, final_bitpos);
          }
        });
      }
      for (auto& th : threads) th.join();
    }
  }
}

extern "C" int host_split() { return kSplit; }
'''


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = (huffman.__file__.rsplit("/ops/", 1)[0] + "/csrc/huffman.cu")
    text = open(src).read()
    kernel = text[: text.index("}  // namespace")] + "}  // namespace\n"
    kernel = kernel.replace("#include <cuda_runtime.h>", "")
    # Dynamic shared memory: one buffer, as blocks run one at a time.
    kernel, n = re.subn(r"extern __shared__ (\w+) (\w+)\[\];",
                        r"\1* \2 = reinterpret_cast<\1*>(g_dyn_smem);", kernel)
    assert n >= 1
    work = tmp_path_factory.mktemp("huffman_host")
    (work / "host.cpp").write_text(_SHIM + kernel + _RUNNER)
    subprocess.run([cxx, "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread",
                    str(work / "host.cpp"), "-o", str(work / "libhost.so")], check=True)
    return ctypes.CDLL(str(work / "libhost.so"))


def _host_decode(lib, words, jump, dec, split):
    batch, w = words.shape
    n_blocks = jump.shape[1]
    words = np.ascontiguousarray(words, np.uint32)
    jump = np.ascontiguousarray(jump, np.int32)
    tabs = [np.ascontiguousarray(t, np.int32) for t in dec]
    symbols = np.zeros((batch, n_blocks * JUMP), np.uint8)
    final = np.zeros((batch, n_blocks), np.int32)
    ptr = ctypes.c_void_p
    lib.host_decode(ptr(words.ctypes.data), w, ptr(jump.ctypes.data), n_blocks,
                    *(ptr(t.ctypes.data) for t in tabs), batch,
                    ptr(symbols.ctypes.data), ptr(final.ctypes.data), split)
    return symbols, final


@pytest.mark.parametrize("case", CASES)
def test_kernel_source_on_the_host_equals_the_plain_version(host_kernel, decoded, case):
    """Both decode kernels: one thread per jump block, and the split kernel
    (the card picks it for calls of few lanes)."""
    words, jump, tabs, (symbols, final), _ = decoded[case]
    for split in (1, host_kernel.host_split()):
        got_symbols, got_final = _host_decode(host_kernel, words, jump, tabs, split)
        np.testing.assert_array_equal(got_symbols, symbols, err_msg=f"split {split}")
        np.testing.assert_array_equal(got_final, final, err_msg=f"split {split}")
