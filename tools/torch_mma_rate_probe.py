#!/usr/bin/env python3
"""Rates of the tensor-core products and the logic op the port's kernels use, on one GPU.

    python3 tools/torch_mma_rate_probe.py

Builds a small CUDA file for sm_90a with the port's nvcc (into a temporary
directory)
and runs, on the card:
- one `mma.sync.m16n8k256 .b1.b1.s32.and.popc` against numpy, to confirm its
  fragment layout (rows g and g + 8, 32-bit k-words t and t + 4) and that it
  computes popc(A_row & B_col);
- a loop of four independent chains of that b1 product per warp over
  132 x 8 blocks of 4 warps, and the same loop with `m16n8k32 .s8.s8.s32`,
  timed with CUDA events. Each product counts 2 ops per multiply-add
  (m x n x k of them), as the published int8 rate does;
- a loop of eight independent `lop3.b32` (three-input majorities) per
  thread per step over the same grid: LOP3 instructions per second, the logic
  rate the AES keystream kernel's bound is set against;
- that LOP3 loop, and the port's AES keystream kernel at the copy window's
  shape (16 rows x 262 145 blocks), each launched back to back for 2 s
  while `nvidia-smi` samples the SM clock: each one's LOP3 per SM per clock
  at the clock it ran at. The kernel's LOP3 per launch are counted from its
  SASS (tools/torch_sass_census.py: the whole function, plus its round loop
  12 more times), so this needs `cuobjdump` too.
Prints one line per product, one for LOP3, and one per clocked run. Needs a
CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tieredstorage_tpu_torch.ops import _cuda, aes_bitsliced  # noqa: E402
from tieredstorage_tpu_torch.ops.aes import key_expansion  # noqa: E402
from tools import torch_sass_census  # noqa: E402

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

#define MMA_LOOP(NAME, SHAPE)                                                      \
  __global__ void NAME(const uint32_t* in, int* out, int iters) {                  \
    uint32_t a[4], b[2];                                                           \
    for (int i = 0; i < 4; ++i) a[i] = in[(threadIdx.x * 7 + i) & 255];            \
    for (int i = 0; i < 2; ++i) b[i] = in[(threadIdx.x * 5 + 9 + i) & 255];        \
    int c[4][4] = {};                                                              \
    for (int it = 0; it < iters; ++it) {                                           \
      for (int k = 0; k < 4; ++k) {                                                \
        asm volatile("mma.sync.aligned." SHAPE                                     \
                     " {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"    \
                     : "+r"(c[k][0]), "+r"(c[k][1]), "+r"(c[k][2]), "+r"(c[k][3])  \
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),      \
                       "r"(b[1]));                                                 \
      }                                                                            \
      a[0] ^= c[0][0];                                                             \
    }                                                                              \
    int s = 0;                                                                     \
    for (int k = 0; k < 4; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];        \
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;                                \
  }

MMA_LOOP(b1_loop, "m16n8k256.row.col.s32.b1.b1.s32.and.popc")
MMA_LOOP(s8_loop, "m16n8k32.row.col.s32.s8.s8.s32")

// Eight independent LOP3 per step: a[k] = maj(a[k], a[k+1], b), all from
// the previous step's values (a majority of neighbours does not simplify).
__global__ void lop3_loop(const uint32_t* in, int* out, int iters) {
  uint32_t a[8];
  for (int i = 0; i < 8; ++i) a[i] = in[(threadIdx.x * 3 + i) & 255];
  const uint32_t b = in[(threadIdx.x + 101) & 255];
#pragma unroll 4
  for (int it = 0; it < iters; ++it) {
    uint32_t n[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      asm volatile("lop3.b32 %0, %1, %2, %3, 0xE8;\n" : "=r"(n[k]) : "r"(a[k]), "r"(a[(k + 1) & 7]), "r"(b));
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] = n[k];
  }
  uint32_t s = 0;
  for (int k = 0; k < 8; ++k) s ^= a[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = (int)s;
}

// One b1 product: A row-major 16 x 256 bits, B column-major 256 x 8 bits.
__global__ void b1_once(const uint32_t* a_rows, const uint32_t* b_cols, int* d) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const uint32_t a0 = a_rows[g * 8 + t], a1 = a_rows[(g + 8) * 8 + t];
  const uint32_t a2 = a_rows[g * 8 + t + 4], a3 = a_rows[(g + 8) * 8 + t + 4];
  const uint32_t b0 = b_cols[g * 8 + t], b1 = b_cols[g * 8 + t + 4];
  int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c0), "+r"(c1), "+r"(c2), "+r"(c3)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  d[g * 8 + 2 * t] = c0;
  d[g * 8 + 2 * t + 1] = c1;
  d[(g + 8) * 8 + 2 * t] = c2;
  d[(g + 8) * 8 + 2 * t + 1] = c3;
}

extern "C" int run_loop(int which, const void* in, void* out, int blocks, int threads, int iters,
                        void* stream) {
  auto kernel = which == 0 ? b1_loop : which == 1 ? s8_loop : lop3_loop;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>((const uint32_t*)in, (int*)out, iters);
  return (int)cudaGetLastError();
}

extern "C" int run_once(const void* a, const void* b, void* d, void* stream) {
  b1_once<<<1, 32, 0, (cudaStream_t)stream>>>((const uint32_t*)a, (const uint32_t*)b, (int*)d);
  return (int)cudaGetLastError();
}
"""

#: (name, run_loop selector, ops per product: 2 x m x n x k)
PRODUCTS = (("b1 m16n8k256 and.popc", 0, 2 * 16 * 8 * 256), ("s8 m16n8k32", 1, 2 * 16 * 8 * 32))
#: LOP3 per thread per step of `lop3_loop`; H100 SXM: 132 SMs, 1.98 GHz boost.
LOP3_PER_STEP = 8
SMS, BOOST_HZ = 132, 1.98e9
#: The AES kernel's round loop runs rounds 1-13 (`#pragma unroll 1`), so its
#: body runs 12 more times than the SASS listing shows it; 256 blocks a warp.
AES_ROUND_LOOP_TRIPS, AES_BLOCKS_PER_WARP = 13, 256


def under_load(run, seconds: float = 2.0) -> tuple[float, float, int]:
    """(device ms per call, median SM clock in MHz, clock samples): `run`
    called back to back for `seconds`, timed with CUDA events, while a
    thread reads the SM clock with `nvidia-smi` until the calls stop."""
    samples: list[float] = []
    stop = threading.Event()

    def sample() -> None:
        while not stop.is_set():
            res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                  "--format=csv,noheader,nounits"],
                                 stdout=subprocess.PIPE, text=True, timeout=30)
            if not stop.is_set() and res.stdout.strip().isdigit():
                samples.append(float(res.stdout))
            time.sleep(0.05)

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    calls = 0
    start.record()
    sampler = threading.Thread(target=sample)
    sampler.start()
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        run()
        calls += 1
    stop.set()
    end.record()
    end.synchronize()
    sampler.join()
    return start.elapsed_time(end) / calls, statistics.median(samples) if samples else float("nan"), len(samples)


def aes_lop3_per_lane() -> int:
    """LOP3 each lane of the AES keystream kernel executes, from its SASS."""
    (instrs,) = torch_sass_census.functions("aes_ctr.cu").values()
    loop = torch_sass_census.largest_loop(instrs)
    count = lambda body: sum(op == "LOP3" for _, op, _ in body)  # noqa: E731
    return count(instrs) + (AES_ROUND_LOOP_TRIPS - 1) * count(loop)


def _build(work: str) -> ctypes.CDLL:
    src, lib = os.path.join(work, "mma_probe.cu"), os.path.join(work, "mma_probe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    res = subprocess.run(
        [_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-Xcompiler", "-fPIC",
         "-shared", src, "-o", lib],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}")
    dll = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.run_loop.argtypes = [i, p, p, i, i, i, p]
    dll.run_once.argtypes = [p, p, p, p]
    return dll


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mma_rate_probe: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory(prefix="mma_probe_") as work:
        dll = _build(work)
        rng = np.random.default_rng(1)
        a = rng.integers(0, 2**32, (16, 8), dtype=np.uint64).astype(np.uint32)
        b = rng.integers(0, 2**32, (8, 8), dtype=np.uint64).astype(np.uint32)
        d = torch.zeros((16, 8), dtype=torch.int32, device=dev)
        a_dev = torch.from_numpy(a.view(np.int32)).to(dev)
        b_dev = torch.from_numpy(b.view(np.int32)).to(dev)
        if dll.run_once(a_dev.data_ptr(), b_dev.data_ptr(), d.data_ptr(), stream):
            raise RuntimeError("b1 product did not launch")
        torch.cuda.synchronize()
        want = np.array([[sum(bin(int(a[m, w]) & int(b[n, w])).count("1") for w in range(8))
                          for n in range(8)] for m in range(16)])
        ok = np.array_equal(d.cpu().numpy(), want)
        print(f"b1 m16n8k256 and.popc matches popc(A_row & B_col): {ok}")

        inp = torch.from_numpy(rng.integers(0, 2**31, 256).astype(np.int32)).to(dev)
        blocks, threads, iters = 132 * 8, 128, 2000
        out = torch.empty(blocks * threads, dtype=torch.int32, device=dev)
        # (name, selector, products per warp or LOP3 per thread per step, ops per product)
        loops = [(name, which, 4, ops) for name, which, ops in PRODUCTS]
        loops.append(("lop3.b32", 2, LOP3_PER_STEP, 1))
        for name, which, per_step, ops in loops:
            per_thread = which == 2  # LOP3 counts per thread, products per warp
            dll.run_loop(which, inp.data_ptr(), out.data_ptr(), blocks, threads, 10, stream)
            torch.cuda.synchronize()
            times = []
            for _ in range(3):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                if dll.run_loop(which, inp.data_ptr(), out.data_ptr(), blocks, threads, iters, stream):
                    raise RuntimeError(f"{name} did not launch")
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            ms = statistics.median(times)
            count = blocks * (threads if per_thread else threads // 32) * iters * per_step
            if per_thread:
                rate = count / ms * 1e3
                print(f"{name}: {ms:.4f} ms for {count} LOP3, {rate / 1e12:.2f} T LOP3/s "
                      f"({rate / SMS / BOOST_HZ:.1f} per SM per clock at 1.98 GHz)")
            else:
                print(f"{name}: {ms:.4f} ms for {count} products, {count * ops / ms / 1e9:.1f} TOPS")

        # Clocked: the LOP3 loop and the AES kernel, each at the clock it ran at.
        lop3_count = blocks * threads * iters * LOP3_PER_STEP
        ms, mhz, n = under_load(lambda: dll.run_loop(2, inp.data_ptr(), out.data_ptr(), blocks,
                                                     threads, iters, stream))
        print(f"lop3.b32 under load: {ms:.4f} ms per launch, {lop3_count / ms / 1e9:.2f} T LOP3/s, "
              f"SM clock {mhz:.0f} MHz ({n} samples): "
              f"{lop3_count / ms * 1e3 / SMS / (mhz * 1e6):.2f} per SM per clock")
        rows, n_blocks = 16, 262_145
        rk = torch.from_numpy(key_expansion(rng.bytes(32))).to(dev)
        ivs = torch.from_numpy(rng.integers(0, 256, (rows, 12), dtype=np.uint8)).to(dev)
        per_lane = aes_lop3_per_lane()
        lanes = rows * -(-n_blocks // AES_BLOCKS_PER_WARP) * 32
        ms, mhz, n = under_load(lambda: aes_bitsliced.ctr_keystream_batch(rk, ivs, 1, n_blocks))
        print(f"aes_ctr_keystream {rows} x {n_blocks} under load: {ms:.4f} ms per launch, "
              f"{per_lane} LOP3 per lane x {lanes} lanes, {per_lane * lanes / ms / 1e9:.2f} T LOP3/s, "
              f"SM clock {mhz:.0f} MHz ({n} samples): "
              f"{per_lane * lanes / ms * 1e3 / SMS / (mhz * 1e6):.2f} per SM per clock")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader"],
                          stdout=subprocess.PIPE, text=True).stdout.strip()
    print(f"card: {card}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
