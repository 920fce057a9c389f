#!/usr/bin/env python3
"""Rates of the two tensor-core products the GHASH kernels could use, on one GPU.

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
  (m x n x k of them), as the published int8 rate does.
Prints one line per product. Needs a CUDA device and nvcc; imports nothing of
JAX.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tieredstorage_tpu_torch.ops import _cuda  # noqa: E402

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
  auto kernel = which == 0 ? b1_loop : s8_loop;
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
        for name, which, ops in PRODUCTS:
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
            products = blocks * (threads // 32) * iters * 4
            print(f"{name}: {ms:.4f} ms for {products} products, {products * ops / ms / 1e9:.1f} TOPS")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          stdout=subprocess.PIPE, text=True).stdout.strip()
    print(f"card: {card}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
