"""Build, bind and launch the hand-written CUDA kernels of csrc/.

The kernels are plain C-interface CUDA C++ for sm_90a. At first use each
source is compiled by its own `nvcc` (all started together), the objects are
linked into one shared library in the build directory, and the library is
loaded with ctypes. Pointers and the stream travel as `c_void_p`; every C
entry point returns `cudaGetLastError()` and `launch` raises when it is not
0. The library is cached by the hash of the sources, so an unchanged tree
builds once.

Build directory: `$TSTORCH_BUILD_DIR`, else `_build/` inside this package
(listed in .gitignore). nvcc: `$NVCC`, else `nvcc` on PATH, else
/usr/local/cuda/bin/nvcc.

`LAUNCHES` counts the launches of each kernel (a plain integer per kernel,
bumped only where the wrapper launches), so a caller can show that a path
really went through the kernels; `LAUNCH_ROWS` splits the same launches by
the rows (chunks) each covered, so it can show how many chunks a launch
carried.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("aes_ctr.cu", "ghash.cu", "huffman.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C entry points: name -> (argument types after the stream is appended).
_SIGNATURES = {
    "aes_ctr_keystream": ("tst_aes_ctr_keystream", (_P, _P, ctypes.c_uint, _I, _I, _P)),
    "ghash_tree": ("tst_ghash_tree", (_P, _I, _I, _I, _P, _P, _P, _P, _P)),
    "ghash_level1": ("tst_ghash_level1", (_P, _I, _I, _P, _P)),
    "huffman_decode": ("tst_huffman_decode", (_P, _I, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P)),
}

LAUNCHES: dict[str, int] = {name: 0 for name in _SIGNATURES}
LAUNCH_ROWS: dict[str, collections.Counter] = {name: collections.Counter() for name in _SIGNATURES}
_LOCK = threading.Lock()
_LIB: list[ctypes.CDLL] = []
#: What the last build printed (nvcc -Xptxas -v), how long it took, and when
#: each source's nvcc finished (seconds from the start of the build).
BUILD_LOG: dict[str, object] = {}


def reset_launch_counts() -> None:
    with _LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
            LAUNCH_ROWS[name].clear()


def launch_counts() -> dict[str, int]:
    with _LOCK:
        return dict(LAUNCHES)


def launch_rows() -> dict[str, dict[int, int]]:
    """Per kernel: rows of a launch -> launches with that many rows."""
    with _LOCK:
        return {name: dict(sorted(c.items())) for name, c in LAUNCH_ROWS.items()}


def build_dir() -> Path:
    return Path(os.environ.get("TSTORCH_BUILD_DIR") or CSRC.parent / "_build")


def _nvcc() -> str:
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(ARCH_FLAGS + CFLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/ into the shared library (once per source hash)."""
    out_dir = build_dir()
    lib = out_dir / f"libtstorch_{_source_hash()}.so"
    if lib.exists():
        BUILD_LOG.setdefault("seconds", 0.0)
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    start = time.monotonic()
    procs = []
    for name in SOURCES:
        obj = out_dir / (Path(name).stem + f"_{os.getpid()}.o")
        cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    logs, failed, seconds = [], [], {}

    def wait(name, proc):
        text, _ = proc.communicate()
        seconds[name] = time.monotonic() - start
        logs.append(f"== {name}\n{text}")
        if proc.returncode != 0:
            failed.append(name)

    waiters = [threading.Thread(target=wait, args=(name, proc)) for name, _obj, proc in procs]
    for th in waiters:
        th.start()
    for th in waiters:
        th.join()
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = out_dir / f".{lib.name}.{os.getpid()}"
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)]
    res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
    os.replace(tmp, lib)
    BUILD_LOG.update(seconds=time.monotonic() - start, log="\n".join(sorted(logs)),
                     source_seconds=dict(sorted(seconds.items())))
    return lib


def library() -> ctypes.CDLL:
    with _LOCK:
        if not _LIB:
            lib = ctypes.CDLL(str(build()))
            for cname, argtypes in _SIGNATURES.values():
                fn = getattr(lib, cname)
                fn.argtypes = [*argtypes, _P]
                fn.restype = ctypes.c_int
            lib.tst_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tst_cuda_error_string.restype = ctypes.c_char_p
            lib.tst_ghash_tree_slice.restype = ctypes.c_int
            lib.tst_huffman_decode_threads.argtypes = []
            lib.tst_huffman_decode_threads.restype = ctypes.c_int
            lib.tst_huffman_split.argtypes = [ctypes.c_int]
            lib.tst_huffman_split.restype = ctypes.c_int
            _LIB.append(lib)
        return _LIB[0]


def tree_slice() -> int:
    """Groups per block of the GHASH tree kernel (csrc/ghash.cu kSlice)."""
    return library().tst_ghash_tree_slice()


def decode_shape(lanes: int) -> tuple[int, int]:
    """The Huffman decode's launch shape for a call of `lanes` (rows x jump
    blocks) lanes: (threads a block, threads a lane) (csrc/huffman.cu
    kThreads, and kSplit where the call splits its lanes, else 1)."""
    lib = library()
    return lib.tst_huffman_decode_threads(), lib.tst_huffman_split(lanes)


def launch(name: str, *args, rows: int) -> None:
    """Launch kernel `name` on the current stream of the current device and
    count it under its `rows`; raise if the launch was refused."""
    lib = library()
    cname, _ = _SIGNATURES[name]
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, cname)(*args, stream)
    if rc != 0:
        msg = lib.tst_cuda_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({rc})")
    with _LOCK:
        LAUNCHES[name] += 1
        LAUNCH_ROWS[name][rows] += 1
