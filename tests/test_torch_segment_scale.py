"""Segment-scale streaming proof of the port (tools/torch_segment_scale_probe.py),
the counterpart of tests/test_segment_scale.py.

- `test_one_gib_segment_streams_through_the_card`: a 1 GiB segment, zstd
  (the JAX test's codec) and encryption on, copied cold then warm through
  the port's RSM and read back in 4 seeded ranges, held to the JAX test's
  checks (warm < 0.9 x cold; the warm copy's `transform.encrypt_dispatch`
  spans < 0.15 x its wall; peak-RSS growth < 2 x the segment at >= 1 GiB;
  the warm copy adds < max(segment / 4, 192 MiB); the ranges exact).
  Where the JAX test's bounds leave room for the XLA CPU arena, here they
  leave it for the port's pinned staging pool. Runs, as
  in JAX, only under TSTPU_SEGMENT_SCALE=1 (TSTPU_SEGMENT_SCALE_MIB,
  default 1024), on cuda:0 when there is a card, else on the CPU, with the
  probe as a child, so that the high-water mark it reads is its own.
- `test_small_segment_matches_the_jax_probe` (always): a 2 MiB segment in
  256 KiB chunks on the CPU. The twin's stored warm segment reads back byte
  for byte through the JAX package's RSM; each copy's span names, the
  port's own (tests/torch_span_parity.py) aside, equal
  those of tools/segment_scale_probe.py run at the same size, chunk and
  codec (run as a child whose tracer's span ring is sliceable: the JAX
  probe slices `tracer._spans`, a deque, which raises as the probe ships);
  and the report has its shape.

The JAX package is imported inside the small test only, so the card test
runs where JAX is not installed (`--noconftest`).
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tests.torch_gates import XLA_ONE_THREAD
from tests.torch_span_parity import PORT_ONLY_SPANS

REPO = Path(__file__).resolve().parent.parent
SMALL_MIB = 2
SMALL_CHUNK = 256 << 10
CODEC = "zstd"


def _probe():
    spec = importlib.util.spec_from_file_location(
        "torch_segment_scale_probe", REPO / "tools" / "torch_segment_scale_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.skipif(not os.environ.get("TSTPU_SEGMENT_SCALE"),
                    reason="segment-scale run is minutes long; set TSTPU_SEGMENT_SCALE=1")
def test_one_gib_segment_streams_through_the_card(tmp_path):
    total = int(os.environ.get("TSTPU_SEGMENT_SCALE_MIB", 1024)) << 20
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    out = tmp_path / "report.json"
    # A process of its own: its high-water mark is the probe's alone.
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "torch_segment_scale_probe.py"),
         "--mib", str(total >> 20), "--out", str(out), "--work", str(tmp_path / "work"),
         "--device", device],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=1800)
    assert proc.returncode in (0, 1) and out.exists(), proc.stdout[-2000:] + proc.stderr[-3000:]
    report = json.loads(out.read_text())
    checks, copies = report["checks"], report["copies"]
    cold_s, warm_s = copies["cold"]["wall_s"], copies["warm"]["wall_s"]
    assert checks["warm_faster"], f"warm copy {warm_s:.1f}s vs cold {cold_s:.1f}s"
    assert checks["dispatch_under_15pct"], (
        f"encrypt_dispatch spans sum to {report['warm_dispatch_s']:.1f}s of a "
        f"{warm_s:.1f}s warm copy: the dispatch stage blocks the pipeline")
    if total >= 1 << 30:
        assert checks["rss_peak_under_2x"], report["rss"]
    assert checks["rss_warm_under_floor"], report["rss"]
    assert checks["ranges_exact"], report["ranges"]
    print(f"[segment-scale] total={total} cold={cold_s:.1f}s warm={warm_s:.1f}s "
          f"dispatch_warm={report['warm_dispatch_s']:.1f}s rss={report['rss']} "
          f"staging={report['staging_pool']} windows={report['windows']}", flush=True)


#: Runs tools/segment_scale_probe.py (argv: MiB, chunk bytes) with the JAX
#: test's CHUNK set to the chunk and a span ring that takes a slice.
_JAX_PROBE = r'''
import collections, runpy, sys
from tieredstorage_tpu.utils import tracing

class SliceableRing(collections.deque):
    def __getitem__(self, index):
        if isinstance(index, slice):
            return list(self)[index]
        return super().__getitem__(index)

tracing.collections = type("collections", (), {"deque": SliceableRing})
import tests.test_segment_scale as jax_test
jax_test.CHUNK = int(sys.argv[2])
sys.argv = [sys.argv[0], sys.argv[1]]
runpy.run_path("tools/segment_scale_probe.py", run_name="__main__")
'''


def _jax_probe_spans() -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", SSP_CODEC=CODEC,
               OMP_NUM_THREADS="1",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {XLA_ONE_THREAD}".strip())
    res = subprocess.run(
        [sys.executable, "-c", _JAX_PROBE, str(SMALL_MIB), str(SMALL_CHUNK)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=220)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    spans: dict = {}
    label = None
    for line in res.stdout.splitlines():
        head = re.match(r"copy\d\((cold|warm)\) wall=", line)
        if head:
            label = head.group(1)
            spans[label] = set()
            continue
        span = re.match(r"  (\S+)\s+n=\s*\d+ total=", line)
        if span and label:
            spans[label].add(span.group(1))
    return spans


def test_small_segment_matches_the_jax_probe(tmp_path):
    from tieredstorage_tpu import metadata as jax_metadata
    from tieredstorage_tpu.rsm import RemoteStorageManager as JaxRemoteStorageManager

    probe = _probe()
    total = SMALL_MIB << 20
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # one core, as the gate pairs' children
    try:
        report = probe.run(total, tmp_path, "cpu", SMALL_CHUNK, CODEC)
    finally:
        torch.set_num_threads(threads)

    # The report's shape.
    assert {"segment_bytes", "chunk_bytes", "codec", "device", "serial", "copies", "rss",
            "staging_pool", "windows", "ranges", "ranges_launches", "checks",
            "warm_dispatch_s", "ok"} <= set(report)
    assert (report["segment_bytes"], report["chunk_bytes"], report["codec"]) == (
        total, SMALL_CHUNK, CODEC)
    assert set(report["copies"]) == {"cold", "warm"}
    for copy in report["copies"].values():
        assert copy["wall_s"] > 0 and copy["spans"]["rsm.copy_log_segment_data"]["n"] == 1
        assert all(n == 0 for n in copy["launches"].values())  # the CPU launches nothing
    assert len(report["ranges"]) == 4 and report["checks"]["ranges_exact"]
    assert set(report["checks"]) == {"warm_faster", "dispatch_under_15pct",
                                     "rss_peak_under_2x", "rss_warm_under_floor",
                                     "ranges_exact"}
    assert report["checks"]["rss_peak_under_2x"] is None  # below 1 GiB

    # The twin's stored segment reads back through the JAX package's RSM.
    jax_rsm = JaxRemoteStorageManager()
    jax_rsm.configure({
        **probe.rsm_configs(tmp_path / "remote", tmp_path / "k_public.pem",
                            tmp_path / "k_private.pem", SMALL_CHUNK, CODEC),
        "storage.backend.class": "tieredstorage_tpu.storage.filesystem.FileSystemStorage",
    })
    source = (tmp_path / "00000000000000000099.log").read_bytes()
    warm = probe.segment_metadata(jax_metadata, probe.WARM_ID, total)
    try:
        assert jax_rsm.fetch_log_segment(warm, 0).read() == source
        for r in report["ranges"][:2]:
            start, end = r["start"], r["start"] + r["length"] - 1
            assert jax_rsm.fetch_log_segment(warm, start, end).read() == source[start : end + 1]
    finally:
        jax_rsm.close()

    # Each copy's span names are the JAX probe's, and the port's own spans
    # of its window path and store uploads besides.
    jax_spans = _jax_probe_spans()
    assert set(jax_spans) == {"cold", "warm"}
    for label in ("cold", "warm"):
        names = set(report["copies"][label]["spans"])
        assert names - PORT_ONLY_SPANS == jax_spans[label], label
        assert names & PORT_ONLY_SPANS == {
            "gcm.context", "transform.stage", "transform.launch", "transform.wait",
            "transform.assemble", "storage.upload", "transform.compress_wait"}, label
