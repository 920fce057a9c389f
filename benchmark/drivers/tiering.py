"""Tiering: copier threads copy rolled segments to the object store back to back.

Closed loop. Each of `copiers` threads calls the program's
`copy_log_segment_data` on the seeded segment under a fresh segment id (so
a fresh data key), then `delete_log_segment_data` on it, as retention
would, except for the copies kept for the comparison: the mix's `keep`
names, for distinct copiers drawn from the seed, which copy each keeps:
`first` its copy 0, `last` its last copy of the run (each of its copies
is deleted once the next one has returned, so the last one stays).
Copiers start no copy after the window's end and the ones in flight drain.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from benchmark import program, segments, stats
from benchmark.reference import check


class Driver:
    def __init__(self, ctx, key_files, pair) -> None:
        self.ctx, self.key_files, self.pair = ctx, key_files, pair
        self.seg = None
        self.rsm = None
        self.kept: list = []        # (copier, copy number, stored objects)

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        ctx = self.ctx
        t = time.perf_counter()
        self.seg = segments.make(ctx.seed, {**ctx.config["segment"],
                                            "log.segment.bytes": ctx.segment_bytes}, ctx.device)
        self.rsm = program.build_rsm(ctx.config, self.key_files, ctx.device, traced=ctx.trace)
        ctx.log(f"segment and RSM {time.perf_counter() - t:.3f} s")
        t = time.perf_counter()
        self.rng = np.random.default_rng([ctx.seed, 0x71E])
        self.topic = self.rng.bytes(16)
        kinds = ctx.traffic["keep"]
        chosen = self.rng.choice(ctx.traffic["copiers"], size=len(kinds), replace=False)
        self.keep = {int(c): kind for c, kind in zip(chosen, kinds)}
        # Warm-up: the cell's own shape at its own concurrency, every copier
        # one copy and its delete, so that the staging buffers, allocator
        # blocks and pool threads of concurrent copies exist before the window.
        errors: list = []

        def warm(c: int) -> None:
            try:
                md, sd = self._segment(bytes([0xFF, c]) + b"\x00" * 14)
                self.rsm.copy_log_segment_data(md, sd)
                self.rsm.delete_log_segment_data(md)
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=warm, args=(c,), name=f"warm-{c}")
                   for c in range(ctx.traffic["copiers"])]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        ctx.log(f"warm-up copies {time.perf_counter() - t:.3f} s")
        self.counters = program.Counters(self.rsm)

    def _segment(self, uid: bytes):
        return program.segment_metadata(uid, self.topic, self.seg.files,
                                        self.seg.indexes["leader_epoch"], self.seg.size,
                                        self.seg.last_offset)

    # ------------------------------------------------------------ window
    def run_window(self) -> dict:
        ctx = self.ctx
        handed = self.seg.size + sum(len(v) for v in self.seg.indexes.values())
        results: list = []
        errors: list = []
        deletes: list = []
        lock = threading.Lock()
        if ctx.trace:
            self.rsm.tracer.clear()
        self.counters.start = self.counters.snapshot()
        start = time.perf_counter()
        deadline = start + ctx.seconds

        def delete(md) -> None:
            t2 = time.perf_counter()
            self.rsm.delete_log_segment_data(md)
            with lock:
                deletes.append(("bench.delete", t2, time.perf_counter()))

        def copier(c: int) -> None:
            k = 0
            kind = self.keep.get(c)
            held = None                     # (copy number, metadata, objects)
            while time.perf_counter() < deadline:
                uid = np.random.default_rng([ctx.seed, 0xC0, c, k]).bytes(16)
                md, sd = self._segment(uid)
                t0 = time.perf_counter()
                try:
                    self.rsm.copy_log_segment_data(md, sd)
                    t1 = time.perf_counter()
                    objects = program.stored_objects(self.rsm, md)
                    stored = sum(len(v) for v in objects.values())
                    if ctx.control:
                        objects = _control(ctx.control, objects, self.rsm, md, ctx.seed + k)
                    with lock:
                        results.append((c, k, t0, t1, self.seg.size, stored))
                    if kind == "first" and k == 0:
                        with lock:
                            self.kept.append((c, k, kind, objects))
                    elif kind == "last":
                        if held is not None:
                            delete(held[1])
                        held = (k, md, objects)
                    else:
                        delete(md)
                except Exception as e:  # a failed copy counts as failed; the copier goes on
                    with lock:
                        errors.append((c, k, t0, time.perf_counter(), repr(e)))
                k += 1
            if held is not None:
                with lock:
                    self.kept.append((c, held[0], kind, held[2]))

        threads = [threading.Thread(target=copier, args=(c,), name=f"copier-{c}")
                   for c in range(ctx.traffic["copiers"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self.counters.end = self.counters.snapshot()
        for e in errors:
            ctx.log(f"copy failed: copier {e[0]} copy {e[1]}: {e[4]}")
        took = sorted(t1 - t0 for _, _, t0, t1, _, _ in results)
        if took:
            last = max(t1 for _, _, _, t1, _, _ in results) - start
            ctx.log(f"{len(took)} copies, seconds each min {took[0]:.2f} median "
                    f"{took[len(took) // 2]:.2f} max {took[-1]:.2f}; last returned at {last:.2f} s")
        ranges = deletes + [("bench.copy", t0, t1) for _, _, t0, t1, _, _ in results]
        return {"start": start, "copies": results, "errors": errors, "handed": handed,
                "host_ranges": ranges, "attempted": len(results) + len(errors),
                "failed": len(errors)}

    def end_to_end(self, w: dict) -> dict:
        ops = [(t0, t1, n) for _, _, t0, t1, n, _ in w["copies"]]
        ops += [(t0, t1, 0) for _, _, t0, t1, _ in w["errors"]]
        return {
            "copy_GiBps": stats.drain_inclusive_rate(w["start"], ops) / stats.GIB,
            "stored_ratio": sum(s for *_, s in w["copies"]) / (w["handed"] * len(w["copies"])),
        }

    def layer_inputs(self, w: dict) -> dict:
        return {"kind": "copy", "spans": program.spans(self.rsm), "counters": self.counters.delta(),
                "copy_GiBps": self.end_to_end(w)["copy_GiBps"],
                "copy_seconds": sum(t1 - t0 for _, _, t0, t1, _, _ in w["copies"]),
                "bytes": self.seg.size * len(w["copies"])}

    def release(self) -> None:
        self.rsm.close()
        self.rsm = None

    # ------------------------------------------------------------ comparison
    def compare(self, w: dict) -> dict:
        totals = {"manifest": 0, "chunks": 0, "indexes": 0}
        for c, k, kind, objects in sorted(self.kept, key=lambda kept: kept[:2]):
            got = check.check_copy(objects, self.seg.log, self.seg.indexes, self.ctx.chunk,
                                   bool(self.ctx.config["rsm"]["compression.enabled"]),
                                   self.pair, self.ctx.device)
            self.ctx.log(f"kept copy {k} of copier {c} ({kind}): {got}")
            for key in totals:
                totals[key] += got[key]
        return {
            "checked_copies": {"value": len(self.kept), "min": len(self.ctx.traffic["keep"])},
            "bad_manifests": {"value": totals["manifest"], "max": 0},
            "bad_chunks": {"value": totals["chunks"], "max": 0},
            "bad_indexes": {"value": totals["indexes"], "max": 0},
            "failed_copies": {"value": w["failed"], "max": 0},
        }

    def close(self) -> None:
        if self.rsm is not None:
            self.rsm.close()
        if self.seg is not None:
            self.seg.close()


def _control(kind: str, objects: dict, rsm, md, seed: int) -> dict:
    """A copy broken where it is produced, for the controls and fault tests:
    `alter` flips one byte of one stored chunk, `half` keeps only the first
    half of the log object."""
    log = objects["log"]
    if kind == "alter":
        pos = int(np.random.default_rng(seed).integers(0, len(log)))
        log = log[:pos] + bytes([log[pos] ^ 0x01]) + log[pos + 1:]
    elif kind == "half":
        log = log[: len(log) // 2]
    else:
        raise ValueError(f"unknown control {kind!r}")
    program.replace_object(rsm, md, "log", log)
    return {**objects, "log": log}
