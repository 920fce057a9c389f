"""Project-invariant static analysis of this package.

Counterpart of tieredstorage_tpu/analysis, holding this package's tree to
the same discipline. An AST-based checker framework (stdlib ``ast``, zero
dependencies) that mechanically enforces the concurrency and observability
discipline the serving tier relies on:

- ``lock-order``        cross-module lock-acquisition graph stays a DAG; no
                        blocking calls (socket/HTTP/waits) under a held lock
- ``races``             guarded-by data-race inference: every shared mutable
                        attribute of a thread-reachable class has one
                        inferred guarding lock, held at every write
                        (``# tsa: single-thread`` / ``new_unguarded`` are
                        checked escape hatches)
- ``device-dispatch``   the CUDA window path stays one window program, one
                        device->host copy and one wait per window: no host
                        sync or device-value materialization in its
                        closure, no context-cache bypass, no read of a
                        staged buffer after the program wrote into it
- ``deadline``          blocking waits in request-path modules clamp to the
                        end-to-end ``Deadline`` budget
- ``bounded-concurrency``  no unsanctioned ``threading.Thread`` and no
                        unbounded executors
- ``monotonic-clock``   no ``time.time()`` (durations/timeouts must ride the
                        monotonic clock)
- ``swallowed-exception``  no broad ``except: pass`` without a trace event,
                        metric, or log
- ``config-drift``      every config key read is declared; generated docs
                        (docs/torch/configs.rst and metrics.rst) match the
                        live code

Entry point: ``python -m tieredstorage_tpu_torch.analysis`` (``--paths
<files...>`` is the incremental mode over a content-hash parse cache).
Findings carry stable line-independent fingerprints; vetted findings live
in ``tools/torch_analysis_suppressions.txt`` with one-line justifications
and are burned down, never silently grandfathered. The static lock-order
and guarded-by proofs are cross-validated at runtime by
``tieredstorage_tpu_torch.utils.locks.LockWitness`` and ``RaceWitness``
(``TSTPU_LOCK_WITNESS=1``; ``RemoteStorageManager.fleet_ping(
include_witness=True)`` reports the verdict).
"""

from tieredstorage_tpu_torch.analysis.core import (
    AnalysisReport,
    Finding,
    Project,
    Suppressions,
    load_project,
    run_analysis,
)

__all__ = [
    "AnalysisReport",
    "Finding",
    "Project",
    "Suppressions",
    "load_project",
    "run_analysis",
]
