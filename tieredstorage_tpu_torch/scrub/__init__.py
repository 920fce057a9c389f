"""Background integrity scrubbing: detect-verify-repair over the object store.

Counterpart of tieredstorage_tpu/scrub/, as far as this package has ported
it: the scrubber (enumerate, CRC32C and detransform verification,
quarantine, repair) and its scheduler, the recovery sweeper of the segment
lifecycle, anti-entropy repair across replicas, and the scrub-metrics group.
"""

from tieredstorage_tpu_torch.scrub.antientropy import (
    AntiEntropyRepairer,
    AntiEntropyReport,
    AntiEntropyScheduler,
)
from tieredstorage_tpu_torch.scrub.metrics import SCRUB_METRIC_GROUP, ScrubMetrics
from tieredstorage_tpu_torch.scrub.scheduler import ScrubScheduler
from tieredstorage_tpu_torch.scrub.scrubber import (
    INDEXES_SUFFIX,
    LOG_SUFFIX,
    MANIFEST_SUFFIX,
    ScrubFinding,
    ScrubReport,
    Scrubber,
)
from tieredstorage_tpu_torch.scrub.sweeper import (
    RecoverySweeper,
    SweeperInvariantError,
    SweepReport,
    SweepScheduler,
)

__all__ = [
    "INDEXES_SUFFIX",
    "LOG_SUFFIX",
    "MANIFEST_SUFFIX",
    "SCRUB_METRIC_GROUP",
    "AntiEntropyRepairer",
    "AntiEntropyReport",
    "AntiEntropyScheduler",
    "RecoverySweeper",
    "ScrubFinding",
    "ScrubMetrics",
    "ScrubReport",
    "ScrubScheduler",
    "Scrubber",
    "SweepReport",
    "SweepScheduler",
    "SweeperInvariantError",
]
