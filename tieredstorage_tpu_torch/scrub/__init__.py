"""Background integrity scrubbing: detect-verify-repair over the object store.

Counterpart of tieredstorage_tpu/scrub/, as far as this package has ported
it: the scrubber (enumerate, CRC32C and detransform verification,
quarantine, repair) and its scheduler, the recovery sweeper of the segment
lifecycle, and anti-entropy repair across replicas. The scrub-metrics group
is not yet ported.
"""

from tieredstorage_tpu_torch.scrub.antientropy import (
    AntiEntropyRepairer,
    AntiEntropyReport,
    AntiEntropyScheduler,
)
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
    "AntiEntropyRepairer",
    "AntiEntropyReport",
    "AntiEntropyScheduler",
    "RecoverySweeper",
    "ScrubFinding",
    "ScrubReport",
    "ScrubScheduler",
    "Scrubber",
    "SweepReport",
    "SweepScheduler",
    "SweeperInvariantError",
]
