"""Background integrity scrubbing: detect-verify-repair over the object store.

Counterpart of tieredstorage_tpu/scrub/, as far as this package has ported
it: the scrubber (enumerate, CRC32C and detransform verification,
quarantine, repair) and its scheduler. Anti-entropy (needs replicated
storage), the recovery sweeper (with the segment lifecycle) and the
scrub-metrics group are not yet ported.
"""

from tieredstorage_tpu_torch.scrub.scheduler import ScrubScheduler
from tieredstorage_tpu_torch.scrub.scrubber import (
    INDEXES_SUFFIX,
    LOG_SUFFIX,
    MANIFEST_SUFFIX,
    ScrubFinding,
    ScrubReport,
    Scrubber,
)

__all__ = [
    "INDEXES_SUFFIX",
    "LOG_SUFFIX",
    "MANIFEST_SUFFIX",
    "ScrubFinding",
    "ScrubReport",
    "ScrubScheduler",
    "Scrubber",
]
