"""Deterministic fault injection for storage backends.

`FaultInjectingBackend` wraps any `StorageBackend` and executes a seedable
`FaultSchedule` (raise on the Nth upload/fetch/delete, truncate or corrupt
fetched bytes, inject latency). Counterpart of tieredstorage_tpu/faults/,
whole: wrapped directly by tests, or by the RSM under its
`fault.injection.enabled` flag.
"""

from tieredstorage_tpu_torch.faults.backend import FaultInjectingBackend
from tieredstorage_tpu_torch.faults.schedule import (
    FaultInjectedException,
    FaultRule,
    FaultSchedule,
)

__all__ = [
    "FaultInjectedException",
    "FaultInjectingBackend",
    "FaultRule",
    "FaultSchedule",
]
