"""Virtual-CPU-member platform pinning, shared by tests, tools and the
sidecar's entry point.

Counterpart of tieredstorage_tpu/utils/platforms.py. Multi-device window
paths are validated on virtual CPU members, as the JAX package validates its
mesh on virtual CPU devices. JAX raises its host platform's device count
through ``XLA_FLAGS``; torch has no such count, so the pin is this module's
own process-wide state: after ``pin_virtual_cpu(n)`` the platform of
`parallel.mesh.local_devices()` is the CPU and it lists ``n`` members, every
one `torch.device("cpu")`. Nothing here reads or writes ``XLA_FLAGS``.

Like JAX's, the pin can only be raised before a CPU plan was resolved with
fewer members (a resolved plan keeps the members it was given). `unpin`
restores the unpinned state with nothing resolved; it exists for test
fixtures, which must restore it so that later tests in the same process see
one CPU member again.
"""

from __future__ import annotations

#: Pinned virtual CPU members (0 = unpinned), and the most CPU members any
#: plan has been resolved with since the last `unpin` (0 = none yet).
_STATE = {"pinned": 0, "resolved": 0}


def pin_virtual_cpu(min_devices: int = 8) -> None:
    """Pin the port to the CPU with at least ``min_devices`` virtual CPU
    members. Safe to call multiple times; raises if a CPU plan was resolved
    with fewer members before the pin could take effect."""
    count = max(1, min_devices)
    have = max(1, _STATE["pinned"])
    if _STATE["resolved"] and have < min_devices:
        raise RuntimeError(
            f"virtual CPU mesh has {have} devices, need {min_devices}; "
            "a CPU plan was resolved before the pin could be raised — call "
            "pin_virtual_cpu() before any data_mesh()/MeshPlan.from_spec() use"
        )
    _STATE["pinned"] = max(_STATE["pinned"], count)


def pinned() -> bool:
    """Whether the port is pinned to virtual CPU members."""
    return _STATE["pinned"] > 0


def cpu_members() -> int:
    """Members of the CPU platform: the pinned count, else the one CPU."""
    return max(1, _STATE["pinned"])


def note_cpu_resolved(members: int) -> None:
    """Record that a plan was resolved over ``members`` CPU members."""
    _STATE["resolved"] = max(_STATE["resolved"], members)


def unpin() -> None:
    """Restore the unpinned state with no plan resolved (test fixtures)."""
    _STATE["pinned"] = 0
    _STATE["resolved"] = 0
