"""Device mesh helpers for splitting chunk windows across devices.

Counterpart of tieredstorage_tpu/parallel/mesh.py, with its names and
semantics. The port's mesh is an ordered list of `torch.device` members
along one axis, `DATA_AXIS`: member i holds rows [i*r, (i+1)*r) of a window
padded to a multiple of the mesh size. Members may repeat one device: four
members on `cuda:0` split a window into four row blocks, each run on its own
CUDA stream, the way the JAX package checks its mesh on virtual CPU devices.

`MeshPlan` is the production handle: built from the `transform.mesh.devices`
config (0/"all" = every local device, the configured default; 1 =
single-device, exactly the unsplit path; n = the first n local devices), it
owns row padding, placement and the per-member accounting the transform
backend reports through `DispatchStats`. A plan whose mesh would have a
single member is the fallback plan (mesh ``None``).

The local devices are every GPU that `torch.cuda.device_count()` reports, or,
after `utils.platforms.pin_virtual_cpu(n)` (or when the CPU platform is asked
for), the CPU's members: n pinned virtual members, else the one CPU.

`shard_map_compat` has no torch meaning: torch has no program that a mesh
partitions. Its role, one body run by every member over that member's rows,
is `run_on_members`: a loop over the members, each under
`torch.cuda.device(member)` and its own stream, forked from and joined back
into the caller's stream.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from tieredstorage_tpu_torch.utils import platforms

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh:
    """A 1-D mesh: an ordered tuple of `torch.device` members along
    `DATA_AXIS`, each CUDA member with a stream of its own (made with the
    mesh, kept for its life)."""

    devices: tuple
    streams: tuple = dataclasses.field(init=False, repr=False)

    def __post_init__(self) -> None:
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one member")
        object.__setattr__(self, "devices", devices)
        object.__setattr__(self, "streams", tuple(
            torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in devices
        ))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.size}

    @contextlib.contextmanager
    def member(self, i: int):
        """Run the enclosed work as member ``i``: under its device and its
        stream (nothing to enter for a CPU member)."""
        stream = self.streams[i]
        if stream is None:
            yield
            return
        with torch.cuda.device(self.devices[i]), torch.cuda.stream(stream):
            yield


def local_devices(platform: Optional[str] = None) -> list:
    """The devices a mesh may span on ``platform`` ("cuda" or "cpu"; None =
    the CPU when pinned, else the GPUs): every GPU, or the CPU's members."""
    if platform is None:
        platform = "cpu" if platforms.pinned() else "cuda"
    if platform == "cpu":
        return [torch.device("cpu")] * platforms.cpu_members()
    if platform != "cuda":
        raise ValueError(f"no mesh members on platform {platform!r}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(count)]


def data_mesh(n_devices: Optional[int] = None, *, platform: Optional[str] = None) -> DeviceMesh:
    """1-D mesh over the first `n_devices` local devices (default: all)."""
    devices = local_devices(platform)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"Requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    if devices and devices[0].type == "cpu":
        platforms.note_cpu_resolved(len(devices))
    return DeviceMesh(tuple(devices))


def _host_rows(array) -> torch.Tensor:
    return array if isinstance(array, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(array))


def shard_rows(mesh: DeviceMesh, array) -> list:
    """Place an array with its leading (row) axis split over the mesh: a list
    of per-member tensors in row order, member i's on its device.

    The batch must be divisible by the mesh size — callers pad with dummy
    rows (the transform backend does) before sharding. A CPU member's shard
    is a view of the array's rows; a CUDA member's is a copy made on that
    member's stream (from pinned memory it runs asynchronously)."""
    rows = _host_rows(array)
    if rows.shape[0] % mesh.size:
        raise ValueError(f"{rows.shape[0]} rows do not split over {mesh.size} members")
    r = rows.shape[0] // mesh.size
    shards = []
    for i, device in enumerate(mesh.devices):
        part = rows[i * r : (i + 1) * r]
        if device.type == "cpu":
            shards.append(part)
            continue
        with mesh.member(i):
            shard = torch.empty(part.shape, dtype=part.dtype, device=device)
            shard.copy_(part, non_blocking=True)
        shards.append(shard)
    return shards


def run_on_members(mesh: DeviceMesh, body: Callable, shards: Sequence) -> list:
    """Run ``body(shard)`` once per member over that member's shard — the
    role `shard_map` plays in the JAX package, for row-local bodies that
    need no collective.

    Each CUDA member's stream first waits for its device's current (caller)
    stream, so every input enqueued before the call (staging copies, the
    per-device constants) is ordered before the member's work; the body then
    runs under the member's device and stream, so its kernel launches and
    allocations are that member's. Afterwards the caller's stream waits for
    every member stream, and each returned tensor is marked as used on the
    caller's stream, so a consumer there and the caching allocator both see
    the member's work as done first."""
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} shards for {mesh.size} members")
    outs = []
    for i, (device, shard) in enumerate(zip(mesh.devices, shards)):
        stream = mesh.streams[i]
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(device))
        with mesh.member(i):
            outs.append(body(shard))
    for i, device in enumerate(mesh.devices):
        stream = mesh.streams[i]
        if stream is None:
            continue
        caller = torch.cuda.current_stream(device)
        caller.wait_stream(stream)
        out = outs[i]
        if isinstance(out, torch.Tensor):
            out.record_stream(caller)
    return outs


def pad_batch(n_rows: int, mesh: Optional[DeviceMesh]) -> int:
    """Rows to add so the batch divides evenly across the mesh."""
    if mesh is None:
        return 0
    return (-n_rows) % mesh.size


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """How one transform window fans out over the local devices.

    ``mesh is None`` is the fallback plan: no split, no padding —
    byte for byte the unsplit path. A real mesh splits the packed window's
    row axis, so ONE logical dispatch runs on every member; each member's
    output is written into its own staged rows, which keeps the staged
    buffer donated."""

    mesh: Optional[DeviceMesh] = None

    @property
    def size(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    @property
    def members(self) -> tuple:
        """The members' devices in row order (() on the fallback plan)."""
        return () if self.mesh is None else self.mesh.devices

    def pad_rows(self, n_rows: int) -> int:
        """Rows to add so the batch divides evenly across the mesh."""
        return pad_batch(n_rows, self.mesh)

    def rows_per_device(self, n_rows: int) -> int:
        """Per-member row count for an (already padded) batch."""
        return (n_rows + self.pad_rows(n_rows)) // self.size

    def shard(self, array):
        """Stage an array: row-split over the mesh (a list of per-member
        tensors), or the array itself as a tensor on the fallback plan."""
        if self.mesh is None:
            return _host_rows(array)
        return shard_rows(self.mesh, array)

    def describe(self) -> dict:
        """Mesh shape for reports ({} on the fallback plan)."""
        if self.mesh is None:
            return {}
        return {str(k): int(v) for k, v in self.mesh.shape.items()}

    @classmethod
    def wrap(cls, mesh: Union[None, DeviceMesh, "MeshPlan", Sequence]) -> "MeshPlan":
        """Adopt a caller-supplied mesh (the backend's `mesh=` argument: a
        `DeviceMesh`, a sequence of devices — members may repeat one device —
        or a plan, passed through); a one-member mesh normalizes to the
        fallback plan."""
        if isinstance(mesh, cls):
            plan = mesh
        elif mesh is None or isinstance(mesh, DeviceMesh):
            plan = cls(mesh)
        else:
            plan = cls(DeviceMesh(tuple(mesh)))
        if plan.mesh is not None and plan.mesh.size <= 1:
            return cls(None)
        return plan

    @classmethod
    def from_spec(cls, spec: Union[None, int, str], *, platform: Optional[str] = None) -> "MeshPlan":
        """Build the plan the `transform.mesh.devices` config asks for.

        ``None``/``0``/``"all"`` = every local device (the configured
        default); ``1`` = single-device (exactly the unsplit path); ``n`` =
        the first n local devices (raises when fewer are attached).
        Whenever the resulting mesh would hold one member the fallback plan
        is returned. ``platform`` picks the local devices ("cuda" or "cpu",
        as `local_devices`); the backend passes its `transform.device`'s."""
        if isinstance(spec, str):
            text = spec.strip().lower()
            if text in ("", "all"):
                spec = None
            else:
                spec = int(text)
        if spec is not None and spec < 0:
            raise ValueError(f"transform.mesh.devices must be >= 0, got {spec}")
        n: Optional[int] = None if spec in (None, 0) else int(spec)
        if n == 1:
            return cls(None)
        devices = local_devices(platform)
        if n is None and len(devices) <= 1:
            return cls(None)
        return cls.wrap(data_mesh(n, platform=platform))
