"""Device meshes for sharded scoring and retraining: the port of
ccfd_tpu/parallel/mesh.py.

The reference's mesh is ONE program over many devices in one process (a
``jax.sharding.Mesh``); the port keeps that shape. A ``Mesh`` is a named
grid of ``torch.device``s that the calling process drives itself:

- axis ``"data"`` — batch shards (data parallelism): each shard scores or
  trains on its slice of the batch; gradients sum over the shards.
- axis ``"model"`` — the legacy 2-D mesh's hidden-dimension axis (tensor
  parallelism); the named 3-D mesh calls it ``"tp"`` beside ``"fsdp"``.

An entry of the grid is a LOGICAL shard: devices may repeat. The CPU tests
run eight CPU shards, as the reference's tests run eight virtual CPU
devices, and one card serves four shards of ``cuda:0``. Each logical shard
on a CUDA device owns its own CUDA stream (``Mesh.stream``), so the shards'
copies and launches are ordered per shard and overlap across shards.
Collectives between shards are explicit tensor moves in this process
(ops/shard_compat.py); ``torch.distributed`` appears only where processes
meet (parallel/multihost.py).
"""

from __future__ import annotations

import threading
from typing import Iterator, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the partitioning layer's axis names (parallel/partition.py): the
# data/fsdp/tp vocabulary the rule tables speak. ``MODEL_AXIS`` stays the
# legacy 2-D mesh's second axis name
FSDP_AXIS = "fsdp"
TP_AXIS = "tp"
NAMED_AXES = (DATA_AXIS, FSDP_AXIS, TP_AXIS)


class Mesh:
    """A named grid of ``torch.device``s (``devices``: a numpy object array
    whose dims are ``axis_names``). ``shape`` maps each axis to its size,
    in order; ``size`` is the number of logical shards."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 process_of: np.ndarray | None = None, process_index: int = 0):
        grid = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(devices[idx])
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-D device grid needs {grid.ndim} axis names, "
                             f"got {tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(s) for a, s in zip(self.axis_names, grid.shape)}
        # a mesh over several processes (parallel/multihost.py): the process
        # each shard belongs to; this process drives only its own shards
        self.process_of = (np.zeros(grid.shape, np.int64) if process_of is None
                           else np.asarray(process_of, np.int64).reshape(grid.shape))
        self.process_index = int(process_index)
        self._streams: dict[int, torch.cuda.Stream] = {}
        self._lock = threading.Lock()

    @property
    def process_count(self) -> int:
        return int(self.process_of.max()) + 1

    def is_local(self, pos: tuple[int, ...]) -> bool:
        return int(self.process_of[pos]) == self.process_index

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat(self) -> list[torch.device]:
        """The logical shards' devices in row-major grid order."""
        return list(self.devices.reshape(-1))

    @property
    def platform(self) -> str:
        """``cuda`` or ``cpu``: the device type of the mesh's shards."""
        return self.devices.reshape(-1)[0].type

    def positions(self) -> Iterator[tuple[int, ...]]:
        """Every grid position this process drives (all of them in a
        one-process mesh), in row-major order (a shard's flat index is its
        rank in the order of the whole grid)."""
        return (pos for pos in np.ndindex(self.devices.shape) if self.is_local(pos))

    def flat_index(self, pos: tuple[int, ...]) -> int:
        return int(np.ravel_multi_index(pos, self.devices.shape))

    def along(self, axis: str, at: dict[str, int] | None = None) -> list[tuple[int, ...]]:
        """The grid positions along ``axis`` (this process's and the
        others'), the other axes fixed at ``at`` (0 where not given)."""
        at = at or {}
        base = [int(at.get(a, 0)) for a in self.axis_names]
        k = self.axis_names.index(axis)
        out = []
        for i in range(self.shape[axis]):
            pos = list(base)
            pos[k] = i
            out.append(tuple(pos))
        return out

    def stream(self, flat: int) -> "torch.cuda.Stream | None":
        """The CUDA stream of logical shard ``flat`` (made at first use);
        None on the CPU."""
        dev = self.flat[flat]
        if dev.type != "cuda":
            return None
        with self._lock:
            s = self._streams.get(flat)
            if s is None:
                s = self._streams[flat] = torch.cuda.Stream(device=dev)
            return s

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, platform={self.platform})"


def cuda_devices() -> list[torch.device]:
    """Every visible CUDA device (the ``devices=None`` default); raises
    when CUDA is not available: a CPU mesh is asked for by its devices."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass the mesh's devices (e.g. "
            "[torch.device('cpu')] * 8 for eight logical CPU shards)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: list | None = None, model_parallel: int = 1) -> Mesh:
    """(n/model_parallel) x model_parallel mesh over the given devices."""
    devices = list(devices) if devices is not None else cuda_devices()
    n = len(devices)
    if n % model_parallel != 0:
        raise ValueError(
            f"{n} devices not divisible by model_parallel={model_parallel}")
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return Mesh(grid.reshape(n // model_parallel, model_parallel), (DATA_AXIS, MODEL_AXIS))


def make_named_mesh(devices: list | None = None, fsdp: int = 1, tp: int = 1) -> Mesh:
    """3-D ``(data, fsdp, tp)`` named mesh; data absorbs the remainder.

    The partitioning layer's canonical shape (parallel/partition.py):
    batches shard over ``data``, param rules speak ``fsdp``/``tp``. A pure
    data-parallel serving mesh is ``(n, 1, 1)``."""
    devices = list(devices) if devices is not None else cuda_devices()
    n = len(devices)
    fsdp, tp = max(1, int(fsdp)), max(1, int(tp))
    if n % (fsdp * tp) != 0:
        raise ValueError(f"{n} devices not divisible by fsdp*tp={fsdp * tp}")
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return Mesh(grid.reshape(n // (fsdp * tp), fsdp, tp), NAMED_AXES)
