"""Multi-process runtime: a mesh whose data axis spans processes. The port
of ccfd_tpu/parallel/multihost.py, where ``torch.distributed`` plays the
part of ``jax.distributed``.

- ``initialize()`` — joins the process group when COORDINATOR_ADDRESS
  (host:port of process 0), NUM_PROCESSES and PROCESS_ID say so (or the
  arguments do): ``torch.distributed.init_process_group`` over
  ``tcp://<address>``, gloo for CPU meshes and nccl for CUDA. A no-op for a
  single process, so every entry point can call it; idempotent.
- ``make_global_mesh()`` — the (data, model) mesh over every process's
  devices, laid out host-major: the data axis spans the processes (the
  gradient all-reduce crosses processes once a step) and the model axis
  stays inside one process. Each process drives only its own shards
  (``Mesh.process_of``); with one process it is ``mesh.make_mesh``.
- ``process_local_batch_to_global()`` — a process's rows as its part of
  the global batch: the rows split over its data shards, with the global
  shape and the rows' offset in it. The sharded train step
  (parallel/train.py) and the single-controller ``shard_map``
  (ops/shard_compat.py) take such local parts and reduce over the process
  group.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import numpy as np
import torch

from ccfd_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, cuda_devices
from ccfd_tpu_torch.parallel.sharding import NamedSharding, P

INIT_TIMEOUT_S = 60.0

_initialized = False


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device: "str | torch.device | None" = None,
               timeout_s: float = INIT_TIMEOUT_S) -> bool:
    """Join the multi-process job if configured; returns True if
    distributed. All of COORDINATOR_ADDRESS, NUM_PROCESSES (> 1) and
    PROCESS_ID unset or a single process -> no-op. ``device``: the mesh's
    device type (gloo for ``cpu``, nccl for CUDA; None picks nccl when CUDA
    is available). A rank that does not join within ``timeout_s`` fails."""
    global _initialized
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS", "")
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", "0") or 0)
    if process_id is None:
        process_id = int(os.environ.get("PROCESS_ID", "-1") or -1)
    if not coordinator_address or num_processes <= 1:
        return False
    if _initialized:
        return True
    import torch.distributed as dist

    if dist.is_initialized():
        _initialized = True
        return True
    if process_id < 0:
        raise ValueError("PROCESS_ID is required with NUM_PROCESSES > 1")
    cpu = (torch.device(device).type == "cpu" if device is not None
           else not torch.cuda.is_available())
    dist.init_process_group(
        backend="gloo" if cpu else "nccl",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    _initialized = True
    return True


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def make_global_mesh(model_parallel: int = 1, devices: list | None = None) -> Mesh:
    """Global (data, model) mesh over every process's devices; ``devices``
    are this process's (None: every visible CUDA device), and every process
    is taken to hold as many. Host-major: the grid is
    ``(processes * local / model_parallel, model_parallel)``, process p's
    shards a contiguous run of data rows, so each model-parallel group
    lies inside one process."""
    local = list(devices) if devices is not None else cuda_devices()
    world, rank = process_count(), process_index()
    n = len(local) * world
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    if len(local) % model_parallel != 0:
        raise ValueError(
            f"model_parallel={model_parallel} does not divide per-process device "
            f"count {len(local)}; tensor-parallel groups must not span processes")
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device(d) for _p in range(world) for d in local]
    owner = np.repeat(np.arange(world), len(local))
    shape = (n // model_parallel, model_parallel)
    return Mesh(grid.reshape(shape), (DATA_AXIS, MODEL_AXIS),
                process_of=owner.reshape(shape), process_index=rank)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Row-sharded batch over the data axis (features whole)."""
    return NamedSharding(mesh, P(DATA_AXIS, None))


@dataclass
class LocalBatch:
    """A process's part of a global batch: its ``rows``, each data shard's
    slice of them on the shard's device (``shards``), the ``global_shape``
    and the rows' ``offset`` in it."""

    rows: torch.Tensor
    shards: list
    global_shape: tuple
    offset: int

    @property
    def shape(self) -> tuple:
        return self.global_shape


def process_local_batch_to_global(mesh: Mesh, local_batch: np.ndarray) -> LocalBatch:
    """Each process's own rows (its bus partitions' decode) as its part of
    one global batch of ``process_count * local_rows`` rows. Every process
    must pass the same number of rows (the scorer's fixed bucket shapes
    already do)."""
    rows = torch.as_tensor(np.asarray(local_batch))
    positions = [p for p in mesh.along(DATA_AXIS) if mesh.is_local(p)]
    if rows.shape[0] % len(positions):
        raise ValueError(f"{rows.shape[0]} local rows do not split over this process's "
                         f"{len(positions)} data shards")
    shards = [part.to(mesh.devices[p]) for p, part in zip(positions, rows.chunk(len(positions)))]
    world = mesh.process_count
    return LocalBatch(rows=rows, shards=shards,
                      global_shape=(rows.shape[0] * world, *rows.shape[1:]),
                      offset=rows.shape[0] * mesh.process_index)


def global_batch_size(mesh: Mesh, per_device_rows: int) -> int:
    """Rows a dispatch across the whole job (static-shape planning)."""
    return per_device_rows * mesh.devices.shape[0]
