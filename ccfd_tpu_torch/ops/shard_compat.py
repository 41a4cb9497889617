"""The port's single-controller ``shard_map``: the counterpart of
ccfd_tpu/ops/shard_compat.py, which picks ``jax.shard_map`` or its
experimental spelling.

``shard_map(f, mesh=, in_specs=, out_specs=, axis_name=)`` returns a
function of global arguments. It splits each tensor argument over ONE mesh
axis as its in-spec says (``P(None, None, "tp", None)`` cuts dim 2 into
``mesh.shape["tp"]`` equal slices; ``P()`` hands every shard the whole
tensor; a ``None`` in-spec passes a non-tensor argument through), runs
``f(ax, *local_args)`` once a shard on that shard's device, and puts the
outputs back together as the out-specs say (a named dim is concatenated,
``P()`` takes shard 0's value). The shards along the axis are the grid
positions with every other axis at ``at`` (0 where not given).

``ax`` (``Axis``) carries the collectives over the axis, as explicit
tensor moves between the shards' devices in this process:

- ``ax.size``, ``ax.index``;
- ``ax.ppermute(x, perm)``: shard ``dst`` receives shard ``src``'s ``x``
  for each ``(src, dst)`` in ``perm`` (zeros where none arrives);
- ``ax.all_to_all(x, split_axis, concat_axis)``: the tiled all-to-all
  (shard ``i`` keeps piece ``i`` of every shard's ``x`` cut along
  ``split_axis``, concatenated along ``concat_axis`` in shard order);
- ``ax.psum(x)``: the sum over the shards, added in shard order on every
  shard, so every shard holds the same bits.

Each shard's body runs on a thread of its own under the shard's CUDA
stream (``Mesh.stream``); a collective is a rendezvous: every shard
deposits its tensor with an event recorded on its stream, and a reader
makes its own stream wait on that event before it moves the tensor. A body
that raises breaks the rendezvous, so the other shards fail instead of
waiting, and the first error is raised to the caller. The moves are
autograd operations: a loss of ``shard_map``'s output back-propagates
through the collectives.

On a mesh over several processes (parallel/multihost.py) a process runs
the bodies of its own shards along the axis and is handed its LOCAL part
of each argument (its rows, as the reference's
``make_array_from_process_local_data``); the outputs are its local part
too. A collective then also crosses the processes: one thread of the
process all-gathers its shards' tensors over the ``torch.distributed``
group (host-major: process p holds the axis's p-th run of shards), the
forward direction only (no gradient crosses a process).

Not carried over: ``pcast_varying``. It marks a scan carry as varying
over the axis for JAX's replication checker; the port has no such checker
(each shard's tensors are simply its own).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Sequence

import torch

from ccfd_tpu_torch.parallel.mesh import Mesh
from ccfd_tpu_torch.parallel.sharding import PartitionSpec, _axes

RENDEZVOUS_TIMEOUT_S = 120.0


class Axis:
    """One shard's view of the mapped axis and its collectives."""

    def __init__(self, name: str, index: int, group: "_Group", device: torch.device):
        self.name = name
        self.index = index
        self.size = group.size
        self.device = device
        self._group = group

    def _exchange(self, x: torch.Tensor) -> list[torch.Tensor]:
        return self._group.exchange(self.index, x, self.device)

    def ppermute(self, x: torch.Tensor, perm: Sequence[tuple[int, int]]) -> torch.Tensor:
        peers = self._exchange(x)
        for src, dst in perm:
            if dst == self.index:
                return peers[src]
        return torch.zeros_like(x)

    def all_to_all(self, x: torch.Tensor, split_axis: int, concat_axis: int) -> torch.Tensor:
        n = self.size
        if x.shape[split_axis] % n:
            raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} does not "
                             f"split over {n} shards")
        peers = self._exchange(x)
        return torch.cat([p.chunk(n, dim=split_axis)[self.index] for p in peers],
                         dim=concat_axis)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        peers = self._exchange(x)
        out = peers[0]
        for p in peers[1:]:
            out = out + p
        return out


class _Group:
    """The rendezvous of one ``shard_map`` call's shards: ``size`` shards
    along the axis, ``local`` of them (from ``offset``) in this process."""

    def __init__(self, size: int, local: int | None = None, offset: int = 0):
        self.size = size
        self.local = size if local is None else local
        self.offset = offset
        self._slots: list[Any] = [None] * self.local
        self._all: list[Any] = []
        self._barrier = threading.Barrier(self.local, timeout=RENDEZVOUS_TIMEOUT_S)

    def abort(self) -> None:
        self._barrier.abort()

    def _gather_processes(self) -> None:
        """The leader's step: every process's shards' tensors, in global
        axis order, over the process group."""
        import torch.distributed as dist

        mine = torch.stack([t for t, _e in self._slots])
        parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, mine)
        self._all = [(t, None) for part in parts for t in part.unbind(0)]

    def exchange(self, index: int, x: torch.Tensor, device: torch.device) -> list[torch.Tensor]:
        ev = None
        if x.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(x.device))
        self._slots[index - self.offset] = (x, ev)
        self._barrier.wait()
        if self.local < self.size:
            if index == self.offset:
                self._gather_processes()
            self._barrier.wait()
            slots = self._all
        else:
            slots = self._slots
        out = []
        for t, e in slots:
            if e is not None:
                for d in {t.device, device}:
                    if d.type == "cuda":
                        torch.cuda.current_stream(d).wait_event(e)
            moved = t if t.device == device else t.to(device)
            if t.is_cuda and moved is t:
                # the allocator must not reuse the block while this
                # shard's stream reads it
                t.record_stream(torch.cuda.current_stream(device))
            out.append(moved)
        # nobody overwrites a slot before every shard has read them all
        self._barrier.wait()
        return out


def _split(x: Any, spec: Any, axis: str, n: int) -> list[Any]:
    if spec is None or not isinstance(x, torch.Tensor):
        return [x] * n
    dims = [d for d, e in enumerate(spec) if axis in _axes(e)]
    for d, e in enumerate(spec):
        if e is not None and axis not in _axes(e):
            raise ValueError(f"in-spec {spec} names axes other than the mapped {axis!r}")
    if not dims:
        return [x] * n
    (d,) = dims
    if x.shape[d] % n:
        raise ValueError(f"dim {d} of a {tuple(x.shape)} argument does not split over the "
                         f"{n}-way axis {axis!r}")
    return list(x.chunk(n, dim=d))


def _join(outs: list[Any], spec: Any, axis: str, device: torch.device) -> Any:
    if spec is None:
        return outs
    dims = [d for d, e in enumerate(spec) if axis in _axes(e)]
    if not dims:
        return outs[0]
    return torch.cat([o.to(device) for o in outs], dim=dims[0])


def _mapped_axis(in_specs: Sequence[Any], out_specs: Any) -> str:
    names = {a for s in list(in_specs) + [out_specs] if isinstance(s, PartitionSpec)
             for e in s for a in _axes(e)}
    if len(names) != 1:
        raise ValueError(f"shard_map maps one mesh axis; the specs name {sorted(names)} "
                         "(pass axis_name=)")
    return names.pop()


def shard_map(f: Callable[..., Any], *, mesh: Mesh, in_specs: Sequence[Any], out_specs: Any,
              axis_name: str | None = None,
              at: dict[str, int] | None = None) -> Callable[..., Any]:
    """``f(ax, *local_args)`` once a shard along one mesh axis (module
    docstring). ``out_specs`` is one spec or a tuple of specs, one per
    output."""
    axis = axis_name or _mapped_axis(in_specs, out_specs)
    every = mesh.along(axis, at)
    local = [i for i, p in enumerate(every) if mesh.is_local(p)]
    if local != list(range(local[0], local[0] + len(local))):
        raise ValueError(f"this process's shards along {axis!r} are not contiguous")
    offset = local[0]
    positions = [every[i] for i in local]
    n = len(positions)
    flat = [mesh.flat_index(p) for p in positions]
    devices = [mesh.devices[p] for p in positions]

    def run(*args: Any) -> Any:
        if len(args) != len(in_specs):
            raise TypeError(f"shard_map body takes {len(in_specs)} arguments, got {len(args)}")
        parts = [_split(a, s, axis, n) for a, s in zip(args, in_specs)]
        grad = torch.is_grad_enabled()
        group = _Group(len(every), n, offset)
        # the caller's streams (a thread's current stream is its own)
        caller = {d: torch.cuda.current_stream(d) for d in set(devices) if d.type == "cuda"}
        outs: list[Any] = [None] * n
        errors: list[BaseException] = []

        def body(i: int) -> None:
            stream = mesh.stream(flat[i])
            ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
            try:
                with torch.set_grad_enabled(grad), ctx:
                    if stream is not None:
                        # the arguments were made on the caller's stream
                        stream.wait_stream(caller[devices[i]])
                    args_i = [p[i].to(devices[i]) if isinstance(p[i], torch.Tensor) else p[i]
                              for p in parts]
                    outs[i] = f(Axis(axis, offset + i, group, devices[i]), *args_i)
            except BaseException as e:  # noqa: BLE001 - re-raised in the caller
                errors.append(e)
                group.abort()

        if n == 1:
            body(0)
        else:
            threads = [threading.Thread(target=body, args=(i,), daemon=True,
                                        name=f"shard_map-{axis}-{i}") for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if errors:
            raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                       errors[0])
        for i, dev in enumerate(devices):
            stream = mesh.stream(flat[i])
            if stream is not None:
                # the caller's stream reads what the shards' streams wrote
                caller[dev].wait_stream(stream)
        home = devices[0]
        if isinstance(out_specs, tuple) and not isinstance(out_specs, PartitionSpec):
            return tuple(_join([o[k] for o in outs], s, axis, home)
                         for k, s in enumerate(out_specs))
        return _join(outs, out_specs, axis, home)

    return run
