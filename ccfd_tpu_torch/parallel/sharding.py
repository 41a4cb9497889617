"""Placement specs: how model params and batches lay out over a mesh. The
port of ccfd_tpu/parallel/sharding.py, with the placement types the
reference takes from ``jax.sharding``.

- ``PartitionSpec`` (``P``): one entry per tensor dim — ``None`` (whole),
  an axis name, or a tuple of axis names (split over their product, the
  first major).
- ``NamedSharding(mesh, spec)``: a spec bound to a mesh.
- ``ShardedTensor``: a tensor laid out per a ``NamedSharding``. It keeps
  one block per distinct slice, on the device of the first logical shard
  (row-major) that holds it; ``local(pos)`` is the block a grid position
  holds, on that position's device (a replica is copied there once and
  kept). ``gather`` reassembles the whole tensor with ``torch.cat``, so
  gradients flow back into the blocks; ``numpy`` is the host copy.

Megatron layout for the MLP (x -> relu(x W1) -> relu(h W2) -> h W3):
W1 column-sharded ``P(None, "model")``, W2 and W3 row-sharded
``P("model", None)``, the first layer's bias on the sharded hidden dim,
the rest replicated; batches shard over ``"data"``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ccfd_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh


class PartitionSpec(tuple):
    """Per-dim axis names of a layout; ``P()`` replicates."""

    def __new__(cls, *entries: Any) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else f"P({self[0]!r})"


P = PartitionSpec


def _axes(entry: Any) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


@dataclass(frozen=True, eq=False)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec

    def splits(self, ndim: int) -> list[int]:
        """Into how many slices each of ``ndim`` dims is cut."""
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than a {ndim}-D tensor")
        out = []
        for d in range(ndim):
            names = _axes(self.spec[d]) if d < len(self.spec) else ()
            for a in names:
                if a not in self.mesh.shape:
                    raise ValueError(f"spec {self.spec} names axis {a!r}; mesh axes are "
                                     f"{self.mesh.axis_names}")
            out.append(int(np.prod([self.mesh.shape[a] for a in names], dtype=np.int64)))
        return out

    def block_of(self, pos: tuple[int, ...], ndim: int) -> tuple[int, ...]:
        """The block (one slice index a dim) that grid position ``pos`` holds."""
        coord = dict(zip(self.mesh.axis_names, pos))
        out = []
        for d in range(ndim):
            names = _axes(self.spec[d]) if d < len(self.spec) else ()
            i = 0
            for a in names:  # mixed radix, the first axis major
                i = i * self.mesh.shape[a] + coord[a]
            out.append(i)
        return tuple(out)


def _slice(t: torch.Tensor, block: tuple[int, ...], splits: list[int]) -> torch.Tensor:
    for d, (i, n) in enumerate(zip(block, splits)):
        if n > 1:
            step = t.shape[d] // n
            t = t.narrow(d, i * step, step)
    return t


class ShardedTensor:
    """A tensor laid out over a mesh (module docstring)."""

    def __init__(self, sharding: NamedSharding, shape: tuple, blocks: dict):
        self.sharding = sharding
        self.shape = tuple(int(s) for s in shape)
        self.blocks = blocks  # block index -> home tensor
        self._replicas: dict[tuple, torch.Tensor] = {}
        self._lock = threading.Lock()

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.blocks.values())).dtype

    @property
    def device(self) -> torch.device:
        """The home device of the first block."""
        return next(iter(self.blocks.values())).device

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def local(self, pos: tuple[int, ...], grad: bool = False) -> torch.Tensor:
        """The block grid position ``pos`` holds, on its device. A replica
        on another device is copied once and kept; with ``grad`` the copy
        is made afresh through autograd, so its gradient reaches the
        home block."""
        b = self.sharding.block_of(pos, self.ndim)
        home = self.blocks[b]
        dev = self.mesh.devices[pos]
        if home.device == dev:
            return home
        if grad:
            return home.to(dev)
        with self._lock:
            key = (b, str(dev))
            rep = self._replicas.get(key)
            if rep is None:
                rep = self._replicas[key] = home.detach().to(dev)
            return rep

    @property
    def shards(self) -> list[torch.Tensor]:
        """The tensor each logical shard holds, in flat order."""
        return [self.local(pos) for pos in self.mesh.positions()]

    def gather(self, device: "torch.device | None" = None) -> torch.Tensor:
        """The whole tensor on ``device`` (the first block's by default),
        assembled through autograd."""
        device = device or self.device
        splits = self.sharding.splits(self.ndim)

        def build(d: int, prefix: tuple) -> torch.Tensor:
            if d == self.ndim:
                return self.blocks[prefix].to(device)
            parts = [build(d + 1, prefix + (i,)) for i in range(splits[d])]
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)

        return build(0, ())

    def numpy(self) -> np.ndarray:
        return self.gather(torch.device("cpu")).detach().numpy()

    def __array__(self, dtype: Any = None, copy: Any = None) -> np.ndarray:
        """``np.asarray``/``np.array`` gather the whole tensor, so code that
        copies a param tree to the host takes a sharded one as it is."""
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self) -> str:
        return f"ShardedTensor(shape={self.shape}, spec={self.spec}, blocks={len(self.blocks)})"


def device_put(x: Any, sharding: NamedSharding, requires_grad: bool = False) -> ShardedTensor:
    """Lay ``x`` (a tensor, numpy array or ``ShardedTensor``) out per
    ``sharding``: each distinct block is copied to the device of the first
    shard that holds it. Raises ``ValueError`` when a split dim does not
    divide evenly."""
    if isinstance(x, ShardedTensor):
        x = x.gather(torch.device("cpu")).detach()
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    splits = sharding.splits(t.ndim)
    for d, n in enumerate(splits):
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of a {tuple(t.shape)} tensor does not divide into "
                             f"{n} shards (spec {sharding.spec})")
    blocks: dict[tuple, torch.Tensor] = {}
    for pos in sharding.mesh.positions():
        b = sharding.block_of(pos, t.ndim)
        if b not in blocks:
            blk = _slice(t, b, splits).detach().to(sharding.mesh.devices[pos], copy=True)
            blocks[b] = blk.contiguous().requires_grad_(
                requires_grad and blk.is_floating_point())
    return ShardedTensor(sharding, tuple(t.shape), blocks)


def batch_spec(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(DATA_AXIS, None))


def label_spec(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def mlp_param_spec(params: Any, mesh: Mesh) -> Any:
    """Tree of ``NamedSharding`` matching the MLP's param structure (the
    megatron layout over the ``"model"`` axis)."""

    def spec_for_layer(i: int, n_layers: int, leaf_name: str) -> PartitionSpec:
        if leaf_name == "w":
            if i == 0:
                return P(None, MODEL_AXIS)  # column-parallel in
            return P(MODEL_AXIS, None)  # contract the sharded hidden / row-parallel out
        # hidden-dim biases follow their activations; the last replicates
        if i == n_layers - 1:
            return P()
        return P(MODEL_AXIS) if i == 0 else P()

    n_layers = len(params["layers"])
    rep = NamedSharding(mesh, P())
    return {
        "norm": {"mu": rep, "sigma": rep},
        "layers": [{"w": NamedSharding(mesh, spec_for_layer(i, n_layers, "w")),
                    "b": NamedSharding(mesh, spec_for_layer(i, n_layers, "b"))}
                   for i in range(n_layers)],
    }


def tree_map2(fn: Any, a: Any, b: Any) -> Any:
    """``fn`` over the leaves of two trees of one structure (dicts and
    lists; ``b``'s leaves are whatever ``a``'s leaves pair with)."""
    if isinstance(a, dict):
        return {k: tree_map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(tree_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def shard_params(params: Any, spec: Any) -> Any:
    """``device_put`` every leaf of ``params`` with its ``NamedSharding``
    from the same-shaped tree ``spec``."""
    return tree_map2(lambda leaf, sh: device_put(leaf, sh), params, spec)
