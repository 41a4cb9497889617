"""The partitioning layer: named mesh, regex rules, partitioners. The port
of ccfd_tpu/parallel/partition.py.

One owner for the questions the live platform has to answer about a mesh:
which axis a param shards over, how host trees get on and off the mesh,
and how a hot swap publishes sharded params under in-flight sharded
dispatches.

- :func:`match_partition_rules` — regex rules over ``/``-joined param tree
  paths -> a tree of ``PartitionSpec``. Scalars and one-element leaves
  never partition; a param no rule covers raises; the first match wins.
- :class:`SpecLayout` — the ``data``/``fsdp``/``tp`` spec vocabulary and
  the stock rule tables (:func:`mlp_rules`, :func:`seq_rules`).
- :class:`DataParallelPartitioner` / :class:`SPMDPartitioner` — shard and
  gather functions over a named mesh, the sharded train step's layout
  (:meth:`Partitioner.partition_train_step`) and the **publish path**: a
  param swap takes the ParallelRouter's group pause barrier so no worker's
  in-flight sharded dispatch interleaves with the re-layout
  (:class:`PublishGate`, armed by ``set_barrier`` and entered by the
  scorers' ``swap_params``).
- :func:`params_fingerprint` — sha256 over the FULLY GATHERED leaf bytes
  (``params.py::params_fingerprint`` of :func:`gather_params`), so a
  lineage hash is the same whether the params lived whole on one device or
  sharded over eight, and equal to the reference's on the same tree.

The port's placements are its own (parallel/sharding.py:
``NamedSharding``, ``ShardedTensor``), not JAX's. Where the reference's
SPMD layouts let XLA pick the collectives, a sharded param is gathered
where it is used (the all-gather schedule); the layout says where it
lives.
"""

from __future__ import annotations

import re
import threading
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ccfd_tpu_torch.params import params_fingerprint as _fingerprint_host
from ccfd_tpu_torch.parallel.mesh import DATA_AXIS, FSDP_AXIS, MODEL_AXIS, TP_AXIS, Mesh
from ccfd_tpu_torch.parallel.sharding import (
    NamedSharding,
    P,
    PartitionSpec,
    ShardedTensor,
    device_put,
    tree_map2,
)


# -- tree path naming --------------------------------------------------------

def _walk(fn: Callable[[str, Any], Any], node: Any, path: str) -> Any:
    if isinstance(node, dict):
        return {k: _walk(fn, v, f"{path}/{k}" if path else str(k)) for k, v in node.items()}
    if isinstance(node, (list, tuple)) and not isinstance(node, PartitionSpec):
        return type(node)(_walk(fn, v, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(node))
    return fn(path, node)


def named_tree_map(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """Map ``fn(path, leaf)`` over a tree of dicts and lists, the path
    ``/``-joined (dict keys, list indices)."""
    return _walk(fn, tree, "")


def tree_paths(tree: Any) -> list[str]:
    """Every leaf path in ``tree``, ``/``-joined (rule-table authoring aid)."""
    out: list[str] = []
    named_tree_map(lambda path, _leaf: out.append(path), tree)
    return out


def tree_leaves(tree: Any) -> list[Any]:
    out: list[Any] = []
    named_tree_map(lambda _path, leaf: out.append(leaf), tree)
    return out


# -- regex partition rules ---------------------------------------------------

def match_partition_rules(rules: Sequence[tuple[str, PartitionSpec]], params: Any) -> Any:
    """Tree of ``PartitionSpec`` from ``(regex, spec)`` rules.

    Scalars and single-element leaves always replicate (``P()``) without
    consulting the rules. The first matching rule wins (``re.search`` over
    the ``/``-joined path). A leaf NO rule covers raises: silence would
    hand a caller who needed the sharded layout a replicated tree and an
    out-of-memory later. Works over optimizer-state trees too: their
    param-structured subtrees' leaf paths end with the same param names."""

    def spec_for(name: str, leaf: Any) -> PartitionSpec:
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return P()
        for rule, spec in rules:
            if re.search(rule, name) is not None:
                return spec
        raise ValueError(f"partition rule not found for param: {name!r}")

    return named_tree_map(spec_for, params)


class SpecLayout:
    """Canonical PartitionSpecs aligned with the named mesh axes. Axis
    names are parameters so the same layout drives the legacy 2-D
    ``(data, model)`` mesh (``tp_axis="model"``)."""

    def __init__(self, data_axis: str = DATA_AXIS, fsdp_axis: str = FSDP_AXIS,
                 tp_axis: str = TP_AXIS):
        self.data_axis = data_axis
        self.fsdp_axis = fsdp_axis
        self.tp_axis = tp_axis

    def batch(self) -> PartitionSpec:
        """Row batches shard over data; the feature dim stays whole."""
        return P(self.data_axis, None)

    def rows(self) -> PartitionSpec:
        """Per-row outputs (probabilities, labels) shard over data."""
        return P(self.data_axis)

    def replicated(self) -> PartitionSpec:
        return P()

    def col_parallel(self) -> PartitionSpec:
        """(in, out) weight, column-sharded."""
        return P(self.fsdp_axis, self.tp_axis)

    def row_parallel(self) -> PartitionSpec:
        """(in, out) weight, row-sharded."""
        return P(self.tp_axis, None)

    def hidden_bias(self) -> PartitionSpec:
        """A bias on a tp-sharded hidden dim follows its activations."""
        return P(self.tp_axis)


def mlp_rules(layout: SpecLayout | None = None) -> list[tuple[str, PartitionSpec]]:
    """Megatron layout for the MLP (``norm/{mu,sigma}`` +
    ``layers/<i>/{w,b}``): the layout ``sharding.mlp_param_spec`` writes by
    hand, as rules."""
    lo = layout or SpecLayout()
    return [
        (r"norm/", lo.replicated()),
        (r"layers/0/w", P(None, lo.tp_axis)),
        (r"layers/0/b", lo.hidden_bias()),
        # ordered: the generic rules below only see the later layers
        (r"layers/\d+/w$", lo.row_parallel()),
        (r"layers/\d+/b$", lo.replicated()),
    ]


def seq_rules(layout: SpecLayout | None = None) -> list[tuple[str, PartitionSpec]]:
    """Transformer layout for the history model (models/seq.py tree:
    embed / blocks/<i>/{ln1,qkv,proj,ln2,mlp_in,mlp_out} / head):
    attention and MLP matmuls shard fsdp x tp, norms and biases replicate."""
    lo = layout or SpecLayout()
    return [
        (r"embed/w", P(None, lo.tp_axis)),
        (r"embed/b", lo.hidden_bias()),
        (r"blocks/\d+/(qkv|mlp_in)/w", lo.col_parallel()),
        (r"blocks/\d+/(proj|mlp_out)/w", lo.row_parallel()),
        (r"blocks/\d+/.*/(b|scale|bias)", lo.replicated()),
        (r"head/", lo.replicated()),
        (r"norm/", lo.replicated()),
    ]


# -- shard / gather ----------------------------------------------------------

def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, ShardedTensor):
        return leaf.numpy()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def make_shard_and_gather_fns(mesh: Mesh, partition_specs: Any) -> tuple[Any, Any]:
    """Trees of per-leaf shard (host -> mesh, a ``ShardedTensor``) and
    gather (mesh -> host numpy) callables from a tree of PartitionSpecs.
    Gather materializes the whole array, so the host tree is byte-identical
    whatever the shard count (what :func:`params_fingerprint` relies on)."""

    def make_shard(_path: str, spec: PartitionSpec):
        sh = NamedSharding(mesh, spec)
        return lambda leaf: device_put(leaf, sh)

    shard_fns = _walk_specs(make_shard, partition_specs)
    gather_fns = _walk_specs(lambda _p, _s: _host, partition_specs)
    return shard_fns, gather_fns


def _walk_specs(fn: Callable[[str, PartitionSpec], Any], specs: Any, path: str = "") -> Any:
    """``named_tree_map`` over a tree whose leaves are PartitionSpecs
    (tuples themselves)."""
    if isinstance(specs, PartitionSpec):
        return fn(path, specs)
    if isinstance(specs, dict):
        return {k: _walk_specs(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in specs.items()}
    return type(specs)(_walk_specs(fn, v, f"{path}/{i}" if path else str(i))
                       for i, v in enumerate(specs))


def gather_params(params: Any) -> Any:
    """Fully gathered host copy of a (possibly sharded) param tree; dtypes
    are kept (the byte-identity surface checkpoints and fingerprints
    read)."""
    return named_tree_map(lambda _p, leaf: _host(leaf) if leaf is not None else None, params)


def params_fingerprint(params: Any) -> str:
    """sha256 hex over the fully gathered param bytes (leaves in sorted
    path order, each framed with its path, dtype and shape): invariant to
    the shard count and layout, not to a renamed, reshaped or retyped
    leaf. The reference's ``params_fingerprint`` gives the same digest on
    the same tree."""
    return _fingerprint_host(gather_params(params))


# -- publish barrier ---------------------------------------------------------

class PublishGate:
    """Context manager a sharded scorer's ``swap_params`` enters: pauses
    the router pool (its group-wide batch-boundary barrier) for the
    publish, so no worker's in-flight sharded dispatch interleaves with
    the param re-layout.

    ``barrier`` is anything with ``pause(timeout_s) -> bool`` / ``resume()``
    (Router and ParallelRouter both). A pause that times out does NOT
    block the publish (double buffering keeps an interleaved swap safe;
    the barrier is what makes it quiescent), and the hold is ALWAYS
    released on exit once a pause was requested, ack or no ack: ``pause``
    takes its holders before awaiting acks, and an un-resumed hold would
    park every worker at its next batch boundary forever. Re-entrant per
    thread, so a respawn that swaps inside an outer publish does not
    deadlock itself."""

    def __init__(self, barrier: Any, timeout_s: float = 10.0,
                 c_publishes: Any = None, c_timeouts: Any = None):
        self.barrier = barrier
        self.timeout_s = float(timeout_s)
        self._local = threading.local()
        self.publishes = 0
        self.pause_timeouts = 0
        self._c_publishes = c_publishes
        self._c_timeouts = c_timeouts

    def __enter__(self) -> "PublishGate":
        depth = getattr(self._local, "depth", 0)
        self._local.depth = depth + 1
        self._local.requested = getattr(self._local, "requested", False)
        if depth == 0:
            self.publishes += 1
            if self._c_publishes is not None:
                self._c_publishes.inc()
            acked = False
            self._local.requested = True
            try:
                acked = bool(self.barrier.pause(self.timeout_s))
            # ccfd-lint: disable=counted-drops -- a dead pool must not block the publish; the timeout below counts it
            except Exception:  # noqa: BLE001
                pass
            if not acked:
                self.pause_timeouts += 1
                if self._c_timeouts is not None:
                    self._c_timeouts.inc()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._local.depth = depth = self._local.depth - 1
        if depth == 0 and self._local.requested:
            # release the hold even when the ack never arrived
            self._local.requested = False
            try:
                self.barrier.resume()
            # ccfd-lint: disable=counted-drops -- resume on a dead pool has nothing to release
            except Exception:  # noqa: BLE001
                pass


# -- partitioners ------------------------------------------------------------

class Partitioner:
    """Shared surface: mesh + layout + shard/gather + the publish path.
    Subclasses decide the PARAM layout; batches shard over the data axis
    and per-row outputs come back per data shard."""

    def __init__(self, mesh: Mesh, data_axis: str = DATA_AXIS,
                 layout: SpecLayout | None = None):
        if data_axis not in mesh.axis_names:
            raise ValueError(f"mesh {mesh.axis_names} has no axis {data_axis!r}")
        self.mesh = mesh
        self.data_axis = data_axis
        self.layout = layout or SpecLayout(data_axis=data_axis)
        self.batch_sharding = NamedSharding(mesh, self.layout.batch())
        self.out_sharding = NamedSharding(mesh, self.layout.rows())
        self.replicated = NamedSharding(mesh, P())
        # the swap-vs-dispatch barrier: armed by the operator once the
        # router pool exists (set_barrier); None publishes without quiescing
        self.gate: PublishGate | None = None

    # - layout ---------------------------------------------------------------
    @property
    def data_size(self) -> int:
        return int(self.mesh.shape[self.data_axis])

    @property
    def n_devices(self) -> int:
        return int(self.mesh.size)

    def data_positions(self) -> list[tuple[int, ...]]:
        """One grid position a data shard this process drives: along the
        data axis, the other axes at 0 (a batch is replicated over them).
        On a mesh over several processes, only this process's shards: it
        feeds them its own rows (parallel/multihost.py)."""
        return [p for p in self.mesh.along(self.data_axis) if self.mesh.is_local(p)]

    def round_batch(self, b: int) -> int:
        """Smallest multiple of the data-axis size covering ``b``."""
        d = self.data_size
        return -(-int(b) // d) * d

    def param_specs(self, params: Any) -> Any:
        raise NotImplementedError

    def param_sharding(self, params: Any) -> Any:
        return _walk_specs(lambda _p, spec: NamedSharding(self.mesh, spec),
                           self.param_specs(params))

    # - shard / gather -------------------------------------------------------
    def shard_params(self, params: Any, requires_grad: bool = False) -> Any:
        """``params`` laid out on the mesh: a tree of ``ShardedTensor``."""
        return tree_map2(lambda leaf, sh: device_put(leaf, sh, requires_grad=requires_grad),
                         params, self.param_sharding(params))

    def gather(self, params: Any) -> Any:
        return gather_params(params)

    def shard_batch(self, batch: Any) -> ShardedTensor:
        return device_put(batch, self.batch_sharding)

    # - the sharded train step -----------------------------------------------
    def train_state_specs(self, state: Any) -> Any:
        """Specs of a train state (``parallel/train.py::init_state``):
        params per the subclass layout, the momentum traces laid out like
        their params, the step counter replicated."""
        pspec = self.param_specs(state["params"])
        return {"params": pspec, "opt_state": {"momentum": pspec}, "step": P()}

    def partition_train_step(self, step: Callable[..., Any], state: Any) -> Callable[..., Any]:
        """Lay ``state`` out per :meth:`train_state_specs` (its params become
        ``ShardedTensor``s whose blocks the optimizer updates; the
        optimizer is rebuilt over the blocks) and return ``step``, the
        per-shard step of ``parallel/train.py`` that runs on that layout."""
        from ccfd_tpu_torch.parallel.train import layout_state

        layout_state(state, self)
        return step

    # - publish path ---------------------------------------------------------
    def set_barrier(self, barrier: Any, timeout_s: float = 10.0, registry: Any = None) -> None:
        """Arm the swap-vs-dispatch barrier (the router pool's group pause).
        Re-arming follows the newest pool. With a ``registry`` the gate's
        tallies also export as counters (the Device board's Mesh row)."""
        if barrier is None:
            self.gate = None
            return
        c_pub = c_to = None
        if registry is not None:
            c_pub = registry.counter(
                "ccfd_mesh_publishes_total",
                "sharded param publishes through the pause-barrier gate")
            c_to = registry.counter(
                "ccfd_mesh_publish_pause_timeouts_total",
                "publishes whose router-pool pause timed out (published "
                "anyway under double buffering; the pool was not "
                "quiescent)")
        self.gate = PublishGate(barrier, timeout_s, c_publishes=c_pub, c_timeouts=c_to)


class DataParallelPartitioner(Partitioner):
    """Pure data parallelism: params replicate, batches shard over
    ``data``. The serving default (the reference's "more replicas"
    scaling, one program instead of N processes)."""

    def param_specs(self, params: Any) -> Any:
        return named_tree_map(lambda _p, _leaf: P(), params)


class SPMDPartitioner(Partitioner):
    """Rule-driven layout: params shard per a regex rule table
    (:func:`match_partition_rules`), batches over ``data``."""

    def __init__(self, mesh: Mesh, rules: Sequence[tuple[str, PartitionSpec]],
                 data_axis: str = DATA_AXIS, layout: SpecLayout | None = None):
        super().__init__(mesh, data_axis=data_axis, layout=layout)
        self.rules = list(rules)

    def param_specs(self, params: Any) -> Any:
        return match_partition_rules(self.rules, params)


def legacy_partitioner(mesh: Mesh) -> SPMDPartitioner:
    """A bare ``mesh=``'s param layout (``param_partition="model"``, the
    train step's mesh): ``sharding.mlp_param_spec``'s megatron layout over
    the mesh's ``model`` (or ``tp``) axis, as rules."""
    tp = MODEL_AXIS if MODEL_AXIS in mesh.axis_names else TP_AXIS
    return SPMDPartitioner(mesh, mlp_rules(SpecLayout(tp_axis=tp)))


def partitioner_from_config(mesh: Mesh, param_partition: str = "replicated",
                            model: str = "mlp") -> Partitioner:
    """CR/env -> partitioner: ``replicated`` (data parallel) or ``rules``
    (the family's stock rule table over fsdp/tp)."""
    if param_partition in ("replicated", "data"):
        return DataParallelPartitioner(mesh)
    if param_partition in ("rules", "spmd"):
        layout = SpecLayout()
        table = seq_rules(layout) if model.startswith("seq") else mlp_rules(layout)
        return SPMDPartitioner(mesh, table, layout=layout)
    raise ValueError(f"unknown param_partition {param_partition!r} (expected replicated|rules)")
