"""Row scorer on the card: bucketed dispatch of any registered model
(kernels B1, B2 and B3 for the MLP family) and hot-swappable params. The
port of ccfd_tpu/serving/scorer.py's ``Scorer``.

- **Fixed batch shapes.** Every request batch pads up to a configured
  bucket (CCFD_BATCH_SIZES), as in the reference, so each launch has one of
  a handful of shapes (the per-bucket dispatch counts read off that grid).
- **The kernel paths.** The model picks the kernel module; on the card a
  wrapper launches its CUDA kernel, on the CPU (``device="cpu"``, the
  tests) it runs the kernel's plain PyTorch version.
  - ``mlp`` in bf16: ``ops.fused_mlp`` (B1). Rows are cast to the bf16
    wire on the host with torch (round to nearest even, the same bits as
    the reference's ml_dtypes cast).
  - ``mlp_q8``: ``ops.fused_mlp_q8``, always. On the default int8 wire
    (``q8_wire="int8"``, CCFD_Q8_WIRE) each chunk is zero-padded to its
    bucket, normalized and quantized on the host
    (``prequantize_rows_numpy``, the model's own first requantization) and
    ships as int8 rows plus one f32 scale per row, 34 B/row, through B3.
    With ``q8_wire="f32"`` f32 rows go through B2.
  - any other model (``mlp`` in another dtype, ``logreg``/``modelfull``,
    ``gbt``, ``gbt_mxu``, an inference graph): its torch ``apply`` on f32
    rows, as the reference runs it under XLA. Its params may be any tree
    (``params.py``), a graph's ``{node: params}`` included; ``fused`` and
    ``int8_wire`` are off.
  Staged rows go into pinned buffers taken per call, are copied to the
  card with ``non_blocking=True``, scored, and copied back into a pinned
  buffer. Per-call buffers come from PyTorch's caching host allocator,
  which keeps a block out of reuse until the copies that read it have
  finished, so the batcher's concurrent workers never share one. With a
  ``telemetry`` plane (observability/device.py) every staging copy is
  bracketed by CUDA events and its bytes and time recorded once the
  dispatch has synchronized (two copies on the int8 wire, q and scale, as
  the reference's two puts); ``telemetry=None`` takes the process default
  (``observability/device.set_default``), as in the reference.
- **Every request dispatches to the device.** The reference's host latency
  tier (small requests scored in numpy on accelerator backends), its host
  fallback while the device is wedged, and its drop to the XLA graph on a
  kernel error or on params the kernel does not take are not carried over:
  each of them would let a request skip the kernel. A kernel that fails to
  build or launch fails ``warmup`` and the request; params a kernel does
  not take fail the constructor or ``swap_params``.
- **The dispatch deadline** (``dispatch_deadline_ms`` > 0; off unless the
  environment sets it, config.py): ``score`` runs its device round trip on
  a ``DeviceDispatcher`` thread and waits at most the deadline (times the
  request's chunks). A timeout (``dispatch_timeouts``) marks the device
  wedged (``WedgeMonitor``, which probes for recovery) and raises
  ``ScorerTimeout``, as does every ``score`` while the device is wedged, so
  no new work queues behind the hang. The REST server answers it with 503
  and the router's degradation ladder counts the batch on its own tiers.
  ``warmup`` and ``score_pipelined`` are not bounded.
- **Double-buffered params.** ``swap_params`` stages fresh device tensors
  (and refolds the kernel weights) before flipping the references under
  the lock; an in-flight call keeps the tensors it snapshotted. Params
  that do not fold raise before the flip, and the old ones keep serving.
  Prepublish hooks (``add_prepublish_hook``: the decision plane,
  serving/fused.py) run every bucket against the staged params between
  the staging and the flip; a hook that raises fails the swap before the
  flip, as params that do not fold do.
- **The challenger slot** (the model lifecycle, lifecycle/):
  ``install_challenger`` stages a candidate's host numpy copy beside the
  champion, double-buffered like ``swap_params``, and ``challenger_score``
  scores rows on the model's numpy host forward (``spec.apply_numpy``, the
  one ``host_score`` uses). This is the reference's own design for a
  second model off the device's critical path, not a fallback: the shadow
  tap and the canary gate score the candidate there, while the champion's
  path never leaves the kernel, and a promoted candidate serves only
  through ``swap_params``.
- **Mesh-sharded dispatch** (``partitioner=``, parallel/partition.py, or a
  bare ``mesh=`` with ``param_partition`` ``replicated`` or ``model``):
  one scorer whose batch shards over the mesh's ``data`` axis, as the
  reference's. Buckets round up to multiples of the data-axis size, and
  each staged chunk is copied shard by shard: shard j's rows go to shard
  j's device on shard j's CUDA stream (``Mesh.stream``), each copy timed
  and counted as its own put. On a kernel path B1 (``mlp``) or B2
  (``mlp_q8``) then launches once a shard on that stream, with the folded
  weights replicated (one packed copy a distinct device), and the shard's
  probabilities are copied back on the same stream, after which an event
  is recorded on it; ``_collect`` waits on every shard's event. The params
  themselves lie on the mesh as the layout says (``params`` is a tree of
  ``ShardedTensor``); a plain torch graph (``mlp`` in f32, the other
  models) runs on each shard with the params gathered onto its device
  (the all-gather schedule, where the reference lets XLA pick one). A mesh
  keeps the f32 wire, as the reference does: B3's int8 wire stays
  single-device, so ``mlp_q8`` on a mesh serves through B2.
  ``swap_params`` enters the partitioner's ``PublishGate`` (``set_swap_gate``)
  for the flip. The executable grid's ``dispatches`` count the bucketed
  dispatches; ``shard_launches`` count the launches, a shard each.
- **Spans and counters.** A caller that hands ``score`` a ``record_span``
  (``Tracer.record`` with its parent bound: the native front's traced
  takes) gets each dispatch's steps as spans: ``scorer.prep`` (pad, host
  cast or int8 quantization, pinned staging), ``scorer.launch`` (H2D,
  kernel, D2H and event enqueued), ``scorer.wait`` (the event's
  synchronize) and ``scorer.readback`` (the copies settled, the answers to
  numpy), each with ``cpu_us``, the dispatching thread's CPU time inside
  it (``time.thread_time_ns``; where that clock steps by a scheduler tick
  only a sum over many dispatches means anything), beside its wall time;
  other callers of the same Scorer (the router, the canary) record none.
  Beside the per-bucket dispatch tally, ``row_totals`` counts the rows
  handed in and the bucket rows launched for them.
- **Fault seams** (runtime/faults.py, as the reference's):
  ``device_seam("dispatch")`` before each launch of ``score_pipelined``
  (``device_hang``, ``compile_stall``) and ``device_seam("put")`` inside
  each staging copy (``observability/device.py::timed_copy``,
  ``put_fail``). ``warmup`` launches every bucket without the dispatch
  seam, as the reference's warmup does; the heal supervisor's canary goes
  through ``score_pipelined``.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from collections import deque
from functools import partial
from typing import Any, Sequence

import numpy as np
import torch

from ccfd_tpu_torch.data.ccfd import NUM_FEATURES
from ccfd_tpu_torch.device import resolve
from ccfd_tpu_torch.models.registry import ModelSpec, get_model
from ccfd_tpu_torch.observability.device import settle_copies, timed_copy
from ccfd_tpu_torch.observability.profile import compile_stage
from ccfd_tpu_torch.ops import fused_mlp, fused_mlp_q8
from ccfd_tpu_torch.params import tensor_leaf, to_numpy, tree_map
from ccfd_tpu_torch.runtime.faults import device_seam
from ccfd_tpu_torch.serving.dispatch import DeviceDispatcher, ScorerTimeout, WedgeMonitor

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}
_Q8_WIRES = ("int8", "f32")


# the ``record_span`` of the dispatch running on this thread (``score``):
# ``_launch`` and ``_collect`` read it here, and keep the signatures of a
# plain dispatch
_STEP_SPANS: contextvars.ContextVar = contextvars.ContextVar("scorer_step_spans",
                                                             default=None)


class _Placed:
    """A mesh scorer's staged params: the laid-out tree and, by shard
    device, what a shard's launch reads (packed kernel weights, or the
    params gathered there)."""

    def __init__(self, tree: Any, local: dict):
        self.tree = tree
        self.local = local


class Scorer:
    def __init__(
        self,
        model_name: str = "mlp",
        params: Any = None,
        batch_sizes: Sequence[int] = (16, 128, 1024, 4096, 16384),
        compute_dtype: str = "bfloat16",
        num_features: int = NUM_FEATURES,
        seed: int = 0,
        device: "str | torch.device | None" = None,
        q8_wire: str = "int8",
        dispatch_deadline_ms: float = 0.0,
        telemetry: Any = None,
        mesh: Any = None,
        param_partition: str = "replicated",
        partitioner: Any = None,
    ):
        # the partitioning layer (parallel/partition.py): a partitioner owns
        # every layout decision; a bare mesh takes the reference's
        # hand-rolled layouts (replicated, or the megatron "model" layout)
        self.partitioner = partitioner
        if partitioner is not None:
            mesh = partitioner.mesh
        self.mesh = mesh
        if param_partition not in ("replicated", "model"):
            raise ValueError(f"unknown param_partition {param_partition!r}")
        if param_partition == "model" and model_name != "mlp":
            raise ValueError(f"param_partition='model' has a layout only for 'mlp', "
                             f"not {model_name!r}")
        self._layout = None
        if mesh is not None:
            from ccfd_tpu_torch.parallel.partition import (
                DataParallelPartitioner,
                legacy_partitioner,
            )

            self._layout = partitioner or (legacy_partitioner(mesh) if param_partition == "model"
                                           else DataParallelPartitioner(mesh))
            home = mesh.flat[0]
            if device is not None and torch.device(device).type != home.type:
                raise ValueError(f"device={device!r} but the mesh's shards lie on {home}")
            device = home
            batch_sizes = {self._layout.round_batch(b) for b in batch_sizes}
        self._swap_gate: Any = None
        self.device = resolve(device)
        if telemetry is None:
            # the process default (observability/device.set_default), as
            # the reference's Scorer resolves it
            from ccfd_tpu_torch.observability import device as _device

            telemetry = _device.get_default()
        self.telemetry = telemetry  # observability/device.DeviceTelemetry
        self.spec: ModelSpec = get_model(model_name)
        if self.spec.name in ("seq", "seq_q8"):
            # the reference's row Scorer fails on these at its first
            # dispatch; the port names the layer that serves them
            raise ValueError(
                f"model {model_name!r} scores (B, L, F) histories: it serves through "
                "serving/history.py::SeqScorer (the operator's scorer.model), not the "
                "row Scorer")
        self.num_features = num_features
        self.batch_sizes = tuple(sorted({int(b) for b in batch_sizes}))
        self.compute_dtype = _DTYPES.get(compute_dtype, torch.float32)
        if q8_wire not in _Q8_WIRES:
            raise ValueError(f"q8_wire must be one of {_Q8_WIRES}, not {q8_wire!r}")
        # the kernel module, on every device (on the CPU a wrapper runs
        # its plain version): B2/B3 for mlp_q8 always, B1 for the MLP in
        # bf16; None serves the model's plain torch graph
        self._q8 = self.spec.name == "mlp_q8"
        self._kmod = fused_mlp_q8 if self._q8 else (
            fused_mlp if self.spec.name == "mlp"
            and self.compute_dtype == torch.bfloat16 else None)
        # a mesh keeps the f32 wire (B2), as the reference does
        self.int8_wire = self._q8 and q8_wire == "int8" and mesh is None
        if params is None:
            params = self.spec.init(torch.Generator().manual_seed(seed))
        self._lock = threading.Lock()
        # per-bucket dispatch tally and warmed buckets for the executable
        # inventory; the rows handed in and the bucket rows launched for
        # them (their ratio is the share of a launch that is not padding)
        self._dispatch_counts: dict[int, int] = {}
        self._rows_in = self._rows_launched = 0
        self._warmed: set[int] = set()
        self._prepublish_hooks: list[Any] = []
        self._live = self._stage(params)
        # the host copy the router's host tier forwards through
        # (``host_score``); refreshed by every swap
        self._host_params = to_numpy(params)
        # the lifecycle's challenger slot: (version, host numpy params)
        self._challenger: tuple[int, Any] | None = None
        # -- the dispatch deadline (module docstring) --
        self.dispatch_deadline_s = max(0.0, float(dispatch_deadline_ms)) / 1e3
        self.dispatch_timeouts = 0
        self._dispatcher = self._wedge = None
        if self.dispatch_deadline_s > 0:
            self._dispatcher = DeviceDispatcher()
            probe_x = np.zeros((self.batch_sizes[0], num_features), np.float32)
            self._wedge = WedgeMonitor(
                self._dispatcher, lambda: self.score_pipelined(probe_x, depth=1),
                deadline_s=self.dispatch_deadline_s)

    # -- params ------------------------------------------------------------
    def _stage(self, params: Any) -> tuple[dict, dict | None, dict | None]:
        """Fresh device copies of ``params`` and, on a kernel path, the
        folded kernel weights and (int8 wire) the host normalizer the rows
        are quantized with; committed before return. ``params`` may hold
        tensors or numpy arrays, in any tree. Raises ``ValueError`` for
        params the kernel does not take."""
        if self.mesh is not None:
            return self._stage_mesh(params)
        staged = tree_map(lambda a: tensor_leaf(a, self.device, copy=True), params)
        kp = host_norm = None
        if self._kmod is not None:
            folded = self._kmod.fold_for_kernel(staged)
            kp = self._kmod.pack_for_kernel(folded, self.device)
            if self.int8_wire:
                # the SAME normalizer the kernel weights were folded with
                host_norm = {k: folded[k].numpy() for k in ("mu", "sigma")}
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return staged, kp, host_norm

    def _stage_mesh(self, params: Any) -> tuple:
        """The mesh's staging: the params laid out per the layout, and for
        each distinct shard device either the packed kernel weights
        (folded once, on the host) or the params gathered there."""
        host = tree_map(lambda a: tensor_leaf(a, "cpu"), params)
        tree = self._layout.shard_params(host)
        devices = {str(self.mesh.devices[p]): self.mesh.devices[p]
                   for p in self._layout.data_positions()}
        if self._kmod is not None:
            folded = self._kmod.fold_for_kernel(host)
            local = {k: self._kmod.pack_for_kernel(folded, d) for k, d in devices.items()}
        else:
            local = {k: tree_map(lambda a: tensor_leaf(a, d, copy=True), tree)
                     for k, d in devices.items()}
        for d in devices.values():
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        return _Placed(tree, local), (local if self._kmod is not None else None), None

    @property
    def params(self) -> dict:
        """The served params; on a mesh, a tree of ``ShardedTensor``."""
        live = self._live[0]
        return live.tree if isinstance(live, _Placed) else live

    def set_swap_gate(self, gate: Any) -> None:
        """Arm the partitioner's publish gate: every ``swap_params`` then
        pauses the router pool at a batch boundary for the flip
        (parallel/partition.py ``PublishGate``; None disarms)."""
        self._swap_gate = gate

    def swap_params(self, new_params: Any) -> None:
        """Publish new params without pausing serving: stage everything, run
        the prepublish hooks on the staged params, then flip the references
        under the lock. Params that do not fold, or a hook that raises,
        raise here, before the flip."""
        live = self._stage(new_params)
        host = to_numpy(new_params)
        with self._lock:
            hooks = list(self._prepublish_hooks)
        for hook in hooks:
            hook(live)
        gate = self._swap_gate
        with gate if gate is not None else contextlib.nullcontext():
            with self._lock:
                self._live = live
                self._host_params = host

    def add_prepublish_hook(self, fn: Any) -> None:
        """``fn(staged)`` runs inside every ``swap_params`` after staging and
        before the flip; ``staged`` is the (params, kernel params, host
        normalizer) tuple the flip will install."""
        with self._lock:
            self._prepublish_hooks.append(fn)

    # -- inventory -----------------------------------------------------------
    def bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if n <= b:
                return b
        return self.batch_sizes[-1]

    @property
    def fused(self) -> bool:
        return self._live[1] is not None

    @property
    def kernel_name(self) -> str | None:
        """The hand kernel this scorer launches (the launch counter's name:
        B1 ``fused_mlp_bf16``, B2 ``fused_mlp_q8``, B3
        ``fused_mlp_q8_preq``), None on a plain torch graph."""
        if self._q8:
            return "fused_mlp_q8_preq" if self.int8_wire else "fused_mlp_q8"
        return "fused_mlp_bf16" if self._kmod is not None else None

    def dispatch_total(self) -> int:
        with self._lock:
            return sum(self._dispatch_counts.values())

    def row_totals(self) -> tuple[int, int]:
        """(rows handed to the dispatches, bucket rows launched for them)."""
        with self._lock:
            return self._rows_in, self._rows_launched

    @property
    def shards(self) -> int:
        """Launches a dispatch: the data axis's size on a mesh, else 1."""
        return len(self._layout.data_positions()) if self._layout is not None else 1

    def executable_grid(self) -> dict:
        """The bucket grid this scorer serves from, with dispatches per
        bucket."""
        with self._lock:
            counts = dict(self._dispatch_counts)
            warmed = sorted(self._warmed)
        out = {
            "model": self.spec.name,
            "kernel": self.kernel_name,
            "batch_sizes": list(self.batch_sizes),
            "warmed": warmed,
            "fused": self.fused,
            "int8_wire": self.int8_wire,
            "device": str(self.device),
            "dispatch_deadline_ms": self.dispatch_deadline_s * 1e3,
            "dispatches": {str(b): int(n) for b, n in sorted(counts.items())},
        }
        if self.mesh is not None:
            out["mesh_devices"] = int(self.mesh.size)
            out["mesh_axes"] = dict(self.mesh.shape)
            out["shard_launches"] = {str(b): int(n) * self.shards
                                     for b, n in sorted(counts.items())}
        return out

    # -- dispatch ------------------------------------------------------------
    def _launch(self, live: tuple, chunk: np.ndarray, b: int) -> tuple:
        """Stage one chunk padded to bucket ``b``, score it, and queue the
        copy back; returns what ``_collect`` needs. Inside a recorded
        ``score``, the staging is the ``scorer.prep`` span and the rest
        ``scorer.launch``."""
        record_span = _STEP_SPANS.get()
        if record_span is None:
            return self._enqueue(live, self._prep(live, chunk, b), chunk.shape[0], b)
        rows = int(chunk.shape[0])
        t0, c0 = time.monotonic_ns(), time.thread_time_ns()
        staging = self._prep(live, chunk, b)
        t1, c1 = time.monotonic_ns(), time.thread_time_ns()
        pending = self._enqueue(live, staging, rows, b)
        t2, c2 = time.monotonic_ns(), time.thread_time_ns()
        record_span("scorer.prep", t0, t1,
                    attrs={"rows": rows, "bucket": b, "cpu_us": (c1 - c0) / 1e3})
        record_span("scorer.launch", t1, t2,
                    attrs={"kernel": self.kernel_name, "bucket": b, "rows": rows,
                           "cpu_us": (c2 - c1) / 1e3})
        return pending

    def _prep(self, live: tuple, chunk: np.ndarray, b: int) -> tuple:
        """The host's part of a dispatch: the chunk padded to bucket ``b``,
        cast to the wire (or, on the int8 wire, quantized), in pinned
        staging buffers on the card's path."""
        take = chunk.shape[0]
        pin = self.device.type == "cuda"
        if self.int8_wire:
            # the rows are padded BEFORE the host quantizes them, as the
            # reference does; padded rows quantize to zeros
            padded = np.zeros((b, self.num_features), np.float32)
            padded[:take] = chunk
            q, s = fused_mlp_q8.prequantize_rows_numpy(live[2], padded)
            return tuple(torch.from_numpy(a).pin_memory() if pin else torch.from_numpy(a)
                         for a in (q, s))
        wire = self._kmod.INPUT_DTYPE if self._kmod is not None else torch.float32
        xh = torch.empty((b, self.num_features), dtype=wire, pin_memory=pin)
        xh[:take].copy_(torch.from_numpy(chunk))  # host cast to the wire
        xh[take:].zero_()
        return (xh,)

    def _enqueue(self, live: tuple, staging: tuple, take: int, b: int) -> tuple:
        """Copy the staged rows to the card, launch, queue the copy back
        and record the event ``_collect`` waits on."""
        if self.mesh is not None:
            return self._enqueue_sharded(live, staging[0], take, b)
        params, kp, _ = live
        pin = self.device.type == "cuda"
        if self.int8_wire:
            (qd, tq), (sd, ts) = (timed_copy(self.telemetry, t, self.device)
                                  for t in staging)
            copies = (tq, ts)
            out = fused_mlp_q8.fused_mlp_q8_score_preq(kp, qd, sd)
        else:
            xd, tx = timed_copy(self.telemetry, staging[0], self.device)
            copies = (tx,)
            if self._q8:
                out = fused_mlp_q8.fused_mlp_q8_score(kp, xd)
            elif kp is not None:
                out = fused_mlp.fused_mlp_score(kp, xd)
            else:
                out = self.spec.apply(params, xd, self.compute_dtype)
        oh = torch.empty((b,), dtype=torch.float32, pin_memory=pin)
        oh.copy_(out, non_blocking=True)
        done = None
        if pin:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return staging, oh, take, done, copies

    def _enqueue_sharded(self, live: tuple, xh: torch.Tensor, take: int, b: int) -> tuple:
        """One bucketed dispatch over the data shards (module docstring):
        shard j copies its rows, launches and copies back on its own
        stream; one event a shard."""
        placed = live[0]
        positions = self._layout.data_positions()
        rows = b // len(positions)
        pin = self.device.type == "cuda"
        oh = torch.empty((b,), dtype=torch.float32, pin_memory=pin)
        events, copies = [], []
        for j, pos in enumerate(positions):
            dev = self.mesh.devices[pos]
            local = placed.local[str(dev)]
            stream = self.mesh.stream(self.mesh.flat_index(pos))
            with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                xd, tok = timed_copy(self.telemetry, xh[j * rows:(j + 1) * rows], dev)
                copies.append(tok)
                if self._q8:
                    out = fused_mlp_q8.fused_mlp_q8_score(local, xd)
                elif self._kmod is not None:
                    out = fused_mlp.fused_mlp_score(local, xd)
                else:
                    out = self.spec.apply(local, xd, self.compute_dtype)
                oh[j * rows:(j + 1) * rows].copy_(out, non_blocking=True)
                if stream is not None:
                    ev = torch.cuda.Event()
                    ev.record(stream)
                    events.append(ev)
        # the live snapshot rides along: nothing it holds is freed while a
        # shard's stream may still read it
        return (xh, live), oh, take, events, copies

    def _collect(self, pending: tuple) -> np.ndarray:
        """Wait for a launch's copy back and hand its rows' answers over;
        inside a recorded ``score``, the ``scorer.wait`` and
        ``scorer.readback`` spans."""
        record_span = _STEP_SPANS.get()
        if record_span is None:
            self._wait(pending)
            return self._readback(pending)
        t0, c0 = time.monotonic_ns(), time.thread_time_ns()
        self._wait(pending)
        t1, c1 = time.monotonic_ns(), time.thread_time_ns()
        out = self._readback(pending)
        t2, c2 = time.monotonic_ns(), time.thread_time_ns()
        record_span("scorer.wait", t0, t1, attrs={"cpu_us": (c1 - c0) / 1e3})
        record_span("scorer.readback", t1, t2, attrs={"cpu_us": (c2 - c1) / 1e3})
        return out

    @staticmethod
    def _wait(pending: tuple) -> None:
        done = pending[3]
        if isinstance(done, list):
            for ev in done:
                ev.synchronize()
        elif done is not None:
            done.synchronize()

    def _readback(self, pending: tuple) -> np.ndarray:
        _staging, oh, take, _done, copies = pending
        settle_copies(self.telemetry, copies)
        return oh[:take].numpy().copy()

    def warmup(self) -> None:
        """Run every bucket once through the serving path: builds the
        kernel (nvcc, first use) and raises if it does not build or
        launch."""
        with self._lock:
            live = self._live
        for b in self.batch_sizes:
            zeros = np.zeros((b, self.num_features), np.float32)
            with compile_stage("scorer.warmup"):
                self._collect(self._launch(live, zeros, b))
            with self._lock:
                self._warmed.add(b)

    def score_pipelined(self, x: np.ndarray, depth: int = 2) -> np.ndarray:
        """Bulk scoring with ``depth`` dispatches in flight: the next
        chunk's copy and kernel are queued before the previous chunk's
        result is read back."""
        x = np.ascontiguousarray(x, dtype=np.float32)
        n = x.shape[0]
        if n == 0:
            return np.zeros((0,), np.float32)
        if x.ndim != 2 or x.shape[1] != self.num_features:
            raise ValueError(
                f"expected (n, {self.num_features}) rows, got {x.shape}")
        with self._lock:
            # one snapshot: a concurrent swap must not pair a new
            # quantization grid with the old kernel weights
            live = self._live
        largest = self.batch_sizes[-1]
        pending: deque = deque()
        chunks: list[np.ndarray] = []
        start = 0
        while start < n:
            take = min(n - start, largest)
            b = self.bucket(take)
            # the device-fault dispatch seam (runtime/faults.py):
            # device_hang stalls this dispatch past its watchdog,
            # compile_stall bills a synthetic build; the taxonomy the heal
            # ladder drills
            device_seam("dispatch")
            with self._lock:  # batcher workers share this scorer
                self._dispatch_counts[b] = self._dispatch_counts.get(b, 0) + 1
                self._rows_in += take
                self._rows_launched += b
            pending.append(self._launch(live, x[start:start + take], b))
            if len(pending) >= depth:
                chunks.append(self._collect(pending.popleft()))
            start += take
        while pending:
            chunks.append(self._collect(pending.popleft()))
        return np.concatenate(chunks)

    def _score_recorded(self, x: np.ndarray, record_span: Any) -> np.ndarray:
        token = _STEP_SPANS.set(record_span)
        try:
            return self.score_pipelined(x, depth=1)
        finally:
            _STEP_SPANS.reset(token)

    def score(self, x: np.ndarray, record_span: Any = None) -> np.ndarray:
        """(n, F) float32 -> (n,) float32 proba_1: the synchronous latency
        path, one chunk in flight, within the dispatch deadline where one
        is set (module docstring). ``record_span(name, start_ns, end_ns,
        attrs=)`` (a ``Tracer.record`` with the caller's span bound as
        parent) gets each dispatch's steps as spans; None records none."""
        run = (partial(self.score_pipelined, x, 1) if record_span is None
               else partial(self._score_recorded, x, record_span))
        if self._dispatcher is None:
            return run()
        if self._wedge.wedged:
            raise ScorerTimeout(f"device wedged for {self._wedge.wedged_for_s:.1f}s")
        # the deadline is for one bucketed dispatch: a request of many chunks
        # gets one deadline a chunk
        n_chunks = max(1, -(-len(x) // self.batch_sizes[-1]))
        try:
            return self._dispatcher.call(run, self.dispatch_deadline_s * n_chunks)
        except ScorerTimeout:
            with self._lock:
                self.dispatch_timeouts += 1
            self._wedge.mark_wedged()
            raise

    def drop_device_state(self) -> None:
        """Forget the per-bucket state this scorer keeps about the card (the
        warmed set): the heal ladder's reinit rung calls it after emptying
        the allocator's cache, and its warm step warms every bucket again.
        The params stay staged."""
        with self._lock:
            self._warmed.clear()

    @property
    def wedged(self) -> bool:
        return self._wedge is not None and self._wedge.wedged

    # -- the router's host tier ------------------------------------------------
    @property
    def has_host_forward(self) -> bool:
        """True when the model has a numpy forward (every registry model;
        not an inference graph)."""
        return self.spec.apply_numpy is not None

    def host_score(self, x: np.ndarray) -> np.ndarray:
        """(n, F) -> (n,) proba_1 by the family's numpy forward over the
        host copy of the params, never touching the card. Only the router's
        degradation ladder calls it, after the scorer edge failed or while
        its breaker is open, and counts every row it scores
        (``router_degraded_total{tier="host"}``); ``score`` never falls back
        to it."""
        with self._lock:
            host_params = self._host_params
        return np.asarray(self.spec.apply_numpy(host_params, np.asarray(x, np.float32)),
                          np.float32)

    # -- the challenger slot (model lifecycle: shadow and canary scoring) ----
    def install_challenger(self, version: int, params: Any) -> None:
        """Stage a challenger's host copy beside the champion: the copy is
        made before the slot flips under the lock, so an in-flight
        ``challenger_score`` keeps the old tree and the next call sees the
        new one. Needs the model's numpy host forward."""
        if self.spec.apply_numpy is None:
            raise RuntimeError(f"model {self.spec.name!r} has no host forward; the "
                               "challenger slot scores on the host by design")
        staged = to_numpy(params)
        with self._lock:
            self._challenger = (int(version), staged)

    def clear_challenger(self, version: int | None = None) -> None:
        """Remove the challenger; with ``version``, only that one (a stale
        clear must not evict a newer candidate)."""
        with self._lock:
            if self._challenger is not None and (
                    version is None or self._challenger[0] == int(version)):
                self._challenger = None

    @property
    def challenger_version(self) -> int | None:
        ch = self._challenger
        return ch[0] if ch is not None else None

    def challenger_score(self, x: np.ndarray) -> np.ndarray:
        """(n, F) -> (n,) proba_1 on the challenger slot's host params: no
        device round trip, never touches the champion's path."""
        ch = self._challenger
        if ch is None:
            raise RuntimeError("no challenger installed")
        return np.asarray(self.spec.apply_numpy(ch[1], np.asarray(x, np.float32)), np.float32)
